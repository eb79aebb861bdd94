// The PJRT accelerator bootstrap of the port's JNI library (sprt_jni).
//
// native/jni/TestSupportJni.cpp declares and calls sprt_pjrt_backend_init,
// which native/jni/pjrt_backend.cpp defines over the PJRT C API. The port
// registers no PJRT accelerator backend: it builds neither that file nor
// native/pjrt/pjrt_executor.cpp, whose header comes from an XLA install.
// This definition keeps the library loadable with RTLD_NOW. It always
// fails, so run_op (sprt_jni_common.hpp) finds no accelerated backend and
// reaches the registered Python backend.
#include <cstdio>

extern "C" int sprt_pjrt_backend_init(const char* plugin_path, const char* exports_dir,
                                      const char* options) {
  (void)plugin_path;
  (void)exports_dir;
  (void)options;
  std::fprintf(stderr,
               "sprt_pjrt_backend_init: the spark_rapids_jni_tpu_torch JNI library "
               "registers no PJRT accelerator backend; ops dispatch to the Python "
               "backend (runtime/jni_backend.register)\n");
  return 1;
}
