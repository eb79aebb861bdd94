"""Build and load the port's native libraries: the CUDA kernels and the
host C++ the port reuses from ``native/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. A host
library (``HOST_SOURCES``) is compiled from its sources in ``native/`` by
the host C++ compiler; ``native/``'s own Makefile is not used:

- ``jcudf_rows``: ``native/jcudf_rows.cpp`` alone (it includes only
  ``<cstdint>`` and ``<cstring>``);
- ``sparkpf``: the Parquet footer parser and page decoder
  (``native/parquet_footer.cpp`` + ``native/parquet_pages.cpp``, over
  ``native/thrift_compact.hpp``). The page decoder includes ``<zlib.h>``
  and, when present, ``<zstd.h>``; ``host_libraries`` probes how this
  machine provides them (``describe_host_libraries`` says which branch
  was taken).

Libraries land in ``build/spark_rapids_jni_tpu_torch/`` beside the
package, named by a hash of the sources, headers and flags, so an edited
source is rebuilt and an unchanged one is not. Builds take a file lock,
so concurrent processes build once, and rename into place atomically;
the sources asked for in one call compile in parallel, one compiler
each.

Nothing here runs at import: the first call builds.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
_ROOT = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(_ROOT, "build", "spark_rapids_jni_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)
_NATIVE = os.path.join(_ROOT, "native")
HOST_SOURCES = {
    "jcudf_rows": (os.path.join(_NATIVE, "jcudf_rows.cpp"),),
    "sparkpf": (
        os.path.join(_NATIVE, "parquet_footer.cpp"),
        os.path.join(_NATIVE, "parquet_pages.cpp"),
    ),
}
HOST_HEADERS = {"sparkpf": (os.path.join(_NATIVE, "thrift_compact.hpp"),)}
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
# zlib's declarations for a machine with libz.so.1 but no zlib.h
HOST_INCLUDE = os.path.join(SRC_DIR, "host_include")

# inflates gzip("spark"): checks the port's zlib declarations against libz.so.1
_ZLIB_PROBE = """#include <zlib.h>
#include <cstring>
int main() {
  static unsigned char in[] = {31, 139, 8, 0, 0, 0, 0, 0, 2, 3, 43, 46, 72, 44, 202,
                               6, 0, 45, 207, 19, 157, 5, 0, 0, 0};
  unsigned char out[16] = {0};
  z_stream s;
  std::memset(&s, 0, sizeof(s));
  if (inflateInit2(&s, 15 + 32) != Z_OK) return 1;
  s.next_in = in;
  s.avail_in = sizeof(in);
  s.next_out = out;
  s.avail_out = sizeof(out);
  int rc = inflate(&s, Z_NO_FLUSH);
  inflateEnd(&s);
  return rc == Z_STREAM_END && std::memcmp(out, "spark", 6) == 0 ? 0 : 1;
}
"""

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}  # guarded by _LOCK


def sources(name: str) -> Tuple[str, ...]:
    """The source files of library ``name``."""
    return HOST_SOURCES.get(name) or (os.path.join(SRC_DIR, f"{name}.cu"),)


def kernel_sources():
    """Names of the CUDA kernel sources under ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(SRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _cxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if found:
        return found
    raise RuntimeError("no host C++ compiler (g++ or c++) found")


def _has_header(header: str) -> bool:
    """Whether the host compiler finds ``<header>`` (the Makefile's zstd
    probe: preprocess a one-line include)."""
    proc = subprocess.run(
        [_cxx(), "-E", "-x", "c++", "-"], input=f"#include <{header}>\n",
        capture_output=True, text=True,
    )
    return proc.returncode == 0


def _probe_runs(code: str, cflags, ldflags) -> bool:
    """Whether ``code`` compiles, links with ``ldflags`` and exits 0."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.join(BUILD_DIR, f"probe-{os.getpid()}-{threading.get_ident()}")
    with open(stem + ".cpp", "w") as f:
        f.write(code)
    try:
        cc = subprocess.run(
            [_cxx(), "-std=c++17", *cflags, stem + ".cpp", "-o", stem, *ldflags],
            capture_output=True,
        )
        return cc.returncode == 0 and subprocess.run([stem], capture_output=True).returncode == 0
    finally:
        for path in (stem + ".cpp", stem):
            if os.path.exists(path):
                os.remove(path)


@functools.lru_cache(maxsize=None)
def host_libraries() -> Dict[str, Tuple[str, Tuple[str, ...], Tuple[str, ...]]]:
    """How this machine provides zlib and zstd to the page decoder:
    ``{"zlib": (branch, cflags, ldflags), "zstd": (...)}``.

    - zlib: the system header with ``-lz``; without the header, the
      port's own declarations (``csrc/host_include/zlib.h``) over
      ``libz.so.1``; with neither, a RuntimeError that names zlib.
    - zstd: optional, as in the Makefile. With the header the decoder
      includes it and links ``-lzstd``; without it a ZSTD page fails
      with the decoder's own error.
    """
    out = {}
    if _has_header("zlib.h"):
        out["zlib"] = ("system zlib.h, -lz", (), ("-lz",))
    elif _probe_runs(_ZLIB_PROBE, ("-I", HOST_INCLUDE), ("-l:libz.so.1",)):
        out["zlib"] = (
            "no zlib.h: port header csrc/host_include/zlib.h over libz.so.1",
            ("-I", HOST_INCLUDE),
            ("-l:libz.so.1",),
        )
    else:
        raise RuntimeError(
            "zlib: neither the header zlib.h nor the library libz.so.1 is usable; "
            "the Parquet page decoder (native/parquet_pages.cpp) needs zlib"
        )
    if _has_header("zstd.h"):
        out["zstd"] = ("system zstd.h, -lzstd", (), ("-lzstd",))
    else:
        out["zstd"] = ("no zstd.h: ZSTD pages fail in the decoder", (), ())
    return out


def describe_host_libraries() -> str:
    """One line naming the zlib and zstd branch ``host_libraries`` took."""
    return "; ".join(f"{k}: {v[0]}" for k, v in host_libraries().items())


def _flags(name: str):
    """(flags before the sources, flags after them) of library ``name``."""
    if name not in HOST_SOURCES:
        return NVCC_FLAGS, ()
    if name != "sparkpf":
        return HOST_FLAGS, ()
    libs = host_libraries().values()
    cflags = tuple(f for _branch, c, _l in libs for f in c)
    ldflags = tuple(f for _branch, _c, ld in libs for f in ld)
    return HOST_FLAGS + cflags, ldflags


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for path in sources(name) + HOST_HEADERS.get(name, ()):
        with open(path, "rb") as f:
            h.update(f.read())
    before, after = _flags(name)
    h.update(" ".join(before + ("|",) + after).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(*names: str) -> Dict[str, str]:
    """Compile the named sources that are not built yet, all at once.
    Returns each name's compiler output ("" when it was already
    built); raises with the output when a compiler fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    logs = {name: "" for name in names}
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = {}
        for name in names:
            path = library_path(name)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            compiler = _cxx() if name in HOST_SOURCES else _nvcc()
            before, after = _flags(name)
            cmd = [compiler, *before, "-o", tmp, *sources(name), *after]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp,
                path,
            )
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(proc.args[0])} failed for {name}:\n{out}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(library_path(name))
            _LIBS[name] = lib
        return lib
