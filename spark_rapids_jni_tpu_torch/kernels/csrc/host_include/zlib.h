/* The part of zlib's public C interface that native/parquet_pages.cpp
 * uses, for machines that carry the zlib runtime (libz.so.1) but not its
 * development header. The declarations follow zlib 1.2's zlib.h: the
 * z_stream layout, inflateInit2 (as the inflateInit2_ macro), inflate,
 * inflateEnd and the three return/flush codes. inflateInit2_ checks only
 * the major version digit and sizeof(z_stream), so any zlib 1.x runtime
 * accepts it. kernels/_build.py puts this directory on the include path
 * only when the system header is absent. */
#ifndef SPARK_RAPIDS_PORT_ZLIB_H
#define SPARK_RAPIDS_PORT_ZLIB_H

#ifdef __cplusplus
extern "C" {
#endif

#define ZLIB_VERSION "1.2.11"

#define Z_NO_FLUSH 0
#define Z_OK 0
#define Z_STREAM_END 1

typedef unsigned char Byte;
typedef Byte Bytef;
typedef unsigned int uInt;
typedef unsigned long uLong;
typedef void* voidpf;
typedef voidpf (*alloc_func)(voidpf opaque, uInt items, uInt size);
typedef void (*free_func)(voidpf opaque, voidpf address);

struct internal_state;

typedef struct z_stream_s {
  Bytef* next_in;
  uInt avail_in;
  uLong total_in;
  Bytef* next_out;
  uInt avail_out;
  uLong total_out;
  char* msg;
  struct internal_state* state;
  alloc_func zalloc;
  free_func zfree;
  voidpf opaque;
  int data_type;
  uLong adler;
  uLong reserved;
} z_stream;

typedef z_stream* z_streamp;

int inflateInit2_(z_streamp strm, int windowBits, const char* version,
                  int stream_size);
int inflate(z_streamp strm, int flush);
int inflateEnd(z_streamp strm);

#define inflateInit2(strm, windowBits) \
  inflateInit2_((strm), (windowBits), ZLIB_VERSION, (int)sizeof(z_stream))

#ifdef __cplusplus
}
#endif

#endif /* SPARK_RAPIDS_PORT_ZLIB_H */
