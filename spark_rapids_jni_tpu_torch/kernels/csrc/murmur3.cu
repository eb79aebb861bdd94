// Spark Murmur3_x86_32 multi-column hash chain for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spark_rapids_jni_tpu/kernels/murmur3.py
// (_hash_kernel, launched by _hash_padded through pl.pallas_call). Same
// contract: word planes int32 [W, n], validity planes int8 [V, n], a
// static plan of columns (consecutive planes mixed into h1, then fmix
// by 4 or 8 bytes; a row that is null in that column keeps the running
// hash), a uint32 seed. Output: int32 [n] holding the uint32 bits.
//
// Bound: memory. Each row reads 4W + V bytes and writes 4; the chain
// does some ten integer operations per plane, far below the card's
// integer rate, so the least time is (4W + V + 4) * n bytes over the
// HBM rate (3.35 TB/s on an H100 SXM).
//
// Design against that bound: one thread per row with a grid-stride
// loop, so that thread i reads words[p * n + i] and a warp's loads of
// one plane are 128 contiguous bytes; every input byte is read once
// and the hash stays in a register across all columns. Arithmetic is
// native uint32 (no masked logical shift as on the TPU's int32 lanes).
// The ragged tail is masked by the loop bound; nothing is padded.
// The plan arrives by value in the kernel's parameters.

#include <cstdint>
#include <cuda_runtime.h>

#define MURMUR3_MAX_COLS 32

struct Murmur3Plan {
  int32_t n_cols;
  int32_t first_plane[MURMUR3_MAX_COLS];
  int32_t n_planes[MURMUR3_MAX_COLS];
  int32_t fmix_len[MURMUR3_MAX_COLS];
  int32_t valid_plane[MURMUR3_MAX_COLS];  // -1: the column has no nulls
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  k1 *= 0x1B873593u;
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h1, uint32_t length) {
  h1 ^= length;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  return h1 ^ (h1 >> 16);
}

__global__ void murmur3_chain_kernel(const uint32_t* __restrict__ words,
                                     const int8_t* __restrict__ valids,
                                     uint32_t* __restrict__ out, int64_t n,
                                     Murmur3Plan plan, uint32_t seed) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t h = seed;
    for (int c = 0; c < plan.n_cols; ++c) {
      uint32_t h1 = h;
      const int64_t p0 = plan.first_plane[c];
      for (int k = 0; k < plan.n_planes[c]; ++k) {
        h1 = mix_h1(h1, __ldg(words + (p0 + k) * n + i));
      }
      h1 = fmix(h1, (uint32_t)plan.fmix_len[c]);
      const int vp = plan.valid_plane[c];
      if (vp < 0 || __ldg(valids + (int64_t)vp * n + i) != 0) h = h1;
    }
    out[i] = h;
  }
}

extern "C" int murmur3_chain(const void* words, const void* valids, void* out,
                             int64_t n, const Murmur3Plan* plan,
                             uint32_t seed, int num_sms, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = (int64_t)num_sms * 8;  // grid-stride past 8 blocks/SM
  if (blocks > cap) blocks = cap;
  murmur3_chain_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const int8_t*>(valids),
      static_cast<uint32_t*>(out), n, *plan, seed);
  return (int)cudaGetLastError();
}
