// Row unpack: the first n rows of an attr-major [R, L_src] block of 4-byte
// words (f32, or packed pairs) into one [n, L] block, optionally
// scattering the columns through a permutation (out[:, idx[j]] =
// block[:, j]).
//
// Replaces gscodec_studio_tpu/ops/raster_v2.py:_unpack_kernel /
// unpack_rows and, with an index, the two payload sorts of the JAX
// backward's reduction (_reduce_grads): the per-intersection gradient rows
// go from S's column order back to expansion order through the forward's
// stable tile order (column j to position perm[j]), and the per-Gaussian
// sums from compacted order back to the input order through the depth
// order. The inverse of B9a's gather-pack (csrc/pack.cu).
//
// Bound on the H100: bytes. Each column reads n floats and one 8-byte
// index and writes n floats. Design: a scatter of n float rows writes
// each 4-byte value to its own 32-byte sector, which on the H100 took
// 1.08 ms for 9 rows of 2.8M columns against 0.22 ms for the same gather.
// So the scatter runs in two passes: one thread per column inverts the
// permutation into an int32 scratch row (the only scattered writes, one
// row), then one thread per output column gathers, reading the inverse
// once and writing every row coalesced across the warp. Each output
// column is written by exactly one thread.
//
// The kernel moves 4-byte words and never reads them as floats: the
// packed-pair gradient rows (csrc/raster_bwd.cu, grad_dtype "bf16") go
// through it with every bit kept, as the JAX package bitcasts them to int32
// before its sorts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void invert_kernel(const int64_t* __restrict__ idx, int64_t L,
                              int32_t* __restrict__ inv) {
  const int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (j < L) inv[idx[j]] = (int32_t)j;
}

__global__ void unpack_kernel(const uint32_t* __restrict__ block,
                              int64_t L_src, int n,
                              const int32_t* __restrict__ inv, int64_t L,
                              uint32_t* __restrict__ out) {
  const int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (j >= L) return;
  const int64_t src = inv ? (int64_t)inv[j] : j;
  for (int r = 0; r < n; ++r) out[r * L + j] = block[r * L_src + src];
}

}  // namespace

// idx: int64 permutation of [0, L) or null; inv: int32 scratch [L], used
// only with idx.
extern "C" int gsc_unpack_rows(const void* block, long long L_src, int n,
                               const void* idx, long long L, void* inv,
                               void* out, void* stream) {
  if (n < 0 || L < 0 || L_src < L || L > INT32_MAX || (idx && !inv))
    return (int)cudaErrorInvalidValue;
  if (L > 0 && n > 0) {
    const int threads = 256;
    const int64_t blocks = (L + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    if (idx)
      invert_kernel<<<(unsigned)blocks, threads, 0, s>>>(
          static_cast<const int64_t*>(idx), (int64_t)L,
          static_cast<int32_t*>(inv));
    unpack_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const uint32_t*>(block), (int64_t)L_src, n,
        idx ? static_cast<const int32_t*>(inv) : nullptr, (int64_t)L,
        static_cast<uint32_t*>(out));
  }
  return (int)cudaGetLastError();
}
