// Row pack: n f32 rows (each with its own element stride) -> one
// attr-major [R, L] block, rows >= n zero-filled, optionally gathering the
// columns through a permutation.
//
// Replaces gscodec_studio_tpu/ops/raster_v2.py:_pack_kernel / pack_rows
// and, when a permutation is given, the payload gather that lax.sort did
// for the rows it carried: the binning calls it once with the depth order
// (the compacted Gaussian table) and once with the stable tile order (the
// sorted intersection table S).
//
// Bound on the H100: bytes. Each output column reads n floats (gathered,
// so a column's reads land on n different cache lines when a permutation
// is given) and one 8-byte index, and writes R floats. Design: one thread
// per output column, so the index is read once and every row's writes are
// coalesced across the warp; the row pointers and strides ride in the
// kernel's parameter space, so no pointer table is copied to the device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 128;

struct Rows {
  const float* ptr[kMaxRows];
  int stride[kMaxRows];
};

__global__ void pack_kernel(Rows rows, int n, const int64_t* __restrict__ perm,
                            int64_t L, float* __restrict__ out, int R) {
  const int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (j >= L) return;
  const int64_t src = perm ? perm[j] : j;
  for (int r = 0; r < R; ++r) {
    out[r * L + j] = r < n ? rows.ptr[r][src * rows.stride[r]] : 0.0f;
  }
}

}  // namespace

extern "C" int gsc_pack_rows(const void* ptrs, const void* strides, int n,
                             const void* perm, long long L, void* out, int R,
                             void* stream) {
  if (n < 0 || n > kMaxRows || R < n) return (int)cudaErrorInvalidValue;
  Rows rows;
  const uint64_t* p = static_cast<const uint64_t*>(ptrs);
  const int* s = static_cast<const int*>(strides);
  for (int i = 0; i < n; ++i) {
    rows.ptr[i] = reinterpret_cast<const float*>(p[i]);
    rows.stride[i] = s[i];
  }
  if (L > 0) {
    const int threads = 256;
    const int64_t blocks = (L + threads - 1) / threads;
    pack_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        rows, n, static_cast<const int64_t*>(perm), (int64_t)L,
        static_cast<float*>(out), R);
  }
  return (int)cudaGetLastError();
}
