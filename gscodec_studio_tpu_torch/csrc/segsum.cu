// Segment sums: per-Gaussian sums of the per-intersection gradient rows,
// read in expansion order, where compacted id r owns the contiguous range
// [min(cum[r-1], n_isects), min(cum[r], n_isects)) (cum[-1] read as 0).
//
// Replaces gscodec_studio_tpu/ops/raster_v2.py:_segsum_kernel /
// segsum_rows. The TPU kernel sums id-sorted rows per block of 128 ids as
// one-hot MXU products (a 3-way bf16 split keeps them exact in f32); here
// each id's rows are one contiguous range, so no one-hot and no id row are
// needed. Truncated runs (total > cap) reduce to partial sums and leave
// every later id's range empty, as in the JAX reduction.
//
// Bound on the H100: bytes. The rows of the first n_isects columns are
// read once, the count prefix once, and d sums written per id. Design: four
// lanes per id (ranges average a few columns, and a whole warp per id left
// most lanes idle: 0.62 ms against 0.29 for index_add_ at 1M Gaussians);
// lane l of an id adds columns lo + l, lo + l + 4, ... of each row in
// ascending order, then the four lanes reduce with shuffles in a fixed
// tree and the first writes the sum. A long range (a large splat) is
// still split four ways. No atomics: the same inputs give the same bits on
// every run.
//
// Packed-pair branch (``packed``; replaces the packed_pairs branch of
// _segsum_kernel, raster_v2.py:1412-1431): each input word holds two
// truncated-bf16 values (csrc/raster_bwd.cu's packed rows), and output row
// r takes the f32 sums of the high halves of input row r, row d + r those
// of the low halves. A half is read with integer masking and shifting and
// reinterpreted as f32 (exact: it is a bf16 value), so no float operation
// ever sees a packed word, whose bits could read as a subnormal float. The
// walk and the shuffle order are the f32 branch's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 4;  // lanes per id

__device__ __forceinline__ float lane_sum(float s) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    s += __shfl_down_sync(kFull, s, o, kLanes);
  }
  return s;
}

template <bool PACKED>
__global__ void segsum_kernel(const void* __restrict__ rows, int64_t L,
                              int d, const int* __restrict__ cum, int M,
                              const int* __restrict__ n_isects,
                              float* __restrict__ out) {
  const int64_t id =
      (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / kLanes;
  const int sub = threadIdx.x % kLanes;
  // lanes past the last id stay for the shuffles with an empty range
  const int n = *n_isects;
  const int lo = id >= M ? 0 : (id == 0 ? 0 : min(cum[id - 1], n));
  const int hi = id >= M ? 0 : min(cum[id], n);
  for (int r = 0; r < d; ++r) {
    if (PACKED) {
      const uint32_t* row =
          static_cast<const uint32_t*>(rows) + (int64_t)r * L;
      float sh = 0.0f, sl = 0.0f;
      for (int j = lo + sub; j < hi; j += kLanes) {
        const uint32_t u = row[j];
        sh += gsc::pair_hi(u);
        sl += gsc::pair_lo(u);
      }
      sh = lane_sum(sh);
      sl = lane_sum(sl);
      if (sub == 0 && id < M) {
        out[(int64_t)r * M + id] = sh;
        out[(int64_t)(d + r) * M + id] = sl;
      }
    } else {
      const float* row = static_cast<const float*>(rows) + (int64_t)r * L;
      float s = 0.0f;
      for (int j = lo + sub; j < hi; j += kLanes) s += row[j];
      s = lane_sum(s);
      if (sub == 0 && id < M) out[(int64_t)r * M + id] = s;
    }
  }
}

}  // namespace

// rows: f32 [d, L], or with packed uint32 words [d, L]; out: f32 [d, M],
// or with packed [2d, M].
extern "C" int gsc_segsum_rows(const void* rows, long long L, int d,
                               const void* cum, int M, const void* n_isects,
                               int packed, void* out, void* stream) {
  if (d < 0 || M < 0 || L < 0) return (int)cudaErrorInvalidValue;
  if (M > 0 && d > 0) {
    const int threads = 256;  // 64 ids per block
    const int64_t blocks = ((int64_t)M * kLanes + threads - 1) / threads;
    auto kernel = packed ? segsum_kernel<true> : segsum_kernel<false>;
    kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        rows, (int64_t)L, d, static_cast<const int*>(cum), M,
        static_cast<const int*>(n_isects), static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
