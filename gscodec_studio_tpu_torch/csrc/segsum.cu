// Segment sums: per-Gaussian sums of the per-intersection gradient rows,
// read in expansion order, where compacted id r owns the contiguous range
// [e[r-1], e[r]), e[r] = min(cum[r], n_isects) (e[-1] read as 0).
//
// Replaces gscodec_studio_tpu/ops/raster_v2.py:_segsum_kernel /
// segsum_rows. The TPU kernel sums id-sorted rows per block of 128 ids as
// one-hot MXU products (a 3-way bf16 split keeps them exact in f32); here
// each id's rows are one contiguous range, so no one-hot and no id row are
// needed. Truncated runs (total > cap) reduce to partial sums and leave
// every later id's range empty, as in the JAX reduction.
//
// Bound on the H100: bytes. The rows of the first n_isects columns are
// read once, the count prefix once, and d sums written per id (0.041 ms at
// the 1M scene's 3DGS rows, 0.089 ms at its 2DGS rows). What held the
// first design back: it gave each id 4 lanes and 8 ids a warp, so a warp
// took as long as its longest range, and one surfel whose range covers
// the screen (4,346 columns of 19 rows at the 1M scene) set the launch at
// 6.7% of the bound.
//
// Design: a merge-path decomposition (Merrill and Garland, "Merge-based
// Parallel Sparse Matrix-Vector Multiplication", SC16), with the warp as
// its unit. The merged sequence puts id r's columns before its end item,
// which sits at r + e[r]; each warp takes kItems items of it, so no
// range, however long, gives a warp more than kItems columns. A first
// pass over cum writes each warp's first id. A lane takes kPer
// consecutive columns, from the 16-byte boundary at or below the warp's
// first, and for each row copies them as two 16-byte words into shared
// memory by cp.async, two rows ahead: every load is coalesced, and none
// holds a register while in flight. It sums its pieces in column order and
// writes those that begin and end in it; a segmented scan of shuffles
// over the lanes gives the piece that reaches into a lane from the lanes
// before it. The sums go to the warp's shared row and out coalesced: each
// id whose end item the warp holds (0 for an empty id), and the sum of
// the id still open at its end to a scratch row. A last pass adds each
// open id's partial sums, in warp order, to the sum that the warp holding
// its end wrote. The warps share no barrier: a block is kWarps of them.
// The id, head and tail of every column are found once and serve every
// row. With no barrier, no range and few instructions a column, a warp
// waits only on its loads. No atomics: the order of the additions is
// fixed, so the same inputs give the same bits on every run.
//
// Packed-pair branch (``packed``; replaces the packed_pairs branch of
// _segsum_kernel, raster_v2.py:1412-1431): each input word holds two
// truncated-bf16 values (csrc/raster_bwd.cu's packed rows), and output row
// r takes the f32 sums of the high halves of input row r, row d + r those
// of the low halves. A half is read with integer masking and shifting and
// reinterpreted as f32 (exact: it is a bf16 value), so no float operation
// ever sees a packed word, whose bits could read as a subnormal float. The
// walk and the order of the additions are the f32 branch's.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// merged items a warp (raster_v2.SEG_WARP_ITEMS): its columns, from the
// 16-byte boundary at or below its first, fit 32 lanes of kPer columns
constexpr int kItems = 252;
constexpr int kPer = 8;  // columns a lane, two 16-byte words
constexpr int kWarps = 8;  // warps a block
constexpr int kStages = 3;  // rows in shared memory, kStages - 1 ahead

__device__ __forceinline__ int range_end(const int* __restrict__ cum, int r,
                                         int n) {
  return min(cum[r], n);
}

// The partition: first[w] is the number of end items among the first
// w * kItems items of the merged sequence (the first r with
// r + e[r] >= w * kItems, M if none), for each warp w that holds items
// and the one after the last. Thread r, r in [0, M], writes the
// boundaries that fall after id r-1's end item and at or before id r's
// (for r = M, the first boundary after the last end item): one coalesced
// pass over cum, each boundary written once.
__global__ void segsum_bounds(const int* __restrict__ cum, int M,
                              const int* __restrict__ n_isects, int64_t L,
                              int nw, int* __restrict__ first) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r > M) return;
  const int n = (int)min((int64_t)*n_isects, L);
  const int64_t lo = r == 0 ? 0 : (int64_t)r + range_end(cum, r - 1, n);
  const int64_t hi = r < M ? (int64_t)r + range_end(cum, r, n)
                           : lo + kItems - 1;
  for (int64_t w = (lo + kItems - 1) / kItems; w <= nw && w * kItems <= hi;
       ++w)
    first[w] = r;
}

// the warp's local id of its local column c: the first q with end[q] > c
__device__ __forceinline__ int local_id(const int* end, int nq, int c) {
  int lo = 0, hi = nq - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (end[mid] > c) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

template <bool PACKED>
__device__ __forceinline__ float half_of(uint32_t u, int v) {
  if (PACKED) return v == 0 ? gsc::pair_hi(u) : gsc::pair_lo(u);
  return __uint_as_float(u);
}

// Each warp of the grid sums one kItems share of the merged sequence;
// the warps of a block share nothing but the block.
template <bool PACKED>
__global__ void __launch_bounds__(32 * kWarps, PACKED ? 4 : 5)
    segsum_warps(const uint32_t* __restrict__ rows, int64_t L, int d,
                 const int* __restrict__ cum, int M,
                 const int* __restrict__ n_isects, int nw,
                 const int* __restrict__ first, float* __restrict__ carry,
                 int* __restrict__ carry_id, float* __restrict__ out) {
  constexpr int NV = PACKED ? 2 : 1;  // sums a word
  __shared__ int s_end[kWarps][kItems + 1];  // local ids' ends
  __shared__ float s_sum[kWarps][NV][kItems + 1];
  __shared__ __align__(16) uint32_t s_rows[kWarps][kStages][32][kPer];
  const int lane = threadIdx.x & 31, wl = threadIdx.x >> 5;
  const int wg = blockIdx.x * kWarps + wl;
  if (wg >= nw) return;
  const int n = (int)min((int64_t)*n_isects, L);
  const int64_t K = (int64_t)M + range_end(cum, M - 1, n);
  const int64_t k0 = (int64_t)wg * kItems;
  if (k0 >= K) {  // the grid is sized for n_isects = L
    if (lane == 0) carry_id[wg] = -1;
    return;
  }
  const int64_t k1 = min(k0 + kItems, K);
  const int i0 = first[wg], i1 = first[wg + 1];
  const int j0 = (int)(k0 - i0), j1 = (int)(k1 - i1);
  const int n_done = i1 - i0;        // ids whose end item is here
  const int nq = n_done + (i1 < M);  // and the one still open
  int* end = s_end[wl];
  for (int q = lane; q < nq; q += 32) {
    end[q] = range_end(cum, i0 + q, n) - j0;
#pragma unroll
    for (int v = 0; v < NV; ++v) s_sum[wl][v][q] = 0.0f;
  }
  if (lane == 0) carry_id[wg] = i1 < M ? i1 : -1;
  __syncwarp();

  // The lane's kPer columns, from the 16-byte boundary at or below j0, and
  // each one's local id (-1 before j0, nq from j1: pieces never written),
  // found once for every row. A column heads its piece where the column
  // before it has another id, and is its tail where the next one does.
  const int a0 = (j0 & ~3) + kPer * lane;
  const bool vec = (L & 3) == 0 && ((uintptr_t)rows & 15) == 0;
  int q[kPer];
  // one search for the lane's first column, then a walk over the ends
  int qc = a0 - j0 < j1 - j0 ? local_id(end, nq, max(a0 - j0, 0)) : nq;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int c = a0 + t - j0;
    if (c < 0) {
      q[t] = -1;
    } else if (a0 + t >= j1) {
      q[t] = nq;
    } else {
      while (end[qc] <= c) ++qc;
      q[t] = qc;
    }
  }
  int before = __shfl_up_sync(kFull, q[kPer - 1], 1);
  int after = __shfl_down_sync(kFull, q[0], 1);
  if (lane == 0) before = -2;
  if (lane == 31) after = nq + 1;
  unsigned hb = 0, tb = 0;  // head and tail bits of the lane's columns
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    if (q[t] != (t > 0 ? q[t - 1] : before)) hb |= 1u << t;
    if (q[t] != (t < kPer - 1 ? q[t + 1] : after)) tb |= 1u << t;
  }
  // the lane's first piece began in an earlier lane where its first column
  // heads nothing; its sum then takes the earlier lanes' partial sums, and
  // the tail of that piece (bit lb) keeps its own. Every other tail of a
  // real id writes its piece's sum to the slot q[t] (-1: no write).
  const bool lead = !(hb & 1u) && tb;
  const unsigned lb = lead ? tb & -tb : 0u;
  int q_lead = -1;
#pragma unroll
  for (int t = kPer - 1; t >= 0; --t)
    if ((tb >> t) & 1u) q_lead = q[t];
  if (q_lead >= nq) q_lead = -1;
#pragma unroll
  for (int t = 0; t < kPer; ++t)
    if (!((tb >> t) & 1u) || ((lb >> t) & 1u) || q[t] >= nq) q[t] = -1;
  // the scan over lanes restarts at the last lane at or below this one
  // whose last piece began in it
  const int hl =
      max(31 - __clz(__ballot_sync(kFull, hb != 0) & (kFull >> (31 - lane))),
          0);

  // the rows' words go through shared memory by cp.async, kStages - 1
  // rows ahead of the one being summed; a lane reads back only the words
  // it copied, and the copies hold no registers in flight
  auto stage = [&](int r) {
    if (r < d) {
      const uint32_t* row = rows + (int64_t)r * L;
      uint32_t* w = s_rows[wl][r % kStages][lane];
      if (vec) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (a0 + 4 * h < j1) {
            __pipeline_memcpy_async(w + 4 * h, row + a0 + 4 * h, 16);
          } else {
            *reinterpret_cast<uint4*>(w + 4 * h) = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < kPer; ++t) {
          if (a0 + t >= j0 && a0 + t < j1) {
            __pipeline_memcpy_async(w + t, row + a0 + t, 4);
          } else {
            w[t] = 0u;
          }
        }
      }
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int r = 0; r < kStages - 1; ++r) stage(r);
  for (int r = 0; r < d; ++r) {
    stage(r + kStages - 1);
    __pipeline_wait_prior(kStages - 1);
    const uint4* got = reinterpret_cast<const uint4*>(
        s_rows[wl][r % kStages][lane]);
    const uint4 w0 = got[0], w1 = got[1];
    const uint32_t u[kPer] = {w0.x, w0.y, w0.z, w0.w,
                              w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      // the lane's pieces in column order: those that begin and end in it
      // are written at their tails (the two halves of a packed word side
      // by side)
      float s = 0.0f, lead_sum = 0.0f;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const float x = half_of<PACKED>(u[t], v);
        s = (hb >> t) & 1u ? x : s + x;
        if ((lb >> t) & 1u) lead_sum = s;
        if (q[t] >= 0) s_sum[wl][v][q[t]] = s;
      }
      // the last piece's partial sums over the lanes, restarting where it
      // began; the first piece of a lane takes the lanes' sum before it
      float incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, incl, o);
        if (lane - o >= hl) incl = y + incl;
      }
      const float excl = __shfl_up_sync(kFull, incl, 1);
      if (q_lead >= 0 && lead) s_sum[wl][v][q_lead] = excl + lead_sum;
    }
    __syncwarp();
    // every id of the warp, coalesced (0 for an empty one), then the
    // open id's partial sum
    for (int qq = lane; qq < nq; qq += 32) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float sum = s_sum[wl][v][qq];
        s_sum[wl][v][qq] = 0.0f;
        if (qq < n_done) {
          out[(int64_t)(v * d + r) * M + i0 + qq] = sum;
        } else {
          carry[(int64_t)(v * d + r) * nw + wg] = sum;
        }
      }
    }
    __syncwarp();
  }
}

// The last pass: the first warp of each run of warps whose open id is
// the same adds their partial sums in warp order, then the sum that the
// warp holding the id's end wrote.
__global__ void segsum_carry(const float* __restrict__ carry,
                             const int* __restrict__ carry_id, int nw, int M,
                             float* __restrict__ out) {
  // the run's next kLook warps are read with the warp's own id, all at
  // once: a surfel whose range covers the screen spans ~20 warps, and a
  // chain of dependent loads would set the pass
  constexpr int kLook = 8;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (w >= nw) return;
  const float* row = carry + (int64_t)r * nw;
  const int id = carry_id[w];
  const int prev = w > 0 ? carry_id[w - 1] : -1;
  float acc = row[w];
  int ids[kLook];
  float vals[kLook];
#pragma unroll
  for (int k = 0; k < kLook; ++k) {
    ids[k] = w + 1 + k < nw ? carry_id[w + 1 + k] : -1;
    vals[k] = w + 1 + k < nw ? row[w + 1 + k] : 0.0f;
  }
  if (id < 0 || prev == id) return;
  for (int t = w + 1;; t += kLook) {
    bool more = true;
#pragma unroll
    for (int k = 0; k < kLook; ++k) {
      more = more && ids[k] == id;
      if (more) acc = acc + vals[k];
    }
    if (!more || t + kLook >= nw) break;
#pragma unroll
    for (int k = 0; k < kLook; ++k) {
      ids[k] = t + kLook + k < nw ? carry_id[t + kLook + k] : -1;
      vals[k] = t + kLook + k < nw ? row[t + kLook + k] : 0.0f;
    }
  }
  float* o = out + (int64_t)r * M + id;
  *o = acc + *o;
}

}  // namespace

// rows: f32 [d, L], or with packed uint32 words [d, L]; out: f32 [d, M],
// or with packed [2d, M]; carry: f32 scratch [d or 2d, nw]; ids: int32
// scratch [2 nw + 1], the warps' open ids, then the partition's first ids;
// nw >= ceil((M + L) / kItems) warps.
extern "C" int gsc_segsum_rows(const void* rows, long long L, int d,
                               const void* cum, int M, const void* n_isects,
                               int packed, int nw, void* carry,
                               void* ids, void* out, void* stream) {
  if (d < 0 || M < 0 || L < 0 || L > INT32_MAX || nw < 0 ||
      (int64_t)nw * kItems < (int64_t)M + L || d > 65535 / 2)
    return (int)cudaErrorInvalidValue;
  if (M > 0 && d > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    int* carry_id = static_cast<int*>(ids);
    int* first = carry_id + nw;
    segsum_bounds<<<(unsigned)(M / 256 + 1), 256, 0, s>>>(
        static_cast<const int*>(cum), M, static_cast<const int*>(n_isects),
        (int64_t)L, nw, first);
    auto warps = packed ? segsum_warps<true> : segsum_warps<false>;
    warps<<<(unsigned)((nw + kWarps - 1) / kWarps), 32 * kWarps, 0, s>>>(
        static_cast<const uint32_t*>(rows), (int64_t)L, d,
        static_cast<const int*>(cum), M, static_cast<const int*>(n_isects),
        nw, first, static_cast<float*>(carry), carry_id,
        static_cast<float*>(out));
    const dim3 grid((unsigned)((nw + 127) / 128),
                    (unsigned)((packed ? 2 : 1) * d));
    segsum_carry<<<grid, 128, 0, s>>>(static_cast<const float*>(carry),
                                      carry_id, nw, M,
                                      static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
