// Intersection expansion: the depth-sorted, compacted Gaussian table ->
// the fixed-capacity per-intersection list (tile key, attribute rows, id).
//
// Replaces gscodec_studio_tpu/ops/raster_v2.py:_expand_kernel / _run_expand.
// The TPU kernel found each output row's Gaussian with a one-hot MXU matmul
// made bit-exact by a 3-way bf16 split; here a search of the inclusive
// intersection-count prefix `cum` finds it, which is exact by construction.
// Rank, dy, dx and the tile id are computed in float, as the TPU kernel
// does, and the conservative ellipse cull uses the same formula in the same
// order (the library is built with --fmad=false), so the list, order
// included, is the JAX package's: the tile sort that follows is stable.
// The cull reads the 3DGS conic layout (x, y, ca, cb, cc, op in rows 0-5);
// with cull = 0 (the 2DGS layout, the TPU kernel's `if cfg.cull:` branch)
// every in-range pair keeps its tile and the overflow tile stays empty.
//
// Packed branch (the 3DGS layout; replaces the `cfg.geom_packed` and
// `cfg.attr_packed` writes at raster_v2.py:520-541): with geom_packed the
// (x, y) rows become one u16 position word; with attr_packed the values
// after the position (ca, cb, cc, op, colors) become truncated-bf16 pairs
// (ca, cb), (cc, op), (c0, c1), ..., an odd last value paired with 0
// (tile_common.cuh). The cull reads the f32 table in both branches, so its
// decisions do not change; only the written rows are packed.
//
// Bound on the H100: bytes: the table's columns and cum, base, nx of the
// Gaussians with a row below n_isects read once (the invisible ones, count
// 0, are never read), the key and the d_s output rows written once.
// Design: a block of 128 threads owns BR = 512 consecutive output rows, 4 a
// thread, so that every output row is written by 16-byte vector stores
// (scalar ones where the capacity is not a multiple of 4). Its first and
// last in-range rows' Gaussians come from two warps' 32-way searches of
// `cum` (4 dependent loads at 1M Gaussians, where one thread's binary
// search took 20).
// Below n_isects every Gaussian has a count >= 1 (the invisible ones sort
// last with count 0, and cum is clamped at the capacity), so the block's
// window of Gaussians holds at most BR of them; the block stages the
// window's cum, base and nx in shared memory with coalesced loads, and
// each row finds its Gaussian there (a search of the staged prefix for a
// thread's first row, then steps). The table's values are read from
// device memory by each row: a warp's 128 rows meet ~30 neighbouring
// Gaussians at 1M, so the reads are mostly L1 hits; staging them too
// (in groups of rows, between barriers) ran 1.18-1.27x slower on an H100
// (PERF.md). A window wider than BR (zero counts inside it, which the
// binning does not make) takes the same code on device memory. Blocks
// wholly past n_isects write the empty rows (INT32_MAX, zeros) and search
// nothing. No atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

constexpr int kInt32Max = 2147483647;
constexpr int RPT = 4;  // consecutive output rows a thread (a multiple of 4)
constexpr int THREADS = 128;     // a block's threads
constexpr int BR = RPT * THREADS;  // a block's output rows
constexpr unsigned kFull = 0xffffffffu;

// Whether 0.5*lambda_min(conic)*dist(mean, tile)^2 already exceeds
// ln(255*op) for a Gaussian at (xs, ys) with conic (ca, cb, cc) and opacity
// op: then its alpha can never reach 1/255 in the tile.
__device__ bool misses_tile(float xs, float ys, float ca, float cb, float cc,
                            float op, int tile, int tile_width,
                            int tile_height, int tile_size) {
  const float ts_f = (float)tile_size;
  const int rem = tile % (tile_width * tile_height);
  const float txt = (float)(rem % tile_width);
  const float tyt = (float)(rem / tile_width);
  const float qx =
      fminf(fmaxf(xs, txt * ts_f + 0.5f), txt * ts_f + ts_f - 0.5f);
  const float qy =
      fminf(fmaxf(ys, tyt * ts_f + 0.5f), tyt * ts_f + ts_f - 0.5f);
  const float ex = xs - qx;
  const float ey = ys - qy;
  const float d2 = ex * ex + ey * ey;
  const float half_tr = 0.5f * (ca + cc);
  const float hd = 0.5f * (ca - cc);
  const float lam_min =
      fmaxf(half_tr - sqrtf(hd * hd + cb * cb + 1e-30f), 0.0f);
  return !(0.5f * lam_min * d2 <= logf(fmaxf(255.0f * op, 1e-12f)));
}

// The first g in [0, M) with cum[g] > v (M - 1 if none, as the plain
// version clamps), by a warp: 32 probes a step, so log33(M) steps.
__device__ int warp_search(const int* __restrict__ cum, int M, int64_t v,
                           int lane) {
  int lo = 0, hi = M - 1;  // the answer lies in [lo, hi]
  while (hi - lo > 31) {
    const int q = lo + (int)((int64_t)(hi - lo) * (lane + 1) / 33);
    const unsigned b = __ballot_sync(kFull, cum[q] > v);
    if (b == 0) {
      lo = __shfl_sync(kFull, q, 31) + 1;
    } else {
      const int f = __ffs(b) - 1;
      const int below = __shfl_sync(kFull, q, f > 0 ? f - 1 : 0);
      hi = __shfl_sync(kFull, q, f);
      if (f > 0) lo = below + 1;
    }
  }
  const int q = min(lo + lane, hi);
  const unsigned b = __ballot_sync(kFull, cum[q] > v);
  return b ? lo + __ffs(b) - 1 : hi;
}

// The block's window of Gaussians [g0, g0 + W): its count prefix, first
// tiles and rect widths, staged in shared memory (kStaged) or read from
// device memory (a window wider than the block). li indexes the window.
template <bool kStaged>
struct Window {
  const int* cum;  // staged: [W + 1], cum[g0 - 1] (0 at g0 = 0) first
  const int* base;
  const int* nx;
  int g0;
  __device__ int cum_incl(int li) const {
    return kStaged ? cum[li + 1] : cum[g0 + li];
  }
  __device__ int cum_excl(int li) const {
    if (kStaged) return cum[li];
    return g0 + li > 0 ? cum[g0 + li - 1] : 0;
  }
  __device__ int base_at(int li) const {
    return base[kStaged ? li : g0 + li];
  }
  __device__ int nx_at(int li) const { return nx[kStaged ? li : g0 + li]; }
};

// Stores a thread's RPT words of one output row (from row p).
__device__ __forceinline__ void store_words(uint32_t* row, int64_t p,
                                            int64_t cap, bool vec,
                                            const uint32_t (&w)[RPT]) {
  if (vec && p + RPT <= cap) {
#pragma unroll
    for (int k = 0; k < RPT; k += 4) {
      *reinterpret_cast<uint4*>(row + p + k) =
          make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      if (p + j < cap) row[p + j] = w[j];
    }
  }
}

struct Args {
  const int* cum;
  int M;
  const int* base;
  const int* nx;
  const float* table;
  int n_attr;
  const int* n_isects;
  int64_t cap;
  int tile_width, tile_height, tile_size, n_tiles;
  int cull, geom_packed, attr_packed, n_srows;
  int* tile_out;
  uint32_t* rows_out;
  bool vec;
};

// Table row a of Gaussian g (the neighbouring rows of a warp read
// neighbouring Gaussians, mostly the same ones: L1 serves them).
__device__ __forceinline__ float tab(const Args& A, int a, int g) {
  return __ldg(A.table + a * (int64_t)A.M + g);
}

// The thread's rows p .. p + RPT - 1 (those below pe in range) through the
// window `win` of W Gaussians: their Gaussians, keys and rows.
template <bool kStaged>
__device__ void expand_rows(const Args& A, const Window<kStaged>& win, int W,
                            int64_t p, int64_t pe) {
  int g[RPT];
  bool ok[RPT];
  int l = 0;
  if (p < pe) {  // the first li with cum > p
    int hi = W - 1;
    while (l < hi) {
      const int mid = (l + hi) >> 1;
      if (win.cum_incl(mid) > p) {
        hi = mid;
      } else {
        l = mid + 1;
      }
    }
  }
  uint32_t w[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    ok[j] = p + j < pe;
    w[j] = (uint32_t)kInt32Max;
    if (ok[j]) {
      while (l < W - 1 && win.cum_incl(l) <= p + j) ++l;
      const float rank = (float)(p + j - win.cum_excl(l));
      const float nxr = fmaxf((float)win.nx_at(l), 1.0f);
      const float dy = floorf(rank / nxr);
      const float dx = rank - dy * nxr;
      int tile =
          (int)((float)win.base_at(l) + dy * (float)A.tile_width + dx);
      const int gj = win.g0 + l;
      if (A.cull &&
          misses_tile(tab(A, 0, gj), tab(A, 1, gj), tab(A, 2, gj),
                      tab(A, 3, gj), tab(A, 4, gj), tab(A, 5, gj), tile,
                      A.tile_width, A.tile_height, A.tile_size)) {
        tile = A.n_tiles;
      }
      w[j] = (uint32_t)tile;
    }
    g[j] = win.g0 + l;
  }
  store_words(reinterpret_cast<uint32_t*>(A.tile_out), p, A.cap, A.vec, w);
  // the rows: the position (f32 or one u16 word), then the values (f32 or
  // bf16 pairs), then the id
  const int after_pos = A.geom_packed ? 1 : 2;
  for (int a = 0; a < A.n_attr;) {
    int orow;
    if (a < 2 && A.geom_packed) {
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        w[j] = ok[j] ? gsc::pack_u16_xy(tab(A, 0, g[j]), tab(A, 1, g[j]))
                     : 0u;
      }
      orow = 0;
      a = 2;
    } else if (a >= 2 && A.attr_packed) {
      const bool second = a + 1 < A.n_attr;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        w[j] = ok[j] ? gsc::pack_pair(tab(A, a, g[j]),
                                      second ? tab(A, a + 1, g[j]) : 0.0f)
                     : 0u;
      }
      orow = after_pos + (a - 2) / 2;
      a += 2;
    } else {
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        w[j] = ok[j] ? __float_as_uint(tab(A, a, g[j])) : 0u;
      }
      orow = a < 2 ? a : after_pos + (a - 2);
      a += 1;
    }
    store_words(A.rows_out + orow * A.cap, p, A.cap, A.vec, w);
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    w[j] = ok[j] ? __float_as_uint((float)g[j]) : 0u;
  }
  store_words(A.rows_out + A.n_srows * A.cap, p, A.cap, A.vec, w);
}

__global__ void expand_kernel(Args A) {
  extern __shared__ int smem[];
  __shared__ int s_g[2];
  const int64_t p0 = (int64_t)blockIdx.x * BR;
  const int64_t p = p0 + RPT * (int64_t)threadIdx.x;
  const int64_t n = *A.n_isects;
  if (p0 >= n) {  // the empty rows
    uint32_t key[RPT], zero[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      key[j] = (uint32_t)kInt32Max;
      zero[j] = 0u;
    }
    store_words(reinterpret_cast<uint32_t*>(A.tile_out), p, A.cap, A.vec,
                key);
    for (int r = 0; r <= A.n_srows; ++r) {
      store_words(A.rows_out + r * A.cap, p, A.cap, A.vec, zero);
    }
    return;
  }
  const int64_t pe = p0 + BR < n ? p0 + BR : n;  // rows [p0, pe) in range
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < 2) {
    const int g = warp_search(A.cum, A.M, warp == 0 ? p0 : pe - 1, lane);
    if (lane == 0) s_g[warp] = g;
  }
  __syncthreads();
  const int g0 = s_g[0];
  const int W = s_g[1] - g0 + 1;
  if (W <= BR) {
    int* s_cum = smem;  // [BR + 1]
    int* s_base = s_cum + BR + 1;
    int* s_nx = s_base + BR;
    for (int i = threadIdx.x; i <= W; i += THREADS) {
      const int g = g0 - 1 + i;
      s_cum[i] = g >= 0 ? A.cum[g] : 0;
      if (i < W) {
        s_base[i] = A.base[g0 + i];
        s_nx[i] = A.nx[g0 + i];
      }
    }
    __syncthreads();
    expand_rows(A, Window<true>{s_cum, s_base, s_nx, g0}, W, p, pe);
  } else {
    expand_rows(A, Window<false>{A.cum, A.base, A.nx, g0}, W, p, pe);
  }
}

}  // namespace

extern "C" int gsc_expand(const void* cum, int M, const void* base,
                          const void* nx, const void* table, int n_attr,
                          const void* n_isects, long long cap, int tile_width,
                          int tile_height, int tile_size, int n_tiles,
                          int cull, int geom_packed, int attr_packed,
                          void* tile_out, void* rows_out,
                          void* stream) {
  if (M < 1 || n_attr < (cull ? 6 : 1) || cap < 0 ||
      ((geom_packed || attr_packed) && n_attr < 6)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nval = n_attr - 2;
  const int n_srows = (geom_packed ? 1 : 2) +
                      (attr_packed ? (nval + 1) / 2 : nval);
  if (cap > 0) {
    const size_t smem = sizeof(int) * (3 * (size_t)BR + 1);
    Args A{static_cast<const int*>(cum),
           M,
           static_cast<const int*>(base),
           static_cast<const int*>(nx),
           static_cast<const float*>(table),
           n_attr,
           static_cast<const int*>(n_isects),
           (int64_t)cap,
           tile_width,
           tile_height,
           tile_size,
           n_tiles,
           cull,
           geom_packed,
           attr_packed,
           n_srows,
           static_cast<int*>(tile_out),
           static_cast<uint32_t*>(rows_out),
           cap % 4 == 0 && (uintptr_t)tile_out % 16 == 0 &&
               (uintptr_t)rows_out % 16 == 0};
    const int64_t blocks = (cap + BR - 1) / BR;
    expand_kernel<<<(unsigned)blocks, THREADS, smem,
                    (cudaStream_t)stream>>>(A);
  }
  return (int)cudaGetLastError();
}
