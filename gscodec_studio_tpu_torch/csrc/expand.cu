// Intersection expansion: the depth-sorted, compacted Gaussian table ->
// the fixed-capacity per-intersection list (tile key, attribute rows, id).
//
// Replaces gscodec_studio_tpu/ops/raster_v2.py:_expand_kernel / _run_expand.
// The TPU kernel found each output row's Gaussian with a one-hot MXU matmul
// made bit-exact by a 3-way bf16 split; here each thread binary-searches the
// inclusive intersection-count prefix for its row, which is exact by
// construction. Rank, dy, dx and the tile id are computed in float, as the
// TPU kernel does, and the conservative ellipse cull uses the same formula
// in the same order (the library is built with --fmad=false), so the list,
// order included, is the JAX package's: the tile sort that follows is stable.
// The cull reads the 3DGS conic layout (x, y, ca, cb, cc, op in rows 0-5);
// with cull = 0 (the 2DGS layout, the TPU kernel's `if cfg.cull:` branch)
// every in-range pair keeps its tile and the overflow tile stays empty.
//
//
// Packed branch (the 3DGS layout; replaces the `cfg.geom_packed` and
// `cfg.attr_packed` writes at raster_v2.py:520-541): with geom_packed the
// (x, y) rows become one u16 position word; with attr_packed the values
// after the position (ca, cb, cc, op, colors) become truncated-bf16 pairs
// (ca, cb), (cc, op), (c0, c1), ..., an odd last value paired with 0
// (tile_common.cuh). The cull reads the f32 table in both branches, so its
// decisions do not change; only the written rows are packed.
//
// Bound on the H100: bytes. Each output row reads one table column (the
// same column for the neighbouring rows of one Gaussian, so the reads are
// mostly broadcasts) and writes 1 + n_srows + 1 words (n_srows = n_attr in
// the f32 branch), coalesced across the warp. The search adds log2(M)
// dependent loads that hit L2 after the first warps. Design: one thread
// per output row; no shared memory, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

constexpr int kInt32Max = 2147483647;

// Whether 0.5*lambda_min(conic)*dist(mean, tile)^2 already exceeds
// ln(255*op) for Gaussian g: then its alpha can never reach 1/255 in the tile.
__device__ bool misses_tile(const float* __restrict__ table, int M, int g,
                            int tile, int tile_width, int tile_height,
                            int tile_size) {
  const float ts_f = (float)tile_size;
  const int rem = tile % (tile_width * tile_height);
  const float txt = (float)(rem % tile_width);
  const float tyt = (float)(rem / tile_width);
  const float xs = table[0 * (int64_t)M + g];
  const float ys = table[1 * (int64_t)M + g];
  const float ca = table[2 * (int64_t)M + g];
  const float cb = table[3 * (int64_t)M + g];
  const float cc = table[4 * (int64_t)M + g];
  const float op = table[5 * (int64_t)M + g];
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

__global__ void expand_kernel(const int* __restrict__ cum, int M,
                              const int* __restrict__ base,
                              const int* __restrict__ nx,
                              const float* __restrict__ table, int n_attr,
                              const int* __restrict__ n_isects_ptr, int64_t cap,
                              int tile_width, int tile_height, int tile_size,
                              int n_tiles, int cull, int geom_packed,
                              int attr_packed, int n_srows,
                              int* __restrict__ tile_out,
                              float* __restrict__ rows_out) {
  const int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (p >= cap) return;
  const int n_isects = *n_isects_ptr;
  if (p >= n_isects) {
    tile_out[p] = kInt32Max;
    for (int r = 0; r <= n_srows; ++r) rows_out[r * cap + p] = 0.0f;
    return;
  }
  // first g with cum[g] > p: the Gaussian whose run [cum[g-1], cum[g]) holds p
  int lo = 0, hi = M;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] > p) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const int g = lo;
  const int cum_e = g > 0 ? cum[g - 1] : 0;
  const float rank = (float)(p - cum_e);
  const float nxr = fmaxf((float)nx[g], 1.0f);
  const float dy = floorf(rank / nxr);
  const float dx = rank - dy * nxr;
  int tile = (int)((float)base[g] + dy * (float)tile_width + dx);
  if (cull && misses_tile(table, M, g, tile, tile_width, tile_height,
                          tile_size)) {
    tile = n_tiles;
  }

  tile_out[p] = tile;
  if (!geom_packed && !attr_packed) {
    for (int r = 0; r < n_attr; ++r) {
      rows_out[r * cap + p] = table[r * (int64_t)M + g];
    }
  } else {
    uint32_t* words = reinterpret_cast<uint32_t*>(rows_out);
    const float x = table[g];
    const float y = table[(int64_t)M + g];
    int r = 0;
    if (geom_packed) {
      words[p] = gsc::pack_u16_xy(x, y);
      r = 1;
    } else {
      rows_out[p] = x;
      rows_out[cap + p] = y;
      r = 2;
    }
    if (attr_packed) {
      for (int a = 2; a < n_attr; a += 2) {
        const float va = table[a * (int64_t)M + g];
        const float vb = a + 1 < n_attr ? table[(a + 1) * (int64_t)M + g]
                                        : 0.0f;
        words[r++ * cap + p] = gsc::pack_pair(va, vb);
      }
    } else {
      for (int a = 2; a < n_attr; ++a) {
        rows_out[r++ * cap + p] = table[a * (int64_t)M + g];
      }
    }
  }
  rows_out[n_srows * cap + p] = (float)g;
}

}  // namespace

extern "C" int gsc_expand(const void* cum, int M, const void* base,
                          const void* nx, const void* table, int n_attr,
                          const void* n_isects, long long cap, int tile_width,
                          int tile_height, int tile_size, int n_tiles,
                          int cull, int geom_packed, int attr_packed,
                          void* tile_out, void* rows_out, void* stream) {
  if (M < 1 || n_attr < (cull ? 6 : 1) || cap < 0 ||
      ((geom_packed || attr_packed) && n_attr < 6)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nval = n_attr - 2;
  const int n_srows = (geom_packed ? 1 : 2) +
                      (attr_packed ? (nval + 1) / 2 : nval);
  if (cap > 0) {
    const int threads = 256;
    const int64_t blocks = (cap + threads - 1) / threads;
    expand_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        static_cast<const int*>(cum), M, static_cast<const int*>(base),
        static_cast<const int*>(nx), static_cast<const float*>(table), n_attr,
        static_cast<const int*>(n_isects), (int64_t)cap, tile_width,
        tile_height, tile_size, n_tiles, cull, geom_packed, attr_packed,
        n_srows, static_cast<int*>(tile_out), static_cast<float*>(rows_out));
  }
  return (int)cudaGetLastError();
}
