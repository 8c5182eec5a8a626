// B7: the legacy v1 tile forward (rasterizer="pallas"): front-to-back
// alpha compositing of each tile's run of the chunk-aligned intersection
// table.
//
// Replaces gscodec_studio_tpu/ops/rasterize_pallas.py:_fwd_kernel /
// _run_fwd (:214-278), with the pair math of _chunk_geometry (:165) and
// _composite_weights (:188). The TPU kernel's grid walks every 128-row
// chunk of the table in order and carries a tile's transmittance in
// scratch from one chunk to the next; here one block owns one tile and
// walks its chunks itself. Semantics kept:
//   * tile t's run is rows [starts[t], ends[t]) of the aligned table
//     packed [cap2, 6 + ch] (x, y, conic a, b, c, opacity, colours), padded
//     to whole chunks from starts[t]; the padding rows have alpha 0;
//   * pair: sigma = 0.5 * (a dx^2 + c dy^2) + b dx dy, alpha =
//     min(0.999, op * exp(-sigma)), valid when sigma >= 0 and
//     alpha >= 1/255; pixel centres at + 0.5;
//   * the stop is per chunk and per tile: before each chunk the block
//     votes whether any of its P pixels (those past the image's edge too)
//     still has T > 1e-4, and stops if none has;
//   * "exact": within a chunk a pixel takes pairs while T * (1 - alpha)
//     > 1e-4 and stops at the first valid pair that fails; the next chunk
//     starts again from the T it reached. "soft": every valid pair of a
//     live chunk composites;
//   * an empty run gives colours 0 and alpha 0.
// Outputs: colors [n_tiles, ch, P], alphas [n_tiles, P] = 1 - T.
//
// Bound on the H100: operations. Each pixel evaluates sigma and alpha
// (~17 float32 operations, one exp) for every pair of its tile's live
// chunks up to its cutoff, and composites (2*ch + 1 more) the pairs that
// pass, while the table is read once per tile. The first design (one
// block per tile, one thread per pixel, 1024-thread blocks at tile 32)
// ran at ~20% of that bound: every pixel evaluated every pair of its
// tile's live chunks, though only 14% of those (pair, pixel) slots pass
// the alpha test at the 1M scene (the v1 binning's scalar radius gives a
// disc, looser than the conic's box). This design is B1's
// (csrc/raster_fwd.cu) on the v1 table (csrc/raster_v1.cuh):
//   * one block per tile, PPT pixels a thread (2 at ch <= 32, 1 above): a
//     thread owns PPT neighbours of one tile row, which share dy and the
//     pair's shared-memory reads; a warp's pixels a cell 8 pixels wide
//     (8 x 8 at PPT 2, 8 x 4 at 1), so tile 32 is a 512-thread block at
//     PPT 2;
//   * B1's candidate region per pair (gsc::conic_region,
//     csrc/regions.cuh), formed in double precision as the chunk is
//     staged, from the f32 values the pair math reads: a warp whose cell
//     misses the pair's box skips the pair; a pixel whose float sigma
//     exceeds the widened bound, or that is past its exact cutoff, is no
//     candidate; a thread with no candidate skips the exp, and one with no
//     pixel that passes the alpha test the rest. A pair that fails the
//     alpha test changes no state in either cutoff, so the results are
//     the same: each pixel's pair math and sums are the first design's
//     expressions in its order;
//   * the chunk's pairs 32 at a time: each lane tests one pair's box
//     against the warp's cell, and the warp walks the pairs of the ballot
//     in order; a warp whose pixels are all past their exact cutoff
//     leaves the chunk;
//   * the thread's pixels side by side, without branches, and a branch,
//     not predication, around a 1-pixel thread's colour loop (B1's);
//   * ``order`` (or null: index order) is the tile each block takes: in
//     training the longest run first (rasterize_pallas.run_order);
//   * occupancy: at bounds 3 and 8, tiles of up to 128 threads (tile 16
//     at PPT 2) get B1's build for 10 blocks an SM (48 registers and 20
//     bytes of spills; for 8, 63 registers and none, it ran 2% slower on
//     the H100 at the 1M scene); 64 and 128 channels (1
//     pixel a thread) a build for tiles of up to 256 threads beside the
//     one for tile 32 (1024 threads, 64 registers); the others are bounded
//     by tile 32's 512 threads.
// The colour sums live in registers under a template bound on the
// channels (3, 8, 16, 32, 64 or 128), so ch <= 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_v1.cuh"

namespace {

using gsc::v1::Cell;
using gsc::v1::K;
using gsc::v1::kAlphaThreshold;
using gsc::v1::kFull;
using gsc::v1::kMaxAlpha;
using gsc::v1::kMaxPixels;
using gsc::v1::kTransmittanceEps;
using gsc::v1::ppt_for;
using gsc::v1::stage_chunk;
using gsc::v1::tile_threads;
constexpr int kRegion = gsc::kConicRegion;
constexpr int kSmallThreads = 128;
constexpr int kSmallMinBlocks = 10;
constexpr int kWideThreads = 256;
constexpr bool tuned(int chm) { return chm <= 8; }
constexpr bool wide(int chm) { return chm >= 64; }

struct FwdArgs {
  const float* packed;  // [cap2, 6 + ch]
  const int* starts;  // [n_tiles] aligned start of each run
  const int* ends;  // [n_tiles] true end of each run
  const int* order;  // [n_tiles] the tile each block takes; null: index
  int tile_width, tile_height, tile_size, ch;
  float* colors;  // [n_tiles, ch, P]
  float* alphas;  // [n_tiles, P]
};

template <int CHM, int PPT, bool SOFT, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    raster_v1_fwd_kernel(const FwdArgs a) {
  extern __shared__ float sm[];
  const int ch = a.ch;
  const int d = 6 + ch;
  float* chunk = sm;  // [d * K], column-major
  float* reg = chunk + d * K;  // [kRegion * K]

  const int t = a.order ? a.order[blockIdx.x] : blockIdx.x;
  const int ts = a.tile_size;
  const int P = ts * ts;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int start = a.starts[t];
  const int end = a.ends[t];
  const int n_chunks = end > start ? (end - start + K - 1) / K : 0;
  const Cell<PPT> cell(t, a.tile_width, a.tile_height, ts, tid >> 5, lane);

  float acc[PPT][CHM];
  float T[PPT], px[PPT];
  bool pix[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    pix[i] = cell.in_tile(i, ts);
    px[i] = cell.px(i);
    T[i] = pix[i] ? 1.0f : 0.0f;
#pragma unroll
    for (int j = 0; j < CHM; ++j) acc[i][j] = 0.0f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    // the tile's stop vote; also the barrier before the chunk is restaged
    bool busy = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) busy |= T[i] > kTransmittanceEps;
    if (!__syncthreads_or(busy)) break;
    const int row0 = start + c * K;
    const int hi = min(end - row0, K);  // rows past it are padding
    stage_chunk(chunk, reg, a.packed + (int64_t)row0 * d, d, hi, tid,
                blockDim.x);
    __syncthreads();
    // exact: a pixel takes pairs until its cutoff
    float tp[PPT];
    bool live[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      tp[i] = T[i];
      live[i] = pix[i];
    }
    // the chunk's pairs 32 at a time: lane l tests pair kb + l's box
    // against the warp's cell, and the warp walks the pairs that meet it in
    // order; a warp none of whose pixels is still live (exact cutoff) is
    // done with the chunk
    for (int kb = 0; kb < hi; kb += 32) {
      bool live_any = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) live_any |= live[i];
      if (!__any_sync(kFull, live_any)) break;
      const int kl = kb + lane;
      const bool meets =
          kl < hi && gsc::cell_meets_box(chunk[kl], chunk[K + kl], reg[kl],
                                         reg[K + kl], cell.x0, cell.x1,
                                         cell.y0, cell.y1);
      unsigned pending = __ballot_sync(kFull, meets);
      while (pending != 0u) {
        const int k = kb + __ffs(pending) - 1;
        pending &= pending - 1u;
        const float x = chunk[k], y = chunk[K + k];
        const float lm = reg[2 * K + k];
        const float ca = chunk[2 * K + k];
        const float cb = chunk[3 * K + k];
        const float cc = chunk[4 * K + k];
        const float dy = y - cell.py;
        float sigma[PPT];
        bool cand[PPT];
        bool any = false;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const float dx = x - px[i];
          sigma[i] = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
          cand[i] = live[i] && sigma[i] <= lm;
          any |= cand[i];
        }
        if (!any) continue;
        const float op = chunk[5 * K + k];
        // the pixels side by side, without branches: every value is formed
        // for each pixel and kept where the pixel composites the pair; a
        // thread none of whose pixels passes the alpha test is done
        float alpha[PPT];
        bool valid[PPT];
        bool any_valid = false;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          alpha[i] = fminf(kMaxAlpha, op * expf(-sigma[i]));
          valid[i] =
              cand[i] && sigma[i] >= 0.0f && alpha[i] >= kAlphaThreshold;
          any_valid |= valid[i];
        }
        if (!any_valid) continue;
        float w[PPT];
        bool h[PPT];
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const float t_incl = tp[i] * (1.0f - alpha[i]);
          const bool cut = !SOFT && !(t_incl > kTransmittanceEps);
          live[i] = live[i] && !(valid[i] && cut);
          h[i] = valid[i] && !cut;
          w[i] = alpha[i] * tp[i];
          tp[i] = h[i] ? t_incl : tp[i];
        }
        if constexpr (PPT == 1) {
          // in a branch: predicated, B1's 64 and 128 channels' loop ran
          // 1.7x slower
          if (h[0]) {
#pragma unroll
            for (int j = 0; j < CHM; ++j) {
              if (j < ch) acc[0][j] += w[0] * chunk[(6 + j) * K + k];
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < CHM; ++j) {
            if (j < ch) {
              const float cj = chunk[(6 + j) * K + k];
#pragma unroll
              for (int i = 0; i < PPT; ++i) {
                if (h[i]) acc[i][j] += w[i] * cj;
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) T[i] = tp[i];
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (!pix[i]) continue;
    const int p = cell.prow * ts + cell.pcol + i;
#pragma unroll
    for (int j = 0; j < CHM; ++j) {
      if (j < ch) a.colors[((int64_t)t * ch + j) * P + p] = acc[i][j];
    }
    a.alphas[(int64_t)t * P + p] = 1.0f - T[i];
  }
}

template <int CHM, int PPT, int MAXT, int MINB>
cudaError_t launch_as(const FwdArgs& a, bool soft, int n_tiles, int threads,
                      cudaStream_t stream) {
  const size_t smem = (size_t)(6 + a.ch + kRegion) * K * sizeof(float);
  auto kernel = soft ? raster_v1_fwd_kernel<CHM, PPT, true, MAXT, MINB>
                     : raster_v1_fwd_kernel<CHM, PPT, false, MAXT, MINB>;
  // above 48 KB (ch > 87) only as opted-in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int CHM>
cudaError_t launch(const FwdArgs& a, bool soft, int n_tiles,
                   cudaStream_t stream) {
  constexpr int PPT = ppt_for(CHM);
  const int threads = tile_threads<PPT>(a.tile_size);
  if constexpr (tuned(CHM)) {
    if (threads <= kSmallThreads) {
      return launch_as<CHM, PPT, kSmallThreads, kSmallMinBlocks>(
          a, soft, n_tiles, threads, stream);
    }
  }
  if constexpr (wide(CHM)) {
    if (threads <= kWideThreads) {
      return launch_as<CHM, PPT, kWideThreads, 1>(a, soft, n_tiles, threads,
                                                  stream);
    }
  }
  return launch_as<CHM, PPT, kMaxPixels / PPT, 1>(a, soft, n_tiles, threads,
                                                  stream);
}

}  // namespace

extern "C" int gsc_raster_v1_fwd(const void* packed, const void* starts,
                                 const void* ends, const void* order,
                                 int n_tiles, int tile_width,
                                 int tile_height, int tile_size, int ch,
                                 int soft, void* colors, void* alphas,
                                 void* stream) {
  const int P = tile_size * tile_size;
  if (ch < 1 || ch > 128 || P < 1 || P > kMaxPixels || n_tiles < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return (int)cudaGetLastError();
  const FwdArgs a{static_cast<const float*>(packed),
                  static_cast<const int*>(starts),
                  static_cast<const int*>(ends),
                  static_cast<const int*>(order),
                  tile_width,
                  tile_height,
                  tile_size,
                  ch,
                  static_cast<float*>(colors),
                  static_cast<float*>(alphas)};
  cudaStream_t st = (cudaStream_t)stream;
  const bool sf = soft != 0;
  if (ch <= 3) return (int)launch<3>(a, sf, n_tiles, st);
  if (ch <= 8) return (int)launch<8>(a, sf, n_tiles, st);
  if (ch <= 16) return (int)launch<16>(a, sf, n_tiles, st);
  if (ch <= 32) return (int)launch<32>(a, sf, n_tiles, st);
  if (ch <= 64) return (int)launch<64>(a, sf, n_tiles, st);
  return (int)launch<128>(a, sf, n_tiles, st);
}
