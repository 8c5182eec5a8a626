// Tile forward: front-to-back alpha compositing of each tile's
// depth-ordered run of the sorted intersection table.
//
// Replaces gscodec_studio_tpu/ops/raster_v2.py:_fwd_kernel / _run_fwd.
// Semantics are the JAX package's, not gsplat's per-pixel `done` rule:
//   * a tile walks the absolute 128-aligned windows [c*128, (c+1)*128) of
//     the sorted list from c0 = off / 128; only rows in [off, end) count;
//   * pair: sigma from the conic, alpha = min(0.999, op * exp(-sigma)),
//     valid when sigma >= 0 and alpha >= 1/255;
//   * "exact" cutoff: within a chunk a pixel takes pairs until the first one
//     whose T_prev * (1 - alpha) <= 1e-4 and nothing more in that chunk; the
//     next chunk starts again from the T before that pair, so the tile loop
//     never ends early;
//   * "soft" cutoff: weights alpha * T_prev with no mask; the block stops at
//     a chunk boundary once every pixel of the tile has T <= 1e-4 (a
//     block-wide vote);
//   * a masked tile (or an empty run) writes colors 0 and alpha 0.
// Output per pixel: colors[CH] then alpha = 1 - T_final.
//
// Precision branches (replace the `cfg.attr_packed`, `cfg.geom_packed` and
// `cfg.log_composite` paths of _fwd_kernel: the readers _chunk_pair /
// _chunk_colors :766-813 and _composite_log :838-869, used at :931-939):
//   * geom_packed / attr_packed (runtime): the chunk is staged from the
//     packed rows of S (n_srows of them before the id) and unpacked into
//     the f32 layout in shared memory (tile_common.cuh), so the pair loop
//     is the f32 branch's; the f32 layout's staging is the plain copy;
//   * LOG (template): the transmittance scan in log space, two running sums
//     of the bf16 split of log1p(-alpha) per pixel (tile_common.cuh);
//     T_prev = T * exp(incl - l); the exact cutoff stops before the first
//     pair with T * exp(incl) <= 1e-4 and leaves the last passing
//     T * exp(incl); the soft cutoff ends the chunk at T * exp(s1 + s2).
//     (incl falls by at least |log1p(-1/255)| per valid pair, far above its
//     rounding, so the pairs that pass the exact test are a prefix, as the
//     JAX mask is.)
//
// Bound on the H100: operations. Each pixel evaluates sigma and alpha (~15
// float32 operations, one exp) for every pair of its run up to its cutoff,
// and composites (2*CH + 4 more) the pairs that pass the alpha test, while
// the table is read once per tile. The first design (one block per tile,
// one thread per pixel, a warp a 2 x 16 strip at tile 16 and a 1 x 32 row
// at tile 32) ran at ~12% of that bound: every pixel evaluated every pair
// of its tile's run, though ~23% of those (pair, pixel) slots pass the
// alpha test at the 1M scene; tile 32 made 1024-thread blocks, one or two
// an SM, whose wide-channel builds could not launch at all. This design,
// B2's (csrc/raster_bwd.cu) on the forward:
//   * one block per tile, PPT pixels a thread (2 at CH <= 32, 1 above,
//     where the accumulators acc[PPT][CHM] fill the registers, and 1 in the
//     dense build, below): a thread owns PPT neighbours of one tile row,
//     which share dy and the pair's shared-memory reads; a warp's pixels
//     form a cell 8 pixels wide (8 x 8 at PPT 2, 8 x 4 at 1), the cells
//     row-major, so tile 32 is a 512-thread block at PPT 2;
//   * B2's candidate region per pair (gsc::conic_region, csrc/regions.cuh),
//     formed in double precision as the chunk is staged, from the unpacked
//     f32 values the pair math reads: a warp whose cell misses the pair's
//     box skips the pair, with no sigma, exp or state; a pixel whose float
//     sigma exceeds the widened bound, or that is past its exact cutoff,
//     is no candidate, a thread with no candidate skips the exp, and one
//     with no pixel that passes the alpha test skips the rest. A pair
//     that fails the alpha test changes no state in either cutoff or
//     in LOG, so the results are the same, bit for bit: each pixel's pair
//     math and sums are the first design's expressions in its order;
//   * the chunk's pairs 32 at a time: each lane tests one pair's box
//     against the warp's cell, and the warp walks the pairs of the ballot
//     in order, so a missed pair costs a lane one test, not the warp a
//     serial one; a warp whose pixels are all past their exact cutoff
//     leaves the chunk;
//   * the thread's pixels side by side: the pair math is formed for each of
//     them without branches and a pixel's state is kept where it
//     composites the pair, so their dependency chains interleave (B2 ran
//     1.2x slower with a branch per pixel);
//   * in training the blocks take the tiles longest run first (the order
//     raster_v2.run_order makes for B1 and B2 together); a render with no
//     backward takes them in index order: on an H100 at the 1M scene the
//     order saves B1 alone 0.025-0.03 ms and its argsort costs 0.07-0.1;
//   * occupancy: the builds at PPT 2 are bounded by tile 32's 512 threads,
//     and at bounds 3 and 8 tile 16 gets one for 10 blocks an SM (below);
//     64 and 128 channels (1 pixel a thread) get a build for tiles of up to
//     256 threads beside the one for tile 32, whose 1024 threads leave 64
//     registers and spill (the first design did not launch there).
// The accumulators live in registers under a template bound on the
// channels (3, 8, 16, 32, 64 or 128), so CH <= 128; wider renders bin once
// per 128 channels (rendering.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "regions.cuh"
#include "tile_common.cuh"

namespace {

constexpr int K = gsc::kChunk;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;
constexpr int kRegion = gsc::kConicRegion;
constexpr int kMaxPixels = 1024;  // tile 32
constexpr unsigned kFull = 0xffffffffu;

// pixels a thread: 2 where the accumulators leave registers free
constexpr int ppt_for(int chm) { return chm <= 32 ? 2 : 1; }
// 64 and 128 channels: a build for tiles of up to 256 threads (tile 16)
constexpr int kWideThreads = 256;
constexpr bool wide(int chm) { return chm >= 64; }
// ``dense`` (B2's rule, raster_v2.bwd_dense: under 32 Gaussians a tile):
// at bounds 3 and 8 and tiles of up to 256 threads at 1 pixel a thread,
// the build with 1 pixel a thread, as B2's: on the checkpoint's views
// 0.74x the 2-pixel build's time, on the 1M scene 1.12x (PERF.md)
constexpr int kDenseThreads = 256;
constexpr bool tuned(int chm) { return chm <= 8; }
// at bounds 3 and 8, tiles of up to 128 threads (tile 16 at 2 pixels a
// thread) get a build for kSmallMinBlocks blocks an SM: 48 registers and a
// few spills; timed on the H100 at the 1M scene (PERF.md), 1 and 8 blocks
// ran ~3% slower, 12 within 1%
constexpr int kSmallThreads = 128;
constexpr int kSmallMinBlocks = 10;

struct FwdArgs {
  const float* S;  // [>= n_srows, cap] sorted attribute rows
  int64_t cap;
  const int* starts;  // [n_tiles + 2] first row of each tile's run
  const int* masks;  // [n_tiles] 0 disables a tile
  const int* order;  // [n_tiles] the tile each block takes; null: index order
  int tile_width, tile_height, tile_size, ch, geom_packed, attr_packed;
  float* out;  // [n_tiles, tile_size^2, ch + 1]
};

template <int CHM, int PPT, bool SOFT, bool LOG, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    raster_fwd_kernel(const FwdArgs a) {
  extern __shared__ float sm[];
  const int ch = a.ch;
  float* chunk = sm;  // [(6 + ch) * K]
  float* reg = chunk + (6 + ch) * K;  // [kRegion * K]

  const int t = a.order ? a.order[blockIdx.x] : blockIdx.x;
  const int ts = a.tile_size;
  const int P = ts * ts;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int off = a.starts[t];
  const int end = a.starts[t + 1];
  const int c0 = off / K;
  const int c1 = (end > off && a.masks[t] > 0) ? (end + K - 1) / K : c0;
  const int rem = t % (a.tile_width * a.tile_height);
  const int x0 = (rem % a.tile_width) * ts;
  const int y0 = (rem / a.tile_width) * ts;

  // the thread's pixels: PPT neighbours of tile row prow; a warp's, a
  // cell 8 pixels wide and RC rows tall, the cells row-major
  constexpr int CT = 8 / PPT;  // threads a cell row
  constexpr int RC = 32 / CT;  // rows a cell
  const int cells_x = (ts + 7) / 8;
  const int cx = warp % cells_x, cy = warp / cells_x;
  const int prow = cy * RC + lane / CT;
  const int pcol = cx * 8 + (lane % CT) * PPT;
  const float py = (float)(y0 + prow) + 0.5f;
  // the cell's pixel centres, for the warp's test against a pair's box
  const float cell_x0 = (float)(x0 + cx * 8) + 0.5f;
  const float cell_x1 = (float)(x0 + min(cx * 8 + 7, ts - 1)) + 0.5f;
  const float cell_y0 = (float)(y0 + cy * RC) + 0.5f;
  const float cell_y1 = (float)(y0 + min(cy * RC + RC - 1, ts - 1)) + 0.5f;

  float acc[PPT][CHM];
  float T[PPT], px[PPT];
  bool pix[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    pix[i] = prow < ts && pcol + i < ts;
    px[i] = (float)(x0 + pcol + i) + 0.5f;
    T[i] = pix[i] ? 1.0f : 0.0f;
#pragma unroll
    for (int j = 0; j < CHM; ++j) acc[i][j] = 0.0f;
  }

  for (int c = c0; c < c1; ++c) {
    if (SOFT) {
      bool busy = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) busy |= T[i] > kTransmittanceEps;
      if (!__syncthreads_or(busy)) break;
    } else {
      __syncthreads();
    }
    const int64_t col0 = (int64_t)c * K;
    const int lo = max(off - c * K, 0);
    const int hi = min(end - c * K, K);
    gsc::stage_chunk_3dgs(chunk, a.S, a.cap, col0, ch, a.geom_packed,
                          a.attr_packed, tid, blockDim.x);
    for (int k = lo + tid; k < hi; k += blockDim.x) {
      float g[6];
      gsc::load_geometry(a.S, a.cap, a.geom_packed, a.attr_packed, col0 + k,
                         g);
      gsc::conic_region(g, reg, k);
    }
    __syncthreads();
    // LOG: tp is the last passing T * exp(incl) (exact cutoff), s1 and s2
    // the chunk's running sums; exact: a pixel takes pairs until its cutoff
    float tp[PPT], s1[PPT], s2[PPT];
    bool live[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      tp[i] = T[i];
      s1[i] = 0.0f;
      s2[i] = 0.0f;
      live[i] = pix[i];
    }
    // the chunk's pairs 32 at a time: lane l tests pair kb + l's box
    // against the warp's cell, and the warp walks the pairs that meet it in
    // order; a warp none of whose pixels is still live (exact cutoff) is
    // done with the chunk
    for (int kb = lo & ~31; kb < hi; kb += 32) {
      bool live_any = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) live_any |= live[i];
      if (!__any_sync(kFull, live_any)) break;
      const int kl = kb + lane;
      const bool meets =
          kl >= lo && kl < hi &&
          gsc::cell_meets_box(chunk[kl], chunk[K + kl], reg[kl], reg[K + kl],
                              cell_x0, cell_x1, cell_y0, cell_y1);
      unsigned pending = __ballot_sync(kFull, meets);
      while (pending != 0u) {
        const int k = kb + __ffs(pending) - 1;
        pending &= pending - 1u;
        const float x = chunk[k], y = chunk[K + k];
        const float lm = reg[2 * K + k];
        const float ca = chunk[2 * K + k];
        const float cb = chunk[3 * K + k];
        const float cc = chunk[4 * K + k];
        const float dy = y - py;
        float sigma[PPT];
        bool cand[PPT];
        bool any = false;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const float dx = x - px[i];
          sigma[i] = (0.5f * ca) * (dx * dx) + (0.5f * cc) * (dy * dy) +
                     cb * (dx * dy);
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
          float t_prev, t_incl;
          if (LOG) {  // gsc::log_scan_step, kept where valid
            const float l = log1pf(-alpha[i]);
            const float l1 = __bfloat162float(__float2bfloat16_rn(l));
            const float l2 = __bfloat162float(__float2bfloat16_rn(l - l1));
            const float s1n = s1[i] + l1;
            const float s2n = s2[i] + l2;
            s1[i] = valid[i] ? s1n : s1[i];
            s2[i] = valid[i] ? s2n : s2[i];
            const float incl = s1n + s2n;
            t_prev = T[i] * expf(incl - l);
            t_incl = SOFT ? 0.0f : T[i] * expf(incl);
          } else {
            t_prev = tp[i];
            t_incl = tp[i] * (1.0f - alpha[i]);
          }
          const bool cut = !SOFT && !(t_incl > kTransmittanceEps);
          live[i] = live[i] && !(valid[i] && cut);
          h[i] = valid[i] && !cut;
          w[i] = alpha[i] * t_prev;
          const float tpn = LOG ? fminf(tp[i], t_incl) : t_incl;
          tp[i] = h[i] ? tpn : tp[i];
        }
        if constexpr (PPT == 1) {
          // in a branch: predicated, the 64 and 128 channels' loop ran
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
    for (int i = 0; i < PPT; ++i) {
      T[i] = (LOG && SOFT) ? T[i] * expf(s1[i] + s2[i]) : tp[i];
    }
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (!pix[i]) continue;
    const int p = prow * ts + pcol + i;
    float* o = a.out + ((int64_t)t * P + p) * (ch + 1);
#pragma unroll
    for (int j = 0; j < CHM; ++j) {
      if (j < ch) o[j] = acc[i][j];
    }
    o[ch] = 1.0f - T[i];
  }
}

template <int CHM, int PPT, int MAXT, int MINB>
cudaError_t launch_as(const FwdArgs& a, bool soft, bool log, int n_tiles,
                      int threads, cudaStream_t stream) {
  const size_t smem = (size_t)(6 + a.ch + kRegion) * K * sizeof(float);
  auto kernel =
      log ? (soft ? raster_fwd_kernel<CHM, PPT, true, true, MAXT, MINB>
                  : raster_fwd_kernel<CHM, PPT, false, true, MAXT, MINB>)
          : (soft ? raster_fwd_kernel<CHM, PPT, true, false, MAXT, MINB>
                  : raster_fwd_kernel<CHM, PPT, false, false, MAXT, MINB>);
  // above 48 KB (CH > 87) only as opted-in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The threads that cover a tile at PPT pixels a thread.
template <int PPT>
int tile_threads(int ts) {
  constexpr int RC = 32 / (8 / PPT);  // rows a cell
  return ((ts + 7) / 8) * ((ts + RC - 1) / RC) * 32;
}

template <int CHM>
cudaError_t launch(const FwdArgs& a, bool soft, bool log, int n_tiles,
                   bool dense, cudaStream_t stream) {
  constexpr int PPT = ppt_for(CHM);
  const int ts = a.tile_size;
  const int threads = tile_threads<PPT>(ts);
  if constexpr (tuned(CHM)) {
    if (dense && tile_threads<1>(ts) <= kDenseThreads) {
      return launch_as<CHM, 1, kDenseThreads, 1>(a, soft, log, n_tiles,
                                                 tile_threads<1>(ts), stream);
    }
  }
  if constexpr (tuned(CHM)) {
    if (threads <= kSmallThreads) {
      return launch_as<CHM, PPT, kSmallThreads, kSmallMinBlocks>(
          a, soft, log, n_tiles, threads, stream);
    }
  }
  if constexpr (wide(CHM)) {
    if (threads <= kWideThreads) {
      return launch_as<CHM, PPT, kWideThreads, 1>(a, soft, log, n_tiles,
                                                  threads, stream);
    }
  }
  return launch_as<CHM, PPT, kMaxPixels / PPT, 1>(a, soft, log, n_tiles,
                                                  threads, stream);
}

}  // namespace

extern "C" int gsc_raster_fwd(const void* S, long long cap, const void* starts,
                              const void* masks, const void* order,
                              int n_tiles, int tile_width, int tile_height,
                              int tile_size, int ch, int soft,
                              int log_composite, int geom_packed,
                              int attr_packed, int dense, void* out,
                              void* stream) {
  const int P = tile_size * tile_size;
  if (ch < 1 || ch > 128 || P < 1 || P > kMaxPixels || n_tiles < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return (int)cudaGetLastError();
  const FwdArgs a{static_cast<const float*>(S), (int64_t)cap,
                  static_cast<const int*>(starts),
                  static_cast<const int*>(masks),
                  static_cast<const int*>(order), tile_width, tile_height,
                  tile_size, ch, geom_packed ? 1 : 0, attr_packed ? 1 : 0,
                  static_cast<float*>(out)};
  cudaStream_t st = (cudaStream_t)stream;
  const bool sf = soft != 0;
  const bool lg = log_composite != 0;
  const bool dn = dense != 0;
  if (ch <= 3) return (int)launch<3>(a, sf, lg, n_tiles, dn, st);
  if (ch <= 8) return (int)launch<8>(a, sf, lg, n_tiles, dn, st);
  if (ch <= 16) return (int)launch<16>(a, sf, lg, n_tiles, dn, st);
  if (ch <= 32) return (int)launch<32>(a, sf, lg, n_tiles, dn, st);
  if (ch <= 64) return (int)launch<64>(a, sf, lg, n_tiles, dn, st);
  return (int)launch<128>(a, sf, lg, n_tiles, dn, st);
}
