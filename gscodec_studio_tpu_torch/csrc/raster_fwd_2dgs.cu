// 2DGS tile forward: front-to-back compositing of each tile's depth-ordered
// run of ray-surfel pairs, with the distortion accumulator and the median
// depth beside the colours.
//
// Replaces gscodec_studio_tpu/ops/raster_v2_2dgs.py:_fwd_kernel_2dgs /
// _run_fwd_2dgs. Semantics are the JAX package's, pair for pair:
//   * the walk is B1's (csrc/raster_fwd.cu): the absolute 128-row windows
//     of the sorted list from off / 128, rows in [off, end), the exact or
//     soft cutoff;
//   * pair: h_u = px*M_2 - M_0, h_v = py*M_2 - M_1, (cx, cy, cz) =
//     h_u x h_v; invalid when cz == 0; (su, sv) = (cx, cy) / cz;
//     sigma = 0.5 * min(su^2 + sv^2, 2 * |mean - pixel|^2);
//     alpha = min(0.999, op * exp(-sigma)), valid when alpha >= 1/255;
//   * per pixel: T, the CB channel sums, A = sum of w*z over the pairs so
//     far, the distortion sum of 2*(w*z*(1 - T_prev) - w*A) and the median,
//     the depth of the last composited pair with T_prev > 0.5. The JAX
//     kernel forms A inside a chunk by a lane cumsum; here it is a running
//     add, so the two differ in rounding, not in meaning.
// Output per pixel: colors[CB] (user channels with the depth at zch, then
// three normal channels), alpha = 1 - T_final, distortion, median.
//
// LOG (template; replaces the `cfg.log_composite` path at
// raster_v2_2dgs.py:184): the transmittance scan in log space, as B1's
// (csrc/tile_common.cuh): T_prev = T * exp(incl - l) feeds the weight, the
// distortion's (1 - T_prev) and the median's T_prev > 0.5; the exact cutoff
// tests T * exp(incl) > 1e-4; the soft cutoff ends the chunk at
// T * exp(s1 + s2).
//
// Bound on the H100: operations. Each pixel evaluates the cross-product
// pair math (~35 float32 operations, one division, one exp) for every pair
// of its run up to its cutoff, and composites (2*CB + 12 more) the pairs
// that pass the alpha test, while the table is read once per tile. The
// first design (one block per tile, one thread per pixel, a warp a strip
// of one or two tile rows) ran at ~20% of that bound: every pixel formed
// the pair math of every pair of its tile's run, though ~8% of those
// (pair, pixel) slots composite at the 1M scene, and tile 32 needed a
// 1024-thread copy capped at 64 registers, which spilled. This design,
// B6's (csrc/raster_bwd_2dgs.cuh) on the forward:
//   * one block per tile, PPT pixels a thread (2 at CB <= 32, 1 above,
//     where the accumulators acc[PPT][CBM] fill the registers): a thread
//     owns PPT neighbours of one tile row, so h_v, which depends on the row
//     alone, is formed once a pair, and the pair's staged rows are read
//     from shared memory once for all its pixels; a warp's pixels form a
//     cell 8 pixels wide (8 x 8 at PPT 2, 8 x 4 at 1), which a surfel's
//     round footprint meets in fewer warps than a row, and tile 32 is a
//     512-thread block at PPT 2;
//   * B6's candidate region per pair (gsc::surfel_region,
//     csrc/regions.cuh), formed once a chunk in double precision: a pixel
//     outside it, or past its exact cutoff, is no candidate, a thread none
//     of whose pixels is a candidate skips the pair math, and one with no
//     pixel that passes the alpha test skips the rest. A pair that fails
//     the alpha test changes no state (T, the sums, A, distortion,
//     median), so the results are the same, bit for bit: each pixel's pair
//     math and sums are the first design's expressions in its order;
//   * the region's box (the ellipse's and the disk's) against each warp's
//     cell, 32 pairs at a time: each lane tests one pair, and the warp
//     walks the pairs of the ballot in order; a warp whose pixels are all
//     past their exact cutoff leaves the chunk;
//   * the thread's pixels side by side, without branches: every value is
//     formed for each pixel and kept where the pixel composites the pair;
//   * occupancy: the builds at PPT 2 are bounded by tile 32's 512 threads,
//     and at bounds 4 and 8 tile 16 gets one for 8 blocks an SM (below);
//     64 and 128 channels get a build for tiles of up to 256 threads beside
//     the one for tile 32 (1024 threads, 64 registers, spills).
// Accumulators live in registers under a template bound on CB (4, 8, 16,
// 32, 64 or 128).

#include <cuda_runtime.h>
#include <stdint.h>

#include "regions.cuh"
#include "tile_common.cuh"

namespace {

constexpr int K = gsc::kChunk;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;
constexpr float kFilterInvSquare = 2.0f;
// attribute rows: x, y, m00..m22, op, colors[CB]
constexpr int kAM = gsc::kSurfelM;
constexpr int kAOP = gsc::kSurfelOp;
constexpr int kACOL = 12;
constexpr int kRegion = gsc::kSurfelRegion + gsc::kSurfelBox;
constexpr int kMaxPixels = 1024;  // tile 32
constexpr unsigned kFull = 0xffffffffu;

// pixels a thread: 2 where the accumulators leave registers free
constexpr int ppt_for(int cbm) { return cbm <= 32 ? 2 : 1; }
// 64 and 128 channels: a build for tiles of up to 256 threads (tile 16)
constexpr int kWideThreads = 256;
constexpr bool wide(int cbm) { return cbm >= 64; }
// at bounds 4 and 8, tiles of up to 128 threads (tile 16 at 2 pixels a
// thread) get a build for kSmallMinBlocks blocks an SM: 64 registers and
// ~300 B of spills, against 118 registers unbounded; timed on the H100 at
// the 1M scene (PERF.md), 1, 4, 6 and 10 blocks ran 5-28% slower, and a
// branch per pixel around the pair math 5% slower
constexpr int kSmallThreads = 128;
constexpr int kSmallMinBlocks = 8;
constexpr bool tuned(int cbm) { return cbm <= 8; }

struct Fwd2Args {
  const float* S;  // [>= 12 + cb, cap] sorted attribute rows
  int64_t cap;
  const int* starts;  // [n_tiles + 2] first row of each tile's run
  const int* masks;  // [n_tiles] 0 disables a tile
  const int* order;  // [n_tiles] the tile each block takes; null: index order
  int tile_width, tile_height, tile_size, cb, zch;
  float* out;  // [n_tiles, tile_size^2, cb + 3]
};

template <int CBM, int PPT, bool SOFT, bool LOG, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    raster_fwd_2dgs_kernel(const Fwd2Args a) {
  extern __shared__ float sm[];
  const int cb = a.cb;
  const int nrows = kACOL + cb;
  float* chunk = sm;  // [(12 + cb) * K]
  float* reg = chunk + nrows * K;  // [kSurfelRegion * K]
  float* box = reg + gsc::kSurfelRegion * K;  // [kSurfelBox * K]
  const float* zs = chunk + (kACOL + a.zch) * K;

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
  // cell 8 pixels wide (8 x 8 at PPT 2, 8 x 4 at 1), the cells row-major
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

  float acc[PPT][CBM];
  float T[PPT], A[PPT], dist[PPT], med[PPT], px[PPT];
  bool pix[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    pix[i] = prow < ts && pcol + i < ts;
    px[i] = (float)(x0 + pcol + i) + 0.5f;
    T[i] = pix[i] ? 1.0f : 0.0f;
    A[i] = 0.0f;
    dist[i] = 0.0f;
    med[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < CBM; ++j) acc[i][j] = 0.0f;
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
    for (int i = tid; i < nrows * K; i += blockDim.x) {
      chunk[i] = a.S[(i / K) * a.cap + col0 + (i % K)];
    }
    __syncthreads();
    const int lo = max(off - c * K, 0);
    const int hi = min(end - c * K, K);
    for (int k = lo + tid; k < hi; k += blockDim.x) {
      gsc::surfel_region(chunk, k, reg);
      gsc::surfel_box(chunk, reg, k, box);
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
      const bool meets = kl >= lo && kl < hi &&
                         gsc::cell_meets_surfel_box(box, kl, cell_x0, cell_x1,
                                                    cell_y0, cell_y1);
      unsigned pending = __ballot_sync(kFull, meets);
      while (pending != 0u) {
        const int k = kb + __ffs(pending) - 1;
        pending &= pending - 1u;
        // the candidate test (B6's): a pixel outside the pair's region
        // cannot pass the alpha test
        const float mx = chunk[k], my = chunk[K + k];
        const float ecx = reg[k], ecy = reg[K + k];
        const float qa = reg[2 * K + k], qb = reg[3 * K + k];
        const float qc = reg[4 * K + k], bound = reg[5 * K + k];
        const float r2 = reg[6 * K + k];
        const float ey = py - ecy;
        const float dy = my - py;
        bool cand[PPT];
        bool any = false;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const float ex = px[i] - ecx;
          const float dx = mx - px[i];
          const float qv = qa * ex * ex + 2.0f * qb * ex * ey + qc * ey * ey;
          cand[i] = live[i] && (qv <= bound || dx * dx + dy * dy <= r2);
          any |= cand[i];
        }
        if (!any) continue;
        // the pair's staged rows, read once for the thread's pixels
        const float* m = chunk + kAM * K + k;  // M[i] at m[i * K]
        const float m0 = m[0], m1 = m[K], m2 = m[2 * K], m3 = m[3 * K];
        const float m4 = m[4 * K], m5 = m[5 * K], m6 = m[6 * K];
        const float m7 = m[7 * K], m8 = m[8 * K];
        const float op = chunk[kAOP * K + k];
        const float z = zs[k];
        // h_v depends on the pixel row alone
        const float hv_x = py * m6 - m3;
        const float hv_y = py * m7 - m4;
        const float hv_z = py * m8 - m5;
        // each candidate pixel's alpha; a thread none of whose pixels
        // passes the alpha test is done with the pair
        float alpha[PPT];
        bool valid[PPT];
        bool any_valid = false;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const float hu_x = px[i] * m6 - m0;
          const float hu_y = px[i] * m7 - m1;
          const float hu_z = px[i] * m8 - m2;
          const float cz = hu_x * hv_y - hu_y * hv_x;
          const float cx = hu_y * hv_z - hu_z * hv_y;
          const float cy = hu_z * hv_x - hu_x * hv_z;
          const float inv_cz = 1.0f / (cz != 0.0f ? cz : 1.0f);
          const float su = cx * inv_cz;
          const float sv = cy * inv_cz;
          const float gw3d = su * su + sv * sv;
          const float dx = mx - px[i];
          const float gw2d = kFilterInvSquare * (dx * dx + dy * dy);
          const float sigma = 0.5f * fminf(gw3d, gw2d);
          alpha[i] = fminf(kMaxAlpha, op * expf(-sigma));
          valid[i] = cand[i] && cz != 0.0f && alpha[i] >= kAlphaThreshold;
          any_valid |= valid[i];
        }
        if (!any_valid) continue;
        float w[PPT];
        bool h[PPT];
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          float t_prev, t_test;
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
            t_test = SOFT ? 0.0f : T[i] * expf(incl);
          } else {
            t_prev = tp[i];
            t_test = tp[i] * (1.0f - alpha[i]);
          }
          const bool cut = !SOFT && !(t_test > kTransmittanceEps);
          live[i] = live[i] && !(valid[i] && cut);
          h[i] = valid[i] && !cut;
          w[i] = alpha[i] * t_prev;
          const float wz = w[i] * z;
          const float dn =
              dist[i] + 2.0f * (wz * (1.0f - t_prev) - w[i] * A[i]);
          dist[i] = h[i] ? dn : dist[i];
          A[i] = h[i] ? A[i] + wz : A[i];
          med[i] = h[i] && t_prev > 0.5f ? z : med[i];
          const float tpn = LOG ? fminf(tp[i], t_test) : t_test;
          tp[i] = h[i] ? tpn : tp[i];
        }
        if constexpr (PPT == 1) {
          if (h[0]) {  // in a branch, as B1's
#pragma unroll
            for (int j = 0; j < CBM; ++j) {
              if (j < cb) acc[0][j] += w[0] * chunk[(kACOL + j) * K + k];
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < CBM; ++j) {
            if (j < cb) {
              const float cj = chunk[(kACOL + j) * K + k];
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
    float* o = a.out + ((int64_t)t * P + p) * (cb + 3);
#pragma unroll
    for (int j = 0; j < CBM; ++j) {
      if (j < cb) o[j] = acc[i][j];
    }
    o[cb] = 1.0f - T[i];
    o[cb + 1] = dist[i];
    o[cb + 2] = med[i];
  }
}

template <int CBM, int PPT, int MAXT, int MINB>
cudaError_t launch_as(const Fwd2Args& a, bool soft, bool log, int n_tiles,
                      int threads, cudaStream_t stream) {
  const size_t smem = (size_t)(kACOL + a.cb + kRegion) * K * sizeof(float);
  auto kernel =
      log ? (soft ? raster_fwd_2dgs_kernel<CBM, PPT, true, true, MAXT, MINB>
                  : raster_fwd_2dgs_kernel<CBM, PPT, false, true, MAXT, MINB>)
          : (soft ? raster_fwd_2dgs_kernel<CBM, PPT, true, false, MAXT, MINB>
                  : raster_fwd_2dgs_kernel<CBM, PPT, false, false, MAXT,
                                           MINB>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int CBM>
cudaError_t launch(const Fwd2Args& a, bool soft, bool log, int n_tiles,
                   cudaStream_t stream) {
  constexpr int PPT = ppt_for(CBM);
  constexpr int RC = 32 / (8 / PPT);  // rows a cell
  const int ts = a.tile_size;
  const int threads = ((ts + 7) / 8) * ((ts + RC - 1) / RC) * 32;
  if constexpr (tuned(CBM)) {
    if (threads <= kSmallThreads) {
      return launch_as<CBM, PPT, kSmallThreads, kSmallMinBlocks>(
          a, soft, log, n_tiles, threads, stream);
    }
  }
  if constexpr (wide(CBM)) {
    if (threads <= kWideThreads) {
      return launch_as<CBM, PPT, kWideThreads, 1>(a, soft, log, n_tiles,
                                                  threads, stream);
    }
  }
  return launch_as<CBM, PPT, kMaxPixels / PPT, 1>(a, soft, log, n_tiles,
                                                  threads, stream);
}

}  // namespace

extern "C" int gsc_raster_fwd_2dgs(const void* S, long long cap,
                                   const void* starts, const void* masks,
                                   const void* order, int n_tiles,
                                   int tile_width,
                                   int tile_height, int tile_size, int cb,
                                   int zch, int soft, int log_composite,
                                   void* out, void* stream) {
  const int P = tile_size * tile_size;
  if (cb < 4 || cb > 128 || zch < 0 || zch >= cb - 3 || P < 1 ||
      P > kMaxPixels || n_tiles < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return (int)cudaGetLastError();
  const Fwd2Args a{static_cast<const float*>(S), (int64_t)cap,
                   static_cast<const int*>(starts),
                   static_cast<const int*>(masks),
                   static_cast<const int*>(order), tile_width, tile_height,
                   tile_size, cb, zch, static_cast<float*>(out)};
  cudaStream_t st = (cudaStream_t)stream;
  const bool sf = soft != 0;
  const bool lg = log_composite != 0;
  if (cb <= 4) return (int)launch<4>(a, sf, lg, n_tiles, st);
  if (cb <= 8) return (int)launch<8>(a, sf, lg, n_tiles, st);
  if (cb <= 16) return (int)launch<16>(a, sf, lg, n_tiles, st);
  if (cb <= 32) return (int)launch<32>(a, sf, lg, n_tiles, st);
  if (cb <= 64) return (int)launch<64>(a, sf, lg, n_tiles, st);
  return (int)launch<128>(a, sf, lg, n_tiles, st);
}
