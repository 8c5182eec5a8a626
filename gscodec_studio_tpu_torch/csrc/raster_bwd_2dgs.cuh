// 2DGS tile backward: per-intersection gradients of the surfel compositing,
// the distortion chain included, recomputed tile by tile from the sorted
// intersection table.
//
// Replaces gscodec_studio_tpu/ops/raster_v2_2dgs.py:_bwd_kernel_2dgs /
// _run_bwd_2dgs. Semantics are the JAX package's hand-derived VJP, pair
// for pair:
//   * the walk and the pair math are B5's (csrc/raster_fwd_2dgs.cu); the
//     tile loop stops once every pixel has T <= 1e-4 (a block-wide vote at
//     each chunk, in both modes, as the JAX loop's condition);
//   * carried per pixel: T, A (the prefix sum of w*z) and the suffix term
//     q, seeded with q0 = sum_ch c_out[ch]*v_c[ch] + 2*v_d*dist_out; per
//     composited pair, with P = 1 - T_prev, S = max(T_incl - T_final, 0)
//     and SZ = wz_total - A - w*z (wz_total: the forward's depth channel):
//       Dw = 2*v_d*(z*P - A + SZ - z*S),  GD = sum_ch col*v_c + Dw,
//       q -= w*GD,  v_alpha = T_prev*GD - q/(1-alpha) + v_a*T_final/(1-alpha),
//       v_sig = -alpha*v_alpha (0 where alpha was clamped at 0.999);
//   * sigma = 0.5*min(gw3d, gw2d): v_sig reaches the means2d rows through
//     the screen filter when gw2d < gw3d, and the nine ray-transform rows
//     through the cross product otherwise; the opacity row is -sum(v_sig)/op
//     (0 where op <= 0); colour rows sum(w*v_c), the depth channel's plus
//     the distortion's 2*v_d*w*(P - S). The median has no gradient.
// Output layout (the port's own, as in B2): row r of the gradient of S's
// column j is out[r * cap + j], d_g = 12 + CB rows (x, y, m00..m22, op,
// colors[CB]); columns no tile reaches stay at the caller's zeros.
//
// ABS (template; replaces the `cfg.absgrad` rows at raster_v2_2dgs.py
// :453-455, zero in the light pass at :508-511): two more rows, d_g =
// 14 + CB, the sums over the tile's pixels of |2 dx v_sig| and |2 dy v_sig|
// where the screen filter set sigma (the means2d terms of that branch; the
// UV branch adds nothing). A template and not a runtime flag, so that the
// build without them is the code it was, registers and all; their
// instantiations are built in their own translation unit
// (raster_bwd_2dgs_absgrad.cu, beside raster_bwd_2dgs.cu), in parallel.
//
// LOG (template; replaces the `cfg.log_composite` path at
// raster_v2_2dgs.py:353): B5's log-space scan (T_prev = T * exp(incl - l),
// the exact cutoff on T * exp(incl)), and then, as the JAX kernel does at
// :363-364, the suffix term's T_incl in product form, T_prev * (1 - alpha),
// not the log value. The product branch is the code it was.
//
// Bound on the H100: operations. Each pixel re-evaluates B5's pairs and,
// for each pair it composites, ~2*CB + 75 more operations of gradient
// arithmetic; the sums over the tile's pixels are d_g values per
// composited pair. The first design (one pixel a thread, a five-step
// shuffle tree per gradient row and warp) spent its time on three things:
// ~5*d_g shuffles for each (pair, warp) that any lane composited, on a
// pipe that retires a quarter of the float rate; the pair math of every
// (pair, pixel), though ~8% of them composite; and the gradient branch,
// taken by a warp whenever one of its lanes composited. Design:
//   * one block per tile, PPT pixels a thread (2 at CB <= 32, 1 above,
//     where the cotangent vc[PPT][CBM] fills the registers; 4 ran slower,
//     the gradient branch then taken once for each of a lane's 4): a
//     thread owns a run of PPT pixels of one tile row, so h_v, which
//     depends on the row alone, is formed once a pair, the pair's staged
//     rows are read from shared memory once for all its pixels, and its
//     pixels' values are added in registers before any warp reduction; a
//     warp's pixels form a square 8 x 8 cell (at PPT 2), which a surfel's
//     round footprint meets in fewer warps than it meets 4 x 16 strips;
//   * a candidate region per pair, formed once a chunk in double precision
//     (gsc::surfel_region in csrc/regions.cuh, B5's too): the
//     screen-filter disk and the ellipse that the surfel's disk {u^2 + v^2
//     <= 2 ln(255 op)} projects to (from the dual conic M diag(rho^2,
//     rho^2, -1) M^T), both widened by margins far above float rounding; a
//     pixel outside both cannot reach alpha >= 1/255, so its pair math is
//     skipped, and a warp none of whose pixels is a candidate skips the
//     pair. Skipping a pair that fails the alpha test
//     changes no state, so the results are the same;
//   * a transposing warp reduction: the d_g values, in groups of 32, in
//     16 + 8 + 4 + 2 + 1 exchange-and-add steps after which lane r holds
//     row r's warp sum and stores it (31 shuffles a group, against 5 a
//     row); the tree is fixed, so the bits repeat;
//   * a ballot shortcut: when one lane alone composited the pair, it
//     stores its own values (adding the other lanes' zeros would give the
//     same sums) and no tree runs; when none did, lane r stores row r's 0;
//   * the warps' partials of `sub` pairs (32 in the main path's build,
//     below; else up to the 128-row chunk, halved until shared memory
//     holds them) are added in warp order by the block after one barrier:
//     deterministic, no atomics;
//   * occupancy (min_blocks, below): the main path's block is built for 6
//     resident an SM, at 80 registers.
// The cotangent's CB channels live in registers under a template bound (4,
// 8, 16, 32, 64 or 128).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "regions.cuh"
#include "tile_common.cuh"

namespace gsc {

// B6 with the absgrad rows (raster_bwd_2dgs_absgrad.cu): the arguments of
// gsc_raster_bwd_2dgs, checked.
int raster_bwd_2dgs_absgrad(const void* S, long long cap, const void* starts,
                            const void* masks, const void* tiles,
                            const void* v_tiles, int n_tiles, int tile_width,
                            int tile_height, int tile_size, int cb, int zch,
                            int soft, int log_composite, void* out,
                            void* stream);

}  // namespace gsc

namespace {

constexpr int K = 128;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;
constexpr float kFilterInvSquare = 2.0f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAM = 2;
constexpr int kAOP = 11;
constexpr int kACOL = 12;
constexpr int kMaxPixels = 1024;  // tile 32
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most
// a pair's candidate region in shared memory (gsc::surfel_region)
constexpr int kRegion = gsc::kSurfelRegion;

// pixels a thread: several where the cotangent leaves registers free
constexpr int ppt_for(int cbm) { return cbm <= 32 ? 2 : 1; }
// Occupancy. A tile of up to 16 x 16 at 2 pixels a thread is a block of at
// most 128 threads, built apart for min_blocks of them an SM: that caps
// its registers (80 at 6), and its partials stage 32 pairs (23 KB a block
// at CB = 7, so 6 blocks leave the L1 most of the SM's 256 KB for the
// spills). The card then has 24 warps an SM to hide the pair math's
// latency, against 16 at the ~110 registers that the compiler takes
// unbounded. 7 blocks an SM, 8, or 64 or 16 staged pairs were slower at
// the 1M scene. Larger tiles, and the channel bounds above 8 whose
// cotangent fills more registers, get the build bounded by tile 32 alone.
constexpr int kSmallThreads = 128;
constexpr int kSmallSub = 32;
constexpr int min_blocks(int cbm) { return cbm <= 8 ? 6 : 1; }

struct Bwd2Args {
  const float* S;  // [>= 12 + cb, cap] sorted attribute rows
  int64_t cap;
  const int* starts;  // [n_tiles + 2] first row of each tile's run
  const int* masks;  // [n_tiles] 0 disables a tile
  const float* tiles;  // [n_tiles, P, cb + 3] forward outputs
  const float* v_tiles;  // [n_tiles, P, cb + 3] their cotangents
  int tile_width, tile_height, tile_size, cb, zch, d_g;
  int sub;  // pairs whose warp partials are staged at once (divides K)
  int dp;  // a pair's pitch in the partials: d_g, made odd (no conflicts)
  float* out;  // [d_g, cap], zero-filled by the caller
};

// One level of the transposing reduction over N values a lane: lanes that
// differ in bit N/2 swap halves, each keeps the half its bit selects and
// adds the partner's copy of it. After the levels N = 32 .. 2, x[0] of lane
// r holds the warp's sum of row r.
template <int N>
__device__ __forceinline__ void transpose_sum(float (&x)[32], int lane) {
  constexpr int H = N / 2;
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? x[i] : x[i + H];
    const float keep = up ? x[i + H] : x[i];
    x[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
  if constexpr (H > 1) transpose_sum<H>(x, lane);
}

// Row r of a thread's sum over its pixels: the 12 geometry rows as summed,
// a colour row from the pixels' weights (0 where a pixel did not composite
// the pair) and cotangents, the depth channel's with the distortion's
// term. Inlined into loops over r that unroll, so every index is a
// constant and the arrays stay in registers.
template <int CBM, int PPT>
__device__ __forceinline__ float grad_row(int r, const float (&g12)[kACOL],
                                          const float (&gw)[PPT],
                                          const float (&gz)[PPT],
                                          const float (&vc)[PPT][CBM],
                                          int cb, int zch,
                                          const float (&gab)[2]) {
  if (r < kACOL) return g12[r];
  if (r >= kACOL + CBM) return gab[r - kACOL - CBM];  // ABS: |x|, |y|
  const int j = r - kACOL;
  if (j >= cb) return 0.0f;
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    v += j == zch ? gw[i] * vc[i][j] + gz[i] : gw[i] * vc[i][j];
  }
  return v;
}

// ABS: the partial row of grad_row's row r under the bound, or -1 (the
// colour rows past the channels).
template <int CBM>
__device__ __forceinline__ int abs_row(int r, int cb) {
  if (r < kACOL + CBM) return r < kACOL + cb ? r : -1;
  return r - CBM + cb;
}

template <int CBM, int PPT, bool SOFT, bool LOG, bool ABS, int MAXT,
          int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    raster_bwd_2dgs_kernel(const Bwd2Args a) {
  // gradient rows under the bound
  constexpr int NR = kACOL + CBM + (ABS ? 2 : 0);
  constexpr int NG = (NR + 31) / 32;  // groups of the warp reduction
  extern __shared__ float sm[];
  const int cb = a.cb;
  const int zch = a.zch;
  const int d_g = a.d_g;
  const int sub = a.sub;
  const int dp = a.dp;
  const int nrows = kACOL + cb;
  float* chunk = sm;  // [(12 + cb) * K]
  float* reg = chunk + nrows * K;  // [kRegion * K]
  float* part = reg + kRegion * K;  // [n_warps, sub, dp]

  const int t = blockIdx.x;
  const int ts = a.tile_size;
  const int P = ts * ts;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  const int off = a.starts[t];
  const int end = a.starts[t + 1];
  const int c0 = off / K;
  const int c1 = (end > off && a.masks[t] > 0) ? (end + K - 1) / K : c0;
  const int rem = t % (a.tile_width * a.tile_height);
  const int x0 = (rem % a.tile_width) * ts;
  const int y0 = (rem / a.tile_width) * ts;
  const float* zs = chunk + (kACOL + zch) * K;

  // the thread's pixels: PPT neighbours of tile row prow; a warp's, a
  // cell 8 pixels wide (8 x 8 at PPT 2, 4 x 8 at 1), the cells row-major
  constexpr int CT = 8 / PPT;  // threads a cell row
  const int cells_x = (ts + 7) / 8;
  const int prow = (warp / cells_x) * (32 / CT) + lane / CT;
  const int pcol = (warp % cells_x) * 8 + (lane % CT) * PPT;
  const float py = (float)(y0 + prow) + 0.5f;
  float vc[PPT][CBM];
  float q[PPT], v_d[PPT], va_tf[PPT], t_final[PPT], wz_total[PPT];
  float T[PPT], A[PPT], px[PPT];
  bool pix[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    pix[i] = prow < ts && pcol + i < ts;
    px[i] = (float)(x0 + pcol + i) + 0.5f;
    float qi = 0.0f, vai = 0.0f, vdi = 0.0f, tfi = 1.0f, wzi = 0.0f;
#pragma unroll
    for (int j = 0; j < CBM; ++j) vc[i][j] = 0.0f;
    if (pix[i]) {
      const int p = prow * ts + pcol + i;
      const int64_t base = ((int64_t)t * P + p) * (cb + 3);
#pragma unroll
      for (int j = 0; j < CBM; ++j) {
        if (j < cb) {
          vc[i][j] = a.v_tiles[base + j];
          qi += a.tiles[base + j] * vc[i][j];
        }
      }
      vai = a.v_tiles[base + cb];
      vdi = a.v_tiles[base + cb + 1];
      tfi = 1.0f - a.tiles[base + cb];
      wzi = a.tiles[base + zch];
      qi = qi + 2.0f * vdi * a.tiles[base + cb + 1];
    }
    q[i] = qi;
    v_d[i] = vdi;
    t_final[i] = tfi;
    wz_total[i] = wzi;
    va_tf[i] = vai * tfi;
    T[i] = pix[i] ? 1.0f : 0.0f;
    A[i] = 0.0f;
  }

  for (int c = c0; c < c1; ++c) {
    bool busy = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) busy |= T[i] > kTransmittanceEps;
    if (!__syncthreads_or(busy)) break;
    const int64_t col0 = (int64_t)c * K;
    for (int i = tid; i < nrows * K; i += blockDim.x) {
      chunk[i] = a.S[(i / K) * a.cap + col0 + (i % K)];
    }
    __syncthreads();
    const int lo = max(off - c * K, 0);
    const int hi = min(end - c * K, K);
    for (int k = lo + tid; k < hi; k += blockDim.x) {
      gsc::surfel_region(chunk, k, reg);
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
    for (int s0 = (lo / sub) * sub; s0 < hi; s0 += sub) {
      for (int kk = 0; kk < sub; ++kk) {
        const int k = s0 + kk;
        if (k < lo || k >= hi) continue;  // the same for the whole block
        float* pw = part + (warp * sub + kk) * dp;  // row r at pw[r]
        // the candidate test: a pixel outside the pair's region cannot
        // pass the alpha test, and a warp without candidates skips it
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
        if (!__any_sync(kFull, any)) {
          for (int r = lane; r < d_g; r += 32) pw[r] = 0.0f;
          continue;
        }
        // the pair's staged rows, read once for the thread's pixels
        const float* m = chunk + kAM * K + k;  // M[i] at m[i * K]
        const float m0 = m[0], m1 = m[K], m2 = m[2 * K], m3 = m[3 * K];
        const float m4 = m[4 * K], m5 = m[5 * K], m6 = m[6 * K];
        const float m7 = m[7 * K], m8 = m[8 * K];
        const float op = chunk[kAOP * K + k];
        const float z = zs[k];
        float col[CBM];
#pragma unroll
        for (int j = 0; j < CBM; ++j) {
          col[j] = j < cb ? chunk[(kACOL + j) * K + k] : 0.0f;
        }
        // h_v depends on the pixel row alone
        const float hv_x = py * m6 - m3;
        const float hv_y = py * m7 - m4;
        const float hv_z = py * m8 - m5;
        // the thread's sums over its pixels: means2d (2), ray transform
        // (9), v_sig; per pixel the colour rows' weight and the depth's
        // extra term (0 where the pixel did not composite the pair)
        float g12[kACOL];
#pragma unroll
        for (int r = 0; r < kACOL; ++r) g12[r] = 0.0f;
        float gw[PPT], gz[PPT];
        float gab[2] = {0.0f, 0.0f};  // ABS: sum |x|, |y| terms
        bool hit = false;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          gw[i] = 0.0f;
          gz[i] = 0.0f;
          if (!cand[i]) continue;
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
          const float alpha_raw = op * expf(-sigma);
          const float alpha = fminf(kMaxAlpha, alpha_raw);
          if (!(cz != 0.0f && alpha >= kAlphaThreshold)) continue;
          const float oma = 1.0f - alpha;
          float t_prev, t_incl, t_test;
          if (LOG) {
            float l;
            const float incl = gsc::log_scan_step(alpha, s1[i], s2[i], l);
            t_prev = T[i] * expf(incl - l);
            t_incl = t_prev * oma;  // the suffix term's, product form
            t_test = SOFT ? 0.0f : T[i] * expf(incl);
          } else {
            t_prev = tp[i];
            t_incl = tp[i] * oma;
            t_test = t_incl;
          }
          if (!SOFT && !(t_test > kTransmittanceEps)) {
            live[i] = false;
            continue;
          }
          const float w = alpha * t_prev;
          const float wz = w * z;
          const float P_i = 1.0f - t_prev;
          const float S_i = fmaxf(t_incl - t_final[i], 0.0f);
          const float SZ_i = wz_total[i] - A[i] - wz;
          float G = 0.0f;
#pragma unroll
          for (int j = 0; j < CBM; ++j) {
            if (j < cb) G += col[j] * vc[i][j];
          }
          const float Dw = 2.0f * v_d[i] * (z * P_i - A[i] + SZ_i - z * S_i);
          const float GD = G + Dw;
          q[i] = q[i] - w * GD;  // the suffix term after this pair
          const float inv_oma = 1.0f / oma;
          const float v_alpha =
              t_prev * GD - q[i] * inv_oma + va_tf[i] * inv_oma;
          const float v_sig = alpha_raw > kMaxAlpha ? 0.0f : -alpha * v_alpha;
          if (gw3d <= gw2d) {
            // the UV branch: through the cross product to M's rows
            const float v_su = su * v_sig;
            const float v_sv = sv * v_sig;
            const float v_cx = v_su * inv_cz;
            const float v_cy = v_sv * inv_cz;
            const float v_cz = -(su * v_su + sv * v_sv) * inv_cz;
            const float v_hu0 = hv_y * v_cz - hv_z * v_cy;
            const float v_hu1 = hv_z * v_cx - hv_x * v_cz;
            const float v_hu2 = hv_x * v_cy - hv_y * v_cx;
            const float v_hv0 = v_cy * hu_z - v_cz * hu_y;
            const float v_hv1 = v_cz * hu_x - v_cx * hu_z;
            const float v_hv2 = v_cx * hu_y - v_cy * hu_x;
            g12[kAM + 0] += -v_hu0;
            g12[kAM + 1] += -v_hu1;
            g12[kAM + 2] += -v_hu2;
            g12[kAM + 3] += -v_hv0;
            g12[kAM + 4] += -v_hv1;
            g12[kAM + 5] += -v_hv2;
            g12[kAM + 6] += px[i] * v_hu0 + py * v_hv0;
            g12[kAM + 7] += px[i] * v_hu1 + py * v_hv1;
            g12[kAM + 8] += px[i] * v_hu2 + py * v_hv2;
          } else {
            // the screen filter branch: to means2d
            const float v_mx = kFilterInvSquare * dx * v_sig;
            const float v_my = kFilterInvSquare * dy * v_sig;
            g12[0] += v_mx;
            g12[1] += v_my;
            if constexpr (ABS) {
              gab[0] += fabsf(v_mx);
              gab[1] += fabsf(v_my);
            }
          }
          g12[kAOP] += v_sig;
          gw[i] = w;
          gz[i] = 2.0f * v_d[i] * w * (P_i - S_i);
          A[i] += wz;
          tp[i] = LOG ? fminf(tp[i], t_test) : t_incl;
          hit = true;
        }
        const unsigned ballot = __ballot_sync(kFull, hit);
        if (ballot == 0u) {
          for (int r = lane; r < d_g; r += 32) pw[r] = 0.0f;
        } else if ((ballot & (ballot - 1u)) == 0u) {
          // one lane composited the pair: its values are the warp's sums
          if (hit) {
#pragma unroll
            for (int r = 0; r < NR; ++r) {
              const float v = grad_row(r, g12, gw, gz, vc, cb, zch, gab);
              if constexpr (ABS) {
                const int rr = abs_row<CBM>(r, cb);
                if (rr >= 0) pw[rr] = v;
              } else if (r < d_g) {
                pw[r] = v;
              }
            }
          }
        } else {
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            float x[32];
#pragma unroll
            for (int s = 0; s < 32; ++s) {
              x[s] = 32 * g + s < NR
                         ? grad_row(32 * g + s, g12, gw, gz, vc, cb, zch, gab)
                         : 0.0f;
            }
            transpose_sum<32>(x, lane);
            const int r = 32 * g + lane;
            if constexpr (ABS) {
              const int rr = r < NR ? abs_row<CBM>(r, cb) : -1;
              if (rr >= 0) pw[rr] = x[0];
            } else if (r < d_g) {
              pw[r] = x[0];
            }
          }
        }
      }
      __syncthreads();
      // the block's sum of the warp partials, in warp order
      for (int i = tid; i < d_g * sub; i += blockDim.x) {
        const int r = i / sub;
        const int kk = i % sub;
        const int k = s0 + kk;
        if (k < lo || k >= hi) continue;
        float v = 0.0f;
        for (int w = 0; w < n_warps; ++w) v += part[(w * sub + kk) * dp + r];
        if (r == kAOP) {
          const float opk = chunk[kAOP * K + k];
          v = opk > 0.0f ? -v / opk : 0.0f;
        }
        a.out[(int64_t)r * a.cap + col0 + k] = v;
      }
      // the partials are written again by the chunk's next sub-block; the
      // next chunk's vote is the barrier before its staging
      if (s0 + sub < hi) __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      T[i] = (LOG && SOFT) ? T[i] * expf(s1[i] + s2[i]) : tp[i];
    }
  }
}

template <int CBM, bool ABS, int MAXT, int MINB>
cudaError_t launch_as(Bwd2Args a, bool soft, bool log, int n_tiles,
                      int threads, cudaStream_t stream) {
  constexpr int PPT = ppt_for(CBM);
  const size_t fixed_bytes =
      (size_t)(kACOL + a.cb + kRegion) * K * sizeof(float);
  a.dp = a.d_g | 1;
  const size_t part_bytes = (size_t)(threads / 32) * a.dp * sizeof(float);
  a.sub = MINB > 1 ? kSmallSub : K;
  while (a.sub > 1 && fixed_bytes + part_bytes * a.sub > kMaxSmem) {
    a.sub >>= 1;
  }
  const size_t smem = fixed_bytes + part_bytes * a.sub;
  auto kernel =
      log ? (soft ? raster_bwd_2dgs_kernel<CBM, PPT, true, true, ABS, MAXT,
                                           MINB>
                  : raster_bwd_2dgs_kernel<CBM, PPT, false, true, ABS, MAXT,
                                           MINB>)
          : (soft ? raster_bwd_2dgs_kernel<CBM, PPT, true, false, ABS, MAXT,
                                           MINB>
                  : raster_bwd_2dgs_kernel<CBM, PPT, false, false, ABS, MAXT,
                                           MINB>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int CBM, bool ABS>
cudaError_t launch(const Bwd2Args& a, bool soft, bool log, int n_tiles,
                   cudaStream_t stream) {
  constexpr int PPT = ppt_for(CBM);
  const int ts = a.tile_size;
  constexpr int RC = 32 / (8 / PPT);  // rows a cell
  const int threads = ((ts + 7) / 8) * ((ts + RC - 1) / RC) * 32;
  if constexpr (min_blocks(CBM) > 1) {
    if (threads <= kSmallThreads) {
      return launch_as<CBM, ABS, kSmallThreads, min_blocks(CBM)>(
          a, soft, log, n_tiles, threads, stream);
    }
  }
  return launch_as<CBM, ABS, kMaxPixels / PPT, 1>(a, soft, log, n_tiles,
                                                  threads, stream);
}

// gsc_raster_bwd_2dgs's body, with (ABS) or without the absgrad rows.
template <bool ABS>
int run(const void* S, long long cap, const void* starts, const void* masks,
        const void* tiles, const void* v_tiles, int n_tiles, int tile_width,
        int tile_height, int tile_size, int cb, int zch, int soft,
        int log_composite, void* out, void* stream) {
  const int P = tile_size * tile_size;
  if (cb < 4 || cb > 128 || zch < 0 || zch >= cb - 3 || P < 1 ||
      P > kMaxPixels || n_tiles < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return (int)cudaGetLastError();
  const Bwd2Args a{static_cast<const float*>(S),
                   (int64_t)cap,
                   static_cast<const int*>(starts),
                   static_cast<const int*>(masks),
                   static_cast<const float*>(tiles),
                   static_cast<const float*>(v_tiles),
                   tile_width,
                   tile_height,
                   tile_size,
                   cb,
                   zch,
                   kACOL + cb + (ABS ? 2 : 0),
                   K,
                   kACOL + cb,
                   static_cast<float*>(out)};
  cudaStream_t st = (cudaStream_t)stream;
  const bool sf = soft != 0;
  const bool lg = log_composite != 0;
  if (cb <= 4) return (int)launch<4, ABS>(a, sf, lg, n_tiles, st);
  if (cb <= 8) return (int)launch<8, ABS>(a, sf, lg, n_tiles, st);
  if (cb <= 16) return (int)launch<16, ABS>(a, sf, lg, n_tiles, st);
  if (cb <= 32) return (int)launch<32, ABS>(a, sf, lg, n_tiles, st);
  if (cb <= 64) return (int)launch<64, ABS>(a, sf, lg, n_tiles, st);
  return (int)launch<128, ABS>(a, sf, lg, n_tiles, st);
}

}  // namespace
