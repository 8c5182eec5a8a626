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
// LOG (template; replaces the `cfg.log_composite` path at
// raster_v2_2dgs.py:353): B5's log-space scan (T_prev = T * exp(incl - l),
// the exact cutoff on T * exp(incl)), and then, as the JAX kernel does at
// :363-364, the suffix term's T_incl in product form, T_prev * (1 - alpha),
// not the log value. The product branch is the code it was.
//
// Bound on the H100: operations. Each pixel re-evaluates B5's pairs and,
// for each pair it composites, ~2*CB + 75 more operations of gradient
// arithmetic; the sums over the tile's pixels are d_g values per
// composited pair. Design: B2's. One block per tile, one thread per pixel,
// each 128-row chunk staged in shared memory; for each pair a warp reduces
// its 32 pixels' values with shuffles in a fixed tree (the whole pair
// skipped when no lane touched it, the nine ray-transform rows when no
// lane took the UV branch, the two means2d rows when none took the filter
// branch), lane 0 stores the warp's partial in shared memory, and after
// every 32 pairs the block adds the partials in warp order: deterministic,
// no atomics. The cotangent's CB channels live in registers under a
// template bound (4, 8, 16, 32, 64 or 128).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

constexpr int K = 128;
constexpr int SUB = 32;  // pairs whose warp partials are staged at once
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;
constexpr float kFilterInvSquare = 2.0f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAM = 2;
constexpr int kAOP = 11;
constexpr int kACOL = 12;

struct Bwd2Args {
  const float* S;  // [>= 12 + cb, cap] sorted attribute rows
  int64_t cap;
  const int* starts;  // [n_tiles + 2] first row of each tile's run
  const int* masks;  // [n_tiles] 0 disables a tile
  const float* tiles;  // [n_tiles, P, cb + 3] forward outputs
  const float* v_tiles;  // [n_tiles, P, cb + 3] their cotangents
  int tile_width, tile_height, tile_size, cb, zch, d_g;
  float* out;  // [d_g, cap], zero-filled by the caller
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

template <int CBM, bool SOFT, bool LOG>
__global__ void raster_bwd_2dgs_kernel(const Bwd2Args a) {
  extern __shared__ float sm[];
  const int cb = a.cb;
  const int d_g = a.d_g;
  const int nrows = kACOL + cb;
  float* chunk = sm;  // [(12 + cb) * K]
  float* part = sm + nrows * K;  // [n_warps, d_g, SUB]

  const int t = blockIdx.x;
  const int ts = a.tile_size;
  const int P = ts * ts;
  const int p = threadIdx.x;
  const bool pix = p < P;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int n_warps = blockDim.x >> 5;
  const int off = a.starts[t];
  const int end = a.starts[t + 1];
  const int c0 = off / K;
  const int c1 = (end > off && a.masks[t] > 0) ? (end + K - 1) / K : c0;
  const int rem = t % (a.tile_width * a.tile_height);
  const float px = (float)((rem % a.tile_width) * ts + p % ts) + 0.5f;
  const float py = (float)((rem / a.tile_width) * ts + p / ts) + 0.5f;
  const float* zs = chunk + (kACOL + a.zch) * K;

  float vc[CBM];
#pragma unroll
  for (int j = 0; j < CBM; ++j) vc[j] = 0.0f;
  float q = 0.0f, v_a = 0.0f, v_d = 0.0f, t_final = 1.0f, wz_total = 0.0f;
  if (pix) {
    const int64_t base = ((int64_t)t * P + p) * (cb + 3);
#pragma unroll
    for (int j = 0; j < CBM; ++j) {
      if (j < cb) {
        vc[j] = a.v_tiles[base + j];
        q += a.tiles[base + j] * vc[j];
      }
    }
    v_a = a.v_tiles[base + cb];
    v_d = a.v_tiles[base + cb + 1];
    t_final = 1.0f - a.tiles[base + cb];
    wz_total = a.tiles[base + a.zch];
    q = q + 2.0f * v_d * a.tiles[base + cb + 1];
  }
  const float va_tf = v_a * t_final;
  float T = pix ? 1.0f : 0.0f;
  float A = 0.0f;

  for (int c = c0; c < c1; ++c) {
    if (!__syncthreads_or(T > kTransmittanceEps)) break;
    const int64_t col0 = (int64_t)c * K;
    for (int i = p; i < nrows * K; i += blockDim.x) {
      chunk[i] = a.S[(i / K) * a.cap + col0 + (i % K)];
    }
    __syncthreads();
    const int lo = max(off - c * K, 0);
    const int hi = min(end - c * K, K);
    float tp = T;  // LOG: the last passing T * exp(incl) (exact cutoff)
    float s1 = 0.0f, s2 = 0.0f;  // LOG: the chunk's running sums
    bool live = pix;  // exact: the pixel takes pairs until its cutoff
    for (int s0 = (lo / SUB) * SUB; s0 < hi; s0 += SUB) {
      for (int kk = 0; kk < SUB; ++kk) {
        const int k = s0 + kk;
        if (k < lo || k >= hi) continue;  // the same for the whole block
        // per-pixel values: means2d (2), ray transform (9), v_sig, the
        // pair's weight (colour rows gw * vc) and the depth's extra term
        float gx = 0.0f, gy = 0.0f, gs = 0.0f, gw = 0.0f, gz = 0.0f;
        float gm[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) gm[i] = 0.0f;
        bool hit = false, uv = false;
        if (live) {
          const float* m = chunk + kAM * K + k;  // M[i] at m[i * K]
          const float hu_x = px * m[6 * K] - m[0];
          const float hu_y = px * m[7 * K] - m[K];
          const float hu_z = px * m[8 * K] - m[2 * K];
          const float hv_x = py * m[6 * K] - m[3 * K];
          const float hv_y = py * m[7 * K] - m[4 * K];
          const float hv_z = py * m[8 * K] - m[5 * K];
          const float cz = hu_x * hv_y - hu_y * hv_x;
          const float cx = hu_y * hv_z - hu_z * hv_y;
          const float cy = hu_z * hv_x - hu_x * hv_z;
          const float inv_cz = 1.0f / (cz != 0.0f ? cz : 1.0f);
          const float su = cx * inv_cz;
          const float sv = cy * inv_cz;
          const float gw3d = su * su + sv * sv;
          const float dx = chunk[k] - px;
          const float dy = chunk[K + k] - py;
          const float gw2d = kFilterInvSquare * (dx * dx + dy * dy);
          const float sigma = 0.5f * fminf(gw3d, gw2d);
          const float op = chunk[kAOP * K + k];
          const float alpha_raw = op * expf(-sigma);
          const float alpha = fminf(kMaxAlpha, alpha_raw);
          if (cz != 0.0f && alpha >= kAlphaThreshold) {
            const float oma = 1.0f - alpha;
            float t_prev, t_incl, t_test;
            if (LOG) {
              float l;
              const float incl = gsc::log_scan_step(alpha, s1, s2, l);
              t_prev = T * expf(incl - l);
              t_incl = t_prev * oma;  // the suffix term's, product form
              t_test = SOFT ? 0.0f : T * expf(incl);
            } else {
              t_prev = tp;
              t_incl = tp * oma;
              t_test = t_incl;
            }
            if (!SOFT && !(t_test > kTransmittanceEps)) {
              live = false;
            } else {
              const float w = alpha * t_prev;
              const float z = zs[k];
              const float wz = w * z;
              const float P_i = 1.0f - t_prev;
              const float S_i = fmaxf(t_incl - t_final, 0.0f);
              const float SZ_i = wz_total - A - wz;
              float G = 0.0f;
#pragma unroll
              for (int j = 0; j < CBM; ++j) {
                if (j < cb) G += chunk[(kACOL + j) * K + k] * vc[j];
              }
              const float Dw = 2.0f * v_d * (z * P_i - A + SZ_i - z * S_i);
              const float GD = G + Dw;
              q = q - w * GD;  // the suffix term after this pair
              const float inv_oma = 1.0f / oma;
              const float v_alpha =
                  t_prev * GD - q * inv_oma + va_tf * inv_oma;
              const float v_sig =
                  alpha_raw > kMaxAlpha ? 0.0f : -alpha * v_alpha;
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
                gm[0] = -v_hu0;
                gm[1] = -v_hu1;
                gm[2] = -v_hu2;
                gm[3] = -v_hv0;
                gm[4] = -v_hv1;
                gm[5] = -v_hv2;
                gm[6] = px * v_hu0 + py * v_hv0;
                gm[7] = px * v_hu1 + py * v_hv1;
                gm[8] = px * v_hu2 + py * v_hv2;
                uv = true;
              } else {
                // the screen filter branch: to means2d
                gx = kFilterInvSquare * dx * v_sig;
                gy = kFilterInvSquare * dy * v_sig;
              }
              gs = v_sig;
              gw = w;
              gz = 2.0f * v_d * w * (P_i - S_i);
              A += wz;
              tp = LOG ? fminf(tp, t_test) : t_incl;
              hit = true;
            }
          }
        }
        float* pw = part + (warp * d_g) * SUB + kk;  // row r at pw[r*SUB]
        if (__any_sync(kFull, hit)) {
          const bool any_uv = __any_sync(kFull, uv);
          const bool any_xy = __any_sync(kFull, hit && !uv);
          const float v0 = any_xy ? warp_sum(gx) : 0.0f;
          const float v1 = any_xy ? warp_sum(gy) : 0.0f;
          if (lane == 0) {
            pw[0] = v0;
            pw[SUB] = v1;
          }
#pragma unroll
          for (int i = 0; i < 9; ++i) {
            const float v = any_uv ? warp_sum(gm[i]) : 0.0f;
            if (lane == 0) pw[(kAM + i) * SUB] = v;
          }
          const float vs = warp_sum(gs);
          if (lane == 0) pw[kAOP * SUB] = vs;
#pragma unroll
          for (int j = 0; j < CBM; ++j) {
            if (j < cb) {
              const float v =
                  warp_sum(j == a.zch ? gw * vc[j] + gz : gw * vc[j]);
              if (lane == 0) pw[(kACOL + j) * SUB] = v;
            }
          }
        } else if (lane == 0) {
          for (int r = 0; r < d_g; ++r) pw[r * SUB] = 0.0f;
        }
      }
      __syncthreads();
      // the block's sum of the warp partials, in warp order
      for (int i = p; i < d_g * SUB; i += blockDim.x) {
        const int r = i / SUB;
        const int k = s0 + i % SUB;
        if (k < lo || k >= hi) continue;
        float v = 0.0f;
        for (int w = 0; w < n_warps; ++w) v += part[(w * d_g) * SUB + i];
        if (r == kAOP) {
          const float op = chunk[kAOP * K + k];
          v = op > 0.0f ? -v / op : 0.0f;
        }
        a.out[(int64_t)r * a.cap + col0 + k] = v;
      }
      __syncthreads();
    }
    T = (LOG && SOFT) ? T * expf(s1 + s2) : tp;
  }
}

template <int CBM>
cudaError_t launch(const Bwd2Args& a, bool soft, bool log, int n_tiles,
                   cudaStream_t stream) {
  const int P = a.tile_size * a.tile_size;
  const int threads = (P + 31) / 32 * 32;
  const size_t smem = ((size_t)(kACOL + a.cb) * K +
                       (size_t)(threads / 32) * a.d_g * SUB) *
                      sizeof(float);
  auto kernel = log ? (soft ? raster_bwd_2dgs_kernel<CBM, true, true>
                            : raster_bwd_2dgs_kernel<CBM, false, true>)
                    : (soft ? raster_bwd_2dgs_kernel<CBM, true, false>
                            : raster_bwd_2dgs_kernel<CBM, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gsc_raster_bwd_2dgs(const void* S, long long cap,
                                   const void* starts, const void* masks,
                                   const void* tiles, const void* v_tiles,
                                   int n_tiles, int tile_width,
                                   int tile_height, int tile_size, int cb,
                                   int zch, int soft, int log_composite,
                                   void* out, void* stream) {
  const int P = tile_size * tile_size;
  if (cb < 4 || cb > 128 || zch < 0 || zch >= cb - 3 || P < 1 || P > 1024 ||
      n_tiles < 0) {
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
                   kACOL + cb,
                   static_cast<float*>(out)};
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
