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
// T * exp(s1 + s2). The product branch is the code it was.
//
// Bound on the H100: operations. Each pixel evaluates the cross-product
// pair math (~35 float32 operations, one division, one exp) for every pair
// of its run up to its cutoff, and composites (2*CB + 12 more) the pairs
// that pass the alpha test, while the table is read once per tile. Design:
// one block per tile, one thread per pixel; each 128-row chunk of the
// 12 + CB attribute rows is staged through shared memory once and read by
// all the tile's pixels as broadcasts. Accumulators live in registers
// under a template bound on CB (1, 2, 3, 4, 8, 16, 32, 64 or 128).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

constexpr int K = 128;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;
constexpr float kFilterInvSquare = 2.0f;
// attribute rows: x, y, m00..m22, op, colors[CB]
constexpr int kAM = 2;
constexpr int kAOP = 11;
constexpr int kACOL = 12;

struct Fwd2Args {
  const float* S;  // [>= 12 + cb, cap] sorted attribute rows
  int64_t cap;
  const int* starts;  // [n_tiles + 2] first row of each tile's run
  const int* masks;  // [n_tiles] 0 disables a tile
  int tile_width, tile_height, tile_size, cb, zch;
  float* out;  // [n_tiles, tile_size^2, cb + 3]
};

template <int CBM, bool SOFT, bool LOG>
__device__ __forceinline__ void fwd_2dgs_body(const Fwd2Args& a) {
  extern __shared__ float sm[];  // [(12 + cb) * K]
  const int t = blockIdx.x;
  const int ts = a.tile_size;
  const int P = ts * ts;
  const int p = threadIdx.x;
  const int off = a.starts[t];
  const int end = a.starts[t + 1];
  const int c0 = off / K;
  const int c1 = (end > off && a.masks[t] > 0) ? (end + K - 1) / K : c0;
  const int rem = t % (a.tile_width * a.tile_height);
  const float px = (float)((rem % a.tile_width) * ts + p % ts) + 0.5f;
  const float py = (float)((rem / a.tile_width) * ts + p / ts) + 0.5f;
  const int cb = a.cb;
  const int nrows = kACOL + cb;
  const float* zs = sm + (kACOL + a.zch) * K;

  float T = 1.0f;
  float acc[CBM];
#pragma unroll
  for (int j = 0; j < CBM; ++j) acc[j] = 0.0f;
  float A = 0.0f, dist = 0.0f, med = 0.0f;

  for (int c = c0; c < c1; ++c) {
    if (SOFT) {
      if (!__syncthreads_or(T > kTransmittanceEps)) break;
    } else {
      __syncthreads();
    }
    const int64_t col0 = (int64_t)c * K;
    for (int i = p; i < nrows * K; i += P) {
      sm[i] = a.S[(i / K) * a.cap + col0 + (i % K)];
    }
    __syncthreads();
    const int lo = max(off - c * K, 0);
    const int hi = min(end - c * K, K);
    float tp = T;  // LOG: the last passing T * exp(incl) (exact cutoff)
    float s1 = 0.0f, s2 = 0.0f;  // LOG: the chunk's running sums
    for (int k = lo; k < hi; ++k) {
      const float* m = sm + kAM * K + k;  // M[i] at m[i * K]
      const float hu_x = px * m[6 * K] - m[0];
      const float hu_y = px * m[7 * K] - m[K];
      const float hu_z = px * m[8 * K] - m[2 * K];
      const float hv_x = py * m[6 * K] - m[3 * K];
      const float hv_y = py * m[7 * K] - m[4 * K];
      const float hv_z = py * m[8 * K] - m[5 * K];
      const float cz = hu_x * hv_y - hu_y * hv_x;
      if (cz == 0.0f) continue;
      const float cx = hu_y * hv_z - hu_z * hv_y;
      const float cy = hu_z * hv_x - hu_x * hv_z;
      const float inv_cz = 1.0f / cz;
      const float su = cx * inv_cz;
      const float sv = cy * inv_cz;
      const float gw3d = su * su + sv * sv;
      const float dx = sm[k] - px;
      const float dy = sm[K + k] - py;
      const float gw2d = kFilterInvSquare * (dx * dx + dy * dy);
      const float sigma = 0.5f * fminf(gw3d, gw2d);
      const float alpha = fminf(kMaxAlpha, sm[kAOP * K + k] * expf(-sigma));
      if (!(alpha >= kAlphaThreshold)) continue;
      const float oma = 1.0f - alpha;
      float t_prev;
      if (LOG) {
        float l;
        const float incl = gsc::log_scan_step(alpha, s1, s2, l);
        t_prev = T * expf(incl - l);
        if (!SOFT) {
          const float t_incl = T * expf(incl);
          if (!(t_incl > kTransmittanceEps)) break;
          tp = fminf(tp, t_incl);
        }
      } else {
        if (!SOFT && !(tp * oma > kTransmittanceEps)) break;
        t_prev = tp;
      }
      const float w = alpha * t_prev;
#pragma unroll
      for (int j = 0; j < CBM; ++j) {
        if (j < cb) acc[j] += w * sm[(kACOL + j) * K + k];
      }
      const float z = zs[k];
      const float wz = w * z;
      dist += 2.0f * (wz * (1.0f - t_prev) - w * A);
      A += wz;
      if (t_prev > 0.5f) med = z;
      if (!LOG) tp = tp * oma;
    }
    T = (LOG && SOFT) ? T * expf(s1 + s2) : tp;
  }

  float* o = a.out + ((int64_t)t * P + p) * (cb + 3);
#pragma unroll
  for (int j = 0; j < CBM; ++j) {
    if (j < cb) o[j] = acc[j];
  }
  o[cb] = 1.0f - T;
  o[cb + 1] = dist;
  o[cb + 2] = med;
}

template <int CBM, bool SOFT, bool LOG>
__global__ void raster_fwd_2dgs_kernel(const Fwd2Args a) {
  fwd_2dgs_body<CBM, SOFT, LOG>(a);
}

// Tiles above 512 pixels (tile 32: 1024 threads) launch this copy, whose
// bound caps the registers at 64 so that the block fits an SM at every
// channel bound (the wide ones spill; unbounded, CB 40 and 128 failed to
// launch at tile 32). Smaller tiles keep the unbounded kernel: this copy
// alone, at every tile, ran the 1M-surfel scene's forward (tile 16, CB 7)
// 5% slower on an H100 at 700 W, 2.39 against 2.27 ms, and its log branch
// 3% slower: the bound moves the CB 8 builds from 48-56 registers to 58-62.
template <int CBM, bool SOFT, bool LOG>
__global__ void __launch_bounds__(1024)
    raster_fwd_2dgs_kernel_1024(const Fwd2Args a) {
  fwd_2dgs_body<CBM, SOFT, LOG>(a);
}

template <int CBM>
cudaError_t launch(const Fwd2Args& a, bool soft, bool log, int n_tiles,
                   cudaStream_t stream) {
  const int threads = a.tile_size * a.tile_size;
  const size_t smem = (size_t)(kACOL + a.cb) * K * sizeof(float);
  auto kernel =
      threads > 512
          ? (log ? (soft ? raster_fwd_2dgs_kernel_1024<CBM, true, true>
                         : raster_fwd_2dgs_kernel_1024<CBM, false, true>)
                 : (soft ? raster_fwd_2dgs_kernel_1024<CBM, true, false>
                         : raster_fwd_2dgs_kernel_1024<CBM, false, false>))
          : (log ? (soft ? raster_fwd_2dgs_kernel<CBM, true, true>
                         : raster_fwd_2dgs_kernel<CBM, false, true>)
                 : (soft ? raster_fwd_2dgs_kernel<CBM, true, false>
                         : raster_fwd_2dgs_kernel<CBM, false, false>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gsc_raster_fwd_2dgs(const void* S, long long cap,
                                   const void* starts, const void* masks,
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
  const Fwd2Args a{static_cast<const float*>(S), (int64_t)cap,
                   static_cast<const int*>(starts),
                   static_cast<const int*>(masks), tile_width, tile_height,
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
