// B8: the legacy v1 tile backward (rasterizer="pallas"): per aligned row
// of the intersection table, the gradient of the loss with respect to
// that row's attributes, summed over its tile's pixels.
//
// Replaces gscodec_studio_tpu/ops/rasterize_pallas.py:_bwd_kernel /
// _run_bwd (:281-387). The TPU kernel's grid walks the chunks in order
// and carries (T, q) in scratch; here one block owns one tile and replays
// the forward's walk (csrc/raster_v1_fwd.cu) itself. Semantics kept:
//   * the same chunks (the per-chunk, per-tile stop vote on T > 1e-4 over
//     all P pixels), the same pair math and the same exact/soft cutoff;
//   * carried per pixel: T and q, the suffix colour term, from q_init =
//     sum_ch C_total * v_c (the JAX package's prepass, computed by the
//     wrapper; C_total is the colour before the background);
//     T_final = 1 - the forward's alpha, read, not recomputed;
//   * per (pair, pixel), for a pair the pixel composites (every valid
//     pair in "soft", those before the pixel's cutoff in "exact"):
//     G = sum_ch colour * v_c, q -= w * G,
//     v_alpha = T_prev * G - q / (1 - alpha) + v_a * T_final / (1 - alpha),
//     v_sig = -alpha * v_alpha, both gradient terms of sigma zero where
//     alpha was clamped at 0.999; the pairs a pixel does not composite
//     add nothing (their JAX terms are zero);
//   * row k of v_packed [cap2, 6 + ch]: sum over the tile's pixels of
//     v_sig (a dx + b dy), v_sig (c dy + b dx), v_sig dx^2 / 2,
//     v_sig dx dy, v_sig dy^2 / 2, v_alpha exp(-sigma), and w * v_c per
//     channel;
//   * every row the kernel does not compute reads 0: dead chunks, the
//     alignment padding and the chunks of no tile keep the caller's zeros.
//
// Bound on the H100: operations. Each pixel re-evaluates the forward's
// pairs and, for each pair it composites, ~3*ch + 25 more operations of
// gradient arithmetic; the per-row sums over the tile's pixels are
// 6 + ch values per composited pair. Design: one block per tile, one
// thread per pixel (rounded up to whole warps), each chunk's rows staged
// in shared memory. The pixel sums are deterministic and free of atomics:
// for each pair a warp reduces its 32 pixels with shuffles in a fixed tree
// (skipped when no lane of the warp composited the pair), lane 0 stores
// the warp's partial in shared memory, and after every `sub` pairs (32,
// halved on the host until the partials fit the block's shared memory)
// the block adds the partials in warp order and writes whole rows. Two
// runs give the same bits. The cotangent's channels live in registers
// under a template bound (1, 2, 3, 4, 8, 16, 32, 64 or 128), so ch <= 128.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 128;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;
constexpr unsigned kFull = 0xffffffffu;

struct BwdArgs {
  const float* packed;  // [cap2, 6 + ch]
  const int* starts;  // [n_tiles] aligned start of each run
  const int* ends;  // [n_tiles] true end of each run
  const float* v_colors;  // [n_tiles, ch, P]
  const float* v_alphas;  // [n_tiles, P]
  const float* alphas;  // [n_tiles, P] the forward's
  const float* q_init;  // [n_tiles, P]
  int tile_width, tile_height, tile_size, ch, sub;
  float* out;  // [cap2, 6 + ch], zero-filled
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

template <int CHM, bool SOFT, int MAXT>
__global__ void __launch_bounds__(MAXT)
    raster_v1_bwd_kernel(const BwdArgs a) {
  extern __shared__ float sm[];
  const int ch = a.ch;
  const int d = 6 + ch;
  const int sub = a.sub;
  float* chunk = sm;  // [K, d]
  float* part = sm + K * d;  // [n_warps, d, sub]

  const int t = blockIdx.x;
  const int ts = a.tile_size;
  const int P = ts * ts;
  const int p = threadIdx.x;
  const bool pix = p < P;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int n_warps = blockDim.x >> 5;
  const int start = a.starts[t];
  const int end = a.ends[t];
  const int n_chunks = end > start ? (end - start + K - 1) / K : 0;
  const int rem = t % (a.tile_width * a.tile_height);
  const float px = (float)((rem % a.tile_width) * ts + p % ts) + 0.5f;
  const float py = (float)((rem / a.tile_width) * ts + p / ts) + 0.5f;

  float vc[CHM];
  float q = 0.0f, va_tf = 0.0f;
#pragma unroll
  for (int j = 0; j < CHM; ++j) vc[j] = 0.0f;
  if (pix) {
    const int64_t tp0 = (int64_t)t * P + p;
#pragma unroll
    for (int j = 0; j < CHM; ++j) {
      if (j < ch) vc[j] = a.v_colors[((int64_t)t * ch + j) * P + p];
    }
    q = a.q_init[tp0];
    va_tf = a.v_alphas[tp0] * (1.0f - a.alphas[tp0]);
  }
  float T = pix ? 1.0f : 0.0f;

  for (int c = 0; c < n_chunks; ++c) {
    if (!__syncthreads_or(T > kTransmittanceEps)) break;
    const int row0 = start + c * K;
    const float* src = a.packed + (int64_t)row0 * d;
    for (int i = p; i < K * d; i += blockDim.x) chunk[i] = src[i];
    __syncthreads();
    const int hi = min(end - row0, K);  // rows past it are padding
    float tp = T;
    bool live = pix;  // exact: the pixel takes pairs until its cutoff
    for (int s0 = 0; s0 < hi; s0 += sub) {
      const int n_sub = min(sub, hi - s0);
      for (int kk = 0; kk < n_sub; ++kk) {
        const float* g = chunk + (s0 + kk) * d;
        float gx = 0.0f, gy = 0.0f, ga = 0.0f, gb = 0.0f, gc = 0.0f;
        float go = 0.0f;  // v_alpha * exp(-sigma): the opacity row
        float gw = 0.0f;  // the pair's weight: its colour rows are gw * vc
        bool hit = false;
        if (live) {
          const float dx = g[0] - px;
          const float dy = g[1] - py;
          const float ca = g[2];
          const float cb = g[3];
          const float cc = g[4];
          const float op = g[5];
          const float sigma =
              0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
          const float e = expf(-sigma);
          const float alpha_raw = op * e;
          const float alpha = fminf(kMaxAlpha, alpha_raw);
          if (sigma >= 0.0f && alpha >= kAlphaThreshold) {
            const float oma = 1.0f - alpha;
            const float t_incl = tp * oma;
            if (!SOFT && !(t_incl > kTransmittanceEps)) {
              live = false;
            } else {
              const float w = alpha * tp;
              float G = 0.0f;
#pragma unroll
              for (int j = 0; j < CHM; ++j) {
                if (j < ch) G += g[6 + j] * vc[j];
              }
              q = q - w * G;  // the suffix term after this pair
              const float inv_oma = 1.0f / oma;
              const float v_alpha = tp * G - q * inv_oma + va_tf * inv_oma;
              if (!(alpha_raw > kMaxAlpha)) {
                const float v_sig = -alpha * v_alpha;
                gx = v_sig * (ca * dx + cb * dy);
                gy = v_sig * (cc * dy + cb * dx);
                ga = v_sig * 0.5f * dx * dx;
                gb = v_sig * dx * dy;
                gc = v_sig * 0.5f * dy * dy;
                go = v_alpha * e;
              }
              gw = w;
              tp = t_incl;
              hit = true;
            }
          }
        }
        float* pw = part + (warp * d) * sub + kk;  // row r at pw[r * sub]
        if (__any_sync(kFull, hit)) {
          const float v0 = warp_sum(gx);
          const float v1 = warp_sum(gy);
          const float v2 = warp_sum(ga);
          const float v3 = warp_sum(gb);
          const float v4 = warp_sum(gc);
          const float v5 = warp_sum(go);
          if (lane == 0) {
            pw[0] = v0;
            pw[sub] = v1;
            pw[2 * sub] = v2;
            pw[3 * sub] = v3;
            pw[4 * sub] = v4;
            pw[5 * sub] = v5;
          }
#pragma unroll
          for (int j = 0; j < CHM; ++j) {
            if (j < ch) {
              const float v = warp_sum(gw * vc[j]);
              if (lane == 0) pw[(6 + j) * sub] = v;
            }
          }
        } else if (lane == 0) {
          for (int r = 0; r < d; ++r) pw[r * sub] = 0.0f;
        }
      }
      __syncthreads();
      // whole rows: consecutive threads write consecutive words of a row
      for (int i = p; i < n_sub * d; i += blockDim.x) {
        const int kk = i / d;
        const int r = i % d;
        float v = 0.0f;
        for (int w = 0; w < n_warps; ++w) v += part[(w * d + r) * sub + kk];
        a.out[(int64_t)(row0 + s0 + kk) * d + r] = v;
      }
      __syncthreads();
    }
    T = tp;
  }
}

template <int CHM>
cudaError_t launch(const BwdArgs& a, bool soft, int n_tiles,
                   cudaStream_t stream) {
  const int P = a.tile_size * a.tile_size;
  const int threads = (P + 31) / 32 * 32;
  const int d = 6 + a.ch;
  const size_t smem =
      ((size_t)d * K + (size_t)(threads / 32) * d * a.sub) * sizeof(float);
  // 1024 threads (tiles above 16) leave a thread 64 registers: the wide
  // instantiations spill there rather than fail to launch
  auto kernel = threads > 256
                    ? (soft ? raster_v1_bwd_kernel<CHM, true, 1024>
                            : raster_v1_bwd_kernel<CHM, false, 1024>)
                    : (soft ? raster_v1_bwd_kernel<CHM, true, 256>
                            : raster_v1_bwd_kernel<CHM, false, 256>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gsc_raster_v1_bwd(const void* packed, const void* starts,
                                 const void* ends, const void* v_colors,
                                 const void* v_alphas, const void* alphas,
                                 const void* q_init, int n_tiles,
                                 int tile_width, int tile_height,
                                 int tile_size, int ch, int soft, int sub,
                                 void* out, void* stream) {
  const int P = tile_size * tile_size;
  if (ch < 1 || ch > 128 || P < 1 || P > 1024 || n_tiles < 0 || sub < 1 ||
      sub > 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return (int)cudaGetLastError();
  const BwdArgs a{static_cast<const float*>(packed),
                  static_cast<const int*>(starts),
                  static_cast<const int*>(ends),
                  static_cast<const float*>(v_colors),
                  static_cast<const float*>(v_alphas),
                  static_cast<const float*>(alphas),
                  static_cast<const float*>(q_init),
                  tile_width,
                  tile_height,
                  tile_size,
                  ch,
                  sub,
                  static_cast<float*>(out)};
  cudaStream_t st = (cudaStream_t)stream;
  const bool sf = soft != 0;
  if (ch <= 1) return (int)launch<1>(a, sf, n_tiles, st);
  if (ch <= 2) return (int)launch<2>(a, sf, n_tiles, st);
  if (ch <= 3) return (int)launch<3>(a, sf, n_tiles, st);
  if (ch <= 4) return (int)launch<4>(a, sf, n_tiles, st);
  if (ch <= 8) return (int)launch<8>(a, sf, n_tiles, st);
  if (ch <= 16) return (int)launch<16>(a, sf, n_tiles, st);
  if (ch <= 32) return (int)launch<32>(a, sf, n_tiles, st);
  if (ch <= 64) return (int)launch<64>(a, sf, n_tiles, st);
  return (int)launch<128>(a, sf, n_tiles, st);
}
