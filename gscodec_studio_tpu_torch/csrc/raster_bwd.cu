// Tile backward: per-intersection gradients of the front-to-back
// compositing, recomputed tile by tile from the sorted intersection table.
//
// Replaces gscodec_studio_tpu/ops/raster_v2.py:_bwd_kernel / _run_bwd.
// Semantics are the JAX package's, pair for pair:
//   * the walk is the forward's (csrc/raster_fwd.cu): the absolute 128-row
//     windows of the sorted list from off / 128, rows in [off, end), the
//     same sigma, alpha, alpha test and exact/soft cutoff;
//   * carried per pixel: T and the suffix colour term s = q - prefix(w*G),
//     q0 = sum_ch c_out[ch] * v_c[ch], G = sum_ch color[ch] * v_c[ch]; the
//     tile loop stops once every pixel has T <= 1e-4 (a block-wide vote at
//     each chunk, in both modes, as the JAX loop's condition);
//   * per (pair, pixel): v_alpha = T_prev*G - s/(1-alpha)
//     + v_a*T_final/(1-alpha), zero past the exact cutoff;
//     v_sig = -alpha*v_alpha, zero where alpha was clamped at 0.999;
//   * per intersection, summed over the tile's pixels: the five geometry
//     rows, the opacity row as -sum(v_sig)/op (0 where op <= 0), CH colour
//     rows sum(w*v_c), and with absgrad two rows of sum|per-pixel xy term|.
// Output layout (the port's own, not the JAX per-(tile, chunk) slots): row
// r of the gradient of S's column j is out[r * cap + j]. Each column of S
// belongs to one tile, so a block writes only its own columns; columns no
// tile reaches stay at the caller's zeros.
//
// Bound on the H100: operations. Each pixel re-evaluates the forward's
// pairs and, for each pair it composites, ~3*CH + 25 more operations of
// gradient arithmetic; the per-intersection sums over the tile's pixels
// are d_g values per composited pair. Design: one block per tile, one
// thread per pixel (rounded up to whole warps), each 128-row chunk of S
// staged in shared memory. The pixel sums are deterministic and free of
// atomics: for each pair a warp reduces its 32 pixels with shuffles in a
// fixed tree (skipped when no lane of the warp touched the pair), lane 0
// stores the warp's partial in shared memory, and after every 32 pairs the
// block adds the partials in warp order and writes whole rows of columns.
// The cotangent's channels live in registers under a template bound (1, 2,
// 3, 4, 8, 16, 32, 64 or 128), so CH <= 128.
//
// Packed-pair branch (``packed``; replaces raster_v2.py:_write_grad_rows
// with cfg.grad_packed, and _pack_pair): the gradient rows are stored as
// 32-bit words holding two truncated-bf16 values, (row 2i in the high
// half | row 2i + 1 in the low half); an odd last attribute row pairs with
// 0, and with absgrad one (|x|, |y|) word follows: ceil((6 + ch) / 2)
// (+ 1) rows of words. The pack happens only at the final write, after the
// block has added its warp partials in warp order, so each half is the f32
// branch's value with its low 16 bits cut. The truncation is integer
// masking and shifting (u & 0xFFFF0000, u >> 16): __float2bfloat16 rounds
// to nearest even and would give other bits. The words are stored as
// integers; no float operation touches them.
//
// Precision branches of the inputs (replace the `cfg.attr_packed`,
// `cfg.geom_packed` and `cfg.log_composite` paths of _bwd_kernel: the
// readers :766-813 and _composite_log at :1131-1136), the forward's
// (csrc/raster_fwd.cu): packed rows of S are unpacked into the f32 layout
// as the chunk is staged (runtime), and LOG (template) walks the log-space
// scan, T_prev = T * exp(incl - l) in v_alpha and the weight, the exact
// cutoff on T * exp(incl). They compose with the packed-pair output. The
// gradients are those of the unpacked values, and reach the f32 inputs
// unchanged, as the JAX custom VJP sends them. The f32, product branch is
// the code it was.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

constexpr int K = 128;
constexpr int SUB = 32;  // pairs whose warp partials are staged at once
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;
constexpr unsigned kFull = 0xffffffffu;

struct BwdArgs {
  const float* S;  // [>= n_srows, cap] sorted attribute rows
  int64_t cap;
  const int* starts;  // [n_tiles + 2] first row of each tile's run
  const int* masks;  // [n_tiles] 0 disables a tile
  const float* tiles;  // [n_tiles, P, ch + 1] forward outputs
  const float* v_tiles;  // [n_tiles, P, ch + 1] their cotangents
  int tile_width, tile_height, tile_size, ch, d_g, absgrad, packed;
  int geom_packed, attr_packed;
  float* out;  // [d_g, cap] (packed: uint32 [d_gp, cap]), zero-filled
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// The block's sum of value row r's warp partials for pair slot kk (the
// pair at chunk position k), in warp order; the opacity row (5) becomes
// -sum / op, 0 where op <= 0.
__device__ __forceinline__ float block_sum(const float* part, int n_warps,
                                           int d_g, int r, int kk,
                                           const float* chunk, int k) {
  float v = 0.0f;
  for (int w = 0; w < n_warps; ++w) v += part[(w * d_g + r) * SUB + kk];
  if (r == 5) {
    const float op = chunk[5 * K + k];
    v = op > 0.0f ? -v / op : 0.0f;
  }
  return v;
}

template <int CHM, bool SOFT, bool LOG>
__global__ void raster_bwd_kernel(const BwdArgs a) {
  extern __shared__ float sm[];
  const int ch = a.ch;
  const int d_g = a.d_g;
  float* chunk = sm;  // [(6 + ch) * K]
  float* part = sm + (6 + ch) * K;  // [n_warps, d_g, SUB]

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

  float vc[CHM];
  float q = 0.0f, v_a = 0.0f, t_final = 1.0f;
#pragma unroll
  for (int j = 0; j < CHM; ++j) vc[j] = 0.0f;
  if (pix) {
    const int64_t base = ((int64_t)t * P + p) * (ch + 1);
#pragma unroll
    for (int j = 0; j < CHM; ++j) {
      if (j < ch) {
        vc[j] = a.v_tiles[base + j];
        q += a.tiles[base + j] * vc[j];
      }
    }
    v_a = a.v_tiles[base + ch];
    t_final = 1.0f - a.tiles[base + ch];
  }
  const float va_tf = v_a * t_final;
  float T = pix ? 1.0f : 0.0f;

  for (int c = c0; c < c1; ++c) {
    if (!__syncthreads_or(T > kTransmittanceEps)) break;
    const int64_t col0 = (int64_t)c * K;
    gsc::stage_chunk_3dgs(chunk, a.S, a.cap, col0, ch, a.geom_packed,
                          a.attr_packed, p, blockDim.x);
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
        float gx = 0.0f, gy = 0.0f, ga = 0.0f, gb = 0.0f, gc = 0.0f;
        float gs = 0.0f;
        float gw = 0.0f;  // the pair's weight: its colour rows are gw * vc
        bool hit = false;
        if (live) {
          const float dx = chunk[k] - px;
          const float dy = chunk[K + k] - py;
          const float ca = chunk[2 * K + k];
          const float cb = chunk[3 * K + k];
          const float cc = chunk[4 * K + k];
          const float op = chunk[5 * K + k];
          const float sigma = (0.5f * ca) * (dx * dx) +
                              (0.5f * cc) * (dy * dy) + cb * (dx * dy);
          const float alpha_raw = op * expf(-sigma);
          const float alpha = fminf(kMaxAlpha, alpha_raw);
          if (sigma >= 0.0f && alpha >= kAlphaThreshold) {
            const float oma = 1.0f - alpha;
            float t_prev, t_incl;
            if (LOG) {
              float l;
              const float incl = gsc::log_scan_step(alpha, s1, s2, l);
              t_prev = T * expf(incl - l);
              t_incl = SOFT ? 0.0f : T * expf(incl);
            } else {
              t_prev = tp;
              t_incl = tp * oma;
            }
            if (!SOFT && !(t_incl > kTransmittanceEps)) {
              live = false;
            } else {
              const float w = alpha * t_prev;
              float G = 0.0f;
#pragma unroll
              for (int j = 0; j < CHM; ++j) {
                if (j < ch) G += chunk[(6 + j) * K + k] * vc[j];
              }
              q = q - w * G;  // the suffix term after this pair
              const float inv_oma = 1.0f / oma;
              const float v_alpha =
                  t_prev * G - q * inv_oma + va_tf * inv_oma;
              const float v_sig =
                  alpha_raw > kMaxAlpha ? 0.0f : -alpha * v_alpha;
              gx = v_sig * (ca * dx + cb * dy);
              gy = v_sig * (cc * dy + cb * dx);
              ga = v_sig * 0.5f * dx * dx;
              gb = v_sig * dx * dy;
              gc = v_sig * 0.5f * dy * dy;
              gs = v_sig;
              gw = w;
              tp = LOG ? fminf(tp, t_incl) : t_incl;
              hit = true;
            }
          }
        }
        float* pw = part + (warp * d_g) * SUB + kk;  // row r at pw[r*SUB]
        if (__any_sync(kFull, hit)) {
          const float v0 = warp_sum(gx);
          const float v1 = warp_sum(gy);
          const float v2 = warp_sum(ga);
          const float v3 = warp_sum(gb);
          const float v4 = warp_sum(gc);
          const float v5 = warp_sum(gs);
          if (lane == 0) {
            pw[0] = v0;
            pw[SUB] = v1;
            pw[2 * SUB] = v2;
            pw[3 * SUB] = v3;
            pw[4 * SUB] = v4;
            pw[5 * SUB] = v5;
          }
#pragma unroll
          for (int j = 0; j < CHM; ++j) {
            if (j < ch) {
              const float v = warp_sum(gw * vc[j]);
              if (lane == 0) pw[(6 + j) * SUB] = v;
            }
          }
          if (a.absgrad) {
            const float ax = warp_sum(fabsf(gx));
            const float ay = warp_sum(fabsf(gy));
            if (lane == 0) {
              pw[(6 + ch) * SUB] = ax;
              pw[(7 + ch) * SUB] = ay;
            }
          }
        } else if (lane == 0) {
          for (int r = 0; r < d_g; ++r) pw[r * SUB] = 0.0f;
        }
      }
      __syncthreads();
      if (a.packed) {
        // two value rows per word: ra in the high half, rb in the low
        const int n_attr = 6 + ch;
        const int n_vp = (n_attr + 1) / 2;
        const int n_out = n_vp + a.absgrad;
        uint32_t* outw = reinterpret_cast<uint32_t*>(a.out);
        for (int i = p; i < n_out * SUB; i += blockDim.x) {
          const int r = i / SUB;
          const int kk = i % SUB;
          const int k = s0 + kk;
          if (k < lo || k >= hi) continue;
          const int ra = r < n_vp ? 2 * r : n_attr;
          const int rb = r < n_vp ? (2 * r + 1 < n_attr ? 2 * r + 1 : -1)
                                  : n_attr + 1;
          const float va = block_sum(part, n_warps, d_g, ra, kk, chunk, k);
          const float vb =
              rb < 0 ? 0.0f
                     : block_sum(part, n_warps, d_g, rb, kk, chunk, k);
          outw[(int64_t)r * a.cap + col0 + k] = gsc::pack_pair(va, vb);
        }
      } else {
        for (int i = p; i < d_g * SUB; i += blockDim.x) {
          const int r = i / SUB;
          const int k = s0 + i % SUB;
          if (k < lo || k >= hi) continue;
          a.out[(int64_t)r * a.cap + col0 + k] =
              block_sum(part, n_warps, d_g, r, i % SUB, chunk, k);
        }
      }
      __syncthreads();
    }
    T = (LOG && SOFT) ? T * expf(s1 + s2) : tp;
  }
}

template <int CHM>
cudaError_t launch(const BwdArgs& a, bool soft, bool log, int n_tiles,
                   cudaStream_t stream) {
  const int P = a.tile_size * a.tile_size;
  const int threads = (P + 31) / 32 * 32;
  const size_t smem = ((size_t)(6 + a.ch) * K +
                       (size_t)(threads / 32) * a.d_g * SUB) *
                      sizeof(float);
  auto kernel = log ? (soft ? raster_bwd_kernel<CHM, true, true>
                            : raster_bwd_kernel<CHM, false, true>)
                    : (soft ? raster_bwd_kernel<CHM, true, false>
                            : raster_bwd_kernel<CHM, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gsc_raster_bwd(const void* S, long long cap, const void* starts,
                              const void* masks, const void* tiles,
                              const void* v_tiles, int n_tiles,
                              int tile_width, int tile_height, int tile_size,
                              int ch, int soft, int absgrad, int packed,
                              int log_composite, int geom_packed,
                              int attr_packed, void* out, void* stream) {
  const int P = tile_size * tile_size;
  if (ch < 1 || ch > 128 || P < 1 || P > 1024 || n_tiles < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return (int)cudaGetLastError();
  const BwdArgs a{static_cast<const float*>(S),
                  (int64_t)cap,
                  static_cast<const int*>(starts),
                  static_cast<const int*>(masks),
                  static_cast<const float*>(tiles),
                  static_cast<const float*>(v_tiles),
                  tile_width,
                  tile_height,
                  tile_size,
                  ch,
                  6 + ch + (absgrad ? 2 : 0),
                  absgrad ? 1 : 0,
                  packed ? 1 : 0,
                  geom_packed ? 1 : 0,
                  attr_packed ? 1 : 0,
                  static_cast<float*>(out)};
  cudaStream_t st = (cudaStream_t)stream;
  const bool sf = soft != 0;
  const bool lg = log_composite != 0;
  if (ch <= 1) return (int)launch<1>(a, sf, lg, n_tiles, st);
  if (ch <= 2) return (int)launch<2>(a, sf, lg, n_tiles, st);
  if (ch <= 3) return (int)launch<3>(a, sf, lg, n_tiles, st);
  if (ch <= 4) return (int)launch<4>(a, sf, lg, n_tiles, st);
  if (ch <= 8) return (int)launch<8>(a, sf, lg, n_tiles, st);
  if (ch <= 16) return (int)launch<16>(a, sf, lg, n_tiles, st);
  if (ch <= 32) return (int)launch<32>(a, sf, lg, n_tiles, st);
  if (ch <= 64) return (int)launch<64>(a, sf, lg, n_tiles, st);
  return (int)launch<128>(a, sf, lg, n_tiles, st);
}
