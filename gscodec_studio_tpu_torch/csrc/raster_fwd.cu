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
// Bound on the H100: operations. Each pixel evaluates sigma and alpha (~15
// float32 operations, one exp) for every pair of its run up to its cutoff,
// and composites (2*CH + 4 more) the pairs that pass the alpha test, while
// the table is read once per tile. Design: one block per tile, one thread per pixel; each 128-row chunk
// of the (6 + CH) attribute rows is staged through shared memory once and
// read by all the tile's pixels as broadcasts. Accumulators live in
// registers (the channel count is a template bound, CH <= 32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 128;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;

struct FwdArgs {
  const float* S;  // [>= 6 + ch, cap] sorted attribute rows
  int64_t cap;
  const int* starts;  // [n_tiles + 2] first row of each tile's run
  const int* masks;  // [n_tiles] 0 disables a tile
  int tile_width, tile_height, tile_size, ch;
  float* out;  // [n_tiles, tile_size^2, ch + 1]
};

template <int CHM, bool SOFT>
__global__ void raster_fwd_kernel(const FwdArgs a) {
  extern __shared__ float sm[];  // [(6 + ch) * K]
  const int t = blockIdx.x;
  const int ts = a.tile_size;
  const int P = ts * ts;
  const int p = threadIdx.x;
  const int off = a.starts[t];
  const int end = a.starts[t + 1];
  const int c0 = off / K;
  const int c1 = (end > off && a.masks[t] > 0) ? (end + K - 1) / K : c0;
  const int rem = t % (a.tile_width * a.tile_height);
  const int ty = rem / a.tile_width;
  const int tx = rem % a.tile_width;
  const float px = (float)(tx * ts + p % ts) + 0.5f;
  const float py = (float)(ty * ts + p / ts) + 0.5f;
  const int ch = a.ch;
  const int nrows = 6 + ch;

  float T = 1.0f;
  float acc[CHM];
#pragma unroll
  for (int k = 0; k < CHM; ++k) acc[k] = 0.0f;

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
    float tp = T;
    for (int k = lo; k < hi; ++k) {
      const float dx = sm[k] - px;
      const float dy = sm[K + k] - py;
      const float ca = sm[2 * K + k];
      const float cb = sm[3 * K + k];
      const float cc = sm[4 * K + k];
      const float op = sm[5 * K + k];
      const float sigma =
          (0.5f * ca) * (dx * dx) + (0.5f * cc) * (dy * dy) + cb * (dx * dy);
      const float alpha = fminf(kMaxAlpha, op * expf(-sigma));
      if (!(sigma >= 0.0f && alpha >= kAlphaThreshold)) continue;
      const float oma = 1.0f - alpha;
      if (!SOFT && !(tp * oma > kTransmittanceEps)) break;
      const float w = alpha * tp;
#pragma unroll
      for (int j = 0; j < CHM; ++j) {
        if (j < ch) acc[j] += w * sm[(6 + j) * K + k];
      }
      tp = tp * oma;
    }
    T = tp;
  }

  float* o = a.out + ((int64_t)t * P + p) * (ch + 1);
#pragma unroll
  for (int j = 0; j < CHM; ++j) {
    if (j < ch) o[j] = acc[j];
  }
  o[ch] = 1.0f - T;
}

template <int CHM>
cudaError_t launch(const FwdArgs& a, bool soft, int n_tiles,
                   cudaStream_t stream) {
  const int threads = a.tile_size * a.tile_size;
  const size_t smem = (size_t)(6 + a.ch) * K * sizeof(float);
  if (soft) {
    raster_fwd_kernel<CHM, true><<<n_tiles, threads, smem, stream>>>(a);
  } else {
    raster_fwd_kernel<CHM, false><<<n_tiles, threads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int gsc_raster_fwd(const void* S, long long cap, const void* starts,
                              const void* masks, int n_tiles, int tile_width,
                              int tile_height, int tile_size, int ch, int soft,
                              void* out, void* stream) {
  const int P = tile_size * tile_size;
  if (ch < 1 || ch > 32 || P < 1 || P > 1024 || n_tiles < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return (int)cudaGetLastError();
  const FwdArgs a{static_cast<const float*>(S), (int64_t)cap,
                  static_cast<const int*>(starts),
                  static_cast<const int*>(masks), tile_width, tile_height,
                  tile_size, ch, static_cast<float*>(out)};
  cudaStream_t st = (cudaStream_t)stream;
  const bool sf = soft != 0;
  if (ch <= 1) return (int)launch<1>(a, sf, n_tiles, st);
  if (ch <= 2) return (int)launch<2>(a, sf, n_tiles, st);
  if (ch <= 3) return (int)launch<3>(a, sf, n_tiles, st);
  if (ch <= 4) return (int)launch<4>(a, sf, n_tiles, st);
  if (ch <= 8) return (int)launch<8>(a, sf, n_tiles, st);
  if (ch <= 16) return (int)launch<16>(a, sf, n_tiles, st);
  return (int)launch<32>(a, sf, n_tiles, st);
}
