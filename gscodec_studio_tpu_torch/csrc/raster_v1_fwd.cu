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
// (~15 float32 operations, one exp) for every pair of its tile's live
// chunks up to its cutoff, and composites (2*ch + 4 more) the pairs that
// pass, while the table is read once per tile. Design: one block per tile,
// one thread per pixel; each chunk's [128, 6 + ch] rows are one contiguous
// block of the table, staged in shared memory by coalesced loads and read
// by all pixels as broadcasts. The colour accumulators live in registers
// under a template bound (1, 2, 3, 4, 8, 16, 32, 64 or 128), so ch <= 128.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 128;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;

struct FwdArgs {
  const float* packed;  // [cap2, 6 + ch]
  const int* starts;  // [n_tiles] aligned start of each run
  const int* ends;  // [n_tiles] true end of each run
  int tile_width, tile_height, tile_size, ch;
  float* colors;  // [n_tiles, ch, P]
  float* alphas;  // [n_tiles, P]
};

template <int CHM, bool SOFT, int MAXT>
__global__ void __launch_bounds__(MAXT)
    raster_v1_fwd_kernel(const FwdArgs a) {
  extern __shared__ float sm[];  // [K, 6 + ch]
  const int t = blockIdx.x;
  const int ts = a.tile_size;
  const int P = ts * ts;
  const int p = threadIdx.x;
  const int ch = a.ch;
  const int d = 6 + ch;
  const int start = a.starts[t];
  const int end = a.ends[t];
  const int n_chunks = end > start ? (end - start + K - 1) / K : 0;
  const int rem = t % (a.tile_width * a.tile_height);
  const float px = (float)((rem % a.tile_width) * ts + p % ts) + 0.5f;
  const float py = (float)((rem / a.tile_width) * ts + p / ts) + 0.5f;

  float T = 1.0f;
  float acc[CHM];
#pragma unroll
  for (int j = 0; j < CHM; ++j) acc[j] = 0.0f;

  for (int c = 0; c < n_chunks; ++c) {
    // the tile's stop vote; also the barrier before the chunk is restaged
    if (!__syncthreads_or(T > kTransmittanceEps)) break;
    const int row0 = start + c * K;
    const float* src = a.packed + (int64_t)row0 * d;
    for (int i = p; i < K * d; i += P) sm[i] = src[i];
    __syncthreads();
    const int hi = min(end - row0, K);  // rows past it are padding
    float tp = T;
    for (int k = 0; k < hi; ++k) {
      const float* g = sm + k * d;
      const float dx = g[0] - px;
      const float dy = g[1] - py;
      const float ca = g[2];
      const float cb = g[3];
      const float cc = g[4];
      const float op = g[5];
      const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
      const float alpha = fminf(kMaxAlpha, op * expf(-sigma));
      if (!(sigma >= 0.0f && alpha >= kAlphaThreshold)) continue;
      const float oma = 1.0f - alpha;
      if (!SOFT && !(tp * oma > kTransmittanceEps)) break;
      const float w = alpha * tp;
#pragma unroll
      for (int j = 0; j < CHM; ++j) {
        if (j < ch) acc[j] += w * g[6 + j];
      }
      tp = tp * oma;
    }
    T = tp;
  }

#pragma unroll
  for (int j = 0; j < CHM; ++j) {
    if (j < ch) a.colors[((int64_t)t * ch + j) * P + p] = acc[j];
  }
  a.alphas[(int64_t)t * P + p] = 1.0f - T;
}

template <int CHM>
cudaError_t launch(const FwdArgs& a, bool soft, int n_tiles,
                   cudaStream_t stream) {
  const int threads = a.tile_size * a.tile_size;
  const size_t smem = (size_t)(6 + a.ch) * K * sizeof(float);
  // 1024 threads (tiles above 16) leave a thread 64 registers: the wide
  // instantiations spill there rather than fail to launch
  auto kernel = threads > 256
                    ? (soft ? raster_v1_fwd_kernel<CHM, true, 1024>
                            : raster_v1_fwd_kernel<CHM, false, 1024>)
                    : (soft ? raster_v1_fwd_kernel<CHM, true, 256>
                            : raster_v1_fwd_kernel<CHM, false, 256>);
  // above 48 KB (ch > 90) only as opted-in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gsc_raster_v1_fwd(const void* packed, const void* starts,
                                 const void* ends, int n_tiles,
                                 int tile_width, int tile_height,
                                 int tile_size, int ch, int soft,
                                 void* colors, void* alphas, void* stream) {
  const int P = tile_size * tile_size;
  if (ch < 1 || ch > 128 || P < 1 || P > 1024 || n_tiles < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return (int)cudaGetLastError();
  const FwdArgs a{static_cast<const float*>(packed),
                  static_cast<const int*>(starts),
                  static_cast<const int*>(ends),
                  tile_width,
                  tile_height,
                  tile_size,
                  ch,
                  static_cast<float*>(colors),
                  static_cast<float*>(alphas)};
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
