// B11: the compositing skeleton of profiling/kernel_skel_bench.py, a
// microbenchmark of the tile walk: attribute-major rows [16, cap], each
// tile a run [starts[t], ends[t]) walked in the absolute 128-column
// windows that hold it, soft compositing, a per-tile stop at chunk
// granularity.
//
// Replaces profiling/kernel_skel_bench.py:kernel / run (:65-145), the
// closures inside main(). Semantics kept:
//   * chunks c from start / 128 to ceil(end / 128); before each the block
//     votes whether any of its 256 pixels still has T > 1e-4;
//   * columns outside [start, end) of a chunk are masked;
//   * pixel p sits at (p % 16, p / 16): no tile offset, no + 0.5;
//   * sigma = (0.5 a) dx^2 + (0.5 c) dy^2 + b dx dy, alpha =
//     min(0.999, op exp(-sigma)), valid when sigma >= 0 and
//     alpha >= 1/255; every valid pair composites (soft);
//   * out [T, 256, 3]: the colour rows 6-8 weighted by alpha * T_prev.
// Rows 9-15 of the table are never read.
//
// Bound on the H100: operations (about 24 float32 operations for each
// (pair, pixel) of the walked columns); the bytes are the 9 rows of the
// walked columns, read once. Design: one block per tile, one thread per
// pixel, each chunk's 9 rows staged in shared memory by coalesced loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 128;
constexpr int P = 256;
constexpr int CH = 3;
constexpr int ROWS = 9;  // x, y, a, b, c, op, three colours
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;

__global__ void skel_composite_kernel(const float* rows, int64_t cap,
                                      const int* starts, const int* ends,
                                      float* out) {
  __shared__ float sm[ROWS * K];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int off = starts[t];
  const int end = ends[t];
  const int c0 = off / K;
  const int c1 = (end + K - 1) / K;
  const float px = (float)(p % 16);
  const float py = (float)(p / 16);
  float T = 1.0f;
  float acc[CH] = {0.0f, 0.0f, 0.0f};
  for (int c = c0; c < c1; ++c) {
    if (!__syncthreads_or(T > kTransmittanceEps)) break;
    for (int i = p; i < ROWS * K; i += P) {
      sm[i] = rows[(int64_t)(i / K) * cap + (int64_t)c * K + i % K];
    }
    __syncthreads();
    const int lo = max(off - c * K, 0);
    const int hi = min(end - c * K, K);
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
      const float w = alpha * T;
#pragma unroll
      for (int j = 0; j < CH; ++j) acc[j] += w * sm[(6 + j) * K + k];
      T = T * (1.0f - alpha);
    }
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) out[((int64_t)t * P + p) * CH + j] = acc[j];
}

}  // namespace

// rows: [16, cap] float32; starts, ends: [n_tiles] int32; out:
// [n_tiles, 256, 3] float32.
extern "C" int gsc_skel_composite(const void* rows, long long cap,
                                  const void* starts, const void* ends,
                                  int n_tiles, void* out, void* stream) {
  if (n_tiles < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  skel_composite_kernel<<<n_tiles, P, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(rows), (int64_t)cap,
      static_cast<const int*>(starts), static_cast<const int*>(ends),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
