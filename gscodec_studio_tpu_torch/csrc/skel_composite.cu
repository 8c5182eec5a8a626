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
// Bound on the H100: operations, the pair math up to the alpha test on
// the (pair, pixel) slots of the (pair, cell)s that the cell test keeps
// and the compositing of the valid ones; the bytes are the 9 rows of the
// walked columns, read once. The first design (one thread a pixel, the
// chunk staged row-major, every pixel evaluating every pair) issued ~40
// instructions a (pair, warp), six of them shared loads, for 8 warps a
// tile, though only 2.6-5.4% of the slots composite. This design:
//   * one block of 128 threads a tile, PPT = 2 pixels a thread, neighbours
//     in one tile row, which share dy and the pair's loads; a warp's 64
//     pixels form an 8 x 8 cell, the cells row-major;
//   * the chunk comes through a ring of two slots in shared memory, filled
//     by cp.async one chunk ahead: thread k copies the 9 values of column
//     k, if it lies in [start, end), straight into the slot's pair-major
//     vectors (x, y, a, b), (c, op, -, r), (g, b) and, once they have
//     arrived, forms in place 0.5 a and 0.5 c (the float products the
//     pixels formed before, so each pixel's bits stay the first design's)
//     and the pair's cell bits. One barrier a chunk, which is also the
//     block's vote: the slot the next copies fill was last read by the
//     walk before it;
//   * the cell test (cell_bits): the range of the quadratic sigma(dx, dy)
//     over each cell's box of dx = x - px, dy = y - py, from its four
//     corners, the edges' critical points and the interior critical point
//     (the origin); a cell is out when the range lies below 0 or above
//     ln(255 op), each side widened by kRangeRel of the terms' magnitude
//     plus kRangeAbs (the float32 range and a pixel's float sigma round
//     within ~4e-7 of that magnitude), and every cell is out where
//     op < 1/255. Standard-normal conics are indefinite about half the
//     time, so this is B11's own test and not the tile kernels'
//     conic_region (regions.cuh), which assumes a positive-definite
//     conic. It keeps ~48% of the (pair, cell)s of the JAX script's
//     inputs. In float32: in double precision it held the kernel at 85
//     registers and ran ~1.4x slower on the H100. Mirrored by
//     kernel_skel_bench._cell_bits;
//   * the walk, B1's (csrc/raster_fwd.cu): the chunk's pairs 32 at a time,
//     lane l reads pair kb + l's cell bit for its warp, and the warp walks
//     the pairs of the ballot in order, two at a time side by side (four
//     independent chains of pair math a thread), with two 16-byte
//     broadcast loads a pair and 8 more bytes for the colours where a
//     pixel composites. A pair that fails the alpha test changes neither
//     T nor the sums, so the skipped pairs change no bit of the output;
//   * 12 blocks an SM (kMinBlocks: 40 registers, a few bytes of spills in
//     the cell test); at the 48 registers the compiler picks alone, 10
//     blocks an SM ran ~3% slower.
// What bounds it now: issue. Two pairs cost a warp ~158 instructions
// (the sm_90a SASS), the expf and the compositing of both pixels
// included, since nearly every kept (pair, cell) holds a valid slot.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int K = 128;
constexpr int P = 256;
constexpr int CH = 3;
constexpr int kThreads = 128;
constexpr int kMinBlocks = 12;  // blocks an SM
constexpr int PPT = 2;  // pixels a thread
constexpr int kCellW = 8;  // a warp's cell: kCellW x kCellH pixels
constexpr int kCellH = 32 * PPT / kCellW;
constexpr int kCellsX = 16 / kCellW;
constexpr int kCellsY = 16 / kCellH;
static_assert(kCellsX * kCellsY * 32 == kThreads, "a warp a cell");
static_assert(kThreads == K, "a thread stages one column");
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;
constexpr unsigned kFull = 0xffffffffu;
// the margins of the cell test (kernel_skel_bench.RANGE_REL, RANGE_ABS,
// LOG_MARGIN): the float32 range and a pixel's float sigma lie within
// ~4e-7 of the magnitude of the terms of the exact sigma, and the float
// alpha test within ~3e-7 of sigma <= ln(255 op)
constexpr float kRangeRel = 1e-4f;
constexpr float kRangeAbs = 1e-4f;
constexpr float kLogMargin = 1e-4f;

struct Slot {
  float4 geo[K];  // x, y, 0.5 a, b
  float4 aux[K];  // 0.5 c, op, -, r
  float2 col[K];  // g, b
  unsigned cells[K];  // bit w: warp w's cell may hold a valid slot
};

__device__ __forceinline__ float quad(float A, float B, float C, float u,
                                      float v) {
  return (A * (u * u) + B * (u * v)) + C * (v * v);
}

__device__ __forceinline__ void take(float q, float& lo, float& hi) {
  lo = fminf(lo, q);
  hi = fmaxf(hi, q);
}

// Which cells' pixels can pass the alpha test for the pair (x, y, A = 0.5
// a, B = b, C = 0.5 c) whose bound on sigma is L = ln(255 op) + kLogMargin
// (-1 where op < 1/255, and then no cell): bit cy * kCellsX + cx.
__device__ __forceinline__ unsigned cell_bits(float X, float Y, float A,
                                              float B, float C, float L) {
  if (!(L >= 0.0f)) return 0u;
  // the edges' critical points: u = kx v on an edge of fixed v, v = ky u
  // on one of fixed u
  const float kx = A != 0.0f ? -B / (2.0f * A) : 0.0f;
  const float ky = C != 0.0f ? -B / (2.0f * C) : 0.0f;
  unsigned bits = 0u;
#pragma unroll
  for (int cy = 0; cy < kCellsY; ++cy) {
    const float v0 = Y - (float)(cy * kCellH + kCellH - 1);
    const float v1 = Y - (float)(cy * kCellH);
#pragma unroll
    for (int cx = 0; cx < kCellsX; ++cx) {
      const float u0 = X - (float)(cx * kCellW + kCellW - 1);
      const float u1 = X - (float)(cx * kCellW);
      float lo = quad(A, B, C, u0, v0), hi = lo;
      take(quad(A, B, C, u0, v1), lo, hi);
      take(quad(A, B, C, u1, v0), lo, hi);
      take(quad(A, B, C, u1, v1), lo, hi);
      if (A != 0.0f) {
        const float s0 = kx * v0, s1 = kx * v1;
        if (s0 >= u0 && s0 <= u1) take(quad(A, B, C, s0, v0), lo, hi);
        if (s1 >= u0 && s1 <= u1) take(quad(A, B, C, s1, v1), lo, hi);
      }
      if (C != 0.0f) {
        const float s0 = ky * u0, s1 = ky * u1;
        if (s0 >= v0 && s0 <= v1) take(quad(A, B, C, u0, s0), lo, hi);
        if (s1 >= v0 && s1 <= v1) take(quad(A, B, C, u1, s1), lo, hi);
      }
      if (u0 <= 0.0f && u1 >= 0.0f && v0 <= 0.0f && v1 >= 0.0f) {
        take(0.0f, lo, hi);
      }
      const float mu = fmaxf(fabsf(u0), fabsf(u1));
      const float mv = fmaxf(fabsf(v0), fabsf(v1));
      const float m = kRangeRel * ((fabsf(A) * (mu * mu) +
                                    fabsf(B) * (mu * mv)) +
                                   fabsf(C) * (mv * mv)) +
                      kRangeAbs;
      if (!(hi < -m) && !(lo > L + m)) bits |= 1u << (cy * kCellsX + cx);
    }
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    skel_composite_kernel(const float* rows, int64_t cap, const int* starts,
                          const int* ends, float* out) {
  __shared__ Slot ring[2];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int off = starts[t];
  const int end = ends[t];
  const int c0 = off / K;
  const int c1 = (end + K - 1) / K;

  // the thread's pixels: PPT neighbours of tile row prow, in the warp's
  // cell (kCellW / PPT threads a cell row)
  constexpr int CT = kCellW / PPT;
  const int prow = (warp / kCellsX) * kCellH + lane / CT;
  const int pcol = (warp % kCellsX) * kCellW + (lane % CT) * PPT;
  const float py = (float)prow;
  float px[PPT], T[PPT], acc[PPT][CH];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    px[i] = (float)(pcol + i);
    T[i] = 1.0f;
#pragma unroll
    for (int j = 0; j < CH; ++j) acc[i][j] = 0.0f;
  }

  // thread tid copies column tid of chunk c, if it lies in [off, end)
  auto issue = [&](int c, Slot& s) {
    const int64_t col = (int64_t)c * K + tid;
    if (col >= off && col < end) {
      const float* src = rows + col;
      float* g = reinterpret_cast<float*>(&s.geo[tid]);
      float* u = reinterpret_cast<float*>(&s.aux[tid]);
      float* cl = reinterpret_cast<float*>(&s.col[tid]);
      __pipeline_memcpy_async(g + 0, src, 4);
      __pipeline_memcpy_async(g + 1, src + cap, 4);
      __pipeline_memcpy_async(g + 2, src + 2 * cap, 4);
      __pipeline_memcpy_async(g + 3, src + 3 * cap, 4);
      __pipeline_memcpy_async(u + 0, src + 4 * cap, 4);
      __pipeline_memcpy_async(u + 1, src + 5 * cap, 4);
      __pipeline_memcpy_async(u + 3, src + 6 * cap, 4);
      __pipeline_memcpy_async(cl + 0, src + 7 * cap, 4);
      __pipeline_memcpy_async(cl + 1, src + 8 * cap, 4);
    }
    __pipeline_commit();
  };

  if (c0 < c1) issue(c0, ring[0]);
  for (int c = c0; c < c1; ++c) {
    Slot& s = ring[(c - c0) & 1];
    const int lo = max(off - c * K, 0);
    const int hi = min(end - c * K, K);
    // the thread's own column has arrived: form what the walk reads
    __pipeline_wait_prior(0);
    unsigned bits = 0u;
    if (tid >= lo && tid < hi) {
      const float4 g = s.geo[tid];
      const float4 u = s.aux[tid];
      const float ha = 0.5f * g.z, hc = 0.5f * u.x;
      s.geo[tid].z = ha;
      s.aux[tid].x = hc;
      const float L =
          u.y >= kAlphaThreshold ? logf(255.0f * u.y) + kLogMargin : -1.0f;
      bits = cell_bits(g.x, g.y, ha, g.w, hc, L);
    }
    s.cells[tid] = bits;
    bool busy = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) busy |= T[i] > kTransmittanceEps;
    // the vote, and the slot's values visible to every warp; the other
    // slot's last reader (the walk of chunk c - 1) is done
    if (!__syncthreads_or(busy)) break;
    if (c + 1 < c1) issue(c + 1, ring[(c + 1 - c0) & 1]);

    // the pairs 32 at a time: lane l reads pair kb + l's bit for this
    // warp's cell, and the warp walks the pairs of the ballot in order
    for (int kb = lo & ~31; kb < hi; kb += 32) {
      unsigned pending =
          __ballot_sync(kFull, (s.cells[kb + lane] >> warp) & 1u);
      while (pending != 0u) {
        // two pairs at a time, side by side: ka, then kc (ka again, and
        // not valid, when the ballot has one left)
        const int ka = kb + __ffs(pending) - 1;
        pending &= pending - 1u;
        const bool two = pending != 0u;
        const int kc = two ? kb + __ffs(pending) - 1 : ka;
        if (two) pending &= pending - 1u;
        const int kk[2] = {ka, kc};
        float4 g[2], u[2];
        float sigma[2][PPT];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          g[q] = s.geo[kk[q]];
          u[q] = s.aux[kk[q]];
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float dy = g[q].y - py;
          const float cdy = u[q].x * (dy * dy);
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            const float dx = g[q].x - px[i];
            sigma[q][i] = g[q].z * (dx * dx) + cdy + g[q].w * (dx * dy);
          }
        }
        float alpha[2][PPT];
        bool valid[2][PPT];
        bool any_valid = false;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            alpha[q][i] = fminf(kMaxAlpha, u[q].y * expf(-sigma[q][i]));
            valid[q][i] = (q == 0 || two) && sigma[q][i] >= 0.0f &&
                          alpha[q][i] >= kAlphaThreshold;
            any_valid |= valid[q][i];
          }
        }
        if (!any_valid) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float2 cl = s.col[kk[q]];
          const float colour[CH] = {u[q].w, cl.x, cl.y};
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            if (valid[q][i]) {
              const float w = alpha[q][i] * T[i];
#pragma unroll
              for (int j = 0; j < CH; ++j) acc[i][j] += w * colour[j];
              T[i] = T[i] * (1.0f - alpha[q][i]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = prow * 16 + pcol + i;
#pragma unroll
    for (int j = 0; j < CH; ++j) out[((int64_t)t * P + p) * CH + j] = acc[i][j];
  }
}

}  // namespace

// rows: [16, cap] float32; starts, ends: [n_tiles] int32; out:
// [n_tiles, 256, 3] float32.
extern "C" int gsc_skel_composite(const void* rows, long long cap,
                                  const void* starts, const void* ends,
                                  int n_tiles, void* out, void* stream) {
  if (n_tiles < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  skel_composite_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(rows), (int64_t)cap,
      static_cast<const int*>(starts), static_cast<const int*>(ends),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
