// B10: inclusive cumulative sum along each row of x [R, L] (float32).
//
// Replaces gscodec_studio_tpu/ops/raster_v2.py:_cumsum_rows_kernel /
// cumsum_rows (:1505-1531): one streaming pass over [R, 8192] blocks in
// grid order, the row totals carried in VMEM scratch. A CUDA grid has no
// order, so the carry becomes a second pass: (1) each block of SEG
// elements of a row sums itself into tot[r, s]; (2) one block per row
// turns tot into exclusive prefixes; (3) each block scans its segment
// again and adds its prefix. Within a block a thread owns PER consecutive
// elements: it scans them in order, the block scans the threads' totals
// (warp shuffles, then the warps' totals), and each element gets the
// prefixes of its segment and its thread. Every sum is taken in a fixed
// order, so two runs give the same bits; the order is not torch.cumsum's.
//
// Bound on the H100: bytes: x read once, the result written once
// (8 R L bytes); this design reads x twice. Nothing in the package calls
// it, as nothing in the JAX package calls cumsum_rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 16;
constexpr int SEG = THREADS * PER;  // elements of a row per block
constexpr unsigned kFull = 0xffffffffu;

// Inclusive scan of v over the block's threads, in thread order; the
// block's total in *total. ws: THREADS / 32 floats of shared memory.
__device__ __forceinline__ float block_scan(float v, float* ws,
                                            float* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) ws[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < THREADS / 32 ? ws[lane] : 0.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += u;
    }
    if (lane < THREADS / 32) ws[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += ws[warp - 1];
  *total = ws[THREADS / 32 - 1];
  __syncthreads();
  return v;
}

// Pass 1: tot[r, s] = the sum of segment s of row r.
__global__ void segment_totals(const float* x, int64_t L, int n_seg,
                               float* tot) {
  __shared__ float ws[THREADS / 32];
  const int s = blockIdx.x;
  const int r = blockIdx.y;
  const int64_t base = (int64_t)r * L + (int64_t)s * SEG;
  const int64_t rest = L - (int64_t)s * SEG;
  const int64_t n = rest < SEG ? rest : SEG;
  float v = 0.0f;
  for (int j = 0; j < PER; ++j) {
    const int64_t i = (int64_t)threadIdx.x * PER + j;
    if (i < n) v += x[base + i];
  }
  float total;
  block_scan(v, ws, &total);
  if (threadIdx.x == 0) tot[(int64_t)r * n_seg + s] = total;
}

// Pass 2: each row's segment totals -> exclusive prefixes, in place.
__global__ void segment_prefixes(float* tot, int n_seg) {
  __shared__ float ws[THREADS / 32];
  float* row = tot + (int64_t)blockIdx.x * n_seg;
  float carry = 0.0f;
  for (int s0 = 0; s0 < n_seg; s0 += THREADS) {
    const int s = s0 + threadIdx.x;
    const float v = s < n_seg ? row[s] : 0.0f;
    float total;
    const float incl = block_scan(v, ws, &total);
    if (s < n_seg) row[s] = carry + (incl - v);
    carry += total;
  }
}

// Pass 3: each segment scanned with its prefix added.
__global__ void segment_scan(const float* x, int64_t L, int n_seg,
                             const float* pre, float* y) {
  __shared__ float ws[THREADS / 32];
  const int s = blockIdx.x;
  const int r = blockIdx.y;
  const int64_t base = (int64_t)r * L + (int64_t)s * SEG;
  const int64_t rest = L - (int64_t)s * SEG;
  const int64_t n = rest < SEG ? rest : SEG;
  float v[PER];
  float run = 0.0f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int64_t i = (int64_t)threadIdx.x * PER + j;
    run += i < n ? x[base + i] : 0.0f;
    v[j] = run;
  }
  float total;
  const float incl = block_scan(run, ws, &total);
  const float off = pre[(int64_t)r * n_seg + s] + (incl - run);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int64_t i = (int64_t)threadIdx.x * PER + j;
    if (i < n) y[base + i] = off + v[j];
  }
}

}  // namespace

// x, y: [R, L] float32; tot: R * ceil(L / SEG) floats of scratch.
extern "C" int gsc_cumsum_rows(const void* x, int R, long long L, void* tot,
                               void* y, void* stream) {
  if (R < 0 || L < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || L == 0) return (int)cudaGetLastError();
  const long long n_seg = (L + SEG - 1) / SEG;
  if (n_seg > 2147483647LL || R > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)n_seg, (unsigned)R);
  const float* xf = static_cast<const float*>(x);
  float* tf = static_cast<float*>(tot);
  segment_totals<<<grid, THREADS, 0, st>>>(xf, L, (int)n_seg, tf);
  segment_prefixes<<<R, THREADS, 0, st>>>(tf, (int)n_seg);
  segment_scan<<<grid, THREADS, 0, st>>>(xf, L, (int)n_seg, tf,
                                         static_cast<float*>(y));
  return (int)cudaGetLastError();
}
