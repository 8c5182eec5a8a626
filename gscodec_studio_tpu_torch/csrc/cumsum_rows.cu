// B10: inclusive cumulative sum along each row of x [R, L] (float32).
//
// Replaces gscodec_studio_tpu/ops/raster_v2.py:_cumsum_rows_kernel /
// cumsum_rows (:1505-1531): one streaming pass over [R, 8192] blocks in
// grid order, the row totals carried in VMEM scratch. The port's v1
// "sort" reduction (ops/rasterize_pallas.segment_reduce) runs its running
// sums through it, once a v1 backward, on the transposed gradient table
// [6 + CH, cap2].
//
// Bound on the H100: bytes, x read once and the result written once
// (8 R L bytes). Design: one pass that reads x from device memory once and
// keeps it in registers until its prefix is known. A CUDA grid has no
// order, so each block takes a ticket (an atomic counter) and with it the
// next segment, segment-major with the rows interleaved; a block then
// waits only on blocks that hold lower tickets, which have started, so
// the waits always end. A segment is SEG = THREADS * 4 * CHUNKS elements:
// each thread loads CHUNKS 16-byte vectors, neighbouring threads on
// neighbouring addresses (chunk c of the segment covers 4 * THREADS
// elements). The order of additions is fixed, whatever the timing, so two
// runs give the same bits:
//   1. each thread's 4 consecutive values, scanned in order (s0..s3);
//   2. for each chunk, the threads' totals s3 by an inclusive warp scan
//      (Hillis-Steele, shuffles; the exclusive value is the left lane's);
//   3. the 32 pieces (chunk, warp), in position order, by one warp's scan:
//      their exclusive prefixes, and the segment's total A;
//   4. the segments of a row in groups of GROUP: the segment's exclusive
//      prefix within its group, W, from the group's aggregates A (4 a lane
//      scanned in order, then a warp scan across the lanes); an inclusive
//      scan's value at a lane depends only on the lanes before it, so each
//      block computes the same W with the later aggregates unknown;
//   5. the groups' prefixes Q by a chain: Q_0 = 0, Q_{q+1} = Q_q + T_q,
//      where T_q is the group's total from the same scan; the last block
//      of group q publishes Q_{q+1};
//   6. y = ((((Q + W) + piece prefix) + lane prefix) + s_j).
// Steps 4 and 5 are a look-back at fixed points: a block publishes its A
// before it waits on anything, waits for the A of its group's blocks
// before it and for its group's Q. The value and a ready bit share one
// 64-bit word, so one store publishes both. A term meets at most
// 3 + 5 + 5 roundings to its segment's total, 3 + 5 more to its group's
// total or its W (+ 1), one a group of the chain and 4 in step 6: at most
// 26 + n_grp (n_grp groups a row); raster_v2.cumsum_rows_bound states it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNKS = 8;  // 16-byte vectors a thread
constexpr int SEG = THREADS * 4 * CHUNKS;  // elements of a row per block
constexpr int GROUP = 128;  // segments whose prefixes one scan gives
static_assert(WARPS * CHUNKS == 32, "one warp scans a segment's pieces");
static_assert(GROUP == 4 * 32, "a lane holds four of a group's totals");
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kReady = 1ull << 32;

// Inclusive Hillis-Steele scan over a warp's lanes.
__device__ __forceinline__ float warp_scan(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ void publish(unsigned long long* p, float v) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      kReady | __float_as_uint(v);
}

__device__ __forceinline__ float wait_for(const unsigned long long* p) {
  unsigned long long w =
      *reinterpret_cast<const volatile unsigned long long*>(p);
  while (!(w & kReady)) {
    __nanosleep(32);
    w = *reinterpret_cast<const volatile unsigned long long*>(p);
  }
  return __uint_as_float((unsigned)w);
}

__global__ void __launch_bounds__(THREADS)
    cumsum_kernel(const float* __restrict__ x, float* __restrict__ y, int R,
                  long long L, int n_seg, int n_grp, int vec,
                  unsigned long long* agg, unsigned long long* grp,
                  unsigned int* ticket) {
  __shared__ unsigned s_ticket;
  __shared__ float s_piece[32];
  __shared__ float s_E;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  const int r = (int)(s_ticket % (unsigned)R);
  const int s = (int)(s_ticket / (unsigned)R);
  const float* xr = x + (long long)r * L;
  float* yr = y + (long long)r * L;
  const long long seg0 = (long long)s * SEG + 4 * threadIdx.x;

  // 1-2: the thread's values, scanned in order; each chunk's warp scan
  float v[CHUNKS][4];
  float eps[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const long long i = seg0 + (long long)c * 4 * THREADS;
    if (vec) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < L) t = *reinterpret_cast<const float4*>(xr + i);
      v[c][0] = t.x;
      v[c][1] = t.y;
      v[c][2] = t.z;
      v[c][3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[c][j] = i + j < L ? xr[i + j] : 0.f;
    }
    v[c][1] += v[c][0];
    v[c][2] += v[c][1];
    v[c][3] += v[c][2];
    const float om = warp_scan(v[c][3], lane);
    const float left = __shfl_up_sync(kFull, om, 1);
    eps[c] = lane > 0 ? left : 0.f;
    if (lane == 31) s_piece[c * WARPS + warp] = om;
  }
  __syncthreads();

  if (warp == 0) {
    // 3: the pieces' prefixes and the segment's total
    const float pin = warp_scan(s_piece[lane], lane);
    const float pleft = __shfl_up_sync(kFull, pin, 1);
    const float A = __shfl_sync(kFull, pin, 31);
    s_piece[lane] = lane > 0 ? pleft : 0.f;
    unsigned long long* agg_r = agg + (long long)r * n_seg;
    if (lane == 0) publish(agg_r + s, A);
    // 4: the prefix within the group, from the aggregates before this one
    const int q = s / GROUP;
    const int k = s - q * GROUP;
    float a[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = 4 * lane + m;
      a[m] = i < k ? wait_for(agg_r + q * GROUP + i) : (i == k ? A : 0.f);
    }
    a[1] += a[0];
    a[2] += a[1];
    a[3] += a[2];
    const float lam = warp_scan(a[3], lane);
    const float lleft = __shfl_up_sync(kFull, lam, 1);
    const float lex = lane > 0 ? lleft : 0.f;
    const int km = k & 3;
    const float within = km == 0 ? 0.f : (km == 1 ? a[0] : (km == 2 ? a[1]
                                                                      : a[2]));
    const float W = __shfl_sync(kFull, lex + within, k >> 2);
    const float T = __shfl_sync(kFull, lam, 31);
    // 5: the group's prefix, and the next group's from the last block
    if (lane == 0) {
      unsigned long long* grp_r = grp + (long long)r * n_grp;
      const float Q = q > 0 ? wait_for(grp_r + q) : 0.f;
      if (k == GROUP - 1 && q + 1 < n_grp) publish(grp_r + q + 1, Q + T);
      s_E = Q + W;
    }
  }
  __syncthreads();

  // 6: the outputs
  const float E = s_E;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const long long i = seg0 + (long long)c * 4 * THREADS;
    const float o = (E + s_piece[c * WARPS + warp]) + eps[c];
    if (vec) {
      if (i < L) {
        *reinterpret_cast<float4*>(yr + i) =
            make_float4(o + v[c][0], o + v[c][1], o + v[c][2], o + v[c][3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j < L) yr[i + j] = o + v[c][j];
      }
    }
  }
}

}  // namespace

// x, y: [R, L] float32. status: R * ceil(L / SEG) + R * n_grp + 1 zeroed
// 64-bit words (the segments' aggregates, the groups' prefixes, the
// ticket counter), n_grp = ceil(ceil(L / SEG) / GROUP).
extern "C" int gsc_cumsum_rows(const void* x, int R, long long L,
                               void* status, void* y, void* stream) {
  if (R < 0 || L < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || L == 0) return (int)cudaGetLastError();
  const long long n_seg = (L + SEG - 1) / SEG;
  const long long n_grp = (n_seg + GROUP - 1) / GROUP;
  if ((long long)R * n_seg > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int vec = L % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)y % 16 == 0;
  unsigned long long* agg = static_cast<unsigned long long*>(status);
  unsigned long long* grp = agg + (long long)R * n_seg;
  unsigned int* ticket =
      reinterpret_cast<unsigned int*>(grp + (long long)R * n_grp);
  cumsum_kernel<<<(unsigned)(R * n_seg), THREADS, 0,
                  (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y), R, L,
      (int)n_seg, (int)n_grp, vec, agg, grp, ticket);
  return (int)cudaGetLastError();
}
