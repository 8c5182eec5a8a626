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
//     alignment padding, the chunks of no tile and the rows no pixel
//     composites keep the caller's zeros.
//
// Bound on the H100: operations. Each pixel re-evaluates the forward's
// pairs and, for each pair it composites, ~3*ch + 25 more operations of
// gradient arithmetic; the per-row sums over the tile's pixels are
// 6 + ch values per composited pair. The first design (one thread per
// pixel, a five-step shuffle tree per gradient row for every (pair, warp)
// where any lane composited, and d zeros stored by lane 0 where none did,
// the block's partials added every 32 pairs behind two barriers) ran at
// ~6% of that bound: every pixel evaluated every pair of its tile's live
// chunks, of which 14% pass the alpha test at the 1M scene. This design
// is B2's (csrc/raster_bwd.cu) on the v1 table (csrc/raster_v1.cuh):
//   * one block per tile, PPT pixels a thread (2 at ch <= 32, 1 above): a
//     thread owns PPT neighbours of one tile row, which share dy, and adds
//     the pair's values of its pixels in registers before any warp
//     reduction; a warp's pixels a cell 8 pixels wide (8 x 8 at PPT 2,
//     8 x 4 at 1);
//   * B2's candidate region per pair (gsc::conic_region,
//     csrc/regions.cuh), formed as the chunk is staged: a warp whose cell
//     misses the pair's box skips the pair, with no math, vote or store; a
//     warp none of whose pixels has its float sigma within the widened
//     bound skips the rest of the pair math. A pair that fails the alpha
//     test changes no state in either cutoff, so the results are the same;
//   * B7's walk of a sub-block's pairs 32 at a time: each lane tests one
//     pair's box against the warp's cell, and the warp walks the pairs of
//     the ballot in order, so a missed pair costs a lane one test, not the
//     warp a serial one (B2's serial test ran 1.4x slower here on the H100
//     at the 1M scene, where 41% of the (pair, warp) walked meet the box);
//   * the thread's pixels side by side, without branches: every value is
//     formed for each pixel and kept where the pixel composites the pair;
//   * a transposing warp reduction: the 6 + CHM values of a thread in
//     groups of 32 (the last of 8 or 16), in exchange-and-add steps after
//     which lane r holds row r's warp sum and stores it: 16 shuffles a
//     pair at ch 3 against the first design's 45; the tree is fixed, so
//     the bits repeat;
//   * a ballot shortcut: when one lane alone composited the pair, it
//     stores its own values and no tree runs; when none did, nothing is
//     stored;
//   * each warp marks the pairs it stored in a bit mask, and after one
//     barrier a sub-block of `sub` pairs is added by the block in warp
//     order over the marked warps alone, and written as whole rows:
//     deterministic, no atomics. The partials alternate between two
//     buffers, so a sub-block needs that one barrier;
//   * ``order`` (or null: index order) is the tile each block takes: in
//     training the longest run first (rasterize_pallas.run_order);
//   * occupancy (B2's builds, below).
// The cotangent's channels live in registers under a template bound (3, 8,
// 16, 32, 64 or 128), so ch <= 128.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "raster_v1.cuh"

namespace {

using gsc::v1::Cell;
using gsc::v1::K;
using gsc::v1::kAlphaThreshold;
using gsc::v1::kFull;
using gsc::v1::kMaxAlpha;
using gsc::v1::kMaxPixels;
using gsc::v1::kTransmittanceEps;
using gsc::v1::ppt_for;
using gsc::v1::stage_chunk;
using gsc::v1::tile_threads;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most
constexpr int kRegion = gsc::kConicRegion;
// Occupancy (B2's): at the channel bounds 3 and 8, tiles of up to 128
// threads (tile 16 at 2 pixels a thread) for 8 blocks an SM and the rest
// (tile 32 is 512) for 2, with 64 pairs staged per barrier; 16 and 32 are
// bounded by tile 32 alone; 64 and 128 (1 pixel a thread) get a build for
// tiles of up to 256 threads (tile 16) beside the one for tile 32, whose
// 1024 threads leave 64 registers. These stage as many pairs as shared
// memory holds, up to a chunk.
constexpr int kSmallThreads = 128;
constexpr int kSmallMinBlocks = 8;
constexpr int kSmallSub = 64;
constexpr int kLargeMinBlocks = 2;
constexpr int kLargeSub = 64;
constexpr int kWideThreads = 256;
constexpr bool tuned(int chm) { return chm <= 8; }
constexpr bool wide(int chm) { return chm >= 64; }

struct BwdArgs {
  const float* packed;  // [cap2, 6 + ch]
  const int* starts;  // [n_tiles] aligned start of each run
  const int* ends;  // [n_tiles] true end of each run
  const int* order;  // [n_tiles] the tile each block takes; null: index
  const float* v_colors;  // [n_tiles, ch, P]
  const float* v_alphas;  // [n_tiles, P]
  const float* alphas;  // [n_tiles, P] the forward's
  const float* q_init;  // [n_tiles, P]
  int tile_width, tile_height, tile_size, ch;
  int sub;  // pairs whose warp partials are staged at once (divides K)
  int dp;  // a pair's pitch in the partials: 6 + ch, made odd
  float* out;  // [cap2, 6 + ch], zero-filled
};

// a * b + c in one rounding: the gradient arithmetic's multiply-adds (the
// build's --fmad=false keeps the pair math, whose tests must decide as
// B7's do, unfused; the gradients are held to a tolerance, not to bits)
__device__ __forceinline__ float madd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// One level of the transposing reduction over the first N of a lane's
// values: lanes that differ in bit N/2 swap halves, each keeps the half its
// bit selects and adds the partner's copy of it. After the levels N .. 2,
// x[0] of lane r holds the sum of value r % N over the lanes that share
// r's bits at and above N.
template <int N, int M>
__device__ __forceinline__ void transpose_sum(float (&x)[M], int lane) {
  constexpr int H = N / 2;
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? x[i] : x[i + H];
    const float keep = up ? x[i + H] : x[i];
    x[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
  if constexpr (H > 1) transpose_sum<H>(x, lane);
}

// Slot s of a thread's sums over its pixels: the six geometry and opacity
// rows, then the CHM colour rows from the pixels' weights (0 where a pixel
// did not composite the pair) and cotangents (0 past the channels), 0
// past them. Inlined into loops over s that unroll, so every index is a
// constant and the arrays stay in registers.
template <int CHM, int PPT>
__device__ __forceinline__ float slot_value(int s, const float (&g6)[6],
                                            const float (&gw)[PPT],
                                            const float (&vc)[PPT][CHM]) {
  if (s < 6) return g6[s];
  if (s < 6 + CHM) {
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < PPT; ++i) v = madd(gw[i], vc[i][s - 6], v);
    return v;
  }
  return 0.0f;
}

// The warp sums of slots [s0, s0 + N) (N a power of two up to 32): lane l
// gets slot s0 + l % N's.
template <int N, int CHM, int PPT>
__device__ __forceinline__ float warp_group_sum(int s0, const float (&g6)[6],
                                                const float (&gw)[PPT],
                                                const float (&vc)[PPT][CHM],
                                                int lane) {
  float x[N];
#pragma unroll
  for (int s = 0; s < N; ++s) x[s] = slot_value<CHM, PPT>(s0 + s, g6, gw, vc);
  transpose_sum<N>(x, lane);
#pragma unroll
  for (int o = N; o < 32; o <<= 1) x[0] += __shfl_xor_sync(kFull, x[0], o);
  return x[0];
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <int CHM, int PPT, bool SOFT, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    raster_v1_bwd_kernel(const BwdArgs a) {
  constexpr int NR = 6 + CHM;  // slots of a thread's sums
  constexpr int NFULL = NR / 32;  // full groups of the warp reduction
  constexpr int NLAST = NR % 32 ? pow2_at_least(NR % 32) : 0;
  extern __shared__ float sm[];
  const int ch = a.ch;
  const int d = 6 + ch;
  const int sub = a.sub;
  const int dp = a.dp;
  const int nw_sub = (sub + 31) / 32;  // mask words a warp's sub-block
  const int n_warps = blockDim.x >> 5;
  float* chunk = sm;  // [d * K], column-major
  float* reg = chunk + d * K;  // [kRegion * K]
  float* part = reg + kRegion * K;  // [2][n_warps, sub, dp]
  unsigned* wmask = reinterpret_cast<unsigned*>(part + 2 * n_warps * sub * dp);
  // [2][n_warps, nw_sub]: the pairs each warp stored

  const int t = a.order ? a.order[blockIdx.x] : blockIdx.x;
  const int ts = a.tile_size;
  const int P = ts * ts;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int start = a.starts[t];
  const int end = a.ends[t];
  const int n_chunks = end > start ? (end - start + K - 1) / K : 0;
  const Cell<PPT> cell(t, a.tile_width, a.tile_height, ts, warp, lane);

  float vc[PPT][CHM];
  float q[PPT], va_tf[PPT], T[PPT], px[PPT];
  bool pix[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    pix[i] = cell.in_tile(i, ts);
    px[i] = cell.px(i);
    float qi = 0.0f, vai = 0.0f;
#pragma unroll
    for (int j = 0; j < CHM; ++j) vc[i][j] = 0.0f;
    if (pix[i]) {
      const int p = cell.prow * ts + cell.pcol + i;
      const int64_t tp0 = (int64_t)t * P + p;
#pragma unroll
      for (int j = 0; j < CHM; ++j) {
        if (j < ch) vc[i][j] = a.v_colors[((int64_t)t * ch + j) * P + p];
      }
      qi = a.q_init[tp0];
      vai = a.v_alphas[tp0] * (1.0f - a.alphas[tp0]);
    }
    q[i] = qi;
    va_tf[i] = vai;
    T[i] = pix[i] ? 1.0f : 0.0f;
  }

  int buf = 0;  // the partials' buffer of the next sub-block
  for (int c = 0; c < n_chunks; ++c) {
    bool busy = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) busy |= T[i] > kTransmittanceEps;
    if (!__syncthreads_or(busy)) break;
    const int row0 = start + c * K;
    const int hi = min(end - row0, K);  // rows past it are padding
    stage_chunk(chunk, reg, a.packed + (int64_t)row0 * d, d, hi, tid,
                blockDim.x);
    __syncthreads();
    // exact: a pixel takes pairs until its cutoff
    float tp[PPT];
    bool live[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      tp[i] = T[i];
      live[i] = pix[i];
    }
    for (int s0 = 0; s0 < hi; s0 += sub) {
      float* pb = part + (buf * n_warps + warp) * sub * dp;
      unsigned* mb = wmask + (buf * n_warps + warp) * nw_sub;
      // the sub-block's pairs 32 at a time: lane l tests pair kb + l's box
      // against the warp's cell, and the warp walks the pairs that meet it
      // in order; bits marks those it stored
      for (int kb = 0; kb < sub; kb += 32) {
        const int kl = s0 + kb + lane;
        const bool meets =
            kb + lane < sub && kl < hi &&
            gsc::cell_meets_box(chunk[kl], chunk[K + kl], reg[kl],
                                reg[K + kl], cell.x0, cell.x1, cell.y0,
                                cell.y1);
        unsigned pending = __ballot_sync(kFull, meets);
        unsigned bits = 0u;
        while (pending != 0u) {
          const int kk = kb + __ffs(pending) - 1;
          pending &= pending - 1u;
          const int k = s0 + kk;
          const float x = chunk[k], y = chunk[K + k];
          const float lm = reg[2 * K + k];
          const float ca = chunk[2 * K + k];
          const float cb = chunk[3 * K + k];
          const float cc = chunk[4 * K + k];
          const float op = chunk[5 * K + k];
          const float dy = y - cell.py;
          // the pixels' sigma; a pixel outside the region, or past its
          // cutoff, is no candidate
          float dx[PPT], sigma[PPT];
          bool cand[PPT];
          bool any = false;
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            dx[i] = x - px[i];
            sigma[i] =
                0.5f * (ca * dx[i] * dx[i] + cc * dy * dy) + cb * dx[i] * dy;
            cand[i] = live[i] && sigma[i] <= lm;
            any |= cand[i];
          }
          if (!__any_sync(kFull, any)) continue;
          // the thread's sums over its pixels: x, y, the conic (3), the
          // opacity; per pixel the colour rows' weight (0 where the pixel
          // did not composite the pair)
          float g6[6];
#pragma unroll
          for (int r = 0; r < 6; ++r) g6[r] = 0.0f;
          float gw[PPT];
          bool hit = false;
          float col[CHM];
#pragma unroll
          for (int j = 0; j < CHM; ++j) {
            col[j] = j < ch ? chunk[(6 + j) * K + k] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            const float e = expf(-sigma[i]);
            const float alpha_raw = op * e;
            const float alpha = fminf(kMaxAlpha, alpha_raw);
            const bool valid =
                cand[i] && sigma[i] >= 0.0f && alpha >= kAlphaThreshold;
            const float oma = 1.0f - alpha;
            const float t_incl = tp[i] * oma;
            const bool cut = !SOFT && !(t_incl > kTransmittanceEps);
            live[i] = live[i] && !(valid && cut);
            const bool h = valid && !cut;
            const float w = alpha * tp[i];
            float G = 0.0f;
#pragma unroll
            for (int j = 0; j < CHM; ++j) G = madd(col[j], vc[i][j], G);
            // the suffix term after this pair
            const float qn = madd(-w, G, q[i]);
            q[i] = h ? qn : q[i];
            const float inv_oma = 1.0f / oma;
            const float v_alpha = madd(tp[i], G, (va_tf[i] - qn) * inv_oma);
            const bool keep = h && !(alpha_raw > kMaxAlpha);
            const float v_sig = keep ? -alpha * v_alpha : 0.0f;
            g6[0] += v_sig * madd(ca, dx[i], cb * dy);
            g6[1] += v_sig * madd(cc, dy, cb * dx[i]);
            const float hs = 0.5f * v_sig;
            g6[2] = madd(hs * dx[i], dx[i], g6[2]);
            g6[3] = madd(v_sig * dx[i], dy, g6[3]);
            g6[4] = madd(hs * dy, dy, g6[4]);
            g6[5] += keep ? v_alpha * e : 0.0f;
            gw[i] = h ? w : 0.0f;
            tp[i] = h ? t_incl : tp[i];
            hit |= h;
          }
          const unsigned ballot = __ballot_sync(kFull, hit);
          if (ballot == 0u) continue;
          bits |= 1u << (kk & 31);
          float* pw = pb + kk * dp;  // row r at pw[r]
          if ((ballot & (ballot - 1u)) == 0u) {
            // one lane composited the pair: its values are the warp's sums
            if (hit) {
#pragma unroll
              for (int s = 0; s < NR; ++s) {
                if (s < 6 + ch) pw[s] = slot_value<CHM, PPT>(s, g6, gw, vc);
              }
            }
          } else {
#pragma unroll
            for (int gi = 0; gi < NFULL; ++gi) {
              const float v =
                  warp_group_sum<32, CHM, PPT>(32 * gi, g6, gw, vc, lane);
              if (32 * gi + lane < 6 + ch) pw[32 * gi + lane] = v;
            }
            if constexpr (NLAST > 0) {
              const float v = warp_group_sum<NLAST, CHM, PPT>(
                  32 * NFULL, g6, gw, vc, lane);
              const int s = 32 * NFULL + lane;
              if (lane < NLAST && s < 6 + ch) pw[s] = v;
            }
          }
        }
        if (lane == 0) mb[kb >> 5] = bits;
      }
      __syncthreads();
      // the block's sum of the marked warps' partials, in warp order, as
      // whole rows (consecutive threads write consecutive words of a row);
      // pairs no warp stored stay at the caller's zeros
      const float* pbb = part + buf * n_warps * sub * dp;
      const unsigned* mbb = wmask + buf * n_warps * nw_sub;
      const int n_sub = min(sub, hi - s0);
      for (int i = tid; i < n_sub * d; i += blockDim.x) {
        const int kk = i / d;
        const int r = i - kk * d;
        const unsigned bit = 1u << (kk & 31);
        const int word = kk >> 5;
        float v = 0.0f;
        bool any = false;
        for (int w = 0; w < n_warps; ++w) {
          if (mbb[w * nw_sub + word] & bit) {
            v += pbb[(w * sub + kk) * dp + r];
            any = true;
          }
        }
        if (any) a.out[(int64_t)(row0 + s0 + kk) * d + r] = v;
      }
      // the other buffer takes the next sub-block; the barrier after it
      // orders this sum before this buffer is written again, and the next
      // chunk's vote orders it before the chunk is staged again
      buf ^= 1;
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) T[i] = tp[i];
  }
}

template <int CHM, int PPT, int MAXT, int MINB>
cudaError_t launch_as(BwdArgs a, bool soft, int n_tiles, int threads,
                      int sub, cudaStream_t stream) {
  const int n_warps = threads / 32;
  const size_t fixed_bytes = (size_t)(6 + a.ch + kRegion) * K * sizeof(float);
  a.dp = (6 + a.ch) | 1;
  auto part_bytes = [&](int s) {
    return 2 * (size_t)n_warps *
           ((size_t)s * a.dp * sizeof(float) +
            (size_t)((s + 31) / 32) * sizeof(unsigned));
  };
  a.sub = sub;
  while (a.sub > 1 && fixed_bytes + part_bytes(a.sub) > kMaxSmem) {
    a.sub >>= 1;
  }
  const size_t smem = fixed_bytes + part_bytes(a.sub);
  auto kernel = soft ? raster_v1_bwd_kernel<CHM, PPT, true, MAXT, MINB>
                     : raster_v1_bwd_kernel<CHM, PPT, false, MAXT, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int CHM>
cudaError_t launch(const BwdArgs& a, bool soft, int n_tiles,
                   cudaStream_t stream) {
  constexpr int PPT = ppt_for(CHM);
  const int threads = tile_threads<PPT>(a.tile_size);
  if constexpr (tuned(CHM)) {
    if (threads <= kSmallThreads) {
      return launch_as<CHM, PPT, kSmallThreads, kSmallMinBlocks>(
          a, soft, n_tiles, threads, kSmallSub, stream);
    }
    return launch_as<CHM, PPT, kMaxPixels / PPT, kLargeMinBlocks>(
        a, soft, n_tiles, threads, kLargeSub, stream);
  } else {
    if constexpr (wide(CHM)) {
      if (threads <= kWideThreads) {
        return launch_as<CHM, PPT, kWideThreads, 1>(a, soft, n_tiles,
                                                    threads, K, stream);
      }
    }
    return launch_as<CHM, PPT, kMaxPixels / PPT, 1>(a, soft, n_tiles,
                                                    threads, K, stream);
  }
}

}  // namespace

extern "C" int gsc_raster_v1_bwd(const void* packed, const void* starts,
                                 const void* ends, const void* order,
                                 const void* v_colors, const void* v_alphas,
                                 const void* alphas, const void* q_init,
                                 int n_tiles, int tile_width,
                                 int tile_height, int tile_size, int ch,
                                 int soft, void* out, void* stream) {
  const int P = tile_size * tile_size;
  if (ch < 1 || ch > 128 || P < 1 || P > kMaxPixels || n_tiles < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return (int)cudaGetLastError();
  const BwdArgs a{static_cast<const float*>(packed),
                  static_cast<const int*>(starts),
                  static_cast<const int*>(ends),
                  static_cast<const int*>(order),
                  static_cast<const float*>(v_colors),
                  static_cast<const float*>(v_alphas),
                  static_cast<const float*>(alphas),
                  static_cast<const float*>(q_init),
                  tile_width,
                  tile_height,
                  tile_size,
                  ch,
                  K,
                  1,
                  static_cast<float*>(out)};
  cudaStream_t st = (cudaStream_t)stream;
  const bool sf = soft != 0;
  if (ch <= 3) return (int)launch<3>(a, sf, n_tiles, st);
  if (ch <= 8) return (int)launch<8>(a, sf, n_tiles, st);
  if (ch <= 16) return (int)launch<16>(a, sf, n_tiles, st);
  if (ch <= 32) return (int)launch<32>(a, sf, n_tiles, st);
  if (ch <= 64) return (int)launch<64>(a, sf, n_tiles, st);
  return (int)launch<128>(a, sf, n_tiles, st);
}
