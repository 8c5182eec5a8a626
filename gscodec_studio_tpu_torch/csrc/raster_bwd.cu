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
// tile reaches, and pairs that no pixel composites, stay at the caller's
// zeros.
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
// unchanged, as the JAX custom VJP sends them.
//
// Bound on the H100: operations. Each pixel re-evaluates the forward's
// pairs and, for each pair it composites, ~3*CH + 25 more operations of
// gradient arithmetic; the per-intersection sums over the tile's pixels
// are d_g values per composited pair. The first design (one pixel a
// thread, a five-step shuffle tree per gradient row and warp, the block's
// partials added every 32 pairs) ran at ~5% of that bound: every pixel
// evaluated every pair of its tile's run, though ~23% of those (pair,
// pixel) slots pass the alpha test; each (pair, warp) that any lane
// composited cost 5 * d_g shuffles and d_g serial stores by lane 0, and a
// warp none of whose lanes did still stored d_g zeros; tile 32 made 32-warp
// blocks that reduced every pair 32 times. This design, B6's
// (csrc/raster_bwd_2dgs.cuh) on the 3DGS pair:
//   * one block per tile, PPT pixels a thread (2 at CH <= 32, 1 above,
//     where the cotangent vc[PPT][CHM] fills the registers, and 1 in the
//     dense build, below): a thread owns
//     PPT neighbours of one tile row, which share dy, and adds the pair's
//     values of its pixels in registers before any warp reduction; a
//     warp's pixels form a cell 8 pixels wide (8 x 8 at PPT 2, 8 x 4 at 1);
//   * a candidate region per pair, formed in double precision as the chunk
//     is staged (gsc::conic_region, csrc/regions.cuh, which B1 shares),
//     from the unpacked f32 values the pair math reads: alpha >= 1/255
//     needs op >= 1/255 and sigma <= L = ln(255 op), the ellipse
//     {0.5 d^T A d <= L} of the conic A = [[ca, cb], [cb, cc]], whose
//     bounding box is |dx| <= sqrt(2 L cc / det A), |dy| <=
//     sqrt(2 L ca / det A). The bounds are widened far above float
//     rounding; a conic that is not positive definite, or too near it for
//     the float sigma to hold the bound (det A < kCond * ca * cc), gets
//     none. A warp whose cell misses the box skips the pair: no math, no
//     vote, no stores. A warp none of whose pixels has its float sigma
//     within the widened L skips the rest of the pair math. A pair that
//     fails the alpha test changes no state in either cutoff or in LOG, so
//     the results are the same;
//   * a thread's pixels side by side: the pair math is formed for each of
//     them without branches and a pixel's values are kept where it
//     composites the pair, so their dependency chains interleave (with a
//     branch per pixel the kernel ran 1.2x slower on the checkpoint's
//     dense views);
//   * a transposing warp reduction: the 8 + CHM values of a thread (the six
//     geometry sums, the CHM colour rows, the two absgrad sums, kept in
//     every build since they cost no shuffle at the channel bounds here),
//     in groups of 32 (the last of 8 or 16), in exchange-and-add steps
//     after which lane r holds row r's warp sum and stores it: 16 shuffles
//     a pair at CH 3 against the first design's 45; the tree is fixed, so
//     the bits repeat;
//   * a ballot shortcut: when one lane alone composited the pair, it
//     stores its own values (adding the other lanes' zeros would give the
//     same sums) and no tree runs; when none did, nothing is stored;
//   * each warp marks the pairs it stored in a bit mask, and after one
//     barrier a sub-block of `sub` pairs is added by the block in warp
//     order over the marked warps alone: deterministic, no atomics. The
//     partials alternate between two buffers, so a sub-block needs that one
//     barrier and no second before the next is written;
//   * the blocks take the tiles longest run first (the wrapper's order):
//     on the checkpoint's views one tile of a ~7,000-pair run (the mean is
//     ~90) takes most of the launch alone, and started last it ends last;
//   * occupancy (the tuned builds, below).
// The cotangent's channels live in registers under a template bound (3, 8,
// 16, 32, 64 or 128), so CH <= 128.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "regions.cuh"
#include "tile_common.cuh"

namespace {

constexpr int K = gsc::kChunk;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPixels = 1024;  // tile 32
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most
// a pair's candidate region in shared memory (gsc::conic_region)
constexpr int kRegion = gsc::kConicRegion;

// pixels a thread: several where the cotangent leaves registers free
constexpr int ppt_for(int chm) { return chm <= 32 ? 2 : 1; }
// Occupancy, timed on the H100 at the 1M scene (PERF.md): the channel
// bounds of the main paths (3, 8) get two builds, one for tiles of up to
// 128 threads (tile 16 at 2 pixels a thread) and one for the rest (tile 32
// is 512), each built for its min_blocks blocks an SM, with `sub` pairs
// staged per barrier. The bounds 16 and 32 are bounded by tile 32 alone;
// 64 and 128 (1 pixel a thread) get a build for tiles of up to 256 threads
// (tile 16) beside the one for tile 32, whose 1024 threads leave 64
// registers and spill. These stage as many pairs as shared memory holds,
// up to a chunk.
constexpr int kSmallThreads = 128;
constexpr int kSmallMinBlocks = 8;
constexpr int kSmallSub = 64;
constexpr int kLargeMinBlocks = 2;
constexpr int kLargeSub = 64;
constexpr int kWideThreads = 256;
// ``dense`` (the wrapper's raster_v2.bwd_dense: under 32 Gaussians a tile,
// as the checkpoint's views have, against ~230 at the 1M scene): at bounds
// 3 and 8 and tiles of up to 256 threads at 1 pixel a thread, the build
// with 1 pixel a thread, 4 blocks an SM. There a few tiles with runs ~80x
// the mean set the launch's time, and 8 warps finish such a tile sooner
// than 4: 0.82-0.85x the parent's time against 0.91-1.06x for the 2-pixel
// build; on the 1M scene 3.15 ms against 2.25.
constexpr int kDenseThreads = 256;
constexpr int kDenseMinBlocks = 4;
constexpr int kDenseSub = 64;
constexpr bool tuned(int chm) { return chm <= 8; }
constexpr bool wide(int chm) { return chm >= 64; }

struct BwdArgs {
  const float* S;  // [>= n_srows, cap] sorted attribute rows
  int64_t cap;
  const int* starts;  // [n_tiles + 2] first row of each tile's run
  const int* masks;  // [n_tiles] 0 disables a tile
  const int* order;  // [n_tiles] the tile each block takes
  const float* tiles;  // [n_tiles, P, ch + 1] forward outputs
  const float* v_tiles;  // [n_tiles, P, ch + 1] their cotangents
  int tile_width, tile_height, tile_size, ch, d_g, absgrad, packed;
  int geom_packed, attr_packed;
  int sub;  // pairs whose warp partials are staged at once (divides K)
  int dp;  // a pair's pitch in the partials: d_g, made odd (no conflicts)
  float* out;  // [d_g, cap] (packed: uint32 [d_gp, cap]), zero-filled
};

// a * b + c in one rounding: the gradient arithmetic's multiply-adds. The
// build's --fmad=false keeps the pair math (sigma, alpha, the
// transmittance), whose tests must decide as B1's do, unfused; the
// gradient values are held to a tolerance, not to bits.
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

// Slot s of a thread's sums over its pixels: the six geometry rows, the CHM
// colour rows from the pixels' weights (0 where a pixel did not composite
// the pair) and cotangents (0 past the channels), the two absgrad rows.
// Inlined into loops over s that unroll, so every index is a constant and
// the arrays stay in registers.
template <int CHM, int PPT>
__device__ __forceinline__ float slot_value(int s, const float (&g8)[8],
                                            const float (&gw)[PPT],
                                            const float (&vc)[PPT][CHM]) {
  if (s < 6) return g8[s];
  if (s < 6 + CHM) {
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < PPT; ++i) v = madd(gw[i], vc[i][s - 6], v);
    return v;
  }
  return s < 8 + CHM ? g8[s - CHM] : 0.0f;
}

// The partial row that slot s is stored in, or -1: the colour slots past
// the channels hold zeros, and the absgrad slots follow the colour rows.
template <int CHM>
__device__ __forceinline__ int slot_row(int s, int ch, int absgrad) {
  if (s < 6 + CHM) return s < 6 + ch ? s : -1;
  return absgrad ? s - CHM + ch : -1;
}

// The warp sums of slots [s0, s0 + N) (N a power of two up to 32): lane l
// gets slot s0 + l % N's.
template <int N, int CHM, int PPT>
__device__ __forceinline__ float warp_group_sum(int s0, const float (&g8)[8],
                                                const float (&gw)[PPT],
                                                const float (&vc)[PPT][CHM],
                                                int lane) {
  float x[N];
#pragma unroll
  for (int s = 0; s < N; ++s) x[s] = slot_value<CHM, PPT>(s0 + s, g8, gw, vc);
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

template <int CHM, int PPT, bool SOFT, bool LOG, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    raster_bwd_kernel(const BwdArgs a) {
  constexpr int NR = 8 + CHM;  // slots of a thread's sums
  constexpr int NFULL = NR / 32;  // full groups of the warp reduction
  constexpr int NLAST = NR % 32 ? pow2_at_least(NR % 32) : 0;
  extern __shared__ float sm[];
  const int ch = a.ch;
  const int d_g = a.d_g;
  const int sub = a.sub;
  const int dp = a.dp;
  const int nw_sub = (sub + 31) / 32;  // mask words a warp's sub-block
  const int n_warps = blockDim.x >> 5;
  float* chunk = sm;  // [(6 + ch) * K]
  float* reg = chunk + (6 + ch) * K;  // [kRegion * K]
  float* part = reg + kRegion * K;  // [2][n_warps, sub, dp]
  unsigned* wmask = reinterpret_cast<unsigned*>(part + 2 * n_warps * sub * dp);
  // [2][n_warps, nw_sub]: the pairs each warp stored

  const int t = a.order[blockIdx.x];
  const int ts = a.tile_size;
  const int P = ts * ts;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int off = a.starts[t];
  const int end = a.starts[t + 1];
  const int c0 = off / K;
  const int c1 = (end > off && a.masks[t] > 0) ? (end + K - 1) / K : c0;
  const int rem = t % (a.tile_width * a.tile_height);
  const int x0 = (rem % a.tile_width) * ts;
  const int y0 = (rem / a.tile_width) * ts;

  // the thread's pixels: PPT neighbours of tile row prow; a warp's, a
  // cell 8 pixels wide and RC rows tall, the cells row-major
  constexpr int CT = 8 / PPT;  // threads a cell row
  constexpr int RC = 32 / CT;  // rows a cell
  const int cells_x = (ts + 7) / 8;
  const int cx = warp % cells_x, cy = warp / cells_x;
  const int prow = cy * RC + lane / CT;
  const int pcol = cx * 8 + (lane % CT) * PPT;
  const float py = (float)(y0 + prow) + 0.5f;
  // the cell's pixel centres, for the warp's test against a pair's box
  const float cell_x0 = (float)(x0 + cx * 8) + 0.5f;
  const float cell_x1 = (float)(x0 + min(cx * 8 + 7, ts - 1)) + 0.5f;
  const float cell_y0 = (float)(y0 + cy * RC) + 0.5f;
  const float cell_y1 = (float)(y0 + min(cy * RC + RC - 1, ts - 1)) + 0.5f;

  float vc[PPT][CHM];
  float q[PPT], va_tf[PPT], T[PPT], px[PPT];
  bool pix[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    pix[i] = prow < ts && pcol + i < ts;
    px[i] = (float)(x0 + pcol + i) + 0.5f;
    float qi = 0.0f, vai = 0.0f, tfi = 1.0f;
#pragma unroll
    for (int j = 0; j < CHM; ++j) vc[i][j] = 0.0f;
    if (pix[i]) {
      const int p = prow * ts + pcol + i;
      const int64_t base = ((int64_t)t * P + p) * (ch + 1);
#pragma unroll
      for (int j = 0; j < CHM; ++j) {
        if (j < ch) {
          vc[i][j] = a.v_tiles[base + j];
          qi += a.tiles[base + j] * vc[i][j];
        }
      }
      vai = a.v_tiles[base + ch];
      tfi = 1.0f - a.tiles[base + ch];
    }
    q[i] = qi;
    va_tf[i] = vai * tfi;
    T[i] = pix[i] ? 1.0f : 0.0f;
  }

  int buf = 0;  // the partials' buffer of the next sub-block
  for (int c = c0; c < c1; ++c) {
    bool busy = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) busy |= T[i] > kTransmittanceEps;
    if (!__syncthreads_or(busy)) break;
    const int64_t col0 = (int64_t)c * K;
    const int lo = max(off - c * K, 0);
    const int hi = min(end - c * K, K);
    gsc::stage_chunk_3dgs(chunk, a.S, a.cap, col0, ch, a.geom_packed,
                          a.attr_packed, tid, blockDim.x);
    for (int k = lo + tid; k < hi; k += blockDim.x) {
      float g[6];
      gsc::load_geometry(a.S, a.cap, a.geom_packed, a.attr_packed, col0 + k,
                         g);
      gsc::conic_region(g, reg, k);
    }
    __syncthreads();
    // LOG: tp is the last passing T * exp(incl) (exact cutoff), s1 and s2
    // the chunk's running sums; exact: a pixel takes pairs until its cutoff
    float tp[PPT], s1[PPT], s2[PPT];
    bool live[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      tp[i] = T[i];
      s1[i] = 0.0f;
      s2[i] = 0.0f;
      live[i] = pix[i];
    }
    for (int s0 = (lo / sub) * sub; s0 < hi; s0 += sub) {
      float* pb = part + (buf * n_warps + warp) * sub * dp;
      unsigned* mb = wmask + (buf * n_warps + warp) * nw_sub;
      unsigned bits = 0u;  // this mask word's pairs that the warp stored
      for (int kk = 0; kk < sub; ++kk) {
        const int k = s0 + kk;
        if (k >= lo && k < hi) {
          const float x = chunk[k], y = chunk[K + k];
          // the cell against the pair's box: the same for the whole warp
          // (gsc::cell_meets_box's test, written out: through the call the
          // kernel ran 3% slower on the H100, PERF.md)
          const float rx = reg[k], ry = reg[K + k];
          const float ex = x - fminf(fmaxf(x, cell_x0), cell_x1);
          const float ey = y - fminf(fmaxf(y, cell_y0), cell_y1);
          if (fabsf(ex) <= rx && fabsf(ey) <= ry) {
            const float lm = reg[2 * K + k];
            const float ca = chunk[2 * K + k];
            const float cb = chunk[3 * K + k];
            const float cc = chunk[4 * K + k];
            const float op = chunk[5 * K + k];
            const float dy = y - py;
            // the pixels' sigma; a pixel outside the region, or past its
            // cutoff, is no candidate
            float dx[PPT], sigma[PPT];
            bool cand[PPT];
            bool any = false;
#pragma unroll
            for (int i = 0; i < PPT; ++i) {
              dx[i] = x - px[i];
              sigma[i] = (0.5f * ca) * (dx[i] * dx[i]) +
                         (0.5f * cc) * (dy * dy) + cb * (dx[i] * dy);
              cand[i] = live[i] && sigma[i] <= lm;
              any |= cand[i];
            }
            // the thread's sums over its pixels: x, y, the conic (3), v_sig,
            // |x|, |y|; per pixel the colour rows' weight (0 where the pixel
            // did not composite the pair)
            float g8[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) g8[r] = 0.0f;
            float gw[PPT];
            bool hit = false;
            if (__any_sync(kFull, any)) {
              float col[CHM];
#pragma unroll
              for (int j = 0; j < CHM; ++j) {
                col[j] = j < ch ? chunk[(6 + j) * K + k] : 0.0f;
              }
              // the pixels side by side, without branches: every value is
              // formed for each pixel and kept where the pixel composites
              // the pair, so the pixels' chains interleave
#pragma unroll
              for (int i = 0; i < PPT; ++i) {
                const float alpha_raw = op * expf(-sigma[i]);
                const float alpha = fminf(kMaxAlpha, alpha_raw);
                const bool valid =
                    cand[i] && sigma[i] >= 0.0f && alpha >= kAlphaThreshold;
                const float oma = 1.0f - alpha;
                float t_prev, t_incl;
                if (LOG) {  // gsc::log_scan_step, kept where valid
                  const float l = log1pf(-alpha);
                  const float l1 = __bfloat162float(__float2bfloat16_rn(l));
                  const float l2 =
                      __bfloat162float(__float2bfloat16_rn(l - l1));
                  const float s1n = s1[i] + l1;
                  const float s2n = s2[i] + l2;
                  s1[i] = valid ? s1n : s1[i];
                  s2[i] = valid ? s2n : s2[i];
                  const float incl = s1n + s2n;
                  t_prev = T[i] * expf(incl - l);
                  t_incl = SOFT ? 0.0f : T[i] * expf(incl);
                } else {
                  t_prev = tp[i];
                  t_incl = tp[i] * oma;
                }
                const bool cut = !SOFT && !(t_incl > kTransmittanceEps);
                live[i] = live[i] && !(valid && cut);
                const bool h = valid && !cut;
                const float w = alpha * t_prev;
                float G = 0.0f;
#pragma unroll
                for (int j = 0; j < CHM; ++j) G = madd(col[j], vc[i][j], G);
                // the suffix term after this pair
                const float qn = madd(-w, G, q[i]);
                q[i] = h ? qn : q[i];
                const float inv_oma = 1.0f / oma;
                const float v_alpha =
                    madd(t_prev, G, (va_tf[i] - qn) * inv_oma);
                const float v_sig = !h || alpha_raw > kMaxAlpha
                                        ? 0.0f
                                        : -alpha * v_alpha;
                const float gx = v_sig * madd(ca, dx[i], cb * dy);
                const float gy = v_sig * madd(cc, dy, cb * dx[i]);
                g8[0] += gx;
                g8[1] += gy;
                const float hs = 0.5f * v_sig;
                g8[2] = madd(hs * dx[i], dx[i], g8[2]);
                g8[3] = madd(v_sig * dx[i], dy, g8[3]);
                g8[4] = madd(hs * dy, dy, g8[4]);
                g8[5] += v_sig;
                g8[6] += fabsf(gx);
                g8[7] += fabsf(gy);
                gw[i] = h ? w : 0.0f;
                const float tpn = LOG ? fminf(tp[i], t_incl) : t_incl;
                tp[i] = h ? tpn : tp[i];
                hit |= h;
              }
            } else {
#pragma unroll
              for (int i = 0; i < PPT; ++i) gw[i] = 0.0f;
            }
            const unsigned ballot = __ballot_sync(kFull, hit);
            float* pw = pb + kk * dp;  // row r at pw[r]
            if (ballot != 0u) bits |= 1u << (kk & 31);
            if ((ballot & (ballot - 1u)) == 0u) {
              // one lane composited the pair: its values are the warp's sums
              if (hit) {
#pragma unroll
                for (int s = 0; s < NR; ++s) {
                  const int r = slot_row<CHM>(s, ch, a.absgrad);
                  if (r >= 0) pw[r] = slot_value<CHM, PPT>(s, g8, gw, vc);
                }
              }
            } else {
#pragma unroll
              for (int gi = 0; gi < NFULL; ++gi) {
                const float v =
                    warp_group_sum<32, CHM, PPT>(32 * gi, g8, gw, vc, lane);
                const int r = slot_row<CHM>(32 * gi + lane, ch, a.absgrad);
                if (r >= 0) pw[r] = v;
              }
              if constexpr (NLAST > 0) {
                const float v = warp_group_sum<NLAST, CHM, PPT>(
                    32 * NFULL, g8, gw, vc, lane);
                const int r =
                    slot_row<CHM>(32 * NFULL + lane, ch, a.absgrad);
                if (lane < NLAST && 32 * NFULL + lane < NR && r >= 0) {
                  pw[r] = v;
                }
              }
            }
          }
        }
        if ((kk & 31) == 31 || kk == sub - 1) {
          if (lane == 0) mb[kk >> 5] = bits;
          bits = 0u;
        }
      }
      __syncthreads();
      // the block's sum of the marked warps' partials, in warp order;
      // pairs no warp stored stay at the caller's zeros
      const float* pbb = part + buf * n_warps * sub * dp;
      const unsigned* mbb = wmask + buf * n_warps * nw_sub;
      const int n_attr = 6 + ch;
      const int n_out = a.packed ? (n_attr + 1) / 2 + a.absgrad : d_g;
      for (int i = tid; i < n_out * sub; i += blockDim.x) {
        const int r = i / sub;
        const int kk = i % sub;
        const int k = s0 + kk;
        if (k < lo || k >= hi) continue;
        const int word = kk >> 5;
        const unsigned bit = 1u << (kk & 31);
        // the rows this entry holds: one, or a packed word's two
        int ra = r, rb = -1;
        if (a.packed) {
          const int n_vp = (n_attr + 1) / 2;
          ra = r < n_vp ? 2 * r : n_attr;
          rb = r < n_vp ? (2 * r + 1 < n_attr ? 2 * r + 1 : -1) : n_attr + 1;
        }
        float va = 0.0f, vb = 0.0f;
        bool any = false;
        for (int w = 0; w < n_warps; ++w) {
          if (mbb[w * nw_sub + word] & bit) {
            const float* pw = pbb + (w * sub + kk) * dp;
            va += pw[ra];
            if (rb >= 0) vb += pw[rb];
            any = true;
          }
        }
        if (!any) continue;
        const float opk = chunk[5 * K + k];
        if (ra == 5) va = opk > 0.0f ? -va / opk : 0.0f;
        if (rb == 5) vb = opk > 0.0f ? -vb / opk : 0.0f;
        if (a.packed) {
          reinterpret_cast<uint32_t*>(a.out)[(int64_t)r * a.cap + col0 + k] =
              gsc::pack_pair(va, vb);
        } else {
          a.out[(int64_t)r * a.cap + col0 + k] = va;
        }
      }
      // the other buffer takes the next sub-block; the barrier after it
      // orders this sum before this buffer is written again, and the next
      // chunk's vote orders it before the chunk is staged again
      buf ^= 1;
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      T[i] = (LOG && SOFT) ? T[i] * expf(s1[i] + s2[i]) : tp[i];
    }
  }
}

template <int CHM, int PPT, int MAXT, int MINB>
cudaError_t launch_as(BwdArgs a, bool soft, bool log, int n_tiles,
                      int threads, int sub, cudaStream_t stream) {
  const int n_warps = threads / 32;
  const size_t fixed_bytes = (size_t)(6 + a.ch + kRegion) * K * sizeof(float);
  a.dp = a.d_g | 1;
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
  auto kernel =
      log ? (soft ? raster_bwd_kernel<CHM, PPT, true, true, MAXT, MINB>
                  : raster_bwd_kernel<CHM, PPT, false, true, MAXT, MINB>)
          : (soft ? raster_bwd_kernel<CHM, PPT, true, false, MAXT, MINB>
                  : raster_bwd_kernel<CHM, PPT, false, false, MAXT, MINB>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The threads that cover a tile at PPT pixels a thread.
template <int PPT>
int tile_threads(int ts) {
  constexpr int RC = 32 / (8 / PPT);  // rows a cell
  return ((ts + 7) / 8) * ((ts + RC - 1) / RC) * 32;
}

template <int CHM>
cudaError_t launch(const BwdArgs& a, bool soft, bool log, int n_tiles,
                   bool dense, cudaStream_t stream) {
  constexpr int PPT = ppt_for(CHM);
  const int ts = a.tile_size;
  const int threads = tile_threads<PPT>(ts);
  if constexpr (tuned(CHM)) {
    if (dense && tile_threads<1>(ts) <= kDenseThreads) {
      return launch_as<CHM, 1, kDenseThreads, kDenseMinBlocks>(
          a, soft, log, n_tiles, tile_threads<1>(ts), kDenseSub, stream);
    }
    if (threads <= kSmallThreads) {
      return launch_as<CHM, PPT, kSmallThreads, kSmallMinBlocks>(
          a, soft, log, n_tiles, threads, kSmallSub, stream);
    }
    return launch_as<CHM, PPT, kMaxPixels / PPT, kLargeMinBlocks>(
        a, soft, log, n_tiles, threads, kLargeSub, stream);
  }
  if constexpr (wide(CHM)) {
    if (threads <= kWideThreads) {
      return launch_as<CHM, PPT, kWideThreads, 1>(a, soft, log, n_tiles,
                                                  threads, K, stream);
    }
  }
  return launch_as<CHM, PPT, kMaxPixels / PPT, 1>(a, soft, log, n_tiles,
                                                  threads, K, stream);
}

}  // namespace

extern "C" int gsc_raster_bwd(const void* S, long long cap, const void* starts,
                              const void* masks, const void* order,
                              const void* tiles,
                              const void* v_tiles, int n_tiles,
                              int tile_width, int tile_height, int tile_size,
                              int ch, int soft, int absgrad, int packed,
                              int log_composite, int geom_packed,
                              int attr_packed, int dense, void* out,
                              void* stream) {
  const int P = tile_size * tile_size;
  if (ch < 1 || ch > 128 || P < 1 || P > kMaxPixels || n_tiles < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return (int)cudaGetLastError();
  const BwdArgs a{static_cast<const float*>(S),
                  (int64_t)cap,
                  static_cast<const int*>(starts),
                  static_cast<const int*>(masks),
                  static_cast<const int*>(order),
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
                  K,
                  1,
                  static_cast<float*>(out)};
  cudaStream_t st = (cudaStream_t)stream;
  const bool sf = soft != 0;
  const bool lg = log_composite != 0;
  const bool dn = dense != 0;
  if (ch <= 3) return (int)launch<3>(a, sf, lg, n_tiles, dn, st);
  if (ch <= 8) return (int)launch<8>(a, sf, lg, n_tiles, dn, st);
  if (ch <= 16) return (int)launch<16>(a, sf, lg, n_tiles, dn, st);
  if (ch <= 32) return (int)launch<32>(a, sf, lg, n_tiles, dn, st);
  if (ch <= 64) return (int)launch<64>(a, sf, lg, n_tiles, dn, st);
  return (int)launch<128>(a, sf, lg, n_tiles, dn, st);
}
