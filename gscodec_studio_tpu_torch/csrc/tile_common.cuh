// What the expansion and the tile kernels share: the sorted table's packed
// words (attr_dtype "bf16", geom_dtype "u16") and one step of the
// log-space transmittance scan (log_composite).
//
// Replaces gscodec_studio_tpu/ops/raster_v2.py:_pack_pair / _unpack_pair
// (:252-268), _pack_u16_xy / _unpack_u16_xy (:271-299), the chunk readers
// _chunk_colors / _chunk_pair (:766-813) and _composite_log (:838-869).
//
//   * A packed pair is one 32-bit word: truncated bf16 of a in the high
//     half, of b in the low half, (bits(a) & 0xFFFF0000) | (bits(b) >> 16).
//     Truncation is integer masking; __float2bfloat16 rounds and would give
//     other bits.
//   * A u16 position word is (qx << 16) | qy with q = int(clip((v + 4096)
//     * 8 + 0.5, 0, 65535)): 1/8 px over [-4096, 4096) px, clipped outside
//     (no range check: a centre outside reads back at the edge, as in the
//     JAX package).
//   * The words travel in float32 tables; loads and stores move their bits
//     unchanged, and only integer operations read them.
//   * The log scan: l = log1p(-alpha) is split into l1 = bf16(l) and
//     l2 = bf16(l - l1), both rounded to nearest even (the JAX package's
//     astype(bfloat16)); a pixel walking its pairs keeps the two running
//     sums, and incl = s1 + s2 (the sum of the two triangular matmuls there,
//     not the running sum of l1 + l2). T_prev = T * exp(incl - l) with the
//     f32 l; the exact cutoff tests T * exp(incl) > 1e-4; the soft cutoff
//     ends the chunk at T * exp(s1 + s2).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gsc {

constexpr int kChunk = 128;  // columns of S per chunk
constexpr float kGeomScale = 8.0f;
constexpr float kGeomOff = 4096.0f;

__device__ __forceinline__ uint32_t pack_pair(float a, float b) {
  return (__float_as_uint(a) & 0xFFFF0000u) | (__float_as_uint(b) >> 16);
}

__device__ __forceinline__ float pair_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ float pair_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ uint32_t quant_u16(float v) {
  const float q = fminf(fmaxf((v + kGeomOff) * kGeomScale + 0.5f, 0.0f),
                        65535.0f);
  return (uint32_t)(int)q;
}

__device__ __forceinline__ uint32_t pack_u16_xy(float x, float y) {
  return (quant_u16(x) << 16) | quant_u16(y);
}

__device__ __forceinline__ float u16_x(uint32_t w) {
  return (float)(int)(w >> 16) / kGeomScale - kGeomOff;
}

__device__ __forceinline__ float u16_y(uint32_t w) {
  return (float)(int)(w & 0xFFFFu) / kGeomScale - kGeomOff;
}

// Stages columns [col0, col0 + kChunk) of the 3DGS sorted table S into
// shared memory as the f32 layout's 6 + ch rows (x, y, ca, cb, cc, op,
// colors), unpacking a u16 position word and bf16 pairs on the way. For
// the f32 layout it is a plain copy. Each word of S is read once.
__device__ __forceinline__ void stage_chunk_3dgs(float* sm, const float* S,
                                                 int64_t cap, int64_t col0,
                                                 int ch, bool geom_packed,
                                                 bool attr_packed, int tid,
                                                 int nthreads) {
  const int ng = geom_packed ? 1 : 2;
  const int nval = 4 + ch;  // ca, cb, cc, op, colors
  const int nsrows = ng + (attr_packed ? (nval + 1) / 2 : nval);
  for (int i = tid; i < nsrows * kChunk; i += nthreads) {
    const int r = i / kChunk;
    const int k = i % kChunk;
    const float v = S[r * cap + col0 + k];
    if (r < ng) {
      if (geom_packed) {
        const uint32_t w = __float_as_uint(v);
        sm[k] = u16_x(w);
        sm[kChunk + k] = u16_y(w);
      } else {
        sm[r * kChunk + k] = v;
      }
    } else if (attr_packed) {
      const int a = 2 * (r - ng);  // value index of the high half
      const uint32_t w = __float_as_uint(v);
      sm[(2 + a) * kChunk + k] = pair_hi(w);
      if (a + 1 < nval) sm[(3 + a) * kChunk + k] = pair_lo(w);
    } else {
      sm[(2 + r - ng) * kChunk + k] = v;
    }
  }
}

// One valid pair's step of the log-space scan: adds the pair's split log
// to the running sums and returns the inclusive sum incl; l gets the f32
// log1p(-alpha).
__device__ __forceinline__ float log_scan_step(float alpha, float& s1,
                                               float& s2, float& l) {
  l = log1pf(-alpha);
  const float l1 = __bfloat162float(__float2bfloat16_rn(l));
  const float l2 = __bfloat162float(__float2bfloat16_rn(l - l1));
  s1 += l1;
  s2 += l2;
  return s1 + s2;
}

}  // namespace gsc
