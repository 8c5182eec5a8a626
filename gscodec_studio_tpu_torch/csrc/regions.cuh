// The candidate regions of a pair: where a pixel can pass the alpha test
// alpha = min(0.999, op * exp(-sigma)) >= 1/255. The tile kernels skip
// the pair math of every pixel outside them; a pair that fails the alpha
// test changes no state of a pixel (T, the sums, the 2DGS A, distortion
// and median) in either cutoff or in the log scan, so the skip is exact.
// The forward and the backward of each splat kind include the same
// function, so that they trust the same regions:
//   * conic_region (3DGS: B1, csrc/raster_fwd.cu, and B2,
//     csrc/raster_bwd.cu; the legacy v1 kernels B7, csrc/raster_v1_fwd.cu,
//     and B8, csrc/raster_v1_bwd.cu, through csrc/raster_v1.cuh; mirrored
//     by raster_v2._pair_regions);
//   * surfel_region (2DGS: B5, csrc/raster_fwd_2dgs.cu, and B6,
//     csrc/raster_bwd_2dgs.cuh; mirrored by raster_v2_2dgs._pair_regions).
// Both are formed in double precision once a chunk, from the f32 values
// the pair math reads, and widened by margins far above the float rounding
// of that math.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace gsc {
namespace {

constexpr float kRegionAlphaMin = 1.0f / 255.0f;

// ---- 3DGS ---------------------------------------------------------------

// a pair's conic region in shared memory: the box's half widths rx, ry and
// the widened bound lm on the float sigma
constexpr int kConicRegion = 3;
// below this det A against ca * cc, no bound: there the float sigma's
// rounding, up to ~8 ulp times (1 + |rho|) / (1 - |rho|) of it with rho the
// conic's correlation, reaches 1% of sigma
constexpr double kCond = 1e-4;

// The f32 values x, y, ca, cb, cc, op of the 3DGS table's column `col`,
// unpacked as stage_chunk_3dgs unpacks them: the regions are formed from
// global memory while the chunk is staged, which saves a barrier a chunk.
__device__ __forceinline__ void load_geometry(const float* S, int64_t cap,
                                              bool geom_packed,
                                              bool attr_packed, int64_t col,
                                              float (&g)[6]) {
  int r = 0;
  if (geom_packed) {
    const uint32_t w = __float_as_uint(S[col]);
    g[0] = u16_x(w);
    g[1] = u16_y(w);
    r = 1;
  } else {
    g[0] = S[col];
    g[1] = S[cap + col];
    r = 2;
  }
  if (attr_packed) {
    const uint32_t w0 = __float_as_uint(S[r * cap + col]);
    const uint32_t w1 = __float_as_uint(S[(r + 1) * cap + col]);
    g[2] = pair_hi(w0);
    g[3] = pair_lo(w0);
    g[4] = pair_hi(w1);
    g[5] = pair_lo(w1);
  } else {
    for (int i = 0; i < 4; ++i) g[2 + i] = S[(r + i) * cap + col];
  }
}

// The conic region of a pair: alpha >= 1/255 needs op >= 1/255 and sigma
// <= L = ln(255 op), the ellipse {0.5 d^T A d <= L} of the conic A = [[ca,
// cb], [cb, cc]], whose bounding box is |dx| <= sqrt(2 L cc / det A), |dy|
// <= sqrt(2 L ca / det A). Outside the box |dx| <= rx, |dy| <= ry, or
// where the float sigma exceeds lm, no pixel passes. op < 1/255: no pixel
// passes (rx = ry = lm = -1); a conic that is not positive definite, or
// has det A < kCond * ca * cc: no bound (+inf). The margins: L * 1.02 +
// 0.01 (the float sigma within 1% of the exact one where det A >= kCond *
// ca * cc, and the float exp and product within a few ulps), the half
// widths * 1.001 + 0.1 px. Stored at reg[k], reg[K + k], reg[2K + k].
__device__ __forceinline__ void conic_region(const float (&g)[6], float* reg,
                                             int k) {
  const float op = g[5];
  float rx = -1.0f, ry = -1.0f, lm = -1.0f;
  if (op >= kRegionAlphaMin) {
    const double Lm = 1.02 * fmax(log(255.0 * (double)op), 0.0) + 0.01;
    const double ca = g[2], cb = g[3], cc = g[4];
    const double det = ca * cc - cb * cb;
    if (ca > 0.0 && cc > 0.0 && det >= kCond * ca * cc) {
      rx = (float)(sqrt(2.0 * Lm * cc / det) * 1.001 + 0.1);
      ry = (float)(sqrt(2.0 * Lm * ca / det) * 1.001 + 0.1);
      lm = (float)Lm;
    } else {
      rx = ry = lm = INFINITY;
    }
  }
  reg[k] = rx;
  reg[kChunk + k] = ry;
  reg[2 * kChunk + k] = lm;
}

// Whether a warp's cell of pixel centres [x0, x1] x [y0, y1] meets the box
// of the pair at (x, y) with half widths (rx, ry): the same answer for
// every lane of the warp.
__device__ __forceinline__ bool cell_meets_box(float x, float y, float rx,
                                               float ry, float x0, float x1,
                                               float y0, float y1) {
  const float ex = x - fminf(fmaxf(x, x0), x1);
  const float ey = y - fminf(fmaxf(y, y0), y1);
  return fabsf(ex) <= rx && fabsf(ey) <= ry;
}

// ---- 2DGS ---------------------------------------------------------------

// the 2DGS table's rows: x, y, m00..m22 (kSurfelM), op (kSurfelOp), colors
constexpr int kSurfelM = 2;
constexpr int kSurfelOp = 11;
// a pair's surfel region in shared memory: the ellipse's centre (2) and
// quadratic form (3), its bound (1: inside when q <= bound), the
// screen-filter disk's squared radius (1)
constexpr int kSurfelRegion = 7;
// the box that holds a pair's surfel region, for a warp's test of its
// cell (surfel_box): x0, x1, y0, y1
constexpr int kSurfelBox = 4;
// below this |det M| against its centred columns' norms, no bound
constexpr double kFlat = 1e-3;

// The surfel region of the chunk's pair k. alpha = op * exp(-sigma) >=
// 1/255 needs op >= 1/255 and sigma = 0.5 * min(gw3d, gw2d) <= L =
// ln(255 op): either the pixel is within sqrt(L) of (x, y) (gw2d = 2
// |d|^2), or its ray meets the surfel's plane at u^2 + v^2 <= 2 L. The
// plane point (u, v, 1) maps to the screen point M (u, v, 1), so the
// second set is the image of a disk of radius rho: an ellipse when the
// disk stays off the line M_2 . (u, v, 1) = 0, with the dual conic Q = M
// diag(rho^2, rho^2, -1) M^T, centre (Q02, Q12) / Q22 and covariance Sigma
// = Q[:2, :2] / -Q22 + c c^T; else (or when it is near that) no bound,
// every pixel a candidate. No bound either when the camera lies nearly in
// the surfel's plane, where the pixel's float cross product h_u x h_v may
// be rounding noise: |det M| under kFlat times the product of the column
// norms of M taken about the ellipse's centre (rows 0 and 1 less cx and cy
// times row 2; the columns are then the surfel's two axes and its centre
// seen from a camera centred on it, so the ratio is about the cosine
// between the plane's normal and the view ray; some 0.03% of a random
// scene's pairs). The margins, each some 1000 times the float rounding of
// the pair math: L * 1.01 + 0.01; Sigma * 1.05 + 0.21 I (the ellipse grown
// by 0.1 px: (1 + e) Sigma + (1 + 1/e) m^2 I holds the ellipse widened by
// m) + 1e-3 trace(Sigma) I (no axis under 1/1000 of the long one, so the
// float test is well conditioned); the disk's radius + 0.1 px.
__device__ void surfel_region(const float* chunk, int k, float* reg) {
  constexpr int K = kChunk;
  const float op = chunk[kSurfelOp * K + k];
  float ex = 0.0f, ey = 0.0f, qa = 0.0f, qb = 0.0f, qc = 0.0f;
  float bound = 1.0f, r2 = -1.0f;
  if (!(op >= kRegionAlphaMin)) {
    bound = -1.0f;  // no pixel composites the pair
  } else {
    const double Lm = 1.01 * fmax(log(255.0 * (double)op), 0.0) + 0.01;
    const double rf = sqrt(Lm) + 0.1;
    r2 = (float)(rf * rf);
    const double rho2 = 2.0 * Lm;
    double m[9];
    for (int i = 0; i < 9; ++i) m[i] = chunk[(kSurfelM + i) * K + k];
    auto Q = [&](int a, int b) {
      return rho2 * (m[3 * a] * m[3 * b] + m[3 * a + 1] * m[3 * b + 1]) -
             m[3 * a + 2] * m[3 * b + 2];
    };
    const double q22 = Q(2, 2);
    const double scale = rho2 * (m[6] * m[6] + m[7] * m[7]) + m[8] * m[8];
    const double cx = Q(0, 2) / q22, cy = Q(1, 2) / q22;
    // M's rows about the ellipse's centre
    double u[3], v[3], w[3];
    for (int i = 0; i < 3; ++i) {
      w[i] = m[6 + i];
      u[i] = m[i] - cx * w[i];
      v[i] = m[3 + i] - cy * w[i];
    }
    const double det_m = u[0] * (v[1] * w[2] - v[2] * w[1]) -
                         u[1] * (v[0] * w[2] - v[2] * w[0]) +
                         u[2] * (v[0] * w[1] - v[1] * w[0]);
    const double cols = sqrt((u[0] * u[0] + v[0] * v[0] + w[0] * w[0]) *
                             (u[1] * u[1] + v[1] * v[1] + w[1] * w[1]) *
                             (u[2] * u[2] + v[2] * v[2] + w[2] * w[2]));
    if (q22 < -1e-6 * scale && fabs(det_m) >= kFlat * cols) {
      const double s00 = Q(0, 0) / -q22 + cx * cx;
      const double s11 = Q(1, 1) / -q22 + cy * cy;
      const double s01 = Q(0, 1) / -q22 + cx * cy;
      const double iso = 0.21 + 1e-3 * (s00 + s11);
      const double a00 = 1.05 * s00 + iso, a11 = 1.05 * s11 + iso;
      const double a01 = 1.05 * s01;
      const double det = a00 * a11 - a01 * a01;
      if (det > 0.0 && a00 > 0.0 && a11 > 0.0) {
        ex = (float)cx;
        ey = (float)cy;
        qa = (float)(a11 / det);
        qb = (float)(-a01 / det);
        qc = (float)(a00 / det);
      }
      // else no bound: q = 0 <= 1 everywhere
    }
  }
  reg[0 * K + k] = ex;
  reg[1 * K + k] = ey;
  reg[2 * K + k] = qa;
  reg[3 * K + k] = qb;
  reg[4 * K + k] = qc;
  reg[5 * K + k] = bound;
  reg[6 * K + k] = r2;
}

// The box [x0, x1] x [y0, y1] (box[r * K + k], r = 0..3) that holds the
// surfel region reg of the chunk's pair k as the kernels' float test reads
// it (qa ex^2 + 2 qb ex ey + qc ey^2 <= bound, or the pixel within the
// disk of squared radius r2 about the mean): the disk's square, and the
// box of the ellipse {e^T Qf e <= 1} of the stored float form Qf = [[qa,
// qb], [qb, qc]], whose half widths are sqrt(Qf^-1 diagonal), formed in
// double; each half width * 1.001 + 0.01 px, far above the rounding of
// the float test (the form's conditioning is held to 1e-3 by
// surfel_region's margin). Empty where no pixel composites, unbounded
// where the ellipse is. For a warp's test of its cell
// (cell_meets_surfel_box).
__device__ __forceinline__ void surfel_box(const float* chunk,
                                           const float* reg, int k,
                                           float* box) {
  constexpr int K = kChunk;
  const float bound = reg[5 * K + k];
  double x0 = INFINITY, x1 = -INFINITY, y0 = INFINITY, y1 = -INFINITY;
  if (bound > 0.0f) {
    const double qa = reg[2 * K + k], qb = reg[3 * K + k];
    const double qc = reg[4 * K + k];
    const double det = qa * qc - qb * qb;
    if (!(det > 0.0)) {  // q = 0 <= 1 everywhere (no bound)
      x0 = y0 = -INFINITY;
      x1 = y1 = INFINITY;
    } else {
      const double rb = sqrt((double)reg[6 * K + k]) * 1.001 + 0.01;
      const double mx = chunk[k], my = chunk[K + k];
      const double hx = sqrt(qc / det) * 1.001 + 0.01;
      const double hy = sqrt(qa / det) * 1.001 + 0.01;
      const double ex = reg[k], ey = reg[K + k];
      x0 = fmin(mx - rb, ex - hx);
      x1 = fmax(mx + rb, ex + hx);
      y0 = fmin(my - rb, ey - hy);
      y1 = fmax(my + rb, ey + hy);
    }
  }
  box[k] = (float)x0;
  box[K + k] = (float)x1;
  box[2 * K + k] = (float)y0;
  box[3 * K + k] = (float)y1;
}

// Whether a warp's cell of pixel centres [x0, x1] x [y0, y1] meets the box
// of the chunk's pair k (surfel_box).
__device__ __forceinline__ bool cell_meets_surfel_box(const float* box,
                                                      int k, float x0,
                                                      float x1, float y0,
                                                      float y1) {
  constexpr int K = kChunk;
  return box[k] <= x1 && box[K + k] >= x0 && box[2 * K + k] <= y1 &&
         box[3 * K + k] >= y0;
}

}  // namespace
}  // namespace gsc
