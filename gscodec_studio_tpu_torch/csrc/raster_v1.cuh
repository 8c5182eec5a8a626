// What the legacy v1 tile kernels B7 (csrc/raster_v1_fwd.cu) and B8
// (csrc/raster_v1_bwd.cu) share: the v1 pair constants, the staging of a
// chunk of the row-major aligned table with its candidate regions, and
// the pixel layout of a tile's threads (B1's and B2's, csrc/raster_fwd.cu
// and csrc/raster_bwd.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "regions.cuh"

// In a named namespace, with no anonymous one: a using-directive that
// nominated an anonymous namespace here would make nvcc's host stub name
// the kernels' own anonymous namespace ambiguously.
namespace gsc {
namespace v1 {

constexpr int K = kChunk;  // rows per chunk == the alignment unit of a run
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPixels = 1024;  // tile 32

// pixels a thread: 2 where the per-pixel registers (B7's colour sums, B8's
// cotangents) leave room, 1 at the 64 and 128 channel bounds
constexpr int ppt_for(int chm) { return chm <= 32 ? 2 : 1; }

// The threads that cover a tile at PPT pixels a thread.
template <int PPT>
inline int tile_threads(int ts) {
  constexpr int RC = 32 / (8 / PPT);  // rows a cell
  return ((ts + 7) / 8) * ((ts + RC - 1) / RC) * 32;
}

// Stages the chunk of rows [0, K) at src of the row-major table (d = 6 +
// ch floats a row) into sm column-major, sm[r * K + k], which the pair
// walk reads as broadcasts and a warp's ballot as consecutive words; and
// forms the candidate region (conic_region) of each of its first hi rows
// from the same f32 values. A thread reads a value's column at a stride of
// d words: the chunk's K * d words stay in L1 after the first pass.
__device__ __forceinline__ void stage_chunk(float* sm, float* reg,
                                            const float* src, int d, int hi,
                                            int tid, int nthreads) {
#pragma unroll 4
  for (int i = tid; i < d * K; i += nthreads) {
    const int r = i / K;
    const int k = i % K;
    sm[i] = src[k * d + r];
  }
  for (int k = tid; k < hi; k += nthreads) {
    float g[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) g[r] = src[k * d + r];
    conic_region(g, reg, k);
  }
}

// A thread's pixels and its warp's cell: PPT neighbours of tile row prow
// from column pcol; a warp's pixels a cell 8 pixels wide and RC rows tall,
// the cells row-major (8 x 8 at PPT 2, 8 x 4 at 1); the cell's pixel
// centres [x0, x1] x [y0, y1], for the warp's test against a pair's box.
template <int PPT>
struct Cell {
  int x_tile, prow, pcol;
  float py, x0, x1, y0, y1;

  __device__ __forceinline__ Cell(int tile, int tile_width, int tile_height,
                                  int ts, int warp, int lane) {
    constexpr int CT = 8 / PPT;  // threads a cell row
    constexpr int RC = 32 / CT;  // rows a cell
    const int rem = tile % (tile_width * tile_height);
    const int tx = (rem % tile_width) * ts;
    const int ty = (rem / tile_width) * ts;
    const int cells_x = (ts + 7) / 8;
    const int cx = warp % cells_x, cy = warp / cells_x;
    prow = cy * RC + lane / CT;
    pcol = cx * 8 + (lane % CT) * PPT;
    py = (float)(ty + prow) + 0.5f;
    x0 = (float)(tx + cx * 8) + 0.5f;
    x1 = (float)(tx + min(cx * 8 + 7, ts - 1)) + 0.5f;
    y0 = (float)(ty + cy * RC) + 0.5f;
    y1 = (float)(ty + min(cy * RC + RC - 1, ts - 1)) + 0.5f;
    x_tile = tx;
  }

  // pixel i's column centre and whether it lies in the tile
  __device__ __forceinline__ float px(int i) const {
    return (float)(x_tile + pcol + i) + 0.5f;
  }
  __device__ __forceinline__ bool in_tile(int i, int ts) const {
    return prow < ts && pcol + i < ts;
  }
};

}  // namespace v1
}  // namespace gsc
