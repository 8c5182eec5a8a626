// Row pack: n f32 rows (each with its own element stride) -> one
// attr-major [R, L] block, rows >= n zero-filled, optionally gathering the
// columns through a permutation.
//
// Replaces gscodec_studio_tpu/ops/raster_v2.py:_pack_kernel / pack_rows
// and, when a permutation is given, the payload gather that lax.sort did
// for the rows it carried: the binning calls it once with the depth order
// (the compacted Gaussian table, whose rows are strided views of the
// per-Gaussian records) and once with the stable tile order (the sorted
// intersection table S, whose rows are separate unit-stride arrays).
//
// Bound on the H100: bytes. Each output column reads n floats and one
// 8-byte index and writes R floats. With a permutation a column's reads
// land on scattered 32-byte sectors, so what the gather costs is how often
// a sector comes from DRAM or L2. The first design (a thread a column, all
// R rows) kept every row of S in flight at once, ~130 MB at 1M Gaussians
// against the 50 MB L2, so a sector came from DRAM up to once for each of
// the 8 columns that read it; for the table, whose rows are the fields of
// one record, that order was the right one (a column's fields share one or
// two sectors, and a thread uses them at once). Design: the rows are
// gathered a group at a time, the group in blockIdx.y, so the groups run
// one after another and the sources a group reads share L2:
//   * a unit-stride row of which the gather reads 8 MB or more (a sixth of
//     the L2; S's rows at 1M Gaussians ~13 MB) goes two at a time, so the
//     pair stays in L2 while the card gathers it; every other run of rows
//     (the fields of records, small rows, the zero rows past the n) is one
//     group, as in the first design;
//   * a thread reads its columns' permutation entries once a group, as
//     int32 (exact: the wrapper refuses L >= 2^31), and starts the gathers
//     of its group's rows (16 at a time) before it stores any of them; its
//     columns (c * blockDim + thread within its block, so every store is
//     coalesced) are 4 when every group is a pair, which keeps 8 gathers
//     in flight, else 1, as in the first design (the table's fields are
//     already 9-19 gathers a column).
// The row pointers, strides and groups ride in the kernel's parameter
// space, so no table is copied to the device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the widest table: 2DGS's 12 + 128 attribute rows and the id
constexpr int kMaxRows = 144;
constexpr int kThreads = 256;
constexpr int kBatch = 16;  // a group's rows gathered before their stores
constexpr int64_t kPairSpan = 8 << 20;  // bytes: unit-stride rows in pairs

struct Rows {
  const float* ptr[kMaxRows];
  int stride[kMaxRows];
  // group g: rows first[g] .. first[g + 1] - 1 (at most n + 1 groups)
  int first[kMaxRows + 2];
};

template <int G, int COLS>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(Rows rows, int n, const int64_t* __restrict__ perm,
                int64_t L, float* __restrict__ out) {
  const int r_end = rows.first[blockIdx.y + 1];
  const int64_t base = (int64_t)blockIdx.x * kThreads * COLS + threadIdx.x;
  int src[COLS];  // -1: past the last column
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int64_t j = base + (int64_t)c * kThreads;
    src[c] = j < L ? (perm ? (int)perm[j] : (int)j) : -1;
  }
  for (int r0 = rows.first[blockIdx.y]; r0 < r_end; r0 += G) {
    float v[G][COLS];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int r = r0 + i;
      const float* p = (r < r_end && r < n) ? rows.ptr[r] : nullptr;
      const int64_t st = p ? rows.stride[r] : 0;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        v[i][c] = (p && src[c] >= 0) ? p[src[c] * st] : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (r0 + i < r_end) {
        float* o = out + (int64_t)(r0 + i) * L + base;
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          if (src[c] >= 0) o[c * kThreads] = v[i][c];
        }
      }
    }
  }
}

}  // namespace

extern "C" int gsc_pack_rows(const void* ptrs, const void* strides, int n,
                             const void* perm, long long L, void* out, int R,
                             void* stream) {
  if (n < 0 || n > kMaxRows || R < n || L < 0 || L >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  Rows rows;
  const uint64_t* p = static_cast<const uint64_t*>(ptrs);
  const int* s = static_cast<const int*>(strides);
  for (int i = 0; i < n; ++i) {
    rows.ptr[i] = reinterpret_cast<const float*>(p[i]);
    rows.stride[i] = s[i];
  }
  // the groups: large unit-stride rows two at a time, every other run of
  // rows together
  // a gather of L columns touches at most 4 L bytes of a row
  auto paired = [&](int r) {
    return r < n && rows.stride[r] == 1 && 4 * (int64_t)L >= kPairSpan;
  };
  int n_groups = 0, widest = 1;
  for (int r = 0; r < R;) {
    int g = 1;
    if (paired(r)) {
      g = paired(r + 1) ? 2 : 1;
    } else {
      while (r + g < R && !paired(r + g)) ++g;
    }
    rows.first[n_groups++] = r;
    widest = g > widest ? g : widest;
    r += g;
  }
  rows.first[n_groups] = R;
  if (L == 0 || R == 0) return (int)cudaGetLastError();
  const int cols = widest <= 2 ? 4 : 1;
  const int64_t per_block = (int64_t)kThreads * cols;
  const dim3 grid((unsigned)((L + per_block - 1) / per_block),
                  (unsigned)n_groups);
  const int64_t* pm = static_cast<const int64_t*>(perm);
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  if (widest <= 2) {
    pack_kernel<2, 4><<<grid, kThreads, 0, st>>>(rows, n, pm, (int64_t)L, o);
  } else {
    pack_kernel<kBatch, 1><<<grid, kThreads, 0, st>>>(rows, n, pm,
                                                      (int64_t)L, o);
  }
  return (int)cudaGetLastError();
}
