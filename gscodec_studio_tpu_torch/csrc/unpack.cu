// Row unpack: the first n rows of an attr-major [R, L_src] block of 4-byte
// words (f32, or packed pairs) into one [n, L] block, optionally
// scattering the columns through a permutation (out[:, idx[j]] =
// block[:, j]).
//
// Replaces gscodec_studio_tpu/ops/raster_v2.py:_unpack_kernel /
// unpack_rows and, with an index, the two payload sorts of the JAX
// backward's reduction (_reduce_grads): the per-intersection gradient rows
// go from S's column order back to expansion order through the forward's
// stable tile order (column j to position perm[j]), and the per-Gaussian
// sums from compacted order back to the input order through the depth
// order. The inverse of B9a's gather-pack (csrc/pack.cu).
//
// Bound on the H100: bytes. Each column reads n words and one 8-byte
// index and writes n words. A scatter of n rows writes each 4-byte word
// to its own 32-byte sector (1.08 ms for 9 rows of 2.8M columns against
// 0.22 ms for the same gather), so the scatter runs in two passes: one
// thread per column inverts the permutation into an int32 scratch row
// (the only scattered writes, one row), then one thread per output column
// gathers, reading the inverse once a row group and writing every row
// coalesced across the warp. Each output column is written by exactly one
// thread.
//
// What holds the gather back: through a permutation neighbouring output
// columns read words of other tiles' runs (or other Gaussians), each in
// its own 32-byte sector, and a block of rows larger than the 50 MB L2
// fetches a sector again for most of its 8 words. Design: the gather
// takes the rows in groups small enough that a group's source rows stay
// in L2 while the whole grid reads them (raster_v2.unpack_row_group: rows
// of at most UNPACK_L2_BYTES together, all rows where they fit); the grid
// is group-major, and the card starts blocks in index order, so the
// groups run one after another. On the H100 this halves the second
// launch at the 1M scene's 2DGS sums ([19, 1M], 76 MB: groups of 8 rows)
// and leaves the first within a few per cent: its rows, 13 MB each, cost
// about the same per row whether 1 or 9 are read at once, which points at
// the L2's rate of random sectors rather than its size. Streaming hints
// on the inverse and the output (__ldcs, __stcs) gained nothing there.
//
// The kernel moves 4-byte words and never reads them as floats: the
// packed-pair gradient rows (csrc/raster_bwd.cu, grad_dtype "bf16") go
// through it with every bit kept, as the JAX package bitcasts them to int32
// before its sorts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void invert_kernel(const int64_t* __restrict__ idx, int64_t L,
                              int32_t* __restrict__ inv) {
  const int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (j < L) inv[idx[j]] = (int32_t)j;
}

// block b of the grid gathers row group b / nbx over the columns of its
// column block b % nbx
__global__ void unpack_kernel(const uint32_t* __restrict__ block,
                              int64_t L_src, int n, int group, int64_t nbx,
                              const int32_t* __restrict__ inv, int64_t L,
                              uint32_t* __restrict__ out) {
  const int64_t g = blockIdx.x / nbx;
  const int64_t j = (blockIdx.x - g * nbx) * (int64_t)kThreads + threadIdx.x;
  if (j >= L) return;
  const int r0 = (int)g * group, r1 = min(r0 + group, n);
  const int64_t src = inv ? (int64_t)inv[j] : j;
  for (int r = r0; r < r1; ++r) out[r * L + j] = block[r * L_src + src];
}

}  // namespace

// idx: int64 permutation of [0, L) or null; inv: int32 scratch [L], used
// only with idx; group: rows gathered together (1 <= group).
extern "C" int gsc_unpack_rows(const void* block, long long L_src, int n,
                               int group, const void* idx, long long L,
                               void* inv, void* out, void* stream) {
  if (n < 0 || L < 0 || L_src < L || L > INT32_MAX || group < 1 ||
      (idx && !inv))
    return (int)cudaErrorInvalidValue;
  const int64_t nbx = (L + kThreads - 1) / kThreads;
  const int64_t groups = (n + group - 1) / group;
  if (nbx * groups > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (L > 0 && n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (idx)
      invert_kernel<<<(unsigned)nbx, kThreads, 0, s>>>(
          static_cast<const int64_t*>(idx), (int64_t)L,
          static_cast<int32_t*>(inv));
    unpack_kernel<<<(unsigned)(nbx * groups), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(block), (int64_t)L_src, n, group, nbx,
        idx ? static_cast<const int32_t*>(inv) : nullptr, (int64_t)L,
        static_cast<uint32_t*>(out));
  }
  return (int)cudaGetLastError();
}
