// SelectiveAdam: one in-place step of Adam over one parameter group whose
// rows with visibility 0 keep their parameter and both moments.
//
// Replaces no Pallas kernel: the JAX package writes the step as plain jnp
// (gscodec_studio_tpu/optimizers/selective_adam.py:59-67), which XLA fuses
// into one elementwise pass, and the reference runs it as one CUDA kernel
// (gsplat's adam.cu). Eager PyTorch would take about ten launches a group
// for the same chain, six groups a training step.
//
// Per element of row r = i / inner, with v = vis[r]:
//   mu' = b1 mu + (1 - b1) g,  nu' = b2 nu + ((1 - b2) g) g,
//   p'  = p + (-lr) mu' / (sqrt(nu') + eps)   (raw moments, no bias
//   correction), and where v == 0 nothing is written. The products and
// sums are rounded one at a time in this order, as the plain version
// (optimizers/selective_adam.selective_adam_plain) rounds them: the
// library is built with --fmad=false, and sqrtf and the division are
// IEEE, so the kernel gives the plain version's bits.
//
// Bound on the H100: bytes. p, g, mu and nu are read once and p, mu and nu
// written once (28 bytes an element), the visibility once (a byte a row).
// Design: each thread takes 4 consecutive elements; with 16-byte aligned
// pointers and a size divisible by 4 it loads and stores them as float4
// (neighbouring threads on neighbouring addresses), else one at a time.
// A group of 4 whose rows are all invisible writes nothing; a group with
// some visible rows stores its invisible elements' old values unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Coef {
  float neg_lr, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void step(float& p, float g, float& mu, float& nu,
                                     const Coef& c) {
  const float m = __fadd_rn(__fmul_rn(c.b1, mu), __fmul_rn(c.omb1, g));
  const float v =
      __fadd_rn(__fmul_rn(c.b2, nu), __fmul_rn(__fmul_rn(c.omb2, g), g));
  const float upd =
      __fdiv_rn(__fmul_rn(c.neg_lr, m), __fadd_rn(__fsqrt_rn(v), c.eps));
  p = __fadd_rn(p, upd);
  mu = m;
  nu = v;
}

__global__ void selective_adam_vec4(float4* __restrict__ p,
                                    const float4* __restrict__ g,
                                    float4* __restrict__ mu,
                                    float4* __restrict__ nu,
                                    const unsigned char* __restrict__ vis,
                                    long long n4, int inner, Coef c) {
  const long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (q >= n4) return;
  const long long i0 = 4 * q;
  bool on[4];
  bool any = false;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    on[j] = vis[(i0 + j) / inner] != 0;
    any |= on[j];
  }
  if (!any) return;
  float4 pp = p[q], gg = g[q], mm = mu[q], vv = nu[q];
  float* pf = reinterpret_cast<float*>(&pp);
  const float* gf = reinterpret_cast<const float*>(&gg);
  float* mf = reinterpret_cast<float*>(&mm);
  float* vf = reinterpret_cast<float*>(&vv);
#pragma unroll
  for (int j = 0; j < 4; j++)
    if (on[j]) step(pf[j], gf[j], mf[j], vf[j], c);
  p[q] = pp;
  mu[q] = mm;
  nu[q] = vv;
}

__global__ void selective_adam_scalar(float* __restrict__ p,
                                      const float* __restrict__ g,
                                      float* __restrict__ mu,
                                      float* __restrict__ nu,
                                      const unsigned char* __restrict__ vis,
                                      long long n, int inner, Coef c) {
  const long long i0 = 4 * ((long long)blockIdx.x * THREADS + threadIdx.x);
#pragma unroll
  for (int j = 0; j < 4; j++) {
    const long long i = i0 + j;
    if (i >= n || vis[i / inner] == 0) continue;
    float pi = p[i], mi = mu[i], vi = nu[i];
    step(pi, g[i], mi, vi, c);
    p[i] = pi;
    mu[i] = mi;
    nu[i] = vi;
  }
}

}  // namespace

// p, g, mu, nu: float32 [n] (a group flattened, rows of ``inner`` elements);
// vis: one byte a row, 0 for a row the step leaves as it is.
extern "C" int gsc_selective_adam(void* p, const void* g, void* mu, void* nu,
                                  const void* vis, long long n, int inner,
                                  float neg_lr, float b1, float omb1,
                                  float b2, float omb2, float eps,
                                  void* stream) {
  if (n < 0 || inner <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const Coef c{neg_lr, b1, omb1, b2, omb2, eps};
  const long long quads = (n + 3) / 4;
  const unsigned blocks = (unsigned)((quads + THREADS - 1) / THREADS);
  const bool vec = n % 4 == 0 && (uintptr_t)p % 16 == 0 &&
                   (uintptr_t)g % 16 == 0 && (uintptr_t)mu % 16 == 0 &&
                   (uintptr_t)nu % 16 == 0;
  const unsigned char* v = static_cast<const unsigned char*>(vis);
  if (vec) {
    selective_adam_vec4<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<float4*>(p), static_cast<const float4*>(g),
        static_cast<float4*>(mu), static_cast<float4*>(nu), v, quads, inner,
        c);
  } else {
    selective_adam_scalar<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<float*>(p), static_cast<const float*>(g),
        static_cast<float*>(mu), static_cast<float*>(nu), v, n, inner, c);
  }
  return (int)cudaGetLastError();
}
