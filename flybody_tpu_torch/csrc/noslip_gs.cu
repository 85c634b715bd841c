// Row 12: the noslip Gauss-Seidel sweeps of the dense path.
//
// Replaces flybody_tpu/ops/noslip_gs.py::_noslip_pallas (:77, the Pallas
// call at :88), reached through make_gs_pe from the dense branch of
// solver.noslip. Given per env the tangent Jacobian rows Jt (K, 2, nv), the
// columns of P = M^-1 J_t^T in the same layout Pt (K, 2, nv), the 2x2 block
// inverses Ainv (K, 2, 2), aref (K, 2), the friction-circle radii lim (K),
// the active-frictional mask use (K), x0 (nv) and ft0 (K, 2), it runs
// `iterations` sweeps over the K slots in order: the residual J_t,k x -
// aref_k, the new tangent forces ft_k - Ainv_k res clamped to the radius,
// and x += P_k (new - old). Semantics: gs_ref in
// flybody_tpu_torch/ops/noslip_gs.py.
//
// What bounds it: bytes. Per env it reads Jt and Pt (2 x 2K x nv floats:
// 221 KB at K = 64, nv = 216) and the small per-slot rows, and writes x and
// ft. The TPU kernel kept a 128-env block of everything in VMEM; here one
// block of 128 threads owns one env, each thread holds its dofs of x in
// registers (up to kPerThread), the two dot products of a slot are reduced
// across the block through a double-buffered shared array (one barrier a
// slot), and every thread then computes the same slot update. The next
// slot's Jt rows load while the current slot updates. Unlike kernel 11
// (noslip.cu, one warp, nv <= 128) it takes any nv up to kThreads x
// kPerThread.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;  // dofs per thread: nv <= 1024

__global__ void __launch_bounds__(kThreads)
    noslip_gs_kernel(const float* __restrict__ Jt, const float* __restrict__ Pt,
                     const float* __restrict__ Ainv,
                     const float* __restrict__ aref,
                     const float* __restrict__ lim,
                     const float* __restrict__ use,
                     const float* __restrict__ x0,
                     const float* __restrict__ ft0, float* __restrict__ x_o,
                     float* __restrict__ ft_o, int nv, int K,
                     int iterations) {
  extern __shared__ float ft[];  // (K, 2) tangent forces
  __shared__ float red[2][2][kWarps];
  const int e = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* Je = Jt + (size_t)e * K * 2 * nv;
  const float* Pe = Pt + (size_t)e * K * 2 * nv;
  const float* Ae = Ainv + (size_t)e * K * 4;
  const float* re = aref + (size_t)e * K * 2;

  float x[kPerThread], j0[kPerThread], j1[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int v = t + q * kThreads;
    x[q] = v < nv ? x0[(size_t)e * nv + v] : 0.f;
  }
  for (int i = t; i < 2 * K; i += kThreads) ft[i] = ft0[(size_t)e * 2 * K + i];
  auto load_rows = [&](int k) {
    const float* r0 = Je + (size_t)k * 2 * nv;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int v = t + q * kThreads;
      j0[q] = v < nv ? r0[v] : 0.f;
      j1[q] = v < nv ? r0[nv + v] : 0.f;
    }
  };
  load_rows(0);
  __syncthreads();

  int step = 0;
  for (int it = 0; it < iterations; ++it) {
    for (int k = 0; k < K; ++k, ++step) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        s0 += j0[q] * x[q];
        s1 += j1[q] * x[q];
      }
      s0 = warp_sum(s0);
      s1 = warp_sum(s1);
      const int buf = step & 1;
      if (lane == 0) {
        red[buf][0][warp] = s0;
        red[buf][1][warp] = s1;
      }
      const float f0 = ft[2 * k], f1 = ft[2 * k + 1];
      // The slot's P rows and the next slot's J rows load across the
      // barrier.
      const float* p0 = Pe + (size_t)k * 2 * nv;
      float pa[kPerThread], pb[kPerThread];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int v = t + q * kThreads;
        pa[q] = v < nv ? p0[v] : 0.f;
        pb[q] = v < nv ? p0[nv + v] : 0.f;
      }
      load_rows(k + 1 < K ? k + 1 : 0);
      __syncthreads();
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        r0 += red[buf][0][w];
        r1 += red[buf][1][w];
      }
      r0 -= re[2 * k];
      r1 -= re[2 * k + 1];
      const float* ai = Ae + 4 * k;
      float n0 = f0 - (ai[0] * r0 + ai[1] * r1);
      float n1 = f1 - (ai[2] * r0 + ai[3] * r1);
      const float norm = sqrtf(n0 * n0 + n1 * n1);
      const float lk = lim[(size_t)e * K + k];
      if (norm > lk) {
        const float s = lk / fmaxf(norm, 1e-15f);
        n0 *= s;
        n1 *= s;
      }
      if (!(use[(size_t)e * K + k] > 0.f)) n0 = f0, n1 = f1;
      const float d0 = n0 - f0, d1 = n1 - f1;
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) x[q] += pa[q] * d0 + pb[q] * d1;
      if (t == 0) {
        ft[2 * k] = n0;
        ft[2 * k + 1] = n1;
      }
      if (K == 1) __syncthreads();  // the next step reads this slot again
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int v = t + q * kThreads;
    if (v < nv) x_o[(size_t)e * nv + v] = x[q];
  }
  for (int i = t; i < 2 * K; i += kThreads) ft_o[(size_t)e * 2 * K + i] = ft[i];
}

}  // namespace

FB_API int noslip_gs_f32(const float* Jt, const float* Pt, const float* Ainv,
                         const float* aref, const float* lim, const float* use,
                         const float* x0, const float* ft0, float* x, float* ft,
                         int B, int nv, int K, int iterations, void* stream) {
  if (B < 1 || K < 1 || nv < 1 || iterations < 0) return -1;
  if (nv > kThreads * kPerThread) return -1;
  const size_t smem = sizeof(float) * 2 * (size_t)K;
  if (smem > 48 * 1024) return -1;
  noslip_gs_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      Jt, Pt, Ainv, aref, lim, use, x0, ft0, x, ft, nv, K, iterations);
  return (int)cudaGetLastError();
}
