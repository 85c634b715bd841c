// Kernel 11: the fused noslip post-pass.
//
// Replaces flybody_tpu/ops/noslip_gs.py::make_noslip_fused_pe (:227, the
// Pallas call at :283). Semantics: noslip_fused_ref in
// flybody_tpu_torch/ops/noslip_gs.py: P = M^-1 J_t^T with the packed arrow
// factor of M (2K right-hand sides), the closed-form inverses of the 2x2
// blocks A_k = J_t,k P_k, then `iterations` Gauss-Seidel sweeps over the K
// contact slots: each updates the slot's two tangent forces from the
// residual J_t,k x - aref, clamps them to the friction circle of radius
// mu f_n, and moves x by P_k times the change.
//
// What bounds it: bytes. Per env it reads the factor (14.6 KB) and J_t
// (2K x nv: 55 KB at K = 64) and writes x and the tangent forces: ~73 KB
// at K = 64, ~30 KB at K = 16. Design: one block of 128 threads per env.
// The factor and P (2K x nv) sit in shared memory; the substitution runs
// in parallel over (limb, right-hand side) pairs (arrow.cuh), the 2x2
// inverses one warp per slot, and the 3K sequential updates in one warp:
// each is two 108-long dot products with butterfly sums (every lane holds
// the result, so no barrier) and a 108-long update of x. J_t is re-read
// from global memory (L2) by the dot products; each lane holds its four
// entries of a slot's rows in registers and loads the next slot's while
// the current one updates, so the sweep does not wait on L2 per update;
// the slots' aref, radii and masks are staged in shared memory.

#include "arrow.cuh"
#include "linesearch.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerLane = 4;  // dofs per lane in the sweeps: nv <= 128

__global__ void __launch_bounds__(kThreads)
    noslip_kernel(const float* __restrict__ F, const float* __restrict__ Jt,
                  const float* __restrict__ aref, const float* __restrict__ lim,
                  const float* __restrict__ use, const float* __restrict__ x0,
                  const float* __restrict__ ft0, float* __restrict__ x_o,
                  float* __restrict__ ft_o, int K, int iterations,
                  ArrowPart p) {
  extern __shared__ float sm[];
  const int e = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nw = nt >> 5;
  const int nv = p.nv, K2 = 2 * K;
  const int msize = (p.nl + 1) * (p.dm + p.nr) * p.dm;
  float* A = sm;                 // packed factor
  float* P = A + msize;          // (2K, nv): J_t rows -> M^-1 J_t^T columns
  float* Ai = P + K2 * nv;       // (K, 4) 2x2 inverses, row-major
  float* x = Ai + 4 * K;         // (nv)
  float* ft = x + nv;            // (K, 2)
  float* ar = ft + K2;           // (K, 2) tangent aref
  float* lm = ar + K2;           // (K) friction-circle radii
  float* us = lm + K;            // (K) active frictional slots
  const float* Je = Jt + (size_t)e * K2 * nv;

  const float* Fe = F + (size_t)e * msize;
  for (int i = t; i < msize; i += nt) A[i] = Fe[i];
  for (int i = t; i < K2 * nv; i += nt) P[i] = Je[i];
  for (int v = t; v < nv; v += nt) x[v] = x0[(size_t)e * nv + v];
  for (int q = t; q < K2; q += nt) {
    ft[q] = ft0[(size_t)e * K2 + q];
    ar[q] = aref[(size_t)e * K2 + q];
  }
  for (int k = t; k < K; k += nt) {
    lm[k] = lim[(size_t)e * K + k];
    us[k] = use[(size_t)e * K + k];
  }
  __syncthreads();
  arrow_solve(A, P, K2, nv, p);

  for (int k = warp; k < K; k += nw) {
    const float* j0 = Je + (2 * k) * nv;
    const float* j1 = j0 + nv;
    const float* p0 = P + (2 * k) * nv;
    const float* p1 = p0 + nv;
    float a = 0.f, b = 0.f, c = 0.f, d = 0.f;
    for (int v = lane; v < nv; v += 32) {
      a += j0[v] * p0[v];
      b += j0[v] * p1[v];
      c += j1[v] * p0[v];
      d += j1[v] * p1[v];
    }
    a = warp_sum(a), b = warp_sum(b), c = warp_sum(c), d = warp_sum(d);
    if (lane == 0) {
      float det = a * d - b * c;
      if (!(fabsf(det) > 1e-12f)) det = det >= 0.f ? 1e-12f : -1e-12f;
      Ai[4 * k] = d / det;
      Ai[4 * k + 1] = -b / det;
      Ai[4 * k + 2] = -c / det;
      Ai[4 * k + 3] = a / det;
    }
  }
  __syncthreads();

  if (warp == 0) {
    // This lane's entries (dofs lane + 32 q) of the slot's two tangent
    // rows; the next slot's rows load while this one updates.
    float c0[kPerLane], c1[kPerLane], n0r[kPerLane], n1r[kPerLane];
    auto load_rows = [&](int k, float* a0, float* a1) {
      const float* j0 = Je + (2 * k) * nv;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int v = lane + 32 * q;
        a0[q] = v < nv ? j0[v] : 0.f;
        a1[q] = v < nv ? j0[nv + v] : 0.f;
      }
    };
    load_rows(0, c0, c1);
    for (int it = 0; it < iterations; ++it) {
      for (int k = 0; k < K; ++k) {
        load_rows(k + 1 < K ? k + 1 : 0, n0r, n1r);
        float r0 = 0.f, r1 = 0.f;
#pragma unroll
        for (int q = 0; q < kPerLane; ++q) {
          const int v = lane + 32 * q;
          if (v < nv) {
            r0 += c0[q] * x[v];
            r1 += c1[q] * x[v];
          }
        }
        r0 = warp_sum(r0) - ar[2 * k];
        r1 = warp_sum(r1) - ar[2 * k + 1];
        const float* ai = Ai + 4 * k;
        const float f0 = ft[2 * k], f1 = ft[2 * k + 1];
        float n0 = f0 - (ai[0] * r0 + ai[1] * r1);
        float n1 = f1 - (ai[2] * r0 + ai[3] * r1);
        const float norm = sqrtf(n0 * n0 + n1 * n1);
        const float lk = lm[k];
        if (norm > lk) {
          const float s = lk / fmaxf(norm, 1e-15f);
          n0 *= s;
          n1 *= s;
        }
        if (!(us[k] > 0.f)) n0 = f0, n1 = f1;
        const float d0 = n0 - f0, d1 = n1 - f1;
        const float* p0 = P + (2 * k) * nv;
        const float* p1 = p0 + nv;
        for (int v = lane; v < nv; v += 32) x[v] += p0[v] * d0 + p1[v] * d1;
        __syncwarp();
        if (lane == 0) {
          ft[2 * k] = n0;
          ft[2 * k + 1] = n1;
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < kPerLane; ++q) c0[q] = n0r[q], c1[q] = n1r[q];
      }
    }
  }
  __syncthreads();
  for (int v = t; v < nv; v += nt) x_o[(size_t)e * nv + v] = x[v];
  for (int q = t; q < K2; q += nt) ft_o[(size_t)e * K2 + q] = ft[q];
}

}  // namespace

FB_API int noslip_fused_f32(const float* F, const float* Jt, const float* aref,
                            const float* lim, const float* use,
                            const float* x0, const float* ft0, float* x,
                            float* ft, int B, int K, int iterations,
                            const ArrowPart* part, void* stream) {
  if (part->nl > 16 || part->nl < 1 || K < 1 || B < 1) return -1;
  if (part->nv > 32 * kPerLane) return -1;
  const int msize = (part->nl + 1) * (part->dm + part->nr) * part->dm;
  const size_t smem =
      sizeof(float) * ((size_t)msize + 2 * K * part->nv + 8 * K + part->nv + 2 * K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        noslip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  noslip_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      F, Jt, aref, lim, use, x0, ft0, x, ft, K, iterations, *part);
  return (int)cudaGetLastError();
}
