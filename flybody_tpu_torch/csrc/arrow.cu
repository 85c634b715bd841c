// Kernel K3: fused block-arrow Cholesky factor + solve, one rhs per env.
//
// Replaces flybody_tpu/ops/arrow.py::_factor_solve_fn (the fused Pallas
// factor+solve reached through ops_for(part).chol_solve_pe), used twice per
// substep: the smooth acceleration (smooth.factor_solve_m) and the damped
// Euler solve (smooth.euler). Input: the packed symmetric matrix
// (nl+1, dm+nr, dm) and b (nv); output: the packed factor and x = A^-1 b.
// Semantics: factor_solve_ref in flybody_tpu_torch/ops/arrow.py.
//
// What bounds it: bytes. Per env it moves the packed matrix in and the
// factor out (3,640 floats each, 30 KB with b and x) for ~15k flops. The
// TPU kernel processed all limbs of 128 envs as lanes of one column loop;
// here one block of one warp owns one env: the packed matrix is staged in
// shared memory with coalesced loads, lanes 0..nl-1 each factor one limb
// block (with its root border) in place, the warp forms the root Schur
// complement, lane 0 factors the small root block, and the substitution
// runs per limb (arrow_factor / arrow_solve in arrow.cuh, which the Newton
// and noslip kernels share). The identity on padded limb diagonals (sizes
// below dmax) stays in place, so the padded rows factor trivially. Twelve
// of 32 lanes do the limb work; a layout that spreads a limb's columns over
// lanes is the next step.

#include "arrow.cuh"

namespace {

struct Limbs {
  int lo[16];
  int d[16];
};

__global__ void arrow_factor_solve_kernel(const float* __restrict__ Mp,
                                          const float* __restrict__ b,
                                          float* __restrict__ F,
                                          float* __restrict__ x,
                                          ArrowPart p) {
  extern __shared__ float sm[];
  const int e = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int msize = (p.nl + 1) * (p.dm + p.nr) * p.dm;
  float* A = sm;          // packed matrix, factored in place
  float* y = A + msize;   // (nv) rhs -> x, dof layout
  const float* Me = Mp + (size_t)e * msize;
  const float* be = b + (size_t)e * p.nv;

  for (int k = t; k < msize; k += nt) A[k] = Me[k];
  for (int k = t; k < p.nv; k += nt) y[k] = be[k];
  __syncthreads();
  arrow_factor(A, p);
  arrow_solve(A, y, 1, p.nv, p);

  float* Fe = F + (size_t)e * msize;
  for (int k = t; k < msize; k += nt) Fe[k] = A[k];
  float* xe = x + (size_t)e * p.nv;
  for (int k = t; k < p.nv; k += nt) xe[k] = y[k];
}

}  // namespace

FB_API int arrow_factor_solve_f32(const float* Mp, const float* b, float* F,
                                  float* x, int B, int nl, int dm, int nr,
                                  int nv, const Limbs* limbs, void* stream) {
  if (nl > 16 || nl < 1) return -1;
  ArrowPart p;
  p.nl = nl;
  p.dm = dm;
  p.nr = nr;
  p.nv = nv;
  for (int i = 0; i < 16; ++i) {
    p.lo[i] = limbs->lo[i];
    p.d[i] = limbs->d[i];
  }
  const size_t smem = sizeof(float) * ((size_t)(nl + 1) * (dm + nr) * dm + nv);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(arrow_factor_solve_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  arrow_factor_solve_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(Mp, b, F, x,
                                                                   p);
  return (int)cudaGetLastError();
}
