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
// shared memory with coalesced loads, lanes 0..nl-1 each factor and
// forward-substitute one limb block (with its root border) in place, the
// warp forms the root Schur complement, lane 0 factors and solves the
// small root block, and the limb lanes finish the back substitution. The
// identity on padded limb diagonals (sizes below dmax) stays in place, so
// the padded rows factor and solve trivially. Twelve of 32 lanes do the
// limb work; a layout that spreads a limb's columns over lanes is the
// next step.

#include "common.cuh"

namespace {

struct Limbs {
  int lo[16];
  int d[16];
};

__global__ void arrow_factor_solve_kernel(const float* __restrict__ Mp,
                                          const float* __restrict__ b,
                                          float* __restrict__ F,
                                          float* __restrict__ x, int nl,
                                          int dm, int nr, int nv,
                                          Limbs limbs) {
  extern __shared__ float sm[];
  const int e = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int rowlen = (dm + nr) * dm;
  const int msize = (nl + 1) * rowlen;
  float* A = sm;             // packed matrix, factored in place
  float* y = A + msize;      // (nl, dm) limb rhs -> y -> x
  float* yr = y + nl * dm;   // (nr) root rhs -> y -> x
  float* S = yr + nr;        // (nr, nr) root Schur complement -> L_R
  const float* Me = Mp + (size_t)e * msize;
  const float* be = b + (size_t)e * nv;

  for (int k = t; k < msize; k += nt) A[k] = Me[k];
  for (int k = t; k < nl * dm; k += nt) {
    const int l = k / dm, a = k % dm;
    y[k] = a < limbs.d[l] ? be[limbs.lo[l] + a] : 0.f;
  }
  for (int r = t; r < nr; r += nt) yr[r] = be[r];
  __syncthreads();

  if (t < nl) {  // limb t: factor D = L L^T, border LB = B L^-T, y = L^-1 b
    float* D = A + t * rowlen;
    float* yl = y + t * dm;
    const int d = limbs.d[t];
    for (int k = 0; k < d; ++k) {
      const float inv = rsqrtf(fmaxf(D[k * dm + k], 1e-30f));
      for (int i = k; i < d; ++i) D[i * dm + k] *= inv;
      for (int r = 0; r < nr; ++r) D[(dm + r) * dm + k] *= inv;
      for (int j = k + 1; j < d; ++j) {
        const float ljk = D[j * dm + k];
        for (int i = j; i < d; ++i) D[i * dm + j] -= D[i * dm + k] * ljk;
        for (int r = 0; r < nr; ++r)
          D[(dm + r) * dm + j] -= D[(dm + r) * dm + k] * ljk;
      }
    }
    for (int i = 0; i < d; ++i)
      for (int j = i + 1; j < dm; ++j) D[i * dm + j] = 0.f;
    for (int k = 0; k < d; ++k) {
      float s = yl[k];
      for (int j = 0; j < k; ++j) s -= D[k * dm + j] * yl[j];
      yl[k] = s / D[k * dm + k];
    }
  }
  __syncthreads();

  // Root: S = R - sum_l LB_l LB_l^T and y_r = b_r - sum_l LB_l y_l.
  const float* R = A + nl * rowlen;
  for (int q = t; q < nr * nr; q += nt) {
    const int r = q / nr, c = q % nr;
    float s = R[r * dm + c];
    for (int l = 0; l < nl; ++l) {
      const float* LB = A + l * rowlen + dm * dm;
      for (int k = 0; k < limbs.d[l]; ++k) s -= LB[r * dm + k] * LB[c * dm + k];
    }
    S[q] = s;
  }
  for (int r = t; r < nr; r += nt) {
    float s = yr[r];
    for (int l = 0; l < nl; ++l) {
      const float* LB = A + l * rowlen + dm * dm;
      for (int k = 0; k < limbs.d[l]; ++k) s -= LB[r * dm + k] * y[l * dm + k];
    }
    yr[r] = s;
  }
  __syncthreads();

  if (t == 0) {  // root block: L_R, then L_R L_R^T x_r = y_r
    for (int k = 0; k < nr; ++k) {
      const float inv = rsqrtf(fmaxf(S[k * nr + k], 1e-30f));
      for (int i = k; i < nr; ++i) S[i * nr + k] *= inv;
      for (int j = k + 1; j < nr; ++j)
        for (int i = j; i < nr; ++i) S[i * nr + j] -= S[i * nr + k] * S[j * nr + k];
    }
    for (int k = 0; k < nr; ++k) {
      float s = yr[k];
      for (int j = 0; j < k; ++j) s -= S[k * nr + j] * yr[j];
      yr[k] = s / S[k * nr + k];
    }
    for (int k = nr - 1; k >= 0; --k) {
      float s = yr[k];
      for (int i = k + 1; i < nr; ++i) s -= S[i * nr + k] * yr[i];
      yr[k] = s / S[k * nr + k];
    }
    float* LR = A + nl * rowlen;
    for (int r = 0; r < nr; ++r)
      for (int c = 0; c < nr; ++c) LR[r * dm + c] = c <= r ? S[r * nr + c] : 0.f;
  }
  __syncthreads();

  if (t < nl) {  // limb t: y -= LB^T x_r, then L^T x = y
    const float* D = A + t * rowlen;
    float* yl = y + t * dm;
    const int d = limbs.d[t];
    for (int a = 0; a < d; ++a) {
      float s = yl[a];
      for (int r = 0; r < nr; ++r) s -= D[(dm + r) * dm + a] * yr[r];
      yl[a] = s;
    }
    for (int k = d - 1; k >= 0; --k) {
      float s = yl[k];
      for (int i = k + 1; i < d; ++i) s -= D[i * dm + k] * yl[i];
      yl[k] = s / D[k * dm + k];
    }
  }
  __syncthreads();

  float* Fe = F + (size_t)e * msize;
  for (int k = t; k < msize; k += nt) Fe[k] = A[k];
  float* xe = x + (size_t)e * nv;
  for (int k = t; k < nl * dm; k += nt) {
    const int l = k / dm, a = k % dm;
    if (a < limbs.d[l]) xe[limbs.lo[l] + a] = y[k];
  }
  for (int r = t; r < nr; r += nt) xe[r] = yr[r];
}

}  // namespace

FB_API int arrow_factor_solve_f32(const float* Mp, const float* b, float* F,
                                  float* x, int B, int nl, int dm, int nr,
                                  int nv, const Limbs* limbs, void* stream) {
  if (nl > 16 || nl < 1) return -1;
  const size_t smem =
      sizeof(float) * ((size_t)(nl + 1) * (dm + nr) * dm + nl * dm + nr + nr * nr);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(arrow_factor_solve_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  arrow_factor_solve_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      Mp, b, F, x, nl, dm, nr, nv, *limbs);
  return (int)cudaGetLastError();
}
