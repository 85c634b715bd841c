// Block-arrow Cholesky factor and multi-RHS substitution as device
// functions, the counterparts of flybody_tpu/ops/arrow.py's
// _make_factor_body (:371) and _make_solve_body (:439). K3 (arrow.cu), the
// Newton kernels (newton.cu) and the fused noslip (noslip.cu) call them.
//
// Packed layout (nl + 1, dm + nr, dm) per env (ops/arrow.py): limb block l
// holds D_l in rows [0, dm) and its root border B_l in rows [dm, dm + nr);
// block nl holds the root block R in [0, nr) x [0, nr). Padded limb
// diagonal entries (sizes below dm) hold the identity and stay untouched.
//
// Every thread of the block calls each function (it synchronises the
// block before it returns); the matrix and the right-hand sides live in
// shared memory.
#pragma once

#include "common.cuh"

struct ArrowPart {
  int nl, dm, nr, nv;
  int lo[16];  // first dof of each limb block
  int d[16];   // size of each limb block
};

// In place: the packed symmetric matrix A becomes its packed factor
// (L_l, LB_l = B_l L_l^-T, L_R), zeros above each live diagonal. Reads
// only the lower triangles of D_l and R. Each limb block is factored by a
// group of G threads of one warp (G the largest power of two with G * nl
// threads in the block, at most 32): column k is scaled, then the group
// splits the trailing update's rows. Then the root Schur complement
// R - sum_l LB_l LB_l^T over all threads, and thread 0 factors the root
// block. Every entry sees the same operations in the same order for any
// G.
__device__ __forceinline__ void arrow_factor(float* A, const ArrowPart& p) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int dm = p.dm, nr = p.nr, nl = p.nl;
  const int rowlen = (dm + nr) * dm;
  int G = 1;
  while (2 * G * nl <= nt && 2 * G <= 32) G *= 2;
  const int l = t / G, gt = t % G;
  if (l < nl) {
    const int lane0 = (t & 31) / G * G;
    const unsigned mask =
        G == 32 ? 0xffffffffu : ((1u << G) - 1u) << lane0;
    float* D = A + l * rowlen;
    const int d = p.d[l];
    for (int k = 0; k < d; ++k) {
      const float inv = rsqrtf(fmaxf(D[k * dm + k], 1e-30f));
      __syncwarp(mask);
      for (int i = k + gt; i < d; i += G) D[i * dm + k] *= inv;
      for (int r = gt; r < nr; r += G) D[(dm + r) * dm + k] *= inv;
      __syncwarp(mask);
      for (int j = k + 1; j < d; ++j) {
        const float ljk = D[j * dm + k];
        for (int i = j + gt; i < d; i += G) D[i * dm + j] -= D[i * dm + k] * ljk;
        for (int r = gt; r < nr; r += G)
          D[(dm + r) * dm + j] -= D[(dm + r) * dm + k] * ljk;
      }
      __syncwarp(mask);
    }
    for (int i = gt; i < d; i += G)
      for (int j = i + 1; j < dm; ++j) D[i * dm + j] = 0.f;
  }
  __syncthreads();
  float* R = A + nl * rowlen;
  for (int q = t; q < nr * nr; q += nt) {
    const int r = q / nr, c = q % nr;
    float s = R[r * dm + c];
    for (int l = 0; l < nl; ++l) {
      const float* LB = A + l * rowlen + dm * dm;
      for (int k = 0; k < p.d[l]; ++k) s -= LB[r * dm + k] * LB[c * dm + k];
    }
    R[r * dm + c] = s;
  }
  __syncthreads();
  if (t == 0) {
    for (int k = 0; k < nr; ++k) {
      const float inv = rsqrtf(fmaxf(R[k * dm + k], 1e-30f));
      for (int i = k; i < nr; ++i) R[i * dm + k] *= inv;
      for (int j = k + 1; j < nr; ++j)
        for (int i = j; i < nr; ++i) R[i * dm + j] -= R[i * dm + k] * R[j * dm + k];
    }
    for (int r = 0; r < nr; ++r)
      for (int c = r + 1; c < nr; ++c) R[r * dm + c] = 0.f;
  }
  __syncthreads();
}

// In place: nrhs right-hand sides X (dof layout, row stride ld) become
// A^-1 X for the packed factor F. Forward substitution per (limb, rhs),
// the root right-hand side per (root dof, rhs), the root solve per rhs,
// then the back substitution per (limb, rhs).
__device__ __forceinline__ void arrow_solve(const float* F, float* X, int nrhs,
                                            int ld, const ArrowPart& p) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int dm = p.dm, nr = p.nr, nl = p.nl;
  const int rowlen = (dm + nr) * dm;
  for (int q = t; q < nl * nrhs; q += nt) {
    const int l = q % nl, j = q / nl;
    const float* D = F + l * rowlen;
    float* y = X + (size_t)j * ld + p.lo[l];
    for (int k = 0; k < p.d[l]; ++k) {
      float s = y[k];
      for (int i = 0; i < k; ++i) s -= D[k * dm + i] * y[i];
      y[k] = s / D[k * dm + k];
    }
  }
  __syncthreads();
  for (int q = t; q < nr * nrhs; q += nt) {
    const int r = q % nr, j = q / nr;
    float* x = X + (size_t)j * ld;
    float s = x[r];
    for (int l = 0; l < nl; ++l) {
      const float* LB = F + l * rowlen + dm * dm;
      const float* y = x + p.lo[l];
      for (int k = 0; k < p.d[l]; ++k) s -= LB[r * dm + k] * y[k];
    }
    x[r] = s;
  }
  __syncthreads();
  const float* LR = F + nl * rowlen;
  for (int j = t; j < nrhs; j += nt) {
    float* x = X + (size_t)j * ld;
    for (int k = 0; k < nr; ++k) {
      float s = x[k];
      for (int i = 0; i < k; ++i) s -= LR[k * dm + i] * x[i];
      x[k] = s / LR[k * dm + k];
    }
    for (int k = nr - 1; k >= 0; --k) {
      float s = x[k];
      for (int i = k + 1; i < nr; ++i) s -= LR[i * dm + k] * x[i];
      x[k] = s / LR[k * dm + k];
    }
  }
  __syncthreads();
  for (int q = t; q < nl * nrhs; q += nt) {
    const int l = q % nl, j = q / nl;
    const float* D = F + l * rowlen;
    const float* xr = X + (size_t)j * ld;
    float* y = X + (size_t)j * ld + p.lo[l];
    const int d = p.d[l];
    for (int a = 0; a < d; ++a) {
      float s = y[a];
      for (int r = 0; r < nr; ++r) s -= D[(dm + r) * dm + a] * xr[r];
      y[a] = s;
    }
    for (int k = d - 1; k >= 0; --k) {
      float s = y[k];
      for (int i = k + 1; i < d; ++i) s -= D[i * dm + k] * y[i];
      y[k] = s / D[k * dm + k];
    }
  }
  __syncthreads();
}

// y = M x for the packed symmetric M (both triangles stored), one thread
// per output dof (M in shared or global memory: the loops are unrolled so
// that several of M's loads are in flight ahead of the sum).
__device__ __forceinline__ void arrow_matvec(const float* M, const float* x,
                                             float* y, const ArrowPart& p) {
  const int dm = p.dm, nr = p.nr, nl = p.nl;
  const int rowlen = (dm + nr) * dm;
  for (int v = threadIdx.x; v < p.nv; v += blockDim.x) {
    float s = 0.f;
    if (v < nr) {
      const float* R = M + nl * rowlen;
#pragma unroll 4
      for (int c = 0; c < nr; ++c) s += R[v * dm + c] * x[c];
      for (int l = 0; l < nl; ++l) {
        const float* Bl = M + l * rowlen + (dm + v) * dm;
        const float* xl = x + p.lo[l];
#pragma unroll 8
        for (int k = 0; k < p.d[l]; ++k) s += Bl[k] * xl[k];
      }
    } else {
      int l = 0;
      while (l + 1 < nl && p.lo[l + 1] <= v) ++l;
      const int a = v - p.lo[l];
      const float* D = M + l * rowlen;
      const float* xl = x + p.lo[l];
#pragma unroll 8
      for (int k = 0; k < p.d[l]; ++k) s += D[a * dm + k] * xl[k];
#pragma unroll 4
      for (int r = 0; r < nr; ++r) s += D[(dm + r) * dm + a] * x[r];
    }
    y[v] = s;
  }
}
