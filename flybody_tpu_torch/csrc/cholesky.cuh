// Dense Cholesky factor and substitutions on one env's matrix in shared
// memory: the device functions of rows 15, 16 and 17 (csrc/cholesky.cu),
// the counterparts of flybody_tpu/ops/cholesky.py's _chol_kernel and
// _solve_kernel / _solve_multi_kernel. Semantics: chol_ref, subst_ref in
// flybody_tpu_torch/ops/cholesky.py.
//
// Layout: only the lower triangle is kept, packed by columns: column j
// holds rows j..n-1 at S[tri_col(n, j) + i - j]. At n = 216 that is 93.7 KB
// of float32 (the full matrix would be 187 KB), so two blocks fit on an SM.
// Packing by columns makes a column contiguous, so threads that own
// consecutive rows touch consecutive words of a column: the factor's
// trailing update and the substitutions' column sweeps are free of bank
// conflicts.
#pragma once

#include "common.cuh"

__device__ __forceinline__ int tri_col(int n, int j) {
  return j * n - (j * (j - 1)) / 2;
}

__host__ __device__ __forceinline__ size_t tri_size(int n) {
  return (size_t)n * (n + 1) / 2;
}

// S <- the lower triangle of the row-major (n, n) matrix A (global). All
// threads; each issues kLoadBatch loads before it stores any, so the loads
// overlap, and entries above the diagonal are not fetched.
constexpr int kLoadBatch = 8;

__device__ __forceinline__ void tri_load(const float* __restrict__ A, float* S,
                                         int n) {
  const int nn = n * n, nt = blockDim.x;
  for (int base = threadIdx.x; base < nn; base += kLoadBatch * nt) {
    float v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = base + u * nt, i = idx / n, j = idx - i * n;
      v[u] = idx < nn && j <= i ? A[idx] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = base + u * nt, i = idx / n, j = idx - i * n;
      if (idx < nn && j <= i) S[tri_col(n, j) + i - j] = v[u];
    }
  }
}

// L (global, row-major (n, n)) <- S with zeros above the diagonal.
__device__ __forceinline__ void tri_store(const float* S, float* __restrict__ L,
                                          int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    L[idx] = j <= i ? S[tri_col(n, j) + i - j] : 0.f;
  }
}

// In-place lower Cholesky of S, column by column (left-looking), threads
// over rows. Column k: each row i >= k subtracts from its entry the dot
// product of its row and row k over the columns j < k (its own entries, and
// row k's as broadcasts; no stores inside the loop, four independent sums,
// so the loads overlap); then every thread reads the pivot d, the rows
// below it are scaled by rsqrt(max(d, 1e-30)) (the TPU kernel's clamp) and
// the diagonal becomes d * rsqrt(d). Every thread of a column does the same
// k products. No jitter is added: the caller adds its own.
__device__ void chol_factor(float* S, int n) {
  const int t = threadIdx.x, nt = blockDim.x;
  int ck = 0;  // tri_col(n, k)
  for (int k = 0; k < n; ++k) {
    for (int i = k + t; i < n; i += nt) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      int cj = 0;  // tri_col(n, j)
      int j = 0;
      for (; j + 3 < k; j += 4) {
        const int c1 = cj + n - j, c2 = c1 + n - j - 1, c3 = c2 + n - j - 2;
        s0 += S[cj + i - j] * S[cj + k - j];
        s1 += S[c1 + i - j - 1] * S[c1 + k - j - 1];
        s2 += S[c2 + i - j - 2] * S[c2 + k - j - 2];
        s3 += S[c3 + i - j - 3] * S[c3 + k - j - 3];
        cj = c3 + n - j - 3;
      }
      for (; j < k; ++j) {
        s0 += S[cj + i - j] * S[cj + k - j];
        cj += n - j;
      }
      S[ck + i - k] -= (s0 + s1) + (s2 + s3);
    }
    __syncthreads();  // column k holds A - L L^T
    const float d = S[ck];
    const float inv = rsqrtf(fmaxf(d, 1e-30f));
    for (int i = k + 1 + t; i < n; i += nt) S[ck + i - k] *= inv;
    __syncthreads();  // every thread has read d; column k is scaled
    if (t == 0) S[ck] = d * inv;  // no later column reads a diagonal
    ck += n - k;
  }
}

// Solves L L^T x = b for one right-hand side with the whole block; x holds
// b on entry and the solution on exit. Each thread keeps the running
// right-hand side of its rows (i = t, t + nt) in registers. Forward, by
// columns: the owner of row k publishes y_k, and every row below subtracts
// L[i][k] y_k. Backward, by rows of L: the owner of row k publishes x_k,
// and every row j < k subtracts L[k][j] x_k. One barrier a row each way.
__device__ void chol_subst_block(const float* S, float* x, int n) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int i0 = t, i1 = t + nt;  // this thread's rows (n <= 2 nt)
  float r0 = i0 < n ? x[i0] : 0.f, r1 = i1 < n ? x[i1] : 0.f;
  int ck = 0;
  for (int k = 0; k < n; ++k) {
    if (k == i0) x[k] = r0 / S[ck];
    if (k == i1) x[k] = r1 / S[ck];
    __syncthreads();
    const float yk = x[k];
    if (i0 > k && i0 < n) r0 -= S[ck + i0 - k] * yk;
    if (i1 > k && i1 < n) r1 -= S[ck + i1 - k] * yk;
    ck += n - k;
  }
  __syncthreads();  // every read of the forward pass is done
  r0 = i0 < n ? x[i0] : 0.f;  // y of this thread's rows
  r1 = i1 < n ? x[i1] : 0.f;
  const int c0 = tri_col(n, i0), c1 = tri_col(n, i1);
  for (int k = n - 1; k >= 0; --k) {
    if (k == i0) x[k] = r0 / S[c0];
    if (k == i1) x[k] = r1 / S[c1];
    __syncthreads();
    const float xk = x[k];
    if (i0 < k) r0 -= S[c0 + k - i0] * xk;
    if (i1 < k) r1 -= S[c1 + k - i1] * xk;
  }
  __syncthreads();
}

// Solves L L^T X = B for the m columns of X (n rows, row stride m, in
// shared memory), one column per thread; X holds B on entry. The columns
// are independent, so no barrier is needed. Both substitutions go in blocks
// of kRowBlock rows: the block's sums over the rows already solved share
// each load of X (one load of X and kRowBlock broadcast loads of L for
// kRowBlock products, in kRowBlock independent sums), then the block's own
// triangle is solved in order. Every lane reads the same entry of L (a
// broadcast) and its own column of X (consecutive words).
constexpr int kRowBlock = 8;

__device__ void chol_subst_cols(const float* S, float* X, int n, int m) {
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    // Forward: y_k = (b_k - sum_{j<k} L[k][j] y_j) / L[k][k].
    for (int k0 = 0; k0 < n; k0 += kRowBlock) {
      const int nk = min(kRowBlock, n - k0);
      float s[kRowBlock];
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r) s[r] = 0.f;
      int cj = 0;  // tri_col(n, j)
      for (int j = 0; j < k0; ++j) {
        const float xj = X[j * m + c];
#pragma unroll
        for (int r = 0; r < kRowBlock; ++r)
          if (r < nk) s[r] += S[cj + k0 + r - j] * xj;
        cj += n - j;
      }
      // cj == tri_col(n, k0)
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r) {
        if (r < nk) {
          const int k = k0 + r;
          float acc = s[r];
          int cq = cj;  // tri_col(n, k0 + q)
          for (int q = 0; q < r; ++q) {
            acc += S[cq + r - q] * X[(k0 + q) * m + c];
            cq += n - k0 - q;
          }
          X[k * m + c] = (X[k * m + c] - acc) / S[cq];  // cq: tri_col(n, k)
        }
      }
    }
    // Backward: x_k = (y_k - sum_{j>k} L[j][k] x_j) / L[k][k].
    for (int k0 = ((n - 1) / kRowBlock) * kRowBlock; k0 >= 0;
         k0 -= kRowBlock) {
      const int nk = min(kRowBlock, n - k0);
      int cc[kRowBlock];  // tri_col(n, k0 + r)
      float s[kRowBlock];
      cc[0] = tri_col(n, k0);
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r) {
        if (r) cc[r] = cc[r - 1] + n - (k0 + r - 1);
        s[r] = 0.f;
      }
      for (int j = k0 + nk; j < n; ++j) {
        const float xj = X[j * m + c];
#pragma unroll
        for (int r = 0; r < kRowBlock; ++r)
          if (r < nk) s[r] += S[cc[r] + j - k0 - r] * xj;
      }
#pragma unroll
      for (int r = kRowBlock - 1; r >= 0; --r) {
        if (r < nk) {
          float acc = s[r];
          for (int q = r + 1; q < nk; ++q)
            acc += S[cc[r] + q - r] * X[(k0 + q) * m + c];
          X[(k0 + r) * m + c] = (X[(k0 + r) * m + c] - acc) / S[cc[r]];
        }
      }
    }
  }
}
