// Dense Cholesky factor and substitutions on one env's matrix in shared
// memory (csrc/cholesky.cu), the counterparts of
// flybody_tpu/ops/cholesky.py's _chol_kernel and _solve_kernel /
// _solve_multi_kernel. Semantics: chol_ref, subst_ref in
// flybody_tpu_torch/ops/cholesky.py.
//
// Rows 14 and 15 (below, to the row-packed section): only the lower
// triangle is kept, packed by columns: column j
// holds rows j..n-1 at S[tri_col(n, j) + i - j]. At n = 216 that is 93.7 KB
// of float32 (the full matrix would be 187 KB), so two blocks fit on an SM.
// Packing by columns makes a column contiguous, so threads that own
// consecutive rows touch consecutive words of a column: the factor's
// trailing update and the substitutions' column sweeps are free of bank
// conflicts.
#pragma once

#include "bulk.cuh"
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

// ---------------------------------------------------------------------------
// Rows 16 and 17: the lower triangle packed by rows.
//
// Row i holds columns 0..i at S[row_off(i) + j], then padding up to a
// multiple of 4 floats, so every row starts 16-byte aligned (at n = 216 the
// triangle takes 95.0 KB: two blocks fit on an SM beside their other
// buffers). Row i of a row-major (n, n) matrix is contiguous in global
// memory, so with n % 4 == 0 each row comes in by one 1-D bulk copy of
// pad4(i + 1) floats, and four consecutive columns of a row from a column
// that is a multiple of 4 are one 16-byte shared access. The padding may
// hold anything: no entry above the diagonal is ever read as a value.

__host__ __device__ __forceinline__ int pad4(int x) { return (x + 3) & ~3; }

// Floats before row i: sum_{r < i} pad4(r + 1) = 4 (a + 1)(2 a + b) for
// i = 4 a + b; row_off(n) is the whole triangle.
__host__ __device__ __forceinline__ int row_off(int i) {
  const int a = i >> 2, b = i & 3;
  return 4 * (a + 1) * (2 * a + b);
}

// S <- the lower triangle of the row-major (n, n) matrix A (global), and
// v <- the n floats at b (global; none when b is null). Bulk: when n % 4 == 0
// and A, b start 16-byte aligned, warp 0 issues one bulk copy a row (and
// one for b) on bar and every thread waits for them; else the block loads
// them by elements. Ends with the block synchronised.
__device__ __forceinline__ void rows_load(const float* __restrict__ A,
                                          const float* __restrict__ b,
                                          float* S, float* v, int n,
                                          uint64_t* bar) {
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31, w = t >> 5;
  const bool bulk = (n & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(A) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  if (bulk) {
    if (t == 0) {
      mbar_init(bar, 1);
      mbar_expect_bytes(bar, 4u * (row_off(n) + (b ? n : 0)));
    }
    __syncwarp();
    if (w == 0) {
      for (int i = lane; i < n; i += 32)
        bulk_load(S + row_off(i), A + (size_t)i * n, 4u * pad4(i + 1), bar);
      if (b && lane == 0) bulk_load(v, b, 4u * n, bar);
    }
    __syncthreads();
    mbar_wait(bar, 0);
  } else {
    for (int i = w; i < n; i += nt >> 5)
      for (int j = lane; j <= i; j += 32)
        S[row_off(i) + j] = A[(size_t)i * n + j];
    if (b)
      for (int i = t; i < n; i += nt) v[i] = b[i];
    __syncthreads();
  }
}

// L (global, row-major (n, n)) <- S with zeros above the diagonal, a warp
// a row: with n % 4 == 0 and L 16-byte aligned each lane stores four
// columns at a time (a warp 512 contiguous bytes; the zeros above the
// diagonal without reading shared memory), else one.
__device__ __forceinline__ void rows_store(const float* S,
                                           float* __restrict__ L, int n) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5,
            nw = blockDim.x >> 5;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(L) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = w; i < n; i += nw) {
      const float* row = S + row_off(i);
      float4* out = reinterpret_cast<float4*>(L + (size_t)i * n);
      for (int c = lane; c < n4; c += 32) {
        const int j = 4 * c;
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j <= i) {
          q = *reinterpret_cast<const float4*>(row + j);
          if (j + 1 > i) q.y = 0.f;
          if (j + 2 > i) q.z = 0.f;
          if (j + 3 > i) q.w = 0.f;
        }
        out[c] = q;
      }
    }
  } else {
    for (int i = w; i < n; i += nw)
      for (int j = lane; j < n; j += 32)
        L[(size_t)i * n + j] = j <= i ? S[row_off(i) + j] : 0.f;
  }
}
