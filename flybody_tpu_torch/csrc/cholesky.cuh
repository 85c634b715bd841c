// Dense Cholesky factor and substitutions (csrc/cholesky.cu), the
// counterparts of flybody_tpu/ops/cholesky.py's _chol_kernel, _solve_kernel,
// _solve_multi_kernel and _chol_solve_kernel. Semantics: chol_ref,
// subst_ref in flybody_tpu_torch/ops/cholesky.py.
//
#pragma once

#include "bulk.cuh"
#include "common.cuh"

// The lower triangle packed by rows (rows 14 at n <= 256, 16 and 17): row i
// holds columns 0..i at S[row_off(i) + j], then padding up to a
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
