// Rows 14, 15, 16 and 17: the dense batched Cholesky family.
//
// Replaces flybody_tpu/ops/cholesky.py:
//   * chol_f32 (row 14): _chol_pallas (:79, the Pallas call at :84), the
//     factor alone: A (B, n, n) -> L lower with zeros above. smooth.factor_m
//     runs it on a model without an arrow partition (n = 216 for two
//     flies), and the arrow Newton step on an unpacked M on its capacitance
//     I + U^T Z + 1e-10 I (n = 3 SB = 24 at SB 8; solver.py:857);
//   * chol_solve_f32 (row 17): _chol_solve_pallas (:333, the Pallas call at
//     :337), the fused factor + single-RHS solve: A (B, n, n), b (B, n) ->
//     L (B, n, n) lower with zeros above, x with A x = b. The dense path
//     runs it for the smooth acceleration, every fresh Newton step and the
//     damped Euler solve;
//   * cho_solve_f32 (row 15): _solve_pallas (:186, call :190), the
//     single-RHS substitution L L^T x = b given L (reuse Newton steps);
//   * cho_solve_multi_f32 (row 16): _solve_multi_pallas (:256, call :262),
//     L L^T X = R for R (B, n, m) (the noslip's M^-1 J_t^T, m = 2K).
// Semantics: chol_solve_ref / cho_solve_ref / cho_solve_multi_ref in
// flybody_tpu_torch/ops/cholesky.py.
//
// What bounds them: bytes for rows 14, 15 and 17 (per env at n = 216 the lower
// triangle in, 93.7 KB, and for row 17 the full factor out, 187 KB; the
// factor is n^3/3 = 3.4 MFLOP), operations for row 16 at m = 128 (2 n^2 m
// = 11.9 MFLOP per env). The TPU kernels put 128 envs on the lanes and ran
// the column loop once for all of them; here one block owns one env and
// keeps the lower triangle packed by columns in shared memory
// (cholesky.cuh; 94.6 KB at n = 216, two blocks an SM): the factor runs
// column by column (left-looking) with threads over rows; a single
// right-hand side is substituted by the whole block, each thread holding
// its rows' running values in registers; for several right-hand sides
// each thread substitutes its own column in blocks of
// rows. This first design leaves the factor and the single-RHS
// substitution at one barrier a column (the rows above the pivot idle),
// and the multi-RHS sweep at one column per thread (a quarter of the
// threads at the bench preset's 32 columns).

#include "cholesky.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMultiCols = 128;  // right-hand sides per pass of row 16

__global__ void __launch_bounds__(kThreads)
    chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                      float* __restrict__ L, float* __restrict__ x, int n) {
  extern __shared__ float sm[];
  const int e = blockIdx.x, t = threadIdx.x;
  float* S = sm;
  float* v = S + tri_size(n);
  tri_load(A + (size_t)e * n * n, S, n);
  for (int i = t; i < n; i += blockDim.x) v[i] = b[(size_t)e * n + i];
  __syncthreads();
  chol_factor(S, n);
  chol_subst_block(S, v, n);
  tri_store(S, L + (size_t)e * n * n, n);
  for (int i = t; i < n; i += blockDim.x) x[(size_t)e * n + i] = v[i];
}

__global__ void __launch_bounds__(kThreads)
    chol_kernel(const float* __restrict__ A, float* __restrict__ L, int n) {
  extern __shared__ float sm[];
  const int e = blockIdx.x;
  tri_load(A + (size_t)e * n * n, sm, n);
  __syncthreads();
  chol_factor(sm, n);
  tri_store(sm, L + (size_t)e * n * n, n);
}

__global__ void __launch_bounds__(kThreads)
    cho_solve_kernel(const float* __restrict__ L, const float* __restrict__ b,
                     float* __restrict__ x, int n) {
  extern __shared__ float sm[];
  const int e = blockIdx.x, t = threadIdx.x;
  float* S = sm;
  float* v = S + tri_size(n);
  tri_load(L + (size_t)e * n * n, S, n);
  for (int i = t; i < n; i += blockDim.x) v[i] = b[(size_t)e * n + i];
  __syncthreads();
  chol_subst_block(S, v, n);
  for (int i = t; i < n; i += blockDim.x) x[(size_t)e * n + i] = v[i];
}

__global__ void __launch_bounds__(kMultiCols)
    cho_solve_multi_kernel(const float* __restrict__ L,
                           const float* __restrict__ R, float* __restrict__ X,
                           int n, int m) {
  extern __shared__ float sm[];
  const int e = blockIdx.x, t = threadIdx.x;
  float* S = sm;
  float* Y = S + tri_size(n);  // (n, mc) chunk of the right-hand sides
  tri_load(L + (size_t)e * n * n, S, n);
  const float* Re = R + (size_t)e * n * m;
  float* Xe = X + (size_t)e * n * m;
  for (int c0 = 0; c0 < m; c0 += kMultiCols) {
    const int mc = min(kMultiCols, m - c0);
    for (int idx = t; idx < n * mc; idx += blockDim.x) {
      const int i = idx / mc, c = idx - i * mc;
      Y[idx] = Re[(size_t)i * m + c0 + c];
    }
    __syncthreads();
    chol_subst_cols(S, Y, n, mc);
    __syncthreads();
    for (int idx = t; idx < n * mc; idx += blockDim.x) {
      const int i = idx / mc, c = idx - i * mc;
      Xe[(size_t)i * m + c0 + c] = Y[idx];
    }
    __syncthreads();
  }
}

// Allows the dynamic shared memory a launch needs and asks for the largest
// shared-memory carveout of the SM's L1, so that two 94.6 KB blocks of rows
// 15 and 17 fit on one SM (the default carveout may leave room for one).
template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes > 232448) return -1;  // Hopper's shared memory per block
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && bytes > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return (int)err;
}

}  // namespace

FB_API int chol_solve_f32(const float* A, const float* b, float* L, float* x,
                          int B, int n, void* stream) {
  if (B < 1 || n < 1 || n > 2 * kThreads) return -1;
  const size_t smem = sizeof(float) * (tri_size(n) + n);
  const int rc = set_smem(chol_solve_kernel, smem);
  if (rc) return rc;
  chol_solve_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(A, b, L, x,
                                                                 n);
  return (int)cudaGetLastError();
}

FB_API int chol_f32(const float* A, float* L, int B, int n, void* stream) {
  if (B < 1 || n < 1 || n > 2 * kThreads) return -1;
  const size_t smem = sizeof(float) * tri_size(n);
  const int rc = set_smem(chol_kernel, smem);
  if (rc) return rc;
  // Below one warp's worth of rows a column (n = 24), one warp a block.
  const int threads = n <= 32 ? 32 : kThreads;
  chol_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(A, L, n);
  return (int)cudaGetLastError();
}

FB_API int cho_solve_f32(const float* L, const float* b, float* x, int B,
                         int n, void* stream) {
  if (B < 1 || n < 1 || n > 2 * kThreads) return -1;
  const size_t smem = sizeof(float) * (tri_size(n) + n);
  const int rc = set_smem(cho_solve_kernel, smem);
  if (rc) return rc;
  cho_solve_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(L, b, x, n);
  return (int)cudaGetLastError();
}

FB_API int cho_solve_multi_f32(const float* L, const float* R, float* X, int B,
                               int n, int m, void* stream) {
  if (B < 1 || n < 1 || m < 1) return -1;
  const int mc = m < kMultiCols ? m : kMultiCols;
  const size_t smem = sizeof(float) * (tri_size(n) + (size_t)n * mc);
  const int rc = set_smem(cho_solve_multi_kernel, smem);
  if (rc) return rc;
  cho_solve_multi_kernel<<<B, kMultiCols, smem, (cudaStream_t)stream>>>(
      L, R, X, n, m);
  return (int)cudaGetLastError();
}
