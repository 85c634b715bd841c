// The block-arrow kernels: K3 (fused factor + solve), row 18 (the factor
// alone) and row 19 (the substitution alone).
//
// Replace flybody_tpu/ops/arrow.py's Pallas kernels:
//   * arrow_factor_solve_f32 (K3): _factor_solve_fn (:585, the Pallas call
//     at :600), reached through ops_for(part).chol_solve_pe: the smooth
//     acceleration (smooth.factor_solve_m), the damped Euler solve
//     (smooth.euler) and, on an unpacked M, the fresh arrow Newton step
//     with its 1 + 3 SB right-hand sides (solver.py:835-860);
//   * arrow_factor_f32 (row 18): _factor_fn (:524, call :533), reached
//     through chol_pe from smooth.factor_m;
//   * arrow_solve_f32 (row 19): _solve_fn (:554, call :563), reached
//     through solve_pe from smooth.solve_m.
// The matrix is the packed symmetric (nl+1, dm+nr, dm) layout or a dense
// (nv, nv) one (the TPU kernels' `_a_spec`, :513); b and x are (nv, m).
// Semantics: factor_solve_ref, factor_ref / factor_ref_p and solve_ref in
// flybody_tpu_torch/ops/arrow.py. A dense matrix is read as the JAX
// package's factor_ref reads it: the limb blocks and the root block
// symmetrized, (A + A^T) / 2 (jnp.linalg.cholesky's default), and each
// root-limb border from the rows of the root dofs, A[0:nr, limb].
//
// What bounds them: bytes. Per env K3 moves the packed matrix in and the
// factor out (3,640 floats each, 30 KB with b and x) for ~15k flops; a
// dense A is 46.7 KB of which the gather reads the ~3,500 live entries
// twice (both triangles) from rows of L2-resident lines. The TPU kernels
// processed all limbs of 128 envs as lanes of one column loop; here one
// block owns one env: the matrix is gathered into the packed layout in
// shared memory, the right-hand sides stored one after another, groups of
// threads factor the limb blocks (with their root borders) in place, the
// block forms the root Schur complement, one thread factors the small root
// block, and the substitution runs per (limb, right-hand side)
// (arrow_factor / arrow_solve in arrow.cuh, which the Newton and noslip
// kernels share). The identity on padded limb diagonals (sizes below
// dmax) stays in place, so the padded rows factor trivially. One warp
// takes an env with one right-hand side; four warps take several, so
// that the (limb, right-hand side) pairs of the substitution spread.

#include "arrow.cuh"

namespace {

// The packed symmetric layout of the dense (nv, nv) matrix Ae in A: limb
// blocks (A + A^T) / 2 with the identity on padded diagonals, the borders
// Ae[r, lo + c], the root block (A + A^T) / 2; zero elsewhere.
__device__ void gather_dense(const float* __restrict__ Ae, float* A,
                             const ArrowPart& p) {
  const int dm = p.dm, nr = p.nr, nv = p.nv, rowlen = (dm + nr) * dm;
  const int msize = (p.nl + 1) * rowlen;
  for (int q = threadIdx.x; q < msize; q += blockDim.x) {
    const int blk = q / rowlen, rem = q - blk * rowlen;
    const int row = rem / dm, col = rem - row * dm;
    float v = 0.f;
    if (blk < p.nl) {
      const int d = p.d[blk], lo = p.lo[blk];
      if (row < dm) {
        if (row < d && col < d)
          v = 0.5f * (Ae[(lo + row) * nv + lo + col] +
                      Ae[(lo + col) * nv + lo + row]);
        else if (row == col)
          v = 1.f;
      } else if (col < d) {
        v = Ae[(row - dm) * nv + lo + col];
      }
    } else if (row < nr && col < nr) {
      v = 0.5f * (Ae[row * nv + col] + Ae[col * nv + row]);
    }
    A[q] = v;
  }
}

// kFactor: factor A (dense or packed) into F; else read the factor F_in.
// kSolve: x = A^-1 b for m right-hand sides, b and x (nv, m) per env.
template <bool kFactor, bool kSolve>
__global__ void arrow_kernel(const float* __restrict__ Ain,
                             const float* __restrict__ b,
                             float* __restrict__ F, float* __restrict__ x,
                             ArrowPart p, int dense, int m) {
  extern __shared__ float sm[];
  const int e = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int nv = p.nv;
  const int msize = (p.nl + 1) * (p.dm + p.nr) * p.dm;
  float* A = sm;         // packed matrix, factored in place
  float* X = A + msize;  // (m, nv) right-hand sides -> solutions

  if (kFactor && dense)
    gather_dense(Ain + (size_t)e * nv * nv, A, p);
  else
    for (int k = t; k < msize; k += nt) A[k] = Ain[(size_t)e * msize + k];
  if (kSolve) {
    const float* be = b + (size_t)e * nv * m;
    for (int k = t; k < nv * m; k += nt) {
      const int v = k / m, j = k - v * m;
      X[j * nv + v] = be[k];
    }
  }
  __syncthreads();
  if (kFactor) arrow_factor(A, p);
  if (kSolve) arrow_solve(A, X, m, nv, p);

  if (kFactor) {
    float* Fe = F + (size_t)e * msize;
    for (int k = t; k < msize; k += nt) Fe[k] = A[k];
  }
  if (kSolve) {
    float* xe = x + (size_t)e * nv * m;
    for (int k = t; k < nv * m; k += nt) {
      const int v = k / m, j = k - v * m;
      xe[k] = X[j * nv + v];
    }
  }
}

template <bool kFactor, bool kSolve>
int launch(const float* Ain, const float* b, float* F, float* x, int B,
           int dense, int m, const ArrowPart* part, void* stream) {
  const ArrowPart& p = *part;
  if (p.nl > 16 || p.nl < 1 || B < 1 || m < (kSolve ? 1 : 0)) return -1;
  const int msize = (p.nl + 1) * (p.dm + p.nr) * p.dm;
  const size_t smem = sizeof(float) * ((size_t)msize + (size_t)p.nv * m);
  if (smem > 232448) return -1;  // Hopper's shared memory per block
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        arrow_kernel<kFactor, kSolve>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = m > 1 ? 128 : 32;
  arrow_kernel<kFactor, kSolve><<<B, threads, smem, (cudaStream_t)stream>>>(
      Ain, b, F, x, p, dense, m);
  return (int)cudaGetLastError();
}

}  // namespace

// K3: A (B, nv, nv) when dense, else (B, nl+1, dm+nr, dm); b, x (B, nv, m).
FB_API int arrow_factor_solve_f32(const float* A, const float* b, float* F,
                                  float* x, int B, int dense, int m,
                                  const ArrowPart* part, void* stream) {
  return launch<true, true>(A, b, F, x, B, dense, m, part, stream);
}

// Row 18: the packed factor F of A (dense or packed).
FB_API int arrow_factor_f32(const float* A, float* F, int B, int dense,
                            const ArrowPart* part, void* stream) {
  return launch<true, false>(A, nullptr, F, nullptr, B, dense, 0, part,
                             stream);
}

// Row 19: x = A^-1 b from the packed factor F; b, x (B, nv, m).
FB_API int arrow_solve_f32(const float* F, const float* b, float* x, int B,
                           int m, const ArrowPart* part, void* stream) {
  return launch<false, true>(F, b, nullptr, x, B, 0, m, part, stream);
}
