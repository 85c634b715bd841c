// The block-arrow kernels: K3 (fused factor + solve), row 18 (the factor
// alone) and row 19 (the substitution alone).
//
// Replace flybody_tpu/ops/arrow.py's Pallas kernels:
//   * arrow_factor_solve_f32 / arrow_factor_solve1_f32 (K3):
//     _factor_solve_fn (:585, the Pallas call at :600), reached through
//     ops_for(part).chol_solve_pe: the smooth acceleration
//     (smooth.factor_solve_m), the damped Euler solve (smooth.euler) and,
//     on an unpacked M, the fresh arrow Newton step with its 1 + 3 SB
//     right-hand sides (solver.py:835-860);
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
// block owns one env.
//
// K3 on a packed matrix with one right-hand side (the walk's a_free and
// Euler solves, 20 launches a control step): arrow_fs1_kernel, a block of
// 128 threads an env. The matrix (14,560 B on the walk) and b come into
// shared memory by 1-D bulk asynchronous copies on an mbarrier (bulk.cuh;
// element loads where _cuda.bulk_mask says a slab is not 16-byte aligned
// or a multiple of 16 bytes an env), the factor leaves by a bulk store as
// soon as it is final (overlapping the substitution) and x at the end.
// Each limb's columns belong to consecutive threads of one warp
// (fs1_lanes; the walk's 96 limb columns fill the four warps), a column
// in its thread's registers (a register tile of 14 rows and 6 border rows,
// the walking model's widths; a partition that does not fit the lanes or
// the tile goes to arrow_kernel): the limb factor broadcasts the pivot
// column by warp shuffles (k3_limb_factor), the forward substitution
// keeps a running sum a row and subtracts D[k, i] y[i] as each y[i] is
// divided and broadcast (d steps, not d^2/2; k3_forward), and the back
// substitution runs each row's chain from its column's registers as the
// y[i] below it arrive (k3_back: its terms i = k+1..d-1 go in ascending
// order, and y[k+1] is the last of them known, so that chain cannot
// spread). The root Schur complement takes one pass, a thread an entry;
// thread 0 factors and solves the root block. Every entry sees the
// operations of the one-warp kernel this replaced in the same order, so F
// and x are that kernel's bit for bit.
//
// K3 on a dense A (the unpacked chain's fresh arrow Newton step, m 1 + 3
// SB = 25, and Euler's damped M, m 1): arrow_dense_kernel, the same block
// and register tile. The live rows of A come in as 16-byte asynchronous
// copies of each limb row's run widened to 16-byte bounds and of the root
// rows, staged in the right-hand sides' room and packed from there (the
// first design's 4-byte loads, each entry twice, lost most of its time to
// the SM throttling their scattered requests); the limb blocks are
// symmetrized as the factor loads its columns, in gather_dense's order,
// and the factor is the fs1 kernel's. At m > 1 a lane takes a right-hand
// side and each warp a set of limbs (dense_warps), with the lane's y in
// registers and the factor read by broadcast; every entry takes
// arrow_solve's terms in arrow_solve's order (two root right-hand sides a
// warp side by side), so F and x are arrow_kernel's bit for bit. At m 1
// the substitution is the fs1 kernel's. What holds it (PERF.md): at eight
// blocks an SM the substitution's chains (each row's division waits for
// the row below, in the back substitution) and the stage-in's reads of
// scattered rows.
//
// Several right-hand sides on a packed A, a partition off the tile, and
// rows 18 and 19 (arrow_kernel): the matrix is gathered into the packed
// layout in shared memory, the
// right-hand sides stored one after another, groups of threads factor the
// limb blocks (with their root borders) in place, the block forms the root
// Schur complement, one thread factors the small root block, and the
// substitution runs per (limb, right-hand side) (arrow_factor /
// arrow_solve in arrow.cuh, which the Newton and noslip kernels share).
// The identity on padded limb diagonals (sizes below dmax) stays in place,
// so the padded rows factor trivially. One warp takes an env with one
// right-hand side; four warps take several, so that the (limb,
// right-hand side) pairs of the substitution spread.

#include "arrow.cuh"
#include "bulk.cuh"

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

// ---- K3 on a packed matrix with one right-hand side (arrow_fs1_kernel).

constexpr int kFsThreads = 128;
constexpr int kFsPhases = 7;  // ops/arrow.PHASES

struct Fs1Args {
  const float* A;
  const float* b;
  float* F;
  float* x;
  ArrowPart p;
  int first[16];   // thread of each limb's column 0 (fs1_lanes)
  unsigned bulk;   // bit 0 A, 1 b, 2 F, 3 x: by 1-D bulk copy
  long long* clk;  // clock instantiation: (ceil(B / stride), kFsPhases)
  int clk_stride;
};

long long* g_clk = nullptr;  // host: where the clock instantiation adds
int g_clk_stride = 1;        // every stride-th env is recorded

__host__ __device__ __forceinline__ int up4(int n) { return (n + 3) & ~3; }

// A thread's column of a limb block: limb l, column j < d (j -1: the
// thread owns none), the lane of the limb's column 0 in the warp, the
// limb's first dof.
struct Lane {
  int l, j, d, lane0, lo;
};

__device__ __forceinline__ Lane k3_lane(const Fs1Args& a) {
  const int t = threadIdx.x;
  Lane ln{0, -1, 0, 0, 0};
  for (int l = 0; l < a.p.nl; ++l)
    if (t >= a.first[l] && t < a.first[l] + a.p.d[l])
      ln = Lane{l, t - a.first[l], a.p.d[l], a.first[l] & 31, a.p.lo[l]};
  return ln;
}

// In place, the limb blocks with their borders, a thread a column: column
// j of limb l lives in the registers of its thread (c[i] = D[i, j] for
// rows i >= j of D, c[kDm + r] = B[r, j]). At step k the owner of column k
// scales it by rsqrt(max(D[k, k], 1e-30)) and the warp broadcasts it row
// by row; each column j > k subtracts L[i, k] L[j, k] from its rows i >= j
// and its border rows. Every entry sees the operations of the one-warp
// kernel's column loop (arrow_factor) in the same order. All threads take
// part (the broadcasts span each warp). kSym: D holds a dense matrix's
// raw block, symmetrized as it loads, (D[i, j] + D[j, i]) / 2 in
// gather_dense's order (only thread j reads row j above the diagonal).
template <int kDm, int kNr, bool kSym = false>
__device__ __forceinline__ void k3_limb_factor(float* A, const ArrowPart& p,
                                               const Lane& ln) {
  const int dm = p.dm, nr = p.nr, j = ln.j, d = ln.d;
  float* D = A + ln.l * (dm + nr) * dm;
  float c[kDm + kNr];
#pragma unroll
  for (int i = 0; i < kDm; ++i) {
    if constexpr (kSym)
      c[i] = (j >= 0 && i >= j && i < d)
                 ? 0.5f * (D[i * dm + j] + D[j * dm + i])
                 : 0.f;
    else
      c[i] = (j >= 0 && i >= j && i < d) ? D[i * dm + j] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kNr; ++r)
    c[kDm + r] = (j >= 0 && r < nr) ? D[(dm + r) * dm + j] : 0.f;
#pragma unroll
  for (int k = 0; k < kDm; ++k) {
    if (j == k) {
      const float inv = rsqrtf(fmaxf(c[k], 1e-30f));
#pragma unroll
      for (int i = k; i < kDm; ++i) c[i] *= inv;
#pragma unroll
      for (int r = 0; r < kNr; ++r) c[kDm + r] *= inv;
    }
    const int src = ln.lane0 + k;
    float ljk = 0.f;
#pragma unroll
    for (int i = k + 1; i < kDm; ++i) {
      const float v = __shfl_sync(0xffffffffu, c[i], src);
      if (i == j) ljk = v;
      if (j > k && i >= j && i < d) c[i] -= v * ljk;
    }
#pragma unroll
    for (int r = 0; r < kNr; ++r) {
      const float v = __shfl_sync(0xffffffffu, c[kDm + r], src);
      if (j > k && r < nr) c[kDm + r] -= v * ljk;
    }
  }
  if (j >= 0) {
#pragma unroll
    for (int i = 0; i < kDm; ++i)
      if (i >= j && i < d) D[i * dm + j] = c[i];
#pragma unroll
    for (int r = 0; r < kNr; ++r)
      if (r < nr) D[(dm + r) * dm + j] = c[kDm + r];
    for (int jj = j + 1; jj < dm; ++jj) D[j * dm + jj] = 0.f;
  }
}

// The root Schur complement R - sum_l LB_l LB_l^T, a thread an entry in
// one pass, then thread 0 factors the root block in its registers
// (arrow_factor's root loop: the same operations in the same order).
template <int kNr>
__device__ __forceinline__ void k3_root_factor(float* A, const ArrowPart& p) {
  const int t = threadIdx.x, dm = p.dm, nr = p.nr, nl = p.nl;
  const int rowlen = (dm + nr) * dm;
  float* R = A + nl * rowlen;
  for (int q = t; q < nr * nr; q += kFsThreads) {
    const int r = q / nr, c = q % nr;
    float s = R[r * dm + c];
    for (int l = 0; l < nl; ++l) {
      const float* LB = A + l * rowlen + dm * dm;
      const int d = p.d[l];
#pragma unroll 4
      for (int k = 0; k < d; ++k) s -= LB[r * dm + k] * LB[c * dm + k];
    }
    R[r * dm + c] = s;
  }
  __syncthreads();
  if (t == 0) {
    float L[kNr][kNr];
#pragma unroll
    for (int i = 0; i < kNr; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) L[i][j] = i < nr ? R[i * dm + j] : 0.f;
#pragma unroll
    for (int k = 0; k < kNr; ++k) {
      if (k < nr) {
        const float inv = rsqrtf(fmaxf(L[k][k], 1e-30f));
#pragma unroll
        for (int i = k; i < kNr; ++i)
          if (i < nr) L[i][k] *= inv;
#pragma unroll
        for (int j = k + 1; j < kNr; ++j)
#pragma unroll
          for (int i = j; i < kNr; ++i)
            if (i < nr) L[i][j] -= L[i][k] * L[j][k];
      }
    }
#pragma unroll
    for (int i = 0; i < kNr; ++i)
#pragma unroll
      for (int j = 0; j < kNr; ++j)
        if (i < nr && j < nr) R[i * dm + j] = j <= i ? L[i][j] : 0.f;
  }
}

// Forward substitution of the limbs' right-hand sides y (in X), a thread
// a row: thread j keeps row j's running sum; at step i the owner of row i
// divides its sum by D[i, i] and the warp broadcasts y[i], and every row
// j > i subtracts D[j, i] y[i]. Row j takes the one-lane chain's terms
// i = 0..j-1 in the same order (a limb takes d steps, not d^2/2).
template <int kDm>
__device__ __forceinline__ void k3_forward(const float* F, float* X,
                                           const ArrowPart& p,
                                           const Lane& ln) {
  const int dm = p.dm, j = ln.j;
  const float* D = F + ln.l * (dm + p.nr) * dm;
  float* y = X + ln.lo;
  float row[kDm];
#pragma unroll
  for (int i = 0; i < kDm; ++i) row[i] = (i <= j) ? D[j * dm + i] : 0.f;
  float s = j >= 0 ? y[j] : 0.f;
#pragma unroll
  for (int i = 0; i < kDm; ++i) {
    float v = 0.f;
    if (j == i) {
      v = s / row[i];
      y[i] = v;
    }
    const float yi = __shfl_sync(0xffffffffu, v, ln.lane0 + i);
    if (j > i) s -= row[i] * yi;
  }
}

// The root right-hand side x_r - sum_l LB_l y_l, a thread a root dof
// (limbs and their dofs in order), then thread 0's root solve in its
// registers (arrow_solve's root loops).
template <int kNr>
__device__ __forceinline__ void k3_root_solve(const float* F, float* X,
                                              const ArrowPart& p) {
  const int t = threadIdx.x, dm = p.dm, nr = p.nr, nl = p.nl;
  const int rowlen = (dm + nr) * dm;
  for (int r = t; r < nr; r += kFsThreads) {
    float s = X[r];
    for (int l = 0; l < nl; ++l) {
      const float* LB = F + l * rowlen + dm * dm;
      const float* y = X + p.lo[l];
      const int d = p.d[l];
#pragma unroll 4
      for (int k = 0; k < d; ++k) s -= LB[r * dm + k] * y[k];
    }
    X[r] = s;
  }
  __syncthreads();
  if (t == 0) {
    const float* LR = F + nl * rowlen;
    float L[kNr][kNr], x[kNr];
#pragma unroll
    for (int i = 0; i < kNr; ++i) {
      x[i] = i < nr ? X[i] : 0.f;
#pragma unroll
      for (int j = 0; j <= i; ++j) L[i][j] = i < nr ? LR[i * dm + j] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kNr; ++k) {
      if (k < nr) {
        float s = x[k];
#pragma unroll
        for (int i = 0; i < k; ++i) s -= L[k][i] * x[i];
        x[k] = s / L[k][k];
      }
    }
#pragma unroll
    for (int k = kNr - 1; k >= 0; --k) {
      if (k < nr) {
        float s = x[k];
#pragma unroll
        for (int i = k + 1; i < kNr; ++i)
          if (i < nr) s -= L[i][k] * x[i];
        x[k] = s / L[k][k];
      }
    }
#pragma unroll
    for (int i = 0; i < kNr; ++i)
      if (i < nr) X[i] = x[i];
  }
}

// Back substitution of the limbs, a thread a column: thread k first takes
// its row's border terms (sum over the root dofs in order), then, once
// y[k+1..d-1] are known (broadcast as each is divided), subtracts D[i, k]
// y[i] for i = k+1..d-1 in ascending order from its column's registers
// and divides by D[k, k]: the one-lane chain's terms and order. That
// order cannot spread (y[k+1], its first term, is the last known), so the
// steps stay d^2/2 fused multiply-adds, now on registers.
template <int kDm>
__device__ __forceinline__ void k3_back(const float* F, float* X,
                                        const ArrowPart& p, const Lane& ln) {
  const int dm = p.dm, nr = p.nr, j = ln.j, d = ln.d;
  const float* D = F + ln.l * (dm + nr) * dm;
  float* y = X + ln.lo;
  float c[kDm], yv[kDm];
#pragma unroll
  for (int i = 0; i < kDm; ++i)
    c[i] = (j >= 0 && i >= j && i < d) ? D[i * dm + j] : 0.f;
  float s = 0.f;
  if (j >= 0) {
    s = y[j];
    for (int r = 0; r < nr; ++r) s -= D[(dm + r) * dm + j] * X[r];
  }
#pragma unroll
  for (int k = kDm - 1; k >= 0; --k) {
    float v = 0.f;
    if (j == k) {
      float u = s;
#pragma unroll
      for (int i = k + 1; i < kDm; ++i)
        if (i < d) u -= c[i] * yv[i];
      v = u / c[k];
      y[k] = v;
    }
    yv[k] = __shfl_sync(0xffffffffu, v, ln.lane0 + k);
  }
}

// Phase i of the env ends: thread 0 adds the cycles since the last mark
// to phase i (clock instantiation only; the block has synchronised).
#define PHASE(i)                        \
  do {                                  \
    if constexpr (kClock) {             \
      __syncthreads();                  \
      if (t == 0) {                     \
        const long long c_ = clock64(); \
        ph[i] += c_ - c_last;           \
        c_last = c_;                    \
      }                                 \
    }                                   \
  } while (0)

// Shared memory: the mbarrier, the matrix (factored in place), x.
__host__ __device__ __forceinline__ int fs1_floats(const ArrowPart& p) {
  return 4 + up4((p.nl + 1) * (p.dm + p.nr) * p.dm) + up4(p.nv);
}

template <bool kClock, int kDm, int kNr>
__global__ void __launch_bounds__(kFsThreads, 8)
    arrow_fs1_kernel(const __grid_constant__ Fs1Args a) {
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x;
  const size_t e = blockIdx.x;
  long long ph[kFsPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kFsPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  const ArrowPart& p = a.p;
  const int nv = p.nv, msize = (p.nl + 1) * (p.dm + p.nr) * p.dm;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  float* A = sm + 4;
  float* X = A + up4(msize);
  const bool bA = a.bulk & 1u, bb = a.bulk & 2u;
  const Lane ln = k3_lane(a);

  // ---- Stage-in: the matrix and b by bulk copy (else by elements).
  if (t == 0 && (bA || bb)) {
    mbar_init(bar, 1);
    mbar_expect_bytes(bar, (bA ? 4u * msize : 0u) + (bb ? 4u * nv : 0u));
    if (bA) bulk_load(A, a.A + e * msize, 4u * msize, bar);
    if (bb) bulk_load(X, a.b + e * nv, 4u * nv, bar);
  }
  if (!bA)
    for (int k = t; k < msize; k += kFsThreads) A[k] = a.A[e * msize + k];
  if (!bb)
    for (int k = t; k < nv; k += kFsThreads) X[k] = a.b[e * nv + k];
  __syncthreads();
  if (bA || bb) mbar_wait(bar, 0);
  PHASE(0);

  // ---- The factor; F leaves as soon as it is final.
  k3_limb_factor<kDm, kNr>(A, p, ln);
  __syncthreads();
  PHASE(1);
  k3_root_factor<kNr>(A, p);
  if (a.bulk & 4u) {
    fence_proxy_async();
    __syncthreads();
    if (t == 0) {
      bulk_store(a.F + e * msize, A, 4u * msize);
      bulk_commit();
    }
  } else {
    __syncthreads();
    for (int k = t; k < msize; k += kFsThreads) a.F[e * msize + k] = A[k];
  }
  PHASE(2);

  // ---- The substitution.
  k3_forward<kDm>(A, X, p, ln);
  __syncthreads();
  PHASE(3);
  k3_root_solve<kNr>(A, X, p);
  __syncthreads();
  PHASE(4);
  k3_back<kDm>(A, X, p, ln);
  if (a.bulk & 8u) {
    fence_proxy_async();
    __syncthreads();
    PHASE(5);
    if (t == 0) {
      bulk_store(a.x + e * nv, X, 4u * nv);
      bulk_commit();
    }
  } else {
    __syncthreads();
    PHASE(5);
    for (int k = t; k < nv; k += kFsThreads) a.x[e * nv + k] = X[k];
  }
  if (t == 0 && (a.bulk & 12u)) bulk_wait_read();
  PHASE(6);
  if constexpr (kClock) {
    if (t == 0 && e % a.clk_stride == 0)
      for (int i = 0; i < kFsPhases; ++i)
        a.clk[(e / a.clk_stride) * kFsPhases + i] += ph[i];
  }
}

// Host: packs each limb's columns into consecutive threads of one warp
// (the largest limbs first, each into the first warp with room) and
// writes the thread of each limb's column 0; false when they do not fit
// the block's warps.
bool fs1_lanes(const ArrowPart& p, int* first) {
  if (p.nl < 1 || p.nl > 16) return false;
  int used[kFsThreads / 32] = {0};
  bool done[16] = {false};
  for (int n = 0; n < p.nl; ++n) {
    int l = -1;
    for (int q = 0; q < p.nl; ++q)
      if (!done[q] && (l < 0 || p.d[q] > p.d[l])) l = q;
    done[l] = true;
    int w = 0;
    while (w < kFsThreads / 32 && used[w] + p.d[l] > 32) ++w;
    if (w == kFsThreads / 32) return false;
    first[l] = 32 * w + used[w];
    used[w] += p.d[l];
  }
  return true;
}

// The register tile: limb widths up to kTileDm, roots up to kTileNr (the
// fly's walking model: 14 and 6).
constexpr int kTileDm = 14, kTileNr = 6;

// Whether arrow_fs1_kernel takes this partition (its lanes and its tile).
bool fs1_fits(const ArrowPart& p, int* first) {
  return fs1_lanes(p, first) && p.dm <= kTileDm && p.nr <= kTileNr;
}

template <bool kClock, int kDm, int kNr>
cudaError_t fs1_launch(const Fs1Args& a, int B, size_t smem, void* stream,
                       int* blocks) {
  auto kern = arrow_fs1_kernel<kClock, kDm, kNr>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                      kFsThreads, smem);
  if (err != cudaSuccess || B < 1) return err;
  kern<<<B, kFsThreads, smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

// Launches (B >= 1) or only sizes (B 0) the instantiation for a.
cudaError_t fs1_run(const Fs1Args& a, int B, void* stream, int* blocks,
                    cudaFuncAttributes* fa) {
  const size_t smem = sizeof(float) * (size_t)fs1_floats(a.p);
  if (smem > 232448) return cudaErrorInvalidValue;
  if (fa)
    return cudaFuncGetAttributes(fa,
                                 arrow_fs1_kernel<false, kTileDm, kTileNr>);
  if (a.clk)
    return fs1_launch<true, kTileDm, kTileNr>(a, B, smem, stream, blocks);
  return fs1_launch<false, kTileDm, kTileNr>(a, B, smem, stream, blocks);
}

// ---- K3's dense form (arrow_dense_kernel): a dense A, m right-hand
// sides.

struct DenseArgs : Fs1Args {
  int m;       // right-hand sides
  int sw[16];  // warp of each limb in the many-right-hand-side solve
  int vec;     // dense_stage by 16-byte copies
};

// A staged limb row's room: its run widened to 16-byte bounds (at most 5
// chunks at the register tile's 14 floats).
constexpr int kSlot = 20;

// A's live rows (global, row-major (nv, nv)) into the staging S: limb row
// i (the i-th limb dof's row over its limb's columns) widened to 16-byte
// bounds into S + kSlot i, then the root rows A[0:nr, :] whole; five lanes
// a row, six rows a warp, by asynchronous copies (the caller waits). vec
// (A 16-byte aligned, nv even): 16-byte copies; else the run's own floats
// by 4-byte copies, which the SM issues slowly when there are many.
__device__ __forceinline__ void dense_stage(const float* __restrict__ Ae,
                                            float* S, const ArrowPart& p,
                                            bool vec) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int nv = p.nv, nr = p.nr, rows = nv - nr, piece = lane % 5;
  for (int i = 6 * w + lane / 5; lane < 30 && i < rows;
       i += 6 * (kFsThreads / 32)) {
    int l = 0;
    while (i + nr >= p.lo[l] + p.d[l]) ++l;
    const int off = (i + nr) * nv + p.lo[l], s0 = (off & ~3) + 4 * piece;
    if (s0 >= off + p.d[l]) continue;
    float* dst = S + kSlot * i + 4 * piece;
    if (vec) {
      cp_async16(dst, Ae + s0);
      continue;
    }
    for (int k = 0; k < 4; ++k)
      if (s0 + k >= off && s0 + k < off + p.d[l])
        cp_async4(dst + k, Ae + s0 + k);
  }
  float* R = S + kSlot * rows;
  for (int c = t; c < (nr * nv + 3) / 4; c += kFsThreads) {
    if (vec) {
      cp_async16(R + 4 * c, Ae + 4 * c);
      continue;
    }
    for (int k = 4 * c; k < 4 * c + 4 && k < nr * nv; ++k)
      cp_async4(R + k, Ae + k);
  }
}

// The packed layout from dense_stage's staging S, as gather_dense forms
// it: the limb blocks' rows raw (k3_limb_factor<kSym> symmetrizes them as
// it loads), the borders from the root rows, the root block's lower
// triangle symmetrized, (R[r, c] + R[c, r]) / 2 in gather_dense's order
// (its upper triangle stays zero: it only feeds Schur complement entries
// that the root factor zeroes), the identity on padded limb diagonals; a
// half-warp a row run, the runs dealt round robin over the eight
// half-warps. A holds zeros. Needs dm <= 16 (the register tile's 14).
__device__ __forceinline__ void dense_extract(const float* S, float* A,
                                              const ArrowPart& p) {
  const int t = threadIdx.x, h = t >> 4, c = t & 15;
  const int dm = p.dm, nr = p.nr, nv = p.nv, rowlen = (dm + nr) * dm;
  const float* Rs = S + kSlot * (nv - nr);
  int base = 0;  // row runs dealt before limb l
  for (int l = 0; l < p.nl; ++l) {
    const int d = p.d[l], lo = p.lo[l];
    float* D = A + l * rowlen;
    for (int q = (h - base) & 7; q < d + nr; q += 8) {
      if (c >= d) continue;
      const int off = (lo + q) * nv + lo;  // limb row q's first float
      if (q < d)
        D[q * dm + c] = S[kSlot * (lo - nr + q) + (off & 3) + c];
      else
        D[(dm + q - d) * dm + c] = Rs[(q - d) * nv + lo + c];
    }
    base += d + nr;
    if (t < dm - d) D[(d + t) * (dm + 1)] = 1.f;
  }
  float* R = A + p.nl * rowlen;
  for (int q = (h - base) & 7; q < nr; q += 8)
    if (c <= q) R[q * dm + c] = 0.5f * (Rs[q * nv + c] + Rs[c * nv + q]);
}

// The many-right-hand-side substitution (m > 1), X (nv, m) in shared
// memory (b's and x's layout), a lane a right-hand side and the limbs
// dealt to the warps (sw): each lane keeps its limb's y in registers and
// reads the factor by broadcast. Every entry takes arrow_solve's terms in
// arrow_solve's order (the forward rows, the root right-hand side over
// the limbs and their dofs in order, the root solve, the border terms,
// then the back rows), so x is arrow_kernel's bit for bit.
template <int kDm, int kNr, bool kExact>
__device__ __forceinline__ void dm_forward(const float* F, float* X, int m,
                                           const ArrowPart& p,
                                           const int* sw) {
  const int dm = kExact ? kDm : p.dm, nr = kExact ? kNr : p.nr;
  const int w = threadIdx.x >> 5, rowlen = (dm + nr) * dm;
  for (int j = threadIdx.x & 31; j < m; j += 32)
    for (int l = 0; l < p.nl; ++l) {
      if (sw[l] != w) continue;
      const float* D = F + l * rowlen;
      float* y = X + p.lo[l] * m + j;
      const int d = p.d[l];
      float v[kDm];
#pragma unroll
      for (int k = 0; k < kDm; ++k) {
        if (k < d) {
          float s = y[k * m];
#pragma unroll
          for (int i = 0; i < k; ++i) s -= D[k * dm + i] * v[i];
          v[k] = div_rn(s, D[k * dm + k]);
          y[k * m] = v[k];
        }
      }
    }
}

// The root right-hand sides x_r - sum_l LB_l y_l, a warp two root dofs r
// and r + 4 side by side and a lane a right-hand side; then the root
// solve, a thread a right-hand side with its x_r in registers.
template <int kDm, int kNr, bool kExact>
__device__ __forceinline__ void dm_root(const float* F, float* X, int m,
                                        const ArrowPart& p) {
  const int dm = kExact ? kDm : p.dm, nr = kExact ? kNr : p.nr;
  const int t = threadIdx.x, nl = p.nl;
  const int rowlen = (dm + nr) * dm, nw = kFsThreads / 32;
  for (int r = t >> 5; r < nr; r += 2 * nw)
    for (int j = t & 31; j < m; j += 32) {
      const bool two = r + nw < nr;
      float s0 = X[r * m + j], s1 = two ? X[(r + nw) * m + j] : 0.f;
      for (int l = 0; l < nl; ++l) {
        const float* LB = F + l * rowlen + (dm + r) * dm;
        const float* y = X + p.lo[l] * m + j;
        const int d = p.d[l];
        if (two) {
#pragma unroll 4
          for (int k = 0; k < d; ++k) {
            const float yk = y[k * m];
            s0 -= LB[k] * yk;
            s1 -= LB[nw * dm + k] * yk;
          }
        } else {
#pragma unroll 4
          for (int k = 0; k < d; ++k) s0 -= LB[k] * y[k * m];
        }
      }
      X[r * m + j] = s0;
      if (two) X[(r + nw) * m + j] = s1;
    }
  __syncthreads();
  const float* LR = F + nl * rowlen;
  for (int j = t; j < m; j += kFsThreads) {
    float x[kNr];
#pragma unroll
    for (int i = 0; i < kNr; ++i) x[i] = i < nr ? X[i * m + j] : 0.f;
#pragma unroll
    for (int k = 0; k < kNr; ++k) {
      if (k < nr) {
        float s = x[k];
#pragma unroll
        for (int i = 0; i < k; ++i) s -= LR[k * dm + i] * x[i];
        x[k] = div_rn(s, LR[k * dm + k]);
      }
    }
#pragma unroll
    for (int k = kNr - 1; k >= 0; --k) {
      if (k < nr) {
        float s = x[k];
#pragma unroll
        for (int i = k + 1; i < kNr; ++i)
          if (i < nr) s -= LR[i * dm + k] * x[i];
        x[k] = div_rn(s, LR[k * dm + k]);
      }
    }
#pragma unroll
    for (int i = 0; i < kNr; ++i)
      if (i < nr) X[i * m + j] = x[i];
  }
}

template <int kDm, int kNr, bool kExact>
__device__ __forceinline__ void dm_back(const float* F, float* X, int m,
                                        const ArrowPart& p, const int* sw) {
  const int dm = kExact ? kDm : p.dm, nr = kExact ? kNr : p.nr;
  const int w = threadIdx.x >> 5;
  const int rowlen = (dm + nr) * dm;
  for (int j = threadIdx.x & 31; j < m; j += 32) {
    float xr[kNr];
#pragma unroll
    for (int r = 0; r < kNr; ++r) xr[r] = r < nr ? X[r * m + j] : 0.f;
    for (int l = 0; l < p.nl; ++l) {
      if (sw[l] != w) continue;
      const float* D = F + l * rowlen;
      float* y = X + p.lo[l] * m + j;
      const int d = p.d[l];
      float v[kDm];
#pragma unroll
      for (int a = 0; a < kDm; ++a) {
        if (a < d) {
          float s = y[a * m];
#pragma unroll
          for (int r = 0; r < kNr; ++r)
            if (r < nr) s -= D[(dm + r) * dm + a] * xr[r];
          v[a] = s;
        }
      }
#pragma unroll
      for (int k = kDm - 1; k >= 0; --k) {
        if (k < d) {
          float s = v[k];
#pragma unroll
          for (int i = k + 1; i < kDm; ++i)
            if (i < d) s -= D[i * dm + k] * v[i];
          v[k] = div_rn(s, D[k * dm + k]);
          y[k * m] = v[k];
        }
      }
    }
  }
}

// Shared memory: the mbarrier, the matrix (factored in place), b -> x
// (before b, dense_stage's staging).
__host__ __device__ __forceinline__ int dense_floats(const ArrowPart& p,
                                                     int m) {
  const int stage = kSlot * (p.nv - p.nr) + up4(p.nr * p.nv);
  return 4 + up4((p.nl + 1) * (p.dm + p.nr) * p.dm) +
         up4(p.nv * m > stage ? p.nv * m : stage);
}

// A block of 128 threads an env. Stage-in: A's live rows staged
// (dense_stage) while A's room is zeroed, then packed (dense_extract),
// then b (a bulk copy, else by elements) into the staging's room. The
// factor is arrow_fs1_kernel's (its limb blocks symmetrized as the columns
// load, k3_limb_factor<kSym>), F leaving by a bulk store once final.
// kMulti: the lane-a-right-hand-side substitution; else (m 1) the fs1
// kernel's own. kExact: dm and nr are the tile's (the walk's 14 and 6),
// so the substitution's offsets are constants. Phases: ops/arrow.PHASES.
template <bool kClock, int kDm, int kNr, bool kMulti, bool kExact>
__global__ void __launch_bounds__(kFsThreads, 8)
    arrow_dense_kernel(const __grid_constant__ DenseArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x;
  const size_t e = blockIdx.x;
  long long ph[kFsPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kFsPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  const ArrowPart& p = a.p;
  const int nv = p.nv, m = a.m, nb = nv * m;
  const int msize = (p.nl + 1) * (p.dm + p.nr) * p.dm;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  float* A = sm + 4;
  float* X = A + up4(msize);
  const bool bb = a.bulk & 2u;
  const Lane ln = k3_lane(a);

  // ---- Stage-in: A's live rows staged in X, then packed; b into X once
  // the staging is read.
  dense_stage(a.A + e * nv * nv, X, p, a.vec);
  if (t == 0 && bb) {
    mbar_init(bar, 1);
    mbar_expect_bytes(bar, 4u * nb);
  }
  float4* A4 = reinterpret_cast<float4*>(A);
  for (int k = t; k < up4(msize) / 4; k += kFsThreads)
    A4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  cp_async_wait_all();
  __syncthreads();
  dense_extract(X, A, p);
  fence_proxy_async();
  __syncthreads();
  if (bb && t == 0) bulk_load(X, a.b + e * nb, 4u * nb, bar);
  if (!bb)
    for (int k = t; k < nb; k += kFsThreads) X[k] = a.b[e * nb + k];
  PHASE(0);

  // ---- The factor; F leaves as soon as it is final.
  k3_limb_factor<kDm, kNr, true>(A, p, ln);
  __syncthreads();
  PHASE(1);
  k3_root_factor<kNr>(A, p);
  if (a.bulk & 4u) {
    fence_proxy_async();
    __syncthreads();
    if (t == 0) {
      bulk_store(a.F + e * msize, A, 4u * msize);
      bulk_commit();
    }
  } else {
    __syncthreads();
    for (int k = t; k < msize; k += kFsThreads) a.F[e * msize + k] = A[k];
  }
  PHASE(2);

  // ---- The substitution.
  if (bb) mbar_wait(bar, 0);
  if constexpr (kMulti) {
    dm_forward<kDm, kNr, kExact>(A, X, m, p, a.sw);
    __syncthreads();
    PHASE(3);
    dm_root<kDm, kNr, kExact>(A, X, m, p);
    __syncthreads();
    PHASE(4);
    dm_back<kDm, kNr, kExact>(A, X, m, p, a.sw);
  } else {
    k3_forward<kDm>(A, X, p, ln);
    __syncthreads();
    PHASE(3);
    k3_root_solve<kNr>(A, X, p);
    __syncthreads();
    PHASE(4);
    k3_back<kDm>(A, X, p, ln);
  }
  if (a.bulk & 8u) {
    fence_proxy_async();
    __syncthreads();
    PHASE(5);
    if (t == 0) {
      bulk_store(a.x + e * nb, X, 4u * nb);
      bulk_commit();
    }
  } else {
    __syncthreads();
    PHASE(5);
    for (int k = t; k < nb; k += kFsThreads) a.x[e * nb + k] = X[k];
  }
  if (t == 0 && (a.bulk & 12u)) bulk_wait_read();
  PHASE(6);
  if constexpr (kClock) {
    if (t == 0 && e % a.clk_stride == 0)
      for (int i = 0; i < kFsPhases; ++i)
        a.clk[(e / a.clk_stride) * kFsPhases + i] += ph[i];
  }
}

// Host: deals the limbs to the block's warps for the many-right-hand-side
// substitution, the costliest first (d (d + nr) multiply-adds a
// right-hand side) to the least loaded warp.
void dense_warps(const ArrowPart& p, int* sw) {
  int load[kFsThreads / 32] = {0};
  bool done[16] = {false};
  for (int n = 0; n < p.nl; ++n) {
    int l = -1;
    for (int q = 0; q < p.nl; ++q)
      if (!done[q] && (l < 0 || p.d[q] > p.d[l])) l = q;
    done[l] = true;
    int w = 0;
    for (int v = 1; v < kFsThreads / 32; ++v)
      if (load[v] < load[w]) w = v;
    sw[l] = w;
    load[w] += p.d[l] * (p.d[l] + p.nr);
  }
}

template <bool kClock, bool kMulti>
cudaError_t dense_launch(const DenseArgs& a, int B, size_t smem,
                         void* stream, int* blocks) {
  auto kern = arrow_dense_kernel<kClock, kTileDm, kTileNr, kMulti, false>;
  if constexpr (kMulti)
    if (a.p.dm == kTileDm && a.p.nr == kTileNr)
      kern = arrow_dense_kernel<kClock, kTileDm, kTileNr, true, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                      kFsThreads, smem);
  if (err != cudaSuccess || B < 1) return err;
  kern<<<B, kFsThreads, smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

// Launches (B >= 1) or only sizes (B 0) the instantiation for a.
cudaError_t dense_run(const DenseArgs& a, int B, void* stream, int* blocks,
                      cudaFuncAttributes* fa) {
  const size_t smem = sizeof(float) * (size_t)dense_floats(a.p, a.m);
  if (smem > 232448) return cudaErrorInvalidValue;
  const bool multi = a.m > 1;
  if (fa)
    return cudaFuncGetAttributes(
        fa, multi ? arrow_dense_kernel<false, kTileDm, kTileNr, true, true>
                  : arrow_dense_kernel<false, kTileDm, kTileNr, false, false>);
  if (a.clk)
    return multi ? dense_launch<true, true>(a, B, smem, stream, blocks)
                 : dense_launch<true, false>(a, B, smem, stream, blocks);
  return multi ? dense_launch<false, true>(a, B, smem, stream, blocks)
               : dense_launch<false, false>(a, B, smem, stream, blocks);
}

// The dense form's arguments; false when the partition is off the
// register tile (arrow_kernel takes it).
bool dense_args(const ArrowPart* part, int m, unsigned bulk, DenseArgs* a) {
  *a = DenseArgs{};
  a->p = *part, a->m = m, a->bulk = bulk;
  if (!fs1_fits(a->p, a->first)) return false;
  a->vec = (bulk & 1u) && a->p.nv % 2 == 0;
  dense_warps(a->p, a->sw);
  return true;
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

// K3 on a packed A (B, nl+1, dm+nr, dm) with one right-hand side b, x
// (B, nv): arrow_fs1_kernel, or arrow_kernel for a partition it does not
// take (the same F and x). bulk: bit 0 A, 1 b, 2 F, 3 x start 16-byte
// aligned and hold a multiple of 16 bytes an env (_cuda.bulk_mask).
FB_API int arrow_factor_solve1_f32(const float* A, const float* b, float* F,
                                   float* x, int B, unsigned bulk,
                                   const ArrowPart* part, void* stream) {
  Fs1Args a{};
  a.A = A, a.b = b, a.F = F, a.x = x, a.p = *part, a.bulk = bulk;
  if (B < 1) return -1;
  if (!fs1_fits(a.p, a.first))
    return launch<true, true>(A, b, F, x, B, 0, 1, part, stream);
  if (g_clk) a.clk = g_clk, a.clk_stride = g_clk_stride;
  int blocks = 0;
  return (int)fs1_run(a, B, stream, &blocks, nullptr);
}

// K3 on a dense A (B, nv, nv) with m >= 1 right-hand sides b, x (B, nv,
// m): arrow_dense_kernel, or arrow_kernel for a partition off its tile
// (the same F and x). bulk: as arrow_factor_solve1_f32's (bit 0: A's
// live rows by 16-byte copies).
FB_API int arrow_factor_solve_dense_f32(const float* A, const float* b,
                                        float* F, float* x, int B, int m,
                                        unsigned bulk, const ArrowPart* part,
                                        void* stream) {
  DenseArgs a;
  if (B < 1 || m < 1) return -1;
  if (!dense_args(part, m, bulk, &a))
    return launch<true, true>(A, b, F, x, B, 1, m, part, stream);
  a.A = A, a.b = b, a.F = F, a.x = x;
  if (g_clk) a.clk = g_clk, a.clk_stride = g_clk_stride;
  int blocks = 0;
  return (int)dense_run(a, B, stream, &blocks, nullptr);
}

// Phase clocks: while clk is set, every arrow_factor_solve1_f32 and
// arrow_factor_solve_dense_f32 launch runs its kernel's clock
// instantiation and adds the cycles of each phase of every stride-th env
// to clk ((ceil(B / stride), kFsPhases) int64); nullptr turns it off.
FB_API int arrow_phase_clock(long long* clk, int stride) {
  if (stride < 1) return -1;
  g_clk = clk, g_clk_stride = stride;
  return 0;
}

// Resources of arrow_fs1_kernel's main instantiation for this partition:
// out = registers a thread, shared bytes a block, blocks an SM, grid
// blocks for B envs.
FB_API int arrow_fs1_info(const ArrowPart* part, int B, int* out) {
  Fs1Args a{};
  a.p = *part;
  if (!fs1_fits(a.p, a.first)) return -1;
  cudaFuncAttributes fa;
  cudaError_t err = fs1_run(a, 0, nullptr, nullptr, &fa);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = fs1_run(a, 0, nullptr, &blocks, nullptr);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs, out[1] = (int)(sizeof(float) * fs1_floats(a.p));
  out[2] = blocks, out[3] = B;
  return 0;
}

// Resources of arrow_dense_kernel's main instantiation for this partition
// and m: as arrow_fs1_info's.
FB_API int arrow_dense_info(const ArrowPart* part, int m, int B, int* out) {
  DenseArgs a;
  if (m < 1 || !dense_args(part, m, 0u, &a)) return -1;
  cudaFuncAttributes fa;
  cudaError_t err = dense_run(a, 0, nullptr, nullptr, &fa);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = dense_run(a, 0, nullptr, &blocks, nullptr);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs, out[1] = (int)(sizeof(float) * dense_floats(a.p, m));
  out[2] = blocks, out[3] = B;
  return 0;
}
