// Kernels 8, 9 and 10: the Newton block, the whole Newton solve, the
// block-full Newton block and the Newton reuse iterations.
//
// Replace flybody_tpu/ops/newton_fused.py::_block_fn (:461, the Pallas call
// at :485; make_newton_block_pe), both modes of _block_full_fn (:1038, the
// call at :1067): the whole solve (make_newton_solve_pe) and one refactor
// block with the Hessian assembled in the kernel (make_newton_block_full_pe),
// and _fused_fn (:232, the call at :258; make_reuse_pe). Semantics:
// newton_block_ref, newton_solve_ref, newton_block_full_ref and reuse_ref in
// flybody_tpu_torch/ops/newton_fused.py.
//
//   newton_block: one refactor block from a packed Hessian Hp assembled
//     outside: arrow factor of Hp, Z = A^-1 U for the 3*SB Woodbury rows,
//     the capacitance Cholesky of I + U Z, then n Newton iterations
//     (gradient, substitution, Woodbury correction, exact line search,
//     linear update of x, M(x - a_free), jar_l, jar_c).
//   newton_solve: the whole solve (iterations <= refactor period): the
//     warmstart pick by primal cost, the jar/msm init, the float32 packed
//     Hessian M + J^T W J + limit diagonal and the Woodbury rows of the
//     selected cross-limb slots, the same block body, then the constraint
//     forces f_l, f_c and qfrc = S f_l + J^T f_c.
//   newton_block_full: one refactor block from the carried state (x,
//     M (x - a_free), jar_l, jar_c): the whole solve's float32 Hessian and
//     Woodbury assembly at that state, then the block body; the state goes
//     back out (no forces).
//   newton_reuse: n iterations with a factor kept from a fresh arrow step
//     on an unpacked M (solver.py:862-868): the packed factor F, the
//     Woodbury operands Z = A^-1 U^T and U, and the capacitance factor LC
//     come in; the mass matrix M is dense (nv, nv) or packed.
// One template (newton_kernel) holds the first three; the prologues (and
// the whole solve's epilogue) are the only difference, and they share one
// iteration body. The reuse iterations have a kernel of their own
// (newton_reuse_kernel, its design below), which shares the device
// functions and keeps the template's sums and their order.
//
// What bounds them on the card: bytes in principle (per env the block
// kernel reads Hp, M: 14.6 KB each, J: 3K x nv, 83 KB at K = 64, U: 10 KB
// at SB = 8, and the state, ~131 KB in all, for ~0.3 MFLOP), in practice
// the latency of each env's dependency chains: the factor, the
// substitutions, the capacitance Cholesky and its inverse, the line search
// (tools/profile_newton.py --phases reads them). Design:
//   * persistent blocks of 128 threads at <= 128 registers, as many as fit
//     on each SM (shared memory allows three at K 64, four at K 24),
//     each walking envs e = blockIdx.x, + gridDim.x, ...; each env's
//     contiguous slabs (Hp or M, U, the state vectors and parameters)
//     come in by 1-D bulk asynchronous copies
//     (TMA) on an mbarrier, issued by one thread as soon as the block is
//     done with its last env, while the other blocks on the SM compute (a
//     second stage, to overlap within the block, would cost the third
//     block an SM, and ran slower); J and M (for M dx) are read where they
//     lie (from L2 after the first touch: a bulk L2 prefetch of the next
//     env's J made the kernel slower, by evicting);
//   * a mask of the limbs (and the root) each contact slot's J rows touch
//     (a nonzero or NaN entry), and from it per-block-row contact lists:
//     J^T f, J dx and the Hessian assembly skip exact zeros only, each sum
//     kept in its dense order;
//   * the assembling modes build the packed Hessian without a J W buffer:
//     a warp a limb, each lane one row of the limb's tile (its d x d lower
//     triangle and nr x d root border) in registers, summed over the
//     listed slots whose W_k is not all zero, W_k J formed per slot at the
//     tile's columns; a lane a root entry for the root tile; float32, the
//     same sums in the same order as the dense assembly over every row, so
//     the Hessian is that assembly's to the bit;
//   * the arrow factor a warp a limb block (a lane a row, Crout column
//     steps, each pivot passed by a shuffle), the substitutions a thread a
//     (limb, right-hand side) with the right-hand side in registers, the
//     limbs taken longest first; the capacitance Cholesky on one warp;
//   * the block modes' line search computes its terms over the whole
//     block and sums them as the one-warp search (the whole solve's) does
//     (linesearch.cuh).
// Every sum runs in the order of the dense one-block-an-env form, so the
// whole solve's arithmetic is that form's bit for bit: its bench
// trajectories are chaotic, and a rounding change sends other flailing
// flies to non-finite states within five control steps (PERF.md section
// 6).
// Shared memory holds the stage, Z, U, the capacitance factor and its
// inverse, the Newton planes and the contact lists: 61-64 KB a block at
// the default preset (K 64), 39 KB at the bench one (K 24).

#include "arrow.cuh"
#include "bulk.cuh"
#include "linesearch.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDm = 16;           // limb block size of the register tiles
constexpr int kMaxNr = 6;            // root dofs
constexpr int kMaxSB3 = 32;          // Woodbury rows (a lane each in the
                                     // capacitance factor)
constexpr int kRootBit = 31;         // mask bit of the root columns
enum Mode { kBlock = 0, kWhole = 1, kReuse = 2, kBlockFull = 3 };
// Phase clocks (newton_phase_clock): the phases of PHASE marks below, in
// this order, as ops/newton_fused.PHASES names them.
constexpr int kPhases = 15;
long long* g_clk = nullptr;  // host: where the clock instantiation adds
int g_clk_stride = 1;        // every stride-th env is recorded

struct LimTables {
  const int* dof;      // (L) dof of each limit row
  const float* sign;   // (L) +1 lower row, -1 upper row
  const int* dof_lim;  // (nv, 2) limit rows of each dof, -1 for none
};

// Shared-memory offsets in floats: the stage of slabs the bulk copies
// bring, then the block's working buffers.
struct Layout {
  int A, Ut, Zg, LC, x, msm, jl, jc, lp, cp;  // the stage
  int Z, ldz, Uw, C, Ci, wu, wv, g, dx, mdx, vl, fl, pl, fc, red;
  int lsw, ldof, lsign, dlim, vbit, lord, mask, list, cnt;
  int W, wnz, G;  // assembling modes
  int total;
};

struct NewtonArgs {
  const float* Hp;          // block: (B, msize) packed Hessian; reuse: F
  const float* M;           // (B, msize) packed, or reuse: (B, nv, nv)
  const float* J;           // (B, 3K, nv) contact rows
  const float* U;           // block, reuse: (B, SB3, nv) Woodbury rows
  const float* Zg;          // reuse: (B, nv, SB3) Z = A^-1 U^T
  const float* LC;          // reuse: (B, SB3, SB3) capacitance factor
  const int* bsel;          // whole, full: (B, SB) cross-limb slots
  const float* x;           // block: x; whole: a_free (B, nv)
  const float* msm;         // block: M (x - a_free); whole: warmstart
  const float* jar_l;       // block: jar_l; whole: limit aref (B, L)
  const float* jar_c;       // block: jar_c; whole: contact aref (B, K, 3)
  const float* lim_params;  // (B, 2, L) [active | D]
  const float* con_params;  // (B, 4 | 5, K) [mu | fric | active | D | hess]
  float* o0;                // block: x; whole: qacc (B, nv)
  float* o1;                // block: msm; whole: qfrc (B, nv)
  float* o2;                // block: jar_l; whole: f_l (B, L)
  float* o3;                // block: jar_c; whole: f_c (B, K, 3)
  LimTables lim;
  ArrowPart p;
  int B, K, SB3, L, ls_iters, n_iters;
  int dense_m;     // reuse: M is dense (nv, nv)
  long long* clk;  // clock instantiation: (ceil(B / stride), kPhases)
  int clk_stride;
  Layout o;  // shared-memory layout (host-computed: kernel parameters are
             // re-read rather than held in registers)
};

inline Layout newton_layout(int K, int SB3, int L, const ArrowPart& p,
                            int mode) {
  const bool assemble = mode == kWhole || mode == kBlockFull;
  const int nv = p.nv, msize = (p.nl + 1) * (p.dm + p.nr) * p.dm;
  Layout o{};
  int n = 0;
  auto take = [&n](int c) {
    const int at = n;
    n += (c + 3) & ~3;  // 16-byte aligned for the bulk copies
    return at;
  };
  take(4);  // the mbarrier
  o.A = take(msize);
  o.Ut = assemble ? 0 : take(SB3 * nv);
  o.x = take(nv);
  o.msm = take(nv);
  o.jl = take(L);
  o.jc = take(3 * K);
  o.lp = take(2 * L);
  o.cp = take((assemble ? 5 : 4) * K);
  o.ldz = nv | 1;  // odd: the (limb, rhs) substitution threads miss banks
  o.Z = take(SB3 * o.ldz);
  o.Uw = assemble ? take(SB3 * nv) : 0;
  o.C = take(SB3 * SB3);
  o.Ci = take(SB3 * SB3);
  o.wu = take(SB3);
  o.wv = take(SB3);
  o.g = take(nv);
  o.dx = take(nv);
  o.mdx = take(nv);
  o.vl = take(L);
  o.fl = take(L);
  o.pl = take(6 * K);  // N, Y1, Y2, V0, V1, V2
  o.fc = take(3 * K);
  o.red = take(4);
  o.lsw = mode == kWhole ? 0 : take(4 * (L + K));  // line search terms
  o.ldof = take(L);
  o.lsign = take(L);
  o.dlim = take(2 * nv);
  o.vbit = take(nv);
  o.lord = take(p.nl);
  o.mask = take(K);
  o.list = take((p.nl + 1) * K);
  o.cnt = take(p.nl + 1);
  o.W = o.wnz = o.G = 0;
  if (assemble) {
    o.W = take(6 * K);
    o.wnz = take(K);
    o.G = take(2 * SB3);
  }
  o.total = n;
  return o;
}

// Unique entries (00, 01, 02, 11, 12, 22) of the elliptic-cone Hessian
// I - dP of one contact (cone_hessian in ops/newton_fused.py), times act.
__device__ __forceinline__ void cone_hessian6(float N, float y1, float y2,
                                              float mu, float fric, float act,
                                              float* h) {
  const float a = 1.f / fmaxf(mu, 1e-6f);
  const float T = sqrtf(y1 * y1 + y2 * y2);
  const float safeT = fmaxf(T, 1e-15f);
  const float yh1 = y1 / safeT, yh2 = y2 / safeT;
  const float w = (N + a * T) / (1.f + a * a);
  const float c = 1.f / (1.f + a * a);
  const float awt = a * w / safeT;
  const bool top = N >= mu * T;
  const bool bottom = mu * N + T <= 0.f;
  float H[6];
  if (fric > 0.f) {
    if (top) {
      for (int i = 0; i < 6; ++i) H[i] = 0.f;
    } else if (bottom) {
      H[0] = 1.f, H[1] = 0.f, H[2] = 0.f, H[3] = 1.f, H[4] = 0.f, H[5] = 1.f;
    } else {
      H[0] = 1.f - c;
      H[1] = -(a * c * yh1);
      H[2] = -(a * c * yh2);
      H[3] = 1.f - (a * a * c * yh1 * yh1 + awt * (1.f - yh1 * yh1));
      H[4] = -(a * a * c * yh1 * yh2 + awt * (0.f - yh1 * yh2));
      H[5] = 1.f - (a * a * c * yh2 * yh2 + awt * (1.f - yh2 * yh2));
    }
  } else {
    H[0] = N < 0.f ? 1.f : 0.f;
    for (int i = 1; i < 6; ++i) H[i] = 0.f;
  }
  for (int i = 0; i < 6; ++i) h[i] = H[i] * act;
}

// Closed-form lower Cholesky of a PSD 3x3 block given by its unique
// entries; zero pivots give zero rows (chol3_psd). Out: a, b, c, d, e, f of
// [[a, 0, 0], [b, d, 0], [c, e, f]].
__device__ __forceinline__ void chol3(const float* W, float* G) {
  const float a = sqrtf(fmaxf(W[0], 0.f));
  const float ia = a > 1e-12f ? 1.f / fmaxf(a, 1e-30f) : 0.f;
  const float b = W[1] * ia;
  const float c = W[2] * ia;
  const float d = sqrtf(fmaxf(W[3] - b * b, 0.f));
  const float id = d > 1e-12f ? 1.f / fmaxf(d, 1e-30f) : 0.f;
  const float e = (W[4] - c * b) * id;
  const float f = sqrtf(fmaxf(W[5] - c * c - e * e, 0.f));
  G[0] = a, G[1] = b, G[2] = c, G[3] = d, G[4] = e, G[5] = f;
}

// Cone residual of one contact for the constraint force (cone_residual
// with active = 1).
__device__ __forceinline__ void cone_residual3(float N, float y1, float y2,
                                               float mu, float fric,
                                               float* r) {
  const float T = sqrtf(y1 * y1 + y2 * y2);
  const float a = 1.f / fmaxf(mu, 1e-6f);
  const float w = (N + a * T) / (1.f + a * a);
  const float safeT = fmaxf(T, 1e-15f);
  const bool top = N >= mu * T;
  const bool bottom = mu * N + T <= 0.f;
  if (fric > 0.f) {
    if (top) {
      r[0] = r[1] = r[2] = 0.f;
    } else if (bottom) {
      r[0] = N, r[1] = y1, r[2] = y2;
    } else {
      const float coef = 1.f - a * w / safeT;
      r[0] = N - w, r[1] = y1 * coef, r[2] = y2 * coef;
    }
  } else {
    r[0] = fminf(N, 0.f), r[1] = 0.f, r[2] = 0.f;
  }
}

// Sum over dof v of the signed limit forces S f (at most two rows a dof).
__device__ __forceinline__ float lim_scatter(const int* dlim, const float* f,
                                             const float* sign, int v) {
  float s = 0.f;
  for (int j = 0; j < 2; ++j) {
    const int i = dlim[2 * v + j];
    if (i >= 0) s += f[i] * sign[i];
  }
  return s;
}

// Lower Cholesky, in place, of the n columns of the rows at M (row stride
// ld) on one warp, lane i taking row i where `live`: column by column,
// each live row at or below the diagonal forms its entry as a dot product
// of finished entries (the Crout order, which subtracts the same products
// in the same order as the right-looking update of arrow.cuh's factor),
// the pivot passed by a shuffle. Rows below n (a limb's border) take part.
__device__ __forceinline__ void chol_cols(float* M, int n, int ld,
                                          bool live) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < n; ++k) {
    const bool mine = live && lane >= k;
    float s = 0.f;
    if (mine) {
      s = M[lane * ld + k];
#pragma unroll 4
      for (int j = 0; j < k; ++j) s -= M[lane * ld + j] * M[k * ld + j];
    }
    const float inv =
        rsqrtf(fmaxf(__shfl_sync(0xffffffffu, s, k), 1e-30f));
    if (mine) M[lane * ld + k] = s * inv;
    __syncwarp();
  }
}

// Lower Cholesky of the n x n block at M (row stride ld, n <= 32) on one
// warp; zeros above the diagonal up to column zero_to.
__device__ __forceinline__ void chol_warp(float* M, int n, int ld,
                                          int zero_to) {
  const int lane = threadIdx.x & 31;
  chol_cols(M, n, ld, lane < n);
  if (lane < n)
    for (int c = lane + 1; c < zero_to; ++c) M[lane * ld + c] = 0.f;
}

// In place: the packed symmetric A becomes its packed factor (L_l, LB_l =
// B_l L_l^-T, L_R), zeros above each live diagonal; reads only the lower
// triangles of D_l and R (arrow_factor in arrow.cuh; each entry sees the
// same operations in the same order). A warp a limb block (chol_cols):
// lane i < d takes limb row i, lane dm + r border row r, the limbs taken
// longest first (lord). Then the root Schur complement a thread an entry
// and the root factor on warp 0.
__device__ __forceinline__ void factor_packed(float* A, const ArrowPart& p,
                                              const int* lord) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int dm = p.dm, nr = p.nr, nl = p.nl, rowlen = (dm + nr) * dm;
  for (int b = warp; b < nl; b += kWarps) {
    const int l = lord[b];
    float* D = A + l * rowlen;
    const int d = p.d[l];
    chol_cols(D, d, dm, lane < d || (lane >= dm && lane < dm + nr));
    if (lane < d)
      for (int c = lane + 1; c < dm; ++c) D[lane * dm + c] = 0.f;
  }
  __syncthreads();
  float* R = A + nl * rowlen;
  for (int q = t; q < nr * nr; q += kThreads) {
    const int r = q / nr, c = q - r * nr;
    if (c > r) continue;
    float s = R[r * dm + c];
    for (int l = 0; l < nl; ++l) {
      const float* LB = A + l * rowlen + dm * dm;
      const int d = p.d[l];
#pragma unroll
      for (int k = 0; k < kMaxDm; ++k)
        if (k < d) s -= LB[r * dm + k] * LB[c * dm + k];
    }
    R[r * dm + c] = s;
  }
  __syncthreads();
  if (warp == 0) chol_warp(R, nr, dm, nr);
  __syncthreads();
}

// In place: nrhs right-hand sides X (dof layout, row stride ld) become
// A^-1 X for the packed factor F (arrow_solve in arrow.cuh, the same
// operations in the same order): forward substitution a thread a (limb,
// rhs), the root right-hand side a thread a (root dof, rhs), the root
// solve a thread a rhs, the back substitution a thread a (limb, rhs),
// longest limbs first (lord) so that a second round of tasks takes the
// short ones; the limb's right-hand side in registers, the factor's rows
// broadcast from shared memory to the threads of one limb.
__device__ __forceinline__ void solve_packed(const float* F, float* X,
                                             int nrhs, int ld,
                                             const ArrowPart& p,
                                             const int* lord) {
  const int t = threadIdx.x;
  const int dm = p.dm, nr = p.nr, nl = p.nl, rowlen = (dm + nr) * dm;
  for (int q = t; q < nl * nrhs; q += kThreads) {
    const int l = lord[q / nrhs], j = q % nrhs;
    const float* D = F + l * rowlen;
    float* y = X + (size_t)j * ld + p.lo[l];
    const int d = p.d[l];
    float r[kMaxDm];
#pragma unroll
    for (int i = 0; i < kMaxDm; ++i) r[i] = i < d ? y[i] : 0.f;
#pragma unroll
    for (int k = 0; k < kMaxDm; ++k) {
      if (k < d) {
        float s = r[k];
#pragma unroll
        for (int i = 0; i < k; ++i) s -= D[k * dm + i] * r[i];
        r[k] = s / D[k * dm + k];
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxDm; ++i)
      if (i < d) y[i] = r[i];
  }
  __syncthreads();
  for (int q = t; q < nr * nrhs; q += kThreads) {
    const int j = q / nr, r = q - j * nr;
    float* x = X + (size_t)j * ld;
    float s = x[r];
    for (int l = 0; l < nl; ++l) {
      const float* LB = F + l * rowlen + dm * dm;
      const float* y = x + p.lo[l];
      const int d = p.d[l];
#pragma unroll
      for (int k = 0; k < kMaxDm; ++k)
        if (k < d) s -= LB[r * dm + k] * y[k];
    }
    x[r] = s;
  }
  __syncthreads();
  const float* LR = F + nl * rowlen;
  for (int j = t; j < nrhs; j += kThreads) {
    float* x = X + (size_t)j * ld;
    float r[kMaxNr];
#pragma unroll
    for (int i = 0; i < kMaxNr; ++i) r[i] = i < nr ? x[i] : 0.f;
#pragma unroll
    for (int k = 0; k < kMaxNr; ++k) {
      if (k < nr) {
        float s = r[k];
#pragma unroll
        for (int i = 0; i < k; ++i) s -= LR[k * dm + i] * r[i];
        r[k] = s / LR[k * dm + k];
      }
    }
#pragma unroll
    for (int k = kMaxNr - 1; k >= 0; --k) {
      if (k < nr) {
        float s = r[k];
#pragma unroll
        for (int i = k + 1; i < kMaxNr; ++i)
          if (i < nr) s -= LR[i * dm + k] * r[i];
        r[k] = s / LR[k * dm + k];
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxNr; ++i)
      if (i < nr) x[i] = r[i];
  }
  __syncthreads();
  for (int q = t; q < nl * nrhs; q += kThreads) {
    const int l = lord[q / nrhs], j = q % nrhs;
    const float* D = F + l * rowlen;
    const float* xr = X + (size_t)j * ld;
    float* y = X + (size_t)j * ld + p.lo[l];
    const int d = p.d[l];
    float root[kMaxNr], r[kMaxDm];
#pragma unroll
    for (int i = 0; i < kMaxNr; ++i) root[i] = i < nr ? xr[i] : 0.f;
#pragma unroll
    for (int a = 0; a < kMaxDm; ++a) {
      r[a] = 0.f;
      if (a < d) {
        float s = y[a];
#pragma unroll
        for (int i = 0; i < kMaxNr; ++i)
          if (i < nr) s -= D[(dm + i) * dm + a] * root[i];
        r[a] = s;
      }
    }
#pragma unroll
    for (int k = kMaxDm - 1; k >= 0; --k) {
      if (k < d) {
        float s = r[k];
#pragma unroll
        for (int i = k + 1; i < kMaxDm; ++i)
          if (i < d) s -= D[i * dm + k] * r[i];
        r[k] = s / D[k * dm + k];
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxDm; ++i)
      if (i < d) y[i] = r[i];
  }
  __syncthreads();
}

// Per contact slot k, mask[k]: bit l for each limb whose columns its three
// J rows touch (a nonzero or NaN entry), bit kRootBit for the root; a warp
// (of the kNW from warp kW0) takes kSlots slots at once, the lanes over
// the columns, kCols columns a lane in flight. kDots (the whole solve):
// also J ws - aref into the planes N, Y1, Y2 and J a_free - aref into
// V0..V2.
template <bool kDots, int kW0 = 0, int kNW = kWarps>
__device__ __forceinline__ void contact_masks(
    const float* __restrict__ J, int K, int nv, const int* vbit,
    unsigned* mask, const float* ws, const float* af, const float* arc,
    float* pl) {
  constexpr int kSlots = 4, kCols = 4;  // slots, column strides in flight
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) - kW0;
  for (int k0 = warp; k0 < K; k0 += kSlots * kNW) {
    unsigned m[kSlots];
    float sw[kSlots][3], sa[kSlots][3];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      m[u] = 0;
      for (int c = 0; c < 3; ++c) sw[u][c] = sa[u][c] = 0.f;
    }
    for (int v0 = lane; v0 < nv; v0 += 32 * kCols) {
      float x[kSlots][kCols][3];
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int k = k0 + u * kNW, v = v0 + 32 * i;
          const bool in = k < K && v < nv;
          const float* j0 = J + (in ? (size_t)3 * k * nv + v : 0);
          for (int c = 0; c < 3; ++c) x[u][i][c] = in ? j0[c * nv] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int v = v0 + 32 * i;
        if (v >= nv) break;
        const unsigned bit = 1u << vbit[v];
        float w = 0.f, f = 0.f;
        if constexpr (kDots) w = ws[v], f = af[v];
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          const float* a = x[u][i];
          if (a[0] != 0.f || a[1] != 0.f || a[2] != 0.f) m[u] |= bit;
          if constexpr (kDots) {
            sw[u][0] += a[0] * w, sw[u][1] += a[1] * w, sw[u][2] += a[2] * w;
            sa[u][0] += a[0] * f, sa[u][1] += a[1] * f, sa[u][2] += a[2] * f;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int k = k0 + u * kNW;
      if (k >= K) break;
      const unsigned mu = __reduce_or_sync(0xffffffffu, m[u]);
      if (lane == 0) mask[k] = mu;
      if constexpr (kDots) {
        for (int c = 0; c < 3; ++c) {
          const float w = warp_sum(sw[u][c]), f = warp_sum(sa[u][c]);
          if (lane == 0) {
            pl[c * K + k] = w - arc[3 * k + c];
            pl[(3 + c) * K + k] = f - arc[3 * k + c];
          }
        }
      }
    }
  }
}

// list + b * K: the slots whose mask has bit b (limb b < nl; b = nl: the
// root), in increasing order; cnt[b] their number. A warp a list (of the
// kNW from warp kW0).
template <int kW0 = 0, int kNW = kWarps>
__device__ __forceinline__ void contact_lists(const unsigned* mask, int K,
                                              int nl, int* list, int* cnt) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) - kW0;
  for (int b = warp; b <= nl; b += kNW) {
    const unsigned bit = 1u << (b < nl ? b : kRootBit);
    int n = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const bool in = k < K && (mask[k] & bit);
      const unsigned bal = __ballot_sync(0xffffffffu, in);
      if (in) list[b * K + n + __popc(bal & ((1u << lane) - 1u))] = k;
      n += __popc(bal);
    }
    if (lane == 0) cnt[b] = n;
  }
}

// out[v] = sum over the slots k touching v's block (its limb's list, or
// the root's) of J[3k + c][v] f[3k + c], in the order of k then c, a
// thread a dof (kT threads from the first): the dense sum over every row
// in its order, less the exact zeros.
template <int kT = kThreads>
__device__ __forceinline__ void jt_times(const float* __restrict__ J,
                                         const float* f, const int* list,
                                         const int* cnt, const int* vbit,
                                         int K, const ArrowPart& p,
                                         float* out) {
  const int nv = p.nv;
  for (int v = threadIdx.x; v < nv; v += kT) {
    const int b = v < p.nr ? p.nl : vbit[v], n = cnt[b];
    const int* ls = list + b * K;
    float s = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const int k = ls[i];
      const float* j = J + (size_t)3 * k * nv + v;
      s += j[0] * f[3 * k];
      s += j[nv] * f[3 * k + 1];
      s += j[2 * nv] * f[3 * k + 2];
    }
    out[v] = s;
  }
}

// V_c[k] (V + c * K) = J[3k + c] . x over the columns slot k touches; a
// warp takes two slots at once, the lanes over the columns.
__device__ __forceinline__ void j_times(const float* __restrict__ J,
                                        const float* x, const unsigned* mask,
                                        const int* vbit, int K, int nv,
                                        float* V) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k0 = warp; k0 < K; k0 += 2 * kWarps) {
    const int k1 = k0 + kWarps;
    const unsigned m0 = mask[k0], m1 = k1 < K ? mask[k1] : 0u;
    const float* j0 = J + (size_t)3 * k0 * nv;
    const float* j1 = J + (size_t)3 * (k1 < K ? k1 : k0) * nv;
    float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (m0 | m1) {
      for (int v = lane; v < nv; v += 32) {
        const int b = vbit[v];
        const float xv = x[v];
        if ((m0 >> b) & 1u)
          s[0] += j0[v] * xv, s[1] += j0[nv + v] * xv,
              s[2] += j0[2 * nv + v] * xv;
        if ((m1 >> b) & 1u)
          s[3] += j1[v] * xv, s[4] += j1[nv + v] * xv,
              s[5] += j1[2 * nv + v] * xv;
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) s[i] = warp_sum(s[i]);
    }
    if (lane == 0) {
      V[k0] = s[0], V[K + k0] = s[1], V[2 * K + k0] = s[2];
      if (k1 < K) V[k1] = s[3], V[K + k1] = s[4], V[2 * K + k1] = s[5];
    }
  }
}

// Row c of the weighted 3x3 W (unique entries 00 01 02 11 12 22) times
// the three J rows of a slot at column v: (W J)[c][v], in the order a
// dense J W buffer forms it.
__device__ __forceinline__ float wj(const float* w, int c, const float* j0,
                                    int nv, int v) {
  const float w0 = c == 0 ? w[0] : (c == 1 ? w[1] : w[2]);
  const float w1 = c == 0 ? w[1] : (c == 1 ? w[3] : w[4]);
  const float w2 = c == 0 ? w[2] : (c == 1 ? w[4] : w[5]);
  return w0 * j0[v] + w1 * j0[nv + v] + w2 * j0[2 * nv + v];
}

// Limb l's tile of J^T W J in registers, added to the packed A with the
// limit diagonal g: lane i < d takes limb row lo + i (its lower triangle),
// lane d + r root row r (the border B_l's row r), each over the limb's d
// columns, summed over the listed slots whose W_k is not all zero. Each
// entry sums J[3k + c][row] (W J)[3k + c][col] in the order of k then c,
// the dense sum over every row less its exact zeros.
__device__ __forceinline__ void limb_tile(float* A,
                                          const float* __restrict__ J,
                                          const float* W, const int* wnz,
                                          const int* ls, int n,
                                          const float* g, const ArrowPart& p,
                                          int l) {
  const int lane = threadIdx.x & 31, nv = p.nv, dm = p.dm, nr = p.nr;
  const int d = p.d[l], lo = p.lo[l];
  const int row = lane < d ? lo + lane : (lane < d + nr ? lane - d : -1);
  float acc[kMaxDm];
#pragma unroll
  for (int c = 0; c < kMaxDm; ++c) acc[c] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int k = ls[i];
    if (!wnz[k]) continue;
    const float* w = W + 6 * k;
    const float* j0 = J + (size_t)3 * k * nv;
    float r[3] = {0.f, 0.f, 0.f};
    if (row >= 0) r[0] = j0[row], r[1] = j0[nv + row], r[2] = j0[2 * nv + row];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int q = 0; q < kMaxDm; ++q)
        if (q < d) acc[q] += r[c] * wj(w, c, j0, nv, lo + q);
    }
  }
  float* D = A + l * (dm + nr) * dm;
  if (lane < d) {
#pragma unroll
    for (int c = 0; c < kMaxDm; ++c) {
      if (c <= lane) {
        float h = D[lane * dm + c] + acc[c];
        if (c == lane) h += g[lo + lane];
        D[lane * dm + c] = h;
      }
    }
  } else if (row >= 0) {
    float* B = D + (dm + lane - d) * dm;
#pragma unroll
    for (int c = 0; c < kMaxDm; ++c)
      if (c < d) B[c] += acc[c];
  }
}

// The root tile (lower triangle) of J^T W J plus the limit diagonal, added
// to A's root block: lane q takes entry q, summed over the root's listed
// slots whose W_k is not all zero in the order of the dense sum.
__device__ __forceinline__ void root_tile(float* A,
                                          const float* __restrict__ J,
                                          const float* W, const int* wnz,
                                          const int* ls, int n,
                                          const float* g,
                                          const ArrowPart& p) {
  const int lane = threadIdx.x & 31, nv = p.nv, dm = p.dm, nr = p.nr;
  if (lane >= nr * (nr + 1) / 2) return;
  int r = 0;
  while ((r + 1) * (r + 2) / 2 <= lane) ++r;
  const int c = lane - r * (r + 1) / 2;
  float s = 0.f;
  for (int i = 0; i < n; ++i) {
    const int k = ls[i];
    if (!wnz[k]) continue;
    const float* w = W + 6 * k;
    const float* j0 = J + (size_t)3 * k * nv;
    for (int q = 0; q < 3; ++q) s += j0[q * nv + r] * wj(w, q, j0, nv, c);
  }
  float* R = A + p.nl * (dm + nr) * dm;
  float h = R[r * dm + c] + s;
  if (c == r) h += g[r];
  R[r * dm + c] = h;
}

// Issues the bulk copies of env e's slabs into the stage of shared memory
// sm (one thread).
template <int kMode>
__device__ __forceinline__ void stage_env(const NewtonArgs& a,
                                          const Layout& o, float* sm,
                                          uint64_t* bar, int e) {
  constexpr bool kAssemble = kMode == kWhole || kMode == kBlockFull;
  const ArrowPart& p = a.p;
  const int nv = p.nv, K = a.K, L = a.L, SB3 = a.SB3;
  const int msize = (p.nl + 1) * (p.dm + p.nr) * p.dm;
  const int ncp = kAssemble ? 5 : 4;
  const uint32_t f4 = sizeof(float);
  uint32_t bytes = f4 * (msize + 2 * nv + L + 3 * K + 2 * L + ncp * K);
  if constexpr (!kAssemble) bytes += f4 * SB3 * nv;
  fence_proxy_async();
  mbar_expect_bytes(bar, bytes);
  const size_t E = (size_t)e;
  bulk_load(sm + o.A, (kAssemble ? a.M : a.Hp) + E * msize, f4 * msize, bar);
  if constexpr (!kAssemble)
    bulk_load(sm + o.Ut, a.U + E * SB3 * nv, f4 * SB3 * nv, bar);
  bulk_load(sm + o.x, a.x + E * nv, f4 * nv, bar);
  bulk_load(sm + o.msm, a.msm + E * nv, f4 * nv, bar);
  bulk_load(sm + o.jl, a.jar_l + E * L, f4 * L, bar);
  bulk_load(sm + o.jc, a.jar_c + E * 3 * K, f4 * 3 * K, bar);
  bulk_load(sm + o.lp, a.lim_params + E * 2 * L, f4 * 2 * L, bar);
  bulk_load(sm + o.cp, a.con_params + E * ncp * K, f4 * ncp * K, bar);
}

// Phase i of the current env ends: the block synchronises and thread 0
// adds the cycles since the last mark to phase i (clock instantiation).
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

template <int kMode, bool kClock>
__global__ void __launch_bounds__(kThreads, 4) newton_kernel(NewtonArgs a) {
  constexpr bool kWholeSolve = kMode == kWhole;
  constexpr bool kAssemble = kWholeSolve || kMode == kBlockFull;
  extern __shared__ __align__(16) float sm[];
  const ArrowPart& p = a.p;
  const int nv = p.nv, nr = p.nr, nl = p.nl, K = a.K, L = a.L, SB3 = a.SB3;
  const int R3 = 3 * K;
  const Layout& o = a.o;
  const int msize = (nl + 1) * (p.dm + nr) * p.dm;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);

  float *Ci = sm + o.Ci, *wu = sm + o.wu, *wv = sm + o.wv;
  float *g = sm + o.g, *dx = sm + o.dx, *mdx = sm + o.mdx;
  float *vl = sm + o.vl, *fl = sm + o.fl, *fc = sm + o.fc, *red = sm + o.red;
  float* pl = sm + o.pl;
  float *N = pl, *Y1 = pl + K, *Y2 = pl + 2 * K;
  float *V0 = pl + 3 * K, *V1 = pl + 4 * K, *V2 = pl + 5 * K;
  int* ldof = reinterpret_cast<int*>(sm + o.ldof);
  float* lsign = sm + o.lsign;
  int* dlim = reinterpret_cast<int*>(sm + o.dlim);
  int* vbit = reinterpret_cast<int*>(sm + o.vbit);
  int* lord = reinterpret_cast<int*>(sm + o.lord);
  unsigned* mask = reinterpret_cast<unsigned*>(sm + o.mask);
  int* list = reinterpret_cast<int*>(sm + o.list);
  int* cnt = reinterpret_cast<int*>(sm + o.cnt);

  // ---- Once a block: the tables, the barriers, the first env's slabs.
  for (int i = t; i < L; i += kThreads) {
    ldof[i] = a.lim.dof[i];
    lsign[i] = a.lim.sign[i];
  }
  for (int i = t; i < 2 * nv; i += kThreads) dlim[i] = a.lim.dof_lim[i];
  for (int v = t; v < nv; v += kThreads) {
    int l = 0;
    while (l + 1 < nl && p.lo[l + 1] <= v) ++l;
    vbit[v] = v < nr ? kRootBit : l;
  }
  if (t == 0) {
    mbar_init(bar, 1);
    for (int i = 0; i < nl; ++i) {  // limbs by decreasing size, stable
      int j = i;
      for (; j > 0 && p.d[lord[j - 1]] < p.d[i]; --j) lord[j] = lord[j - 1];
      lord[j] = i;
    }
  }
  __syncthreads();
  if (t == 0) stage_env<kMode>(a, o, sm, bar, blockIdx.x);

  int round = 0;
  for (int e = blockIdx.x; e < a.B; e += gridDim.x, ++round) {
    long long ph[kPhases], c_last = 0;
    if constexpr (kClock) {
      for (int i = 0; i < kPhases; ++i) ph[i] = 0;
      c_last = clock64();
    }
    mbar_wait(bar, round & 1);

    float *A = sm + o.A, *x = sm + o.x, *msm = sm + o.msm, *jl = sm + o.jl;
    float *al = sm + o.lp, *Dl = sm + o.lp + L;
    const float* cp = sm + o.cp;
    const float *mu = cp, *fric = cp + K, *act = cp + 2 * K, *D = cp + 3 * K;
    const float* Je = a.J + (size_t)e * R3 * nv;
    const float* Me = a.M + (size_t)e * msize;
    float* Ut = kAssemble ? sm + o.Uw : sm + o.Ut;
    float* C = sm + o.C;

    // ---- The contact-limb mask and lists; the Newton state's planes.
    if constexpr (kWholeSolve) {
      // Candidates: x holds a_free, msm the warmstart ws, jl the limit
      // aref, the jc slab the contact aref. The warmstart's jars go to
      // (jl, N, Y1, Y2), a_free's to (vl, V0, V1, V2); dx = ws - a_free.
      float *af = x, *ws = msm;
      for (int i = t; i < L; i += kThreads) {
        const float arl = jl[i];
        jl[i] = ws[ldof[i]] * lsign[i] - arl;
        vl[i] = af[ldof[i]] * lsign[i] - arl;
      }
      contact_masks<true>(Je, K, nv, vbit, mask, ws, af, sm + o.jc, pl);
      for (int v = t; v < nv; v += kThreads) dx[v] = ws[v] - af[v];
      __syncthreads();
      arrow_matvec(A, dx, mdx, p);  // A holds M here
      contact_lists(mask, K, nl, list, cnt);
      __syncthreads();
      if (warp == 0) {  // primal costs of both candidates
        float sq = 0.f, lw = 0.f, la = 0.f, cw = 0.f, ca = 0.f;
        for (int v = lane; v < nv; v += 32) sq += dx[v] * mdx[v];
        for (int i = lane; i < L; i += 32) {
          const float w1 = jl[i], w2 = vl[i];
          lw += Dl[i] * al[i] * (w1 < 0.f ? w1 * w1 : 0.f);
          la += Dl[i] * al[i] * (w2 < 0.f ? w2 * w2 : 0.f);
        }
        for (int k = lane; k < K; k += 32) {
          float r[3];
          cone_residual3(N[k], Y1[k], Y2[k], mu[k], fric[k], r);
          cw += D[k] * act[k] * (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
          cone_residual3(V0[k], V1[k], V2[k], mu[k], fric[k], r);
          ca += D[k] * act[k] * (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
        }
        sq = warp_sum(sq), lw = warp_sum(lw), la = warp_sum(la);
        cw = warp_sum(cw), ca = warp_sum(ca);
        const float c_ws = 0.5f * sq + 0.5f * lw + 0.5f * cw;
        const float c_af = 0.5f * la + 0.5f * ca;
        if (lane == 0) red[0] = c_ws < c_af ? 1.f : 0.f;
      }
      __syncthreads();
      const bool use_ws = red[0] > 0.5f;
      for (int v = t; v < nv; v += kThreads) {  // x <- start, msm <- M dx
        x[v] = use_ws ? ws[v] : af[v];
        msm[v] = use_ws ? mdx[v] : 0.f;
      }
      if (!use_ws) {
        for (int i = t; i < L; i += kThreads) jl[i] = vl[i];
        for (int q = t; q < R3; q += kThreads) pl[q] = pl[R3 + q];
      }
    } else {
      const float* jc = sm + o.jc;
      for (int q = t; q < R3; q += kThreads) pl[(q % 3) * K + q / 3] = jc[q];
      contact_masks<false>(Je, K, nv, vbit, mask, nullptr, nullptr, nullptr,
                           nullptr);
      __syncthreads();
      contact_lists(mask, K, nl, list, cnt);
    }
    __syncthreads();
    PHASE(0);

    if constexpr (kAssemble) {
      // Hessian: W_k = D_k * cone Hessian (hess-active slots), the limit
      // diagonal (in g), then the tiles of M + J^T W J + diag.
      float *W = sm + o.W, *G = sm + o.G;
      int* wnz = reinterpret_cast<int*>(sm + o.wnz);
      const float* hact = cp + 4 * K;
      for (int k = t; k < K; k += kThreads) {
        float w6[6];
        cone_hessian6(N[k], Y1[k], Y2[k], mu[k], fric[k], hact[k], w6);
        bool nz = false;
        for (int i = 0; i < 6; ++i) {
          w6[i] *= D[k];
          W[6 * k + i] = w6[i];
          nz |= w6[i] != 0.f;
        }
        wnz[k] = nz;
      }
      for (int v = t; v < nv; v += kThreads) {
        float sd = 0.f;
        for (int j = 0; j < 2; ++j) {
          const int i = dlim[2 * v + j];
          if (i >= 0) sd += Dl[i] * (jl[i] < 0.f ? al[i] : 0.f);
        }
        g[v] = sd + 1e-12f;
      }
      __syncthreads();
      PHASE(1);
      for (int b = warp; b <= nl; b += kWarps) {
        if (b < nl)
          limb_tile(A, Je, W, wnz, list + b * K, cnt[b], g, p, b);
        else
          root_tile(A, Je, W, wnz, list + nl * K, cnt[nl], g, p);
      }
      __syncthreads();
      PHASE(2);
      // Woodbury rows of the selected cross-limb slots: U = G^T V.
      const int SB = SB3 / 3;
      const int* bs = a.bsel + (size_t)e * SB;
      for (int q = t; q < SB; q += kThreads) {
        const int k = bs[q];
        float w6[6];
        cone_hessian6(N[k], Y1[k], Y2[k], mu[k], fric[k], act[k] - hact[k],
                      w6);
        for (int i = 0; i < 6; ++i) w6[i] *= D[k];
        chol3(w6, G + 6 * q);
      }
      __syncthreads();
      for (int q = t; q < SB3 * nv; q += kThreads) {
        const int r = q / nv, v = q - r * nv;
        const int sl = r / 3, c = r % 3;
        const float* gs = G + 6 * sl;  // a b c d e f
        const float* j0 = Je + (size_t)(3 * bs[sl]) * nv;
        float u;
        if (c == 0)
          u = gs[0] * j0[v] + gs[1] * j0[nv + v] + gs[2] * j0[2 * nv + v];
        else if (c == 1)
          u = gs[3] * j0[nv + v] + gs[4] * j0[2 * nv + v];
        else
          u = gs[5] * j0[2 * nv + v];
        Ut[q] = u;
      }
      __syncthreads();
      PHASE(3);
    }

    // ---- Factor, Z = A^-1 U, capacitance I + U Z and its Cholesky.
    factor_packed(A, p, lord);
    PHASE(4);
    float* Z = sm + o.Z;
    for (int q = t; q < SB3 * nv; q += kThreads) {
      const int r = q / nv, v = q - r * nv;
      Z[r * o.ldz + v] = Ut[q];
    }
    __syncthreads();
    solve_packed(A, Z, SB3, o.ldz, p, lord);
    PHASE(5);
    for (int q = t; q < SB3 * SB3; q += kThreads) {
      const int i = q / SB3, j = q - i * SB3;
      if (j <= i) {
        float sc = 0.f;
#pragma unroll 4
        for (int v = 0; v < nv; ++v) sc += Ut[i * nv + v] * Z[j * o.ldz + v];
        C[q] = i == j ? (1.f + sc) + 1e-10f : sc;
      }
    }
    __syncthreads();
    if (warp == 0) chol_warp(C, SB3, SB3, 0);
    __syncthreads();
    for (int c = t; c < SB3; c += kThreads) {  // Ci = LC^-1, column c
      for (int i = c; i < SB3; ++i) {
        float sc = i == c ? 1.f : 0.f;
#pragma unroll 4
        for (int k = c; k < i; ++k) sc -= C[i * SB3 + k] * Ci[k * SB3 + c];
        Ci[i * SB3 + c] = sc / C[i * SB3 + i];
      }
    }
    __syncthreads();
    PHASE(6);

    LsRows rows;
    rows.jl = jl, rows.vl = vl, rows.al = al, rows.Dl = Dl;
    rows.n0 = N, rows.t10 = Y1, rows.t20 = Y2;
    rows.v0 = V0, rows.v1 = V1, rows.v2 = V2;
    rows.mu = mu, rows.fric = fric, rows.act = act, rows.D = D;
    rows.L = L, rows.K = K;

    // ---- Newton iterations on the fixed factor.
    for (int it = 0; it < a.n_iters; ++it) {
      for (int i = t; i < L; i += kThreads)
        fl[i] = jl[i] < 0.f ? -Dl[i] * jl[i] * al[i] : 0.f;
      for (int k = t; k < K; k += kThreads) {
        float r[3];
        cone_residual3(N[k], Y1[k], Y2[k], mu[k], fric[k], r);
        const float Da = D[k] * act[k];
        fc[3 * k] = -Da * r[0];
        fc[3 * k + 1] = -Da * r[1];
        fc[3 * k + 2] = -Da * r[2];
      }
      __syncthreads();
      jt_times(Je, fc, list, cnt, vbit, K, p, g);
      __syncthreads();
      for (int v = t; v < nv; v += kThreads)
        g[v] = (msm[v] - lim_scatter(dlim, fl, lsign, v)) - g[v];
      __syncthreads();
      PHASE(7);
      solve_packed(A, g, 1, nv, p, lord);  // g <- t = A^-1 g
      PHASE(8);
      for (int r = warp; r < SB3; r += kWarps) {
        float sw = 0.f;
        for (int v = lane; v < nv; v += 32) sw += Ut[r * nv + v] * g[v];
        sw = warp_sum(sw);
        if (lane == 0) wu[r] = sw;
      }
      __syncthreads();
      if (warp == 0) {  // wu <- Ci^T (Ci wu), the capacitance solve
        float sw = 0.f;
        if (lane < SB3)
          for (int j = 0; j <= lane; ++j) sw += Ci[lane * SB3 + j] * wu[j];
        __syncwarp();
        if (lane < SB3) wv[lane] = sw;
        __syncwarp();
        sw = 0.f;
        if (lane < SB3)
          for (int j = lane; j < SB3; ++j) sw += Ci[j * SB3 + lane] * wv[j];
        __syncwarp();
        if (lane < SB3) wu[lane] = sw;
      }
      __syncthreads();
      for (int v = t; v < nv; v += kThreads) {
        float sw = 0.f;
        for (int r = 0; r < SB3; ++r) sw += Z[r * o.ldz + v] * wu[r];
        dx[v] = -(g[v] - sw);
      }
      __syncthreads();
      PHASE(9);
      arrow_matvec(Me, dx, mdx, p);
      __syncthreads();
      PHASE(10);
      j_times(Je, dx, mask, vbit, K, nv, V0);
      for (int i = t; i < L; i += kThreads) vl[i] = dx[ldof[i]] * lsign[i];
      if (warp == 0) {  // msm . dx, dx . M dx
        float s0 = 0.f, s1 = 0.f;
        for (int v = lane; v < nv; v += 32) {
          s0 += msm[v] * dx[v];
          s1 += dx[v] * mdx[v];
        }
        s0 = warp_sum(s0), s1 = warp_sum(s1);
        if (lane == 0) red[0] = s0, red[1] = s1;
      }
      __syncthreads();
      PHASE(11);
      // The search on one warp or with the block computing its terms: the
      // same step bit for bit; the one warp is quicker at K 24 (one slot
      // a lane), the block at K 64.
      float alpha;
      if constexpr (kWholeSolve) {
        if (warp == 0) {
          const float step =
              ls_alpha_warp(rows, red[0], red[1], 6, a.ls_iters, lane);
          if (lane == 0) red[2] = step;
        }
        __syncthreads();
        alpha = red[2];
      } else {
        alpha = ls_alpha_split(rows, red[0], red[1], 6, a.ls_iters,
                               reinterpret_cast<float4*>(sm + o.lsw),
                               red + 2);
      }
      PHASE(12);
      for (int v = t; v < nv; v += kThreads) {
        x[v] += alpha * dx[v];
        msm[v] += alpha * mdx[v];
      }
      for (int i = t; i < L; i += kThreads) jl[i] += alpha * vl[i];
      for (int q = t; q < R3; q += kThreads) pl[q] += alpha * pl[R3 + q];
      __syncthreads();
      PHASE(13);
    }

    // ---- Outputs.
    if constexpr (!kWholeSolve) {
      for (int v = t; v < nv; v += kThreads) {
        a.o0[(size_t)e * nv + v] = x[v];
        a.o1[(size_t)e * nv + v] = msm[v];
      }
      for (int i = t; i < L; i += kThreads) a.o2[(size_t)e * L + i] = jl[i];
      for (int q = t; q < R3; q += kThreads)
        a.o3[(size_t)e * R3 + q] = pl[(q % 3) * K + q / 3];
    } else {
      for (int i = t; i < L; i += kThreads)
        fl[i] = -Dl[i] * jl[i] * (jl[i] < 0.f ? al[i] : 0.f);
      for (int k = t; k < K; k += kThreads) {
        float r[3];
        cone_residual3(N[k], Y1[k], Y2[k], mu[k], fric[k], r);
        const float Da = D[k] * act[k];
        fc[3 * k] = -Da * r[0];
        fc[3 * k + 1] = -Da * r[1];
        fc[3 * k + 2] = -Da * r[2];
      }
      __syncthreads();
      jt_times(Je, fc, list, cnt, vbit, K, p, g);
      __syncthreads();
      for (int v = t; v < nv; v += kThreads) {
        a.o0[(size_t)e * nv + v] = x[v];
        a.o1[(size_t)e * nv + v] = lim_scatter(dlim, fl, lsign, v) + g[v];
      }
      for (int i = t; i < L; i += kThreads) a.o2[(size_t)e * L + i] = fl[i];
      for (int q = t; q < R3; q += kThreads) a.o3[(size_t)e * R3 + q] = fc[q];
    }
    // Every thread is done with the stage before the next env's slabs
    // come in; the other blocks on the SM compute while they do.
    __syncthreads();
    if (t == 0 && e + (int)gridDim.x < a.B)
      stage_env<kMode>(a, o, sm, bar, e + gridDim.x);
    PHASE(14);
    if constexpr (kClock) {
      if (t == 0 && e % a.clk_stride == 0)
        for (int i = 0; i < kPhases; ++i)
          a.clk[(size_t)(e / a.clk_stride) * kPhases + i] += ph[i];
    }
  }
}

// ---------------------------------------------------------------------
// Kernel 10 on its own: newton_reuse_kernel.
//
// Its first form ran as a mode of newton_kernel and spent 213.7 thousand
// cycles an env on the chain's first reuse launch (PERF.md section 5).
// What held it, and what this design does about each:
//   * M dx (71.4): a warp walked its 27 rows of the dense M one at a
//     time, each row's loads and butterfly before the next row's loads.
//     Here a warp keeps kRowGroup rows' loads in flight, then sums each
//     row's lanes in the same order and runs the rows' butterflies
//     together (dense_matvec_rows).
//   * the line search (34.2): the block form's two barriers and a warp's
//     sum of the staged terms at each of its 19 evaluations. Here warp 0
//     runs it with the slots' cone constants in registers and the limit
//     rows of zero weight skipped, as row 13's kernel does
//     (reuse_line_search), and the other warps work meanwhile (below).
//   * the stage-in (23.9) and Ci (16.6): the slabs were asked for only
//     once the env before was written out, then every warp read J for the
//     contact masks, then 24 threads walked Ci's columns through shared
//     memory. Here, during the last search of the block's env before,
//     the last warp asks for this env's factor slabs (F, U, Z, LC) and
//     forms Ci once they are in, a lane a column on LC's rows by 16-byte
//     loads (ci_columns), while warps 1 .. kWarps - 2 form its contact
//     masks and lists; the block's first env forms Ci on the last warp
//     while the others compute its first gradient and substitution.
//   * the substitution (23.3, of it the back substitution most): a
//     thread a limb, each term behind its shared load. Here the back
//     substitution runs a half-warp a limb, each row's column of the
//     factor in registers and each solved value passed by a shuffle
//     (solve_lanes_back).
//   * J dx (14.9): two slots a warp, each load behind its mask test. Here
//     kJSlots slots a warp with every load of the columns their masks
//     hold issued before the sums (j_times_slots).
//   * the code: fully unrolled, the search's evaluations would come to
//     some 27 thousand instructions, and four blocks in different phases
//     would miss in the instruction cache; loops stay rolled where their
//     trip counts are the data's (one evaluation site in the search).
// Every sum keeps the first form's order (jt_times, j_times, dense_matvec,
// solve_packed, the Woodbury sums, the capacitance inverse, the line
// search's evaluations), so the outputs are its bit for bit.
constexpr int kRowGroup = 9;  // dense M rows a warp keeps in flight
constexpr int kMvCols = 4;    // column strides of 32 a row's loads span
constexpr int kJSlots = 2;    // J dx: slots a warp keeps in flight
constexpr int kJCols = 4;     // J dx: column strides of 32 in flight
constexpr int kPre = kWarps - 1;  // warps that solve while the last forms Ci
constexpr int kPreThreads = 32 * kPre;
constexpr int kLsExpand = 6;  // the search's bracket doublings

inline Layout reuse_layout(int K, int SB3, int L, const ArrowPart& p) {
  const int nv = p.nv, msize = (p.nl + 1) * (p.dm + p.nr) * p.dm;
  Layout o{};
  int n = 0;
  auto take = [&n](int c) {
    const int at = n;
    n += (c + 3) & ~3;  // 16-byte aligned for the bulk copies
    return at;
  };
  take(4);  // two mbarriers: the factor slabs, the state slabs
  o.A = take(msize);
  o.Ut = take(SB3 * nv);
  o.Zg = take(nv * SB3);
  o.LC = take(SB3 * SB3);
  o.x = take(nv);
  o.msm = take(nv);
  o.jl = take(L);
  o.jc = take(3 * K);
  o.lp = take(2 * L);
  o.cp = take(4 * K);
  // Ci^T's row stride: an odd multiple of 4, so that a quarter-warp's
  // 16-byte loads of eight rows fall in distinct banks.
  o.ldz = ((SB3 + 3) & ~3) | 4;
  o.Ci = take(SB3 * o.ldz);
  o.wu = take(SB3);
  o.wv = take(SB3);
  o.g = take(nv);
  o.dx = take(nv);
  o.mdx = take(nv);
  o.vl = take(L);
  o.fl = take(L);
  o.pl = take(6 * K);  // N, Y1, Y2, V0, V1, V2
  o.fc = take(3 * K);
  o.red = take(8);  // the line search's sums and step; Ci's clock
  o.ldof = take(L);
  o.lsign = take(L);
  o.dlim = take(2 * nv);
  o.vbit = take(nv);
  o.lord = take(p.nl);
  o.mask = take(K);
  o.list = take((p.nl + 1) * K);
  o.cnt = take(p.nl + 1);
  o.total = n;
  return o;
}

// Issues the bulk copies of env e's factor slabs (F, U, Z, LC) on bar
// (one thread).
__device__ __forceinline__ void stage_factor(const NewtonArgs& a,
                                             const Layout& o, float* sm,
                                             uint64_t* bar, int e) {
  const ArrowPart& p = a.p;
  const int nv = p.nv, SB3 = a.SB3;
  const int msize = (p.nl + 1) * (p.dm + p.nr) * p.dm;
  const uint32_t f4 = sizeof(float);
  const size_t E = (size_t)e;
  fence_proxy_async();
  mbar_expect_bytes(bar, f4 * (msize + 2 * SB3 * nv + SB3 * SB3));
  bulk_load(sm + o.A, a.Hp + E * msize, f4 * msize, bar);
  bulk_load(sm + o.Ut, a.U + E * SB3 * nv, f4 * SB3 * nv, bar);
  bulk_load(sm + o.Zg, a.Zg + E * nv * SB3, f4 * nv * SB3, bar);
  bulk_load(sm + o.LC, a.LC + E * SB3 * SB3, f4 * SB3 * SB3, bar);
}

// Issues the bulk copies of env e's state slabs (x, msm, jar_l, jar_c and
// the rows' parameters) on bar (one thread).
__device__ __forceinline__ void stage_state(const NewtonArgs& a,
                                            const Layout& o, float* sm,
                                            uint64_t* bar, int e) {
  const int nv = a.p.nv, K = a.K, L = a.L;
  const uint32_t f4 = sizeof(float);
  const size_t E = (size_t)e;
  fence_proxy_async();
  mbar_expect_bytes(bar, f4 * (2 * nv + 3 * L + 7 * K));
  bulk_load(sm + o.x, a.x + E * nv, f4 * nv, bar);
  bulk_load(sm + o.msm, a.msm + E * nv, f4 * nv, bar);
  bulk_load(sm + o.jl, a.jar_l + E * L, f4 * L, bar);
  bulk_load(sm + o.jc, a.jar_c + E * 3 * K, f4 * 3 * K, bar);
  bulk_load(sm + o.lp, a.lim_params + E * 2 * L, f4 * 2 * L, bar);
  bulk_load(sm + o.cp, a.con_params + E * 4 * K, f4 * 4 * K, bar);
}

// Synchronises the kPre warps that solve while the last forms Ci.
__device__ __forceinline__ void pre_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(kPreThreads) : "memory");
}

// y = M x for a dense (nv, nv) M in global memory, each row's sum in the
// first form's order (lane l sums the columns l, l + 32, ... in order,
// then the butterfly), a warp kG rows at a time: the rows' loads are
// issued together, kQ column strides at a time.
template <int kG, int kQ>
__device__ __forceinline__ void dense_matvec_rows(const float* __restrict__ M,
                                                  const float* x, float* y,
                                                  int nv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = warp * kG; i0 < nv; i0 += kWarps * kG) {
    float s[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) s[g] = 0.f;
    for (int j0 = 0; j0 < nv; j0 += 32 * kQ) {
      float m[kG][kQ];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int i = i0 + g, j = j0 + lane + 32 * q;
          m[g][q] = i < nv && j < nv ? M[(size_t)i * nv + j] : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int j = j0 + lane + 32 * q;
        if (j < nv) {
          const float xj = x[j];
#pragma unroll
          for (int g = 0; g < kG; ++g) s[g] += m[g][q] * xj;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < kG; ++g)
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < kG; ++g)
        if (i0 + g < nv) y[i0 + g] = s[g];
    }
  }
}

// V_c[k] (V + c * K) = J[3k + c] . x over the columns slot k touches, in
// j_times's order (lane l's columns l, l + 32, ... whose block the slot's
// mask holds, then the butterfly), a warp kS slots at a time with the
// loads of those columns issued before the sums, kQ column strides at a
// time.
template <int kS, int kQ>
__device__ __forceinline__ void j_times_slots(const float* __restrict__ J,
                                              const float* x,
                                              const unsigned* mask,
                                              const int* vbit, int K, int nv,
                                              float* V) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k0 = warp * kS; k0 < K; k0 += kWarps * kS) {
    unsigned m[kS];
    float s[kS][3];
#pragma unroll
    for (int u = 0; u < kS; ++u) {
      m[u] = k0 + u < K ? mask[k0 + u] : 0u;
      s[u][0] = s[u][1] = s[u][2] = 0.f;
    }
    for (int j0 = 0; j0 < nv; j0 += 32 * kQ) {
      float jv[kS][kQ][3];
      unsigned bits[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int v = j0 + lane + 32 * q;
        bits[q] = v < nv ? 1u << vbit[v] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kS; ++u) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const bool in = (m[u] & bits[q]) != 0u;
          const float* j =
              J + (in ? (size_t)3 * (k0 + u) * nv + j0 + lane + 32 * q : 0);
#pragma unroll
          for (int c = 0; c < 3; ++c) jv[u][q][c] = in ? j[c * nv] : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int v = j0 + lane + 32 * q;
        if (v < nv) {
          const float xv = x[v];
#pragma unroll
          for (int u = 0; u < kS; ++u) {
            if (m[u] & bits[q])
              s[u][0] += jv[u][q][0] * xv, s[u][1] += jv[u][q][1] * xv,
                  s[u][2] += jv[u][q][2] * xv;
          }
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kS; ++u) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          s[u][c] += __shfl_xor_sync(0xffffffffu, s[u][c], o);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kS; ++u) {
        if (k0 + u < K)
          V[k0 + u] = s[u][0], V[K + k0 + u] = s[u][1],
                 V[2 * K + k0 + u] = s[u][2];
      }
    }
  }
}

// t = A^-1 g for one right-hand side in place (X, dof layout), the
// operations of solve_packed (nrhs 1) in its order, in four parts that the
// caller separates by barriers: the forward substitution a thread a limb,
// the root right-hand side a thread a root dof, the root solve on one
// thread, then the back substitution (solve_lanes_back). Each division by
// div_rn, which is the division bit for bit.
__device__ __forceinline__ void solve_forward(const float* F, float* X,
                                              const ArrowPart& p) {
  const int l = threadIdx.x;
  if (l >= p.nl) return;
  const int dm = p.dm, rowlen = (dm + p.nr) * dm, d = p.d[l];
  const float* D = F + l * rowlen;
  float* y = X + p.lo[l];
  float r[kMaxDm];
#pragma unroll
  for (int i = 0; i < kMaxDm; ++i) r[i] = i < d ? y[i] : 0.f;
#pragma unroll
  for (int k = 0; k < kMaxDm; ++k) {
    if (k < d) {
      float s = r[k];
#pragma unroll
      for (int i = 0; i < k; ++i) s -= D[k * dm + i] * r[i];
      r[k] = div_rn(s, D[k * dm + k]);
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxDm; ++i)
    if (i < d) y[i] = r[i];
}

__device__ __forceinline__ void solve_root_rhs(const float* F, float* X,
                                               const ArrowPart& p) {
  const int r = threadIdx.x;
  if (r >= p.nr) return;
  const int dm = p.dm, rowlen = (dm + p.nr) * dm;
  float s = X[r];
  for (int l = 0; l < p.nl; ++l) {
    const float* LB = F + l * rowlen + dm * dm;
    const float* y = X + p.lo[l];
    const int d = p.d[l];
#pragma unroll
    for (int k = 0; k < kMaxDm; ++k)
      if (k < d) s -= LB[r * dm + k] * y[k];
  }
  X[r] = s;
}

__device__ __forceinline__ void solve_root(const float* F, float* X,
                                           const ArrowPart& p) {
  if (threadIdx.x != 0) return;
  const int dm = p.dm, nr = p.nr;
  const float* LR = F + p.nl * (dm + nr) * dm;
  float r[kMaxNr];
#pragma unroll
  for (int i = 0; i < kMaxNr; ++i) r[i] = i < nr ? X[i] : 0.f;
#pragma unroll
  for (int k = 0; k < kMaxNr; ++k) {
    if (k < nr) {
      float s = r[k];
#pragma unroll
      for (int i = 0; i < k; ++i) s -= LR[k * dm + i] * r[i];
      r[k] = div_rn(s, LR[k * dm + k]);
    }
  }
#pragma unroll
  for (int k = kMaxNr - 1; k >= 0; --k) {
    if (k < nr) {
      float s = r[k];
#pragma unroll
      for (int i = k + 1; i < kMaxNr; ++i)
        if (i < nr) s -= LR[i * dm + k] * r[i];
      r[k] = div_rn(s, LR[k * dm + k]);
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxNr; ++i)
    if (i < nr) X[i] = r[i];
}

// The back substitution with a half-warp a limb (the first kNW warps, two
// limbs a warp side by side), lane i taking row i of its limb: its border
// terms, then column i's entries below the diagonal in registers; at step
// k (from the last row up) lane k subtracts D[j][k] r_j for j = k + 1, ...
// in increasing j and divides, and a shuffle passes r_k to the other
// lanes. The same terms in the same order as solve_packed's thread a limb.
template <int kNW>
__device__ __forceinline__ void solve_lanes_back(const float* F, float* X,
                                                 const ArrowPart& p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = lane & 15, base = lane & 16;
  const int dm = p.dm, nr = p.nr, rowlen = (dm + nr) * dm;
  float root[kMaxNr];
#pragma unroll
  for (int r = 0; r < kMaxNr; ++r) root[r] = r < nr ? X[r] : 0.f;
  for (int b0 = 2 * warp; b0 < p.nl; b0 += 2 * kNW) {
    const int l = b0 + (base >> 4);
    const int d = l < p.nl ? p.d[l] : 0;
    const int d0 = p.d[b0], d1 = b0 + 1 < p.nl ? p.d[b0 + 1] : 0;
    const int dw = d0 > d1 ? d0 : d1;  // the warp's longer limb
    const float* D = F + (l < p.nl ? l : b0) * rowlen;
    float* y = X + (l < p.nl ? p.lo[l] : 0);
    const bool in = i < d;
    float s = 0.f;
    if (in) {
      s = y[i];
#pragma unroll
      for (int r = 0; r < kMaxNr; ++r)
        if (r < nr) s -= D[(dm + r) * dm + i] * root[r];
    }
    float col[kMaxDm], rr[kMaxDm];
#pragma unroll
    for (int j = 0; j < kMaxDm; ++j) {
      col[j] = in && j >= i && j < d ? D[j * dm + i] : 0.f;
      rr[j] = 0.f;
    }
    float mine = 0.f;
#pragma unroll
    for (int k = kMaxDm - 1; k >= 0; --k) {
      if (k < dw) {
        float rk = 0.f;
        if (i == k && in) {
          float t = s;
#pragma unroll
          for (int j = k + 1; j < kMaxDm; ++j)
            if (j < d) t -= col[j] * rr[j];
          rk = div_rn(t, col[k]);
        }
        rk = __shfl_sync(0xffffffffu, rk, base + k);
        rr[k] = rk;
        if (i == k) mine = rk;
      }
    }
    __syncwarp();
    if (in) y[i] = mine;
  }
}

// Ci = LC^-1, stored transposed (CiT[c][i] = Ci[i][c], row stride ldt, a
// multiple of 4; zeros for i < c), column c on lane c of the calling
// warp: entry (i, c) is (e_c[i] - sum over k = c .. i - 1 of LC[i][k]
// Ci[k][c]) / LC[i][i], the terms in increasing k (the first form's
// recurrence). Every lane runs the same instructions: the terms k < c
// multiply a zero LC entry (selected) by the column's stored zero, which
// leaves the sum (+0 or 1 until k reaches c) as it is. With SB3 a multiple
// of 4, LC's row and the lane's column come in by 16-byte loads.
__device__ __forceinline__ void ci_columns(const float* C, float* CiT, int SB3,
                                           int ldt) {
  const int c = threadIdx.x & 31;
  float* mine = CiT + (c < SB3 ? c : SB3 - 1) * ldt;
  const bool vec = (SB3 & 3) == 0;
#pragma unroll 1
  for (int i = 0; i < SB3; ++i) {
    const float* Crow = C + i * SB3;
    float sc = i == c ? 1.f : 0.f;
    int k = 0;
    if (vec) {
#pragma unroll 1
      for (; k + 4 <= i; k += 4) {
        const float4 cr = *reinterpret_cast<const float4*>(Crow + k);
        const float4 cm = *reinterpret_cast<const float4*>(mine + k);
        sc -= (k >= c ? cr.x : 0.f) * cm.x;
        sc -= (k + 1 >= c ? cr.y : 0.f) * cm.y;
        sc -= (k + 2 >= c ? cr.z : 0.f) * cm.z;
        sc -= (k + 3 >= c ? cr.w : 0.f) * cm.w;
      }
    }
#pragma unroll 1
    for (; k < i; ++k) sc -= (k >= c ? Crow[k] : 0.f) * mine[k];
    const float v = div_rn(sc, Crow[i]);
    if (c < SB3) mine[i] = i >= c ? v : 0.f;
  }
}

// The slope and curvature of the line search at `at` on one warp, the sums
// as ls_alpha_warp forms them: every lane its live rows (bit q of `live`:
// row lane + 32 q; the rows past 32 q all), then its slots, the ones in
// registers (cs) behind `opaque`, then the butterflies.
template <int kSlots>
__device__ __forceinline__ void ls_eval(const LsRows& r, const LsCon* cs,
                                        unsigned live, int nmax, float sm0,
                                        float smm, float at, float* slope,
                                        float* curv) {
  const int lane = threadIdx.x & 31, L = r.L, K = r.K;
  float s = 0.f, c = 0.f;
  unsigned mk = live;
#pragma unroll 1
  for (int n = 0; n < nmax; ++n)
    if (mk) {
      const int i = lane + 32 * (__ffs(mk) - 1);
      mk &= mk - 1;
      ls_add(ls_lim_term(ls_lim(r, i), at), s, c);
    }
#pragma unroll 1
  for (int i = lane + 32 * 32; i < L; i += 32)
    ls_add(ls_lim_term(ls_lim(r, i), at), s, c);
#pragma unroll
  for (int u = 0; u < kSlots; ++u)
    if (lane + 32 * u < K) ls_add(ls_con_term(opaque(cs[u]), at), s, c);
#pragma unroll 1
  for (int k = lane + 32 * kSlots; k < K; k += 32)
    ls_add(ls_con_term(opaque(ls_con(r, k)), at), s, c);
  s = warp_sum(s);
  c = warp_sum(c);
  *slope = sm0 + at * smm + s;
  *curv = fmaxf(smm + c, 1e-15f);
}

// The exact line search on warp 0 (every lane returns the step), as
// linesearch.cu's kernel runs it on a warp: ls_alpha_warp's points
// (kLsExpand bracket doublings from 1, then ls_iters rounds of the
// midpoint and the guarded Newton probe, then the slope at 0), one
// evaluation site for them all (ls_eval), the steps taking the
// same branches on the same values, so the step is ls_alpha_warp's bit
// for bit. The lane's contact slots k < 64 keep their cone constants in
// registers (LsCon), the others are recomputed at each evaluation; its
// limit rows i = lane + 32 q, q < 32, are kept in a mask unless
// ls_row_dead.
__device__ __forceinline__ float reuse_line_search(const LsRows& r, float sm0,
                                                   float smm, int ls_iters) {
  constexpr int kSlots = 2;
  const int lane = threadIdx.x & 31, L = r.L, K = r.K;
  LsCon cs[kSlots];
#pragma unroll
  for (int u = 0; u < kSlots; ++u)
    if (lane + 32 * u < K) cs[u] = ls_con(r, lane + 32 * u);
  const float amax = ldexpf(1.f, kLsExpand);
  unsigned live = 0;
  for (int q = 0; q < 32; ++q) {
    const int i = lane + 32 * q;
    if (i < L && !ls_row_dead(r.jl[i], r.vl[i], r.al[i], r.Dl[i], amax))
      live |= 1u << q;
  }
  const int nmax = __reduce_max_sync(0xffffffffu, __popc(live));
  const int n_eval = kLsExpand + 2 * ls_iters + 1;
  float hi = 1.f, lo = 0.f, mid = 0.f, s = 0.f, c = 0.f, alpha = 0.f;
#pragma unroll 1
  for (int q = 0; q < n_eval; ++q) {
    const int rr = q - kLsExpand;
    float at;
    if (rr < 0)
      at = hi;
    else if (q == n_eval - 1)
      at = 0.f;
    else if ((rr & 1) == 0)
      at = mid = 0.5f * (lo + hi);
    else {
      const float cand = mid - s / c;
      at = (cand > lo && cand < hi) ? cand : mid;
    }
    float sl, cv;
    ls_eval<kSlots>(r, cs, live, nmax, sm0, smm, at, &sl, &cv);
    if (rr < 0) {
      if (sl < 0.f) hi *= 2.f;
    } else if (q == n_eval - 1) {
      alpha = sl < 0.f ? 0.5f * (lo + hi) : 0.f;
    } else if ((rr & 1) == 0) {
      s = sl, c = cv;
    } else if (sl < 0.f) {
      lo = at;
    } else {
      hi = at;
    }
  }
  return alpha;
}

// Phase i of the kPre solving warps ends (clock instantiation): they
// synchronise and thread 0 adds the cycles since the last mark.
#define PRE_PHASE(i)                    \
  do {                                  \
    if constexpr (kClock) {             \
      pre_sync();                       \
      if (t == 0) {                     \
        const long long c_ = clock64(); \
        ph[i] += c_ - c_last;           \
        c_last = c_;                    \
      }                                 \
    }                                   \
  } while (0)

// Kernel 10: persistent blocks of kThreads, each walking envs e =
// blockIdx.x, + gridDim.x, ...; the phases' clocks (kClock) as
// newton_kernel's marks name them (ops/newton_fused.PHASES). Ci's are the
// last warp's, taken while the others run the first iteration's J^T f and
// substitution, in the block's first env; a later env's masks, lists and
// Ci fall in the line search of the env before.
template <bool kClock>
__global__ void __launch_bounds__(kThreads, 4)
    newton_reuse_kernel(const __grid_constant__ NewtonArgs a) {
  extern __shared__ __align__(16) float sm[];
  const ArrowPart& p = a.p;
  const int nv = p.nv, nl = p.nl, K = a.K, L = a.L, SB3 = a.SB3;
  const int R3 = 3 * K;
  const Layout& o = a.o;
  const int msize = (nl + 1) * (p.dm + p.nr) * p.dm;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);  // factor, state

  float *A = sm + o.A, *Ut = sm + o.Ut, *Zs = sm + o.Zg, *C = sm + o.LC;
  float *x = sm + o.x, *msm = sm + o.msm, *jl = sm + o.jl;
  float *al = sm + o.lp, *Dl = sm + o.lp + L;
  const float* cp = sm + o.cp;
  const float *mu = cp, *fric = cp + K, *act = cp + 2 * K, *D = cp + 3 * K;
  float *Ci = sm + o.Ci, *wu = sm + o.wu, *wv = sm + o.wv;
  float *g = sm + o.g, *dx = sm + o.dx, *mdx = sm + o.mdx;
  float *vl = sm + o.vl, *fl = sm + o.fl, *fc = sm + o.fc, *red = sm + o.red;
  float* pl = sm + o.pl;
  float *N = pl, *Y1 = pl + K, *Y2 = pl + 2 * K;
  float *V0 = pl + 3 * K, *V1 = pl + 4 * K, *V2 = pl + 5 * K;
  int* ldof = reinterpret_cast<int*>(sm + o.ldof);
  float* lsign = sm + o.lsign;
  int* dlim = reinterpret_cast<int*>(sm + o.dlim);
  int* vbit = reinterpret_cast<int*>(sm + o.vbit);
  int* lord = reinterpret_cast<int*>(sm + o.lord);
  unsigned* mask = reinterpret_cast<unsigned*>(sm + o.mask);
  int* list = reinterpret_cast<int*>(sm + o.list);
  int* cnt = reinterpret_cast<int*>(sm + o.cnt);
  long long* ci_clock = reinterpret_cast<long long*>(red + 4);
  const int ldc = o.ldz;
  const size_t mstride = a.dense_m ? (size_t)nv * nv : (size_t)msize;

  LsRows rows;
  rows.jl = jl, rows.vl = vl, rows.al = al, rows.Dl = Dl;
  rows.n0 = N, rows.t10 = Y1, rows.t20 = Y2;
  rows.v0 = V0, rows.v1 = V1, rows.v2 = V2;
  rows.mu = mu, rows.fric = fric, rows.act = act, rows.D = D;
  rows.L = L, rows.K = K;

  // ---- Once a block: the tables, the barriers, the first env's slabs.
  for (int i = t; i < L; i += kThreads) {
    ldof[i] = a.lim.dof[i];
    lsign[i] = a.lim.sign[i];
  }
  for (int i = t; i < 2 * nv; i += kThreads) dlim[i] = a.lim.dof_lim[i];
  for (int v = t; v < nv; v += kThreads) {
    int l = 0;
    while (l + 1 < nl && p.lo[l + 1] <= v) ++l;
    vbit[v] = v < p.nr ? kRootBit : l;
  }
  if (t == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    for (int i = 0; i < nl; ++i) {  // limbs by decreasing size, stable
      int j = i;
      for (; j > 0 && p.d[lord[j - 1]] < p.d[i]; --j) lord[j] = lord[j - 1];
      lord[j] = i;
    }
  }
  __syncthreads();
  if (t == 0) {
    stage_factor(a, o, sm, bars, blockIdx.x);
    stage_state(a, o, sm, bars + 1, blockIdx.x);
  }

  // Whether the env's masks, lists and Ci were formed during the search of
  // the block's env before.
  bool prepped = false;
  int round = 0;
  for (int e = blockIdx.x; e < a.B; e += gridDim.x, ++round) {
    const int next = e + (int)gridDim.x;
    long long ph[kPhases], c_last = 0;
    if constexpr (kClock) {
      for (int i = 0; i < kPhases; ++i) ph[i] = 0;
      c_last = clock64();
    }
    const float* Je = a.J + (size_t)e * R3 * nv;
    const float* Me = a.M + (size_t)e * mstride;
    const bool was_prepped = prepped;
    mbar_wait(bars + 1, round & 1);

    // ---- The contact-limb mask and lists; the Newton state's planes.
    const float* jc = sm + o.jc;
    for (int q = t; q < R3; q += kThreads) pl[(q % 3) * K + q / 3] = jc[q];
    if (!prepped) {
      contact_masks<false>(Je, K, nv, vbit, mask, nullptr, nullptr, nullptr,
                           nullptr);
      __syncthreads();
      contact_lists(mask, K, nl, list, cnt);
    }
    mbar_wait(bars, round & 1);
    __syncthreads();
    if (a.n_iters == 0 && t == 0 && next < a.B)
      stage_factor(a, o, sm, bars, next);
    PHASE(0);

    // ---- Newton iterations on the fixed factor.
    for (int it = 0; it < a.n_iters; ++it) {
      if (warp < kPre) {
        // Forces, gradient and t = A^-1 g on the kPre warps.
        for (int i = t; i < L; i += kPreThreads)
          fl[i] = jl[i] < 0.f ? -Dl[i] * jl[i] * al[i] : 0.f;
        for (int k = t; k < K; k += kPreThreads) {
          float r[3];
          cone_residual3(N[k], Y1[k], Y2[k], mu[k], fric[k], r);
          const float Da = D[k] * act[k];
          fc[3 * k] = -Da * r[0];
          fc[3 * k + 1] = -Da * r[1];
          fc[3 * k + 2] = -Da * r[2];
        }
        pre_sync();
        jt_times<kPreThreads>(Je, fc, list, cnt, vbit, K, p, g);
        pre_sync();
        for (int v = t; v < nv; v += kPreThreads)
          g[v] = (msm[v] - lim_scatter(dlim, fl, lsign, v)) - g[v];
        PRE_PHASE(7);
        pre_sync();
        solve_forward(A, g, p);  // g <- t = A^-1 g
        pre_sync();
        solve_root_rhs(A, g, p);
        pre_sync();
        solve_root(A, g, p);
        pre_sync();
        solve_lanes_back<kPre>(A, g, p);
      } else if (it == 0 && !prepped) {
        // ---- Ci = LC^-1 (the capacitance factor's inverse) meanwhile.
        long long c0 = 0;
        if constexpr (kClock) c0 = clock64();
        ci_columns(C, Ci, SB3, ldc);
        if constexpr (kClock) {
          __syncwarp();
          if (lane == 0) *ci_clock = clock64() - c0;
        }
      }
      __syncthreads();
      PHASE(8);
      // wu = U t: a warp a group of rows, the rows' butterflies together.
      constexpr int kWg = (kMaxSB3 + kWarps - 1) / kWarps;
      {
        float sw[kWg];
#pragma unroll
        for (int u = 0; u < kWg; ++u) sw[u] = 0.f;
        const int r0 = warp * kWg;
        for (int v = lane; v < nv; v += 32) {
          const float tv = g[v];
#pragma unroll
          for (int u = 0; u < kWg; ++u)
            if (r0 + u < SB3) sw[u] += Ut[(r0 + u) * nv + v] * tv;
        }
#pragma unroll
        for (int u = 0; u < kWg; ++u) {
          if (r0 + u < SB3) {  // the same for the warp's lanes
            sw[u] = warp_sum(sw[u]);
            if (lane == 0) wu[r0 + u] = sw[u];
          }
        }
      }
      __syncthreads();
      if (warp == 0) {  // wu <- Ci^T (Ci wu), the capacitance solve
        // wv = Ci wu: lane r sums Ci[r][j] wu[j], j = 0 .. r.
        float sw = 0.f;
        if (lane < SB3) {
#pragma unroll 4
          for (int j = 0; j <= lane; ++j) sw += Ci[j * ldc + lane] * wu[j];
        }
        __syncwarp();
        if (lane < SB3) wv[lane] = sw;
        __syncwarp();
        // wu = Ci^T wv: lane r sums Ci[j][r] wv[j], j = r .. SB3 - 1, its
        // row of Ci^T by 16-byte loads past the first multiple of 4.
        sw = 0.f;
        if (lane < SB3) {
          const float* row = Ci + lane * ldc;
          int j = lane;
          if ((SB3 & 3) == 0) {
            for (; j & 3; ++j) sw += row[j] * wv[j];
            for (; j < SB3; j += 4) {
              const float4 q = *reinterpret_cast<const float4*>(row + j);
              const float4 w = *reinterpret_cast<const float4*>(wv + j);
              sw += q.x * w.x;
              sw += q.y * w.y;
              sw += q.z * w.z;
              sw += q.w * w.w;
            }
          }
          for (; j < SB3; ++j) sw += row[j] * wv[j];
        }
        __syncwarp();
        if (lane < SB3) wu[lane] = sw;
      }
      __syncthreads();
      // dx = -(t - Z wu): a thread a dof, its row of Z by 16-byte loads.
      for (int v = t; v < nv; v += kThreads) {
        const float* z = Zs + v * SB3;
        float sw = 0.f;
        if ((SB3 & 3) == 0) {
          for (int r = 0; r < SB3; r += 4) {
            const float4 q = *reinterpret_cast<const float4*>(z + r);
            sw += q.x * wu[r];
            sw += q.y * wu[r + 1];
            sw += q.z * wu[r + 2];
            sw += q.w * wu[r + 3];
          }
        } else {
          for (int r = 0; r < SB3; ++r) sw += z[r] * wu[r];
        }
        dx[v] = -(g[v] - sw);
      }
      __syncthreads();
      PHASE(9);
      if (a.dense_m)
        dense_matvec_rows<kRowGroup, kMvCols>(Me, dx, mdx, nv);
      else
        arrow_matvec(Me, dx, mdx, p);
      __syncthreads();
      PHASE(10);
      j_times_slots<kJSlots, kJCols>(Je, dx, mask, vbit, K, nv, V0);
      for (int i = t; i < L; i += kThreads) vl[i] = dx[ldof[i]] * lsign[i];
      if (warp == kWarps - 1) {  // msm . dx, dx . M dx
        float s0 = 0.f, s1 = 0.f;
        for (int v = lane; v < nv; v += 32) {
          s0 += msm[v] * dx[v];
          s1 += dx[v] * mdx[v];
        }
        s0 = warp_sum(s0), s1 = warp_sum(s1);
        if (lane == 0) red[0] = s0, red[1] = s1;
      }
      __syncthreads();
      PHASE(11);
      // After the last iteration's J dx this env reads its factor slabs,
      // masks, lists and Ci no more: while warp 0 runs the search, the last
      // warp asks for the block's next env's factor slabs and forms its
      // Ci once they are in, and warps 1 .. kWarps - 2 its masks and
      // lists.
      const bool last = it == a.n_iters - 1 && next < a.B;
      if (last && t == kPreThreads) stage_factor(a, o, sm, bars, next);
      if (warp == 0) {
        const float step = reuse_line_search(rows, red[0], red[1], a.ls_iters);
        if (lane == 0) red[2] = step;
      } else if (last) {
        if (warp < kWarps - 1) {
          contact_masks<false, 1, kWarps - 2>(a.J + (size_t)next * R3 * nv,
                                              K, nv, vbit, mask, nullptr,
                                              nullptr, nullptr, nullptr);
          asm volatile("bar.sync 2, %0;" ::"r"(32 * (kWarps - 2)) : "memory");
          contact_lists<1, kWarps - 2>(mask, K, nl, list, cnt);
        } else {
          mbar_wait(bars, (round + 1) & 1);
          ci_columns(C, Ci, SB3, ldc);
        }
      }
      __syncthreads();
      const float alpha = red[2];
      PHASE(12);
      for (int v = t; v < nv; v += kThreads) {
        x[v] += alpha * dx[v];
        msm[v] += alpha * mdx[v];
      }
      for (int i = t; i < L; i += kThreads) jl[i] += alpha * vl[i];
      for (int q = t; q < R3; q += kThreads) pl[q] += alpha * pl[R3 + q];
      __syncthreads();
      PHASE(13);
    }

    prepped = a.n_iters > 0 && next < a.B;

    // ---- Outputs; then the next env's state slabs.
    for (int v = t; v < nv; v += kThreads) {
      a.o0[(size_t)e * nv + v] = x[v];
      a.o1[(size_t)e * nv + v] = msm[v];
    }
    for (int i = t; i < L; i += kThreads) a.o2[(size_t)e * L + i] = jl[i];
    for (int q = t; q < R3; q += kThreads)
      a.o3[(size_t)e * R3 + q] = pl[(q % 3) * K + q / 3];
    __syncthreads();
    if (t == 0 && next < a.B) stage_state(a, o, sm, bars + 1, next);
    PHASE(14);
    if constexpr (kClock) {
      if (t == 0 && e % a.clk_stride == 0) {
        if (a.n_iters > 0 && !was_prepped) ph[6] += *ci_clock;
        for (int i = 0; i < kPhases; ++i)
          a.clk[(size_t)(e / a.clk_stride) * kPhases + i] += ph[i];
      }
    }
  }
}

bool supported(const NewtonArgs& a) {
  const ArrowPart& p = a.p;
  return p.nl >= 1 && p.nl <= 16 && p.dm <= kMaxDm && p.nr <= kMaxNr &&
         p.dm + p.nr <= 32 && a.SB3 >= 1 && a.SB3 <= kMaxSB3 && a.B >= 1 &&
         a.K >= 1;
}


// Blocks an SM of a kernel at its shared memory, and the persistent grid
// for B envs.
template <typename Kern>
cudaError_t geometry(Kern kern, const NewtonArgs& a, size_t smem,
                     int* blocks, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (*blocks < 1) return cudaErrorInvalidConfiguration;
  *grid = a.B < *blocks * sms ? a.B : *blocks * sms;
  return cudaSuccess;
}

template <typename Kern>
int launch_as(Kern kern, const NewtonArgs& a, void* stream) {
  const size_t smem = sizeof(float) * (size_t)a.o.total;
  if (smem > 232448) return -1;  // Hopper's shared memory per block
  int blocks = 0, grid = 0;
  const cudaError_t err = geometry(kern, a, smem, &blocks, &grid);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The layout of a mode's kernel (kernel 10's own, the template's else).
inline Layout mode_layout(const NewtonArgs& a, int mode) {
  return mode == kReuse ? reuse_layout(a.K, a.SB3, a.L, a.p)
                        : newton_layout(a.K, a.SB3, a.L, a.p, mode);
}

template <int kMode>
int launch(NewtonArgs a, void* stream) {
  if (!supported(a)) return -1;
  a.o = mode_layout(a, kMode);
  const bool clock = g_clk != nullptr;
  if (clock) a.clk = g_clk, a.clk_stride = g_clk_stride;
  if constexpr (kMode == kReuse)
    return clock ? launch_as(newton_reuse_kernel<true>, a, stream)
                 : launch_as(newton_reuse_kernel<false>, a, stream);
  else
    return clock ? launch_as(newton_kernel<kMode, true>, a, stream)
                 : launch_as(newton_kernel<kMode, false>, a, stream);
}

// Registers a thread, shared memory a block (bytes), blocks an SM and the
// persistent grid of one mode's main instantiation for B envs.
template <typename Kern>
int info_of(Kern kern, const NewtonArgs& a, int mode, int* out) {
  if (!supported(a)) return -1;
  const size_t smem = sizeof(float) * (size_t)mode_layout(a, mode).total;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0, grid = 0;
  err = geometry(kern, a, smem, &blocks, &grid);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs, out[1] = (int)smem, out[2] = blocks, out[3] = grid;
  return 0;
}

}  // namespace

FB_API int newton_block_f32(const float* Hp, const float* M, const float* J,
                            const float* U, const float* x, const float* msm,
                            const float* jar_l, const float* jar_c,
                            const float* lim_params, const float* con_params,
                            float* x_o, float* msm_o, float* jl_o, float* jc_o,
                            int B, int K, int SB3, int L, const int* lim_dof,
                            const float* lim_sign, const int* dof_lim,
                            int ls_iters, int n_iters, const ArrowPart* part,
                            void* stream) {
  NewtonArgs a{};
  a.Hp = Hp, a.M = M, a.J = J, a.U = U, a.bsel = nullptr;
  a.x = x, a.msm = msm, a.jar_l = jar_l, a.jar_c = jar_c;
  a.lim_params = lim_params, a.con_params = con_params;
  a.o0 = x_o, a.o1 = msm_o, a.o2 = jl_o, a.o3 = jc_o;
  a.lim = LimTables{lim_dof, lim_sign, dof_lim};
  a.p = *part;
  a.B = B, a.K = K, a.SB3 = SB3, a.L = L;
  a.ls_iters = ls_iters, a.n_iters = n_iters;
  return launch<kBlock>(a, stream);
}

FB_API int newton_block_full_f32(
    const float* Mp, const float* J, const int* bsel, const float* x,
    const float* msm, const float* jar_l, const float* jar_c,
    const float* lim_params, const float* con_params5, float* x_o,
    float* msm_o, float* jl_o, float* jc_o, int B, int K, int SB, int L,
    const int* lim_dof, const float* lim_sign, const int* dof_lim,
    int ls_iters, int n_iters, const ArrowPart* part, void* stream) {
  NewtonArgs a{};
  a.Hp = nullptr, a.M = Mp, a.J = J, a.U = nullptr, a.bsel = bsel;
  a.x = x, a.msm = msm, a.jar_l = jar_l, a.jar_c = jar_c;
  a.lim_params = lim_params, a.con_params = con_params5;
  a.o0 = x_o, a.o1 = msm_o, a.o2 = jl_o, a.o3 = jc_o;
  a.lim = LimTables{lim_dof, lim_sign, dof_lim};
  a.p = *part;
  a.B = B, a.K = K, a.SB3 = 3 * SB, a.L = L;
  a.ls_iters = ls_iters, a.n_iters = n_iters;
  return launch<kBlockFull>(a, stream);
}

FB_API int newton_solve_f32(const float* Mp, const float* J, const int* bsel,
                            const float* a_free, const float* ws,
                            const float* lim_aref, const float* con_aref,
                            const float* lim_params, const float* con_params5,
                            float* qacc, float* qfrc, float* f_l, float* f_c,
                            int B, int K, int SB, int L, const int* lim_dof,
                            const float* lim_sign, const int* dof_lim,
                            int ls_iters, int n_iters, const ArrowPart* part,
                            void* stream) {
  NewtonArgs a{};
  a.Hp = nullptr, a.M = Mp, a.J = J, a.U = nullptr, a.bsel = bsel;
  a.x = a_free, a.msm = ws, a.jar_l = lim_aref, a.jar_c = con_aref;
  a.lim_params = lim_params, a.con_params = con_params5;
  a.o0 = qacc, a.o1 = qfrc, a.o2 = f_l, a.o3 = f_c;
  a.lim = LimTables{lim_dof, lim_sign, dof_lim};
  a.p = *part;
  a.B = B, a.K = K, a.SB3 = 3 * SB, a.L = L;
  a.ls_iters = ls_iters, a.n_iters = n_iters;
  return launch<kWhole>(a, stream);
}

// Kernel 10: M dense (B, nv, nv) when dense_m, else packed (B, msize).
FB_API int newton_reuse_f32(const float* F, const float* M, const float* J,
                            const float* Z, const float* U, const float* LC,
                            const float* x, const float* msm,
                            const float* jar_l, const float* jar_c,
                            const float* lim_params, const float* con_params,
                            float* x_o, float* msm_o, float* jl_o, float* jc_o,
                            int B, int K, int SB3, int L, int dense_m,
                            const int* lim_dof, const float* lim_sign,
                            const int* dof_lim, int ls_iters, int n_iters,
                            const ArrowPart* part, void* stream) {
  NewtonArgs a{};
  a.Hp = F, a.M = M, a.J = J, a.U = U, a.Zg = Z, a.LC = LC, a.bsel = nullptr;
  a.x = x, a.msm = msm, a.jar_l = jar_l, a.jar_c = jar_c;
  a.lim_params = lim_params, a.con_params = con_params;
  a.o0 = x_o, a.o1 = msm_o, a.o2 = jl_o, a.o3 = jc_o;
  a.lim = LimTables{lim_dof, lim_sign, dof_lim};
  a.p = *part;
  a.B = B, a.K = K, a.SB3 = SB3, a.L = L;
  a.ls_iters = ls_iters, a.n_iters = n_iters;
  a.dense_m = dense_m;
  return launch<kReuse>(a, stream);
}

// Phase clocks: while clk is set, every launch runs the clock instantiation
// and adds the cycles of each phase of every stride-th env to clk
// ((ceil(B / stride), kPhases) int64); nullptr turns it off.
FB_API int newton_phase_clock(long long* clk, int stride) {
  if (stride < 1) return -1;
  g_clk = clk, g_clk_stride = stride;
  return 0;
}

// Resources of mode (0 block, 1 whole, 2 reuse, 3 block full) at these
// widths: out = registers a thread, shared bytes a block, blocks an SM,
// grid blocks for B envs.
FB_API int newton_info(int mode, int B, int K, int SB3, int L,
                       const ArrowPart* part, int* out) {
  NewtonArgs a{};
  a.p = *part;
  a.B = B, a.K = K, a.SB3 = SB3, a.L = L;
  switch (mode) {
    case kBlock: return info_of(newton_kernel<kBlock, false>, a, mode, out);
    case kWhole: return info_of(newton_kernel<kWhole, false>, a, mode, out);
    case kReuse: return info_of(newton_reuse_kernel<false>, a, mode, out);
    case kBlockFull:
      return info_of(newton_kernel<kBlockFull, false>, a, mode, out);
  }
  return -1;
}
