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
// One template holds the four; the prologues (and the whole solve's
// epilogue) are the only difference, and they share one iteration body.
//
// What bounds them: bytes. Per env the block kernel reads Hp, M (14.6 KB
// each), J (3K x nv: 83 KB at K = 64), U (10 KB at SB = 8) and the state
// (~131 KB in all) for ~0.3 MFLOP; the reuse kernel reads F (14.6 KB), a
// dense M (46.7 KB), J (41.5 KB at K = 32), Z and U (20.7 KB at SB = 8) and
// LC (~124 KB in all). Design: one block of 128 threads per env. The packed matrices, U, Z, the capacitance factor, the carried
// state and the line search's planes live in shared memory; J is read
// from global memory (coalesced over dofs for J^T f, one warp per row for
// J dx), so the block kernel fits three blocks on an SM at K = 64; the
// reuse kernel keeps F, Z, U and the inverse of LC in shared memory and
// reads a dense M from global memory (L2), a row per warp. The
// whole-solve kernel stages J and J W (31 KB each at K = 24), as its
// Hessian assembly reads them ~1,250 times, and reads M from L2, so two
// of its blocks fit on an SM. The block-full kernel stages the same at the
// default preset's K = 64 (83 KB each): 215 KB in all, under the 227 KB a
// block may take, so one block an SM. The TPU kernel kept envs on
// 128 lanes and inverted the capacitance factor once so every iteration's
// two triangular solves became products; this kernel does the same with
// one thread per column. The line search is one warp's work
// (linesearch.cuh), with every lane holding the reduced sums.

#include "arrow.cuh"
#include "linesearch.cuh"

namespace {

constexpr int kThreads = 128;
enum Mode { kBlock = 0, kWhole = 1, kReuse = 2, kBlockFull = 3 };
constexpr int kRows = 4;  // rows of J dx a warp takes at once

struct LimTables {
  const int* dof;      // (L) dof of each limit row
  const float* sign;   // (L) +1 lower row, -1 upper row
  const int* dof_lim;  // (nv, 2) limit rows of each dof, -1 for none
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
  int K, SB3, L, ls_iters, n_iters;
  int dense_m;  // reuse: M is dense (nv, nv)
};

// Shared-memory offsets (in floats), the same on host and device.
struct Layout {
  int A, Mm, Ut, Z, C, Ci, wu, wv;
  int x, msm, g, dx, mdx;
  int jl, vl, al, Dl, fl;
  int pl;  // 10 planes of K: N, y1, y2, v0, v1, v2, mu, fric, act, D
  int fc, red, ldof, lsign, dlim;
  int J, JH, W, G, hact;  // whole solve and block full only
  int aw, arl, arc;       // whole solve only
  int total;
};

__host__ __device__ inline Layout newton_layout(int K, int SB3, int L, int nv,
                                                int msize, int mode,
                                                bool dense_m) {
  const bool whole = mode == kWhole;
  const bool assemble = whole || mode == kBlockFull;
  Layout o;
  int n = 0;
  auto take = [&n](int c) {
    const int at = n;
    n += (c + 3) & ~3;
    return at;
  };
  o.A = take(msize);
  // The assembling modes read M from L2, the reuse iterations a dense M.
  o.Mm = assemble || dense_m ? 0 : take(msize);
  o.Ut = take(SB3 * nv);
  o.Z = take(SB3 * nv);
  o.C = take(SB3 * SB3);
  o.Ci = take(SB3 * SB3);
  o.wu = take(SB3);
  o.wv = take(SB3);
  o.x = take(nv);
  o.msm = take(nv);
  o.g = take(nv);
  o.dx = take(nv);
  o.mdx = take(nv);
  o.jl = take(L);
  o.vl = take(L);
  o.al = take(L);
  o.Dl = take(L);
  o.fl = take(L);
  o.pl = take(10 * K);
  o.fc = take(3 * K);
  o.red = take(32);
  o.ldof = take(L);
  o.lsign = take(L);
  o.dlim = take(2 * nv);
  o.J = o.JH = o.W = o.G = o.aw = o.arl = o.arc = o.hact = 0;
  if (assemble) {
    o.J = take(3 * K * nv);
    o.JH = take(3 * K * nv);
    o.W = take(6 * K);
    o.G = take(2 * SB3);  // 6 per selected slot
    o.hact = take(K);
  }
  if (whole) {
    o.aw = take(2 * nv);
    o.arl = take(L);
    o.arc = take(3 * K);
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

// y = M x for a dense (nv, nv) M in global memory: a warp a row, the lanes
// over its columns.
__device__ __forceinline__ void dense_matvec(const float* __restrict__ M,
                                             const float* x, float* y,
                                             int nv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = warp; i < nv; i += nw) {
    float s = 0.f;
    for (int j = lane; j < nv; j += 32) s += M[(size_t)i * nv + j] * x[j];
    s = warp_sum(s);
    if (lane == 0) y[i] = s;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) newton_kernel(NewtonArgs a) {
  constexpr bool kWholeSolve = kMode == kWhole;
  constexpr bool kAssemble = kWholeSolve || kMode == kBlockFull;
  extern __shared__ float sm[];
  const ArrowPart& p = a.p;
  const int nv = p.nv, K = a.K, L = a.L, SB3 = a.SB3, R3 = 3 * K;
  const int msize = (p.nl + 1) * (p.dm + p.nr) * p.dm;
  const bool dense_m = kMode == kReuse && a.dense_m;
  const Layout o = newton_layout(K, SB3, L, nv, msize, kMode, dense_m);
  const int e = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nw = nt >> 5;

  float *A = sm + o.A, *Ut = sm + o.Ut, *Z = sm + o.Z;
  float *C = sm + o.C, *Ci = sm + o.Ci, *wu = sm + o.wu, *wv = sm + o.wv;
  float *x = sm + o.x, *msm = sm + o.msm, *g = sm + o.g, *dx = sm + o.dx;
  float *mdx = sm + o.mdx, *jl = sm + o.jl, *vl = sm + o.vl;
  float *al = sm + o.al, *Dl = sm + o.Dl, *fl = sm + o.fl, *fc = sm + o.fc;
  float *red = sm + o.red;
  float* pl = sm + o.pl;
  float *N = pl, *Y1 = pl + K, *Y2 = pl + 2 * K;
  float *V0 = pl + 3 * K, *V1 = pl + 4 * K, *V2 = pl + 5 * K;
  float *mu = pl + 6 * K, *fric = pl + 7 * K, *act = pl + 8 * K;
  float* D = pl + 9 * K;
  int* ldof = reinterpret_cast<int*>(sm + o.ldof);
  float* lsign = sm + o.lsign;
  int* dlim = reinterpret_cast<int*>(sm + o.dlim);

  // ---- Load the tables, parameters and matrices of env e.
  for (int i = t; i < L; i += nt) {
    ldof[i] = a.lim.dof[i];
    lsign[i] = a.lim.sign[i];
  }
  for (int i = t; i < 2 * nv; i += nt) dlim[i] = a.lim.dof_lim[i];
  const float* lp = a.lim_params + (size_t)e * 2 * L;
  for (int i = t; i < L; i += nt) {
    al[i] = lp[i];
    Dl[i] = lp[L + i];
  }
  const int ncp = kAssemble ? 5 : 4;
  const float* cp = a.con_params + (size_t)e * ncp * K;
  for (int k = t; k < K; k += nt) {
    mu[k] = cp[k];
    fric[k] = cp[K + k];
    act[k] = cp[2 * K + k];
    D[k] = cp[3 * K + k];
  }
  // M for the products M dx: a shared copy in the block kernel; the
  // assembling modes read it from global memory (L2), which keeps the whole
  // solve's shared memory under half an SM's so that two of its blocks fit;
  // so do the reuse iterations a dense M (dense_matvec).
  const float* Me = a.M + (size_t)e * (dense_m ? nv * nv : msize);
  const float* Mm = Me;
  if (!kAssemble && !dense_m) {
    float* Ms = sm + o.Mm;
    for (int i = t; i < msize; i += nt) Ms[i] = Me[i];
    Mm = Ms;
  }
  const float* Je = a.J + (size_t)e * R3 * nv;
  const float* Jp = Je;

  if constexpr (!kAssemble) {
    const float* He = a.Hp + (size_t)e * msize;  // Hp, or reuse: F
    for (int i = t; i < msize; i += nt) A[i] = He[i];
    const float* Ue = a.U + (size_t)e * SB3 * nv;
    for (int i = t; i < SB3 * nv; i += nt) Ut[i] = Ue[i];
    if constexpr (kMode == kReuse) {
      const float* Ze = a.Zg + (size_t)e * nv * SB3;
      for (int i = t; i < SB3 * nv; i += nt) {
        const int v = i / SB3, r = i - v * SB3;
        Z[r * nv + v] = Ze[i];
      }
      const float* Ce = a.LC + (size_t)e * SB3 * SB3;
      for (int i = t; i < SB3 * SB3; i += nt) C[i] = Ce[i];
    }
    for (int v = t; v < nv; v += nt) {
      x[v] = a.x[(size_t)e * nv + v];
      msm[v] = a.msm[(size_t)e * nv + v];
    }
    for (int i = t; i < L; i += nt) jl[i] = a.jar_l[(size_t)e * L + i];
    for (int q = t; q < R3; q += nt) pl[(q % 3) * K + q / 3] = a.jar_c[(size_t)e * R3 + q];
    __syncthreads();
  } else {
    float *Js = sm + o.J, *JH = sm + o.JH, *W = sm + o.W, *G = sm + o.G;
    float* hact = sm + o.hact;
    for (int i = t; i < R3 * nv; i += nt) Js[i] = Je[i];
    for (int i = t; i < msize; i += nt) A[i] = Me[i];
    for (int k = t; k < K; k += nt) hact[k] = cp[4 * K + k];
    Jp = Js;
    if constexpr (kWholeSolve) {
      float *af = sm + o.aw, *ws = sm + o.aw + nv, *arl = sm + o.arl;
      float* arc = sm + o.arc;
      for (int v = t; v < nv; v += nt) {
        af[v] = a.x[(size_t)e * nv + v];
        ws[v] = a.msm[(size_t)e * nv + v];
      }
      for (int i = t; i < L; i += nt) arl[i] = a.jar_l[(size_t)e * L + i];
      for (int q = t; q < R3; q += nt) arc[q] = a.jar_c[(size_t)e * R3 + q];
      __syncthreads();

      // Candidate jars: warmstart into (jl, N, Y1, Y2), a_free into
      // (vl, V0, V1, V2); dx = ws - a_free.
      for (int i = t; i < L; i += nt) {
        jl[i] = ws[ldof[i]] * lsign[i] - arl[i];
        vl[i] = af[ldof[i]] * lsign[i] - arl[i];
      }
      for (int r = warp; r < R3; r += nw) {
        float sw = 0.f, sa = 0.f;
        for (int v = lane; v < nv; v += 32) {
          sw += Js[r * nv + v] * ws[v];
          sa += Js[r * nv + v] * af[v];
        }
        sw = warp_sum(sw);
        sa = warp_sum(sa);
        if (lane == 0) {
          const int k = r / 3, c = r % 3;
          pl[c * K + k] = sw - arc[r];
          pl[(3 + c) * K + k] = sa - arc[r];
        }
      }
      for (int v = t; v < nv; v += nt) dx[v] = ws[v] - af[v];
      __syncthreads();
      arrow_matvec(Mm, dx, mdx, p);
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
      for (int v = t; v < nv; v += nt) {
        x[v] = use_ws ? ws[v] : af[v];
        msm[v] = use_ws ? mdx[v] : 0.f;
      }
      if (!use_ws) {
        for (int i = t; i < L; i += nt) jl[i] = vl[i];
        for (int q = t; q < R3; q += nt) pl[q] = pl[R3 + q];
      }
      __syncthreads();
    } else {  // block full: the carried state
      for (int v = t; v < nv; v += nt) {
        x[v] = a.x[(size_t)e * nv + v];
        msm[v] = a.msm[(size_t)e * nv + v];
      }
      for (int i = t; i < L; i += nt) jl[i] = a.jar_l[(size_t)e * L + i];
      for (int q = t; q < R3; q += nt)
        pl[(q % 3) * K + q / 3] = a.jar_c[(size_t)e * R3 + q];
      __syncthreads();
    }

    // Hessian: W_k = D_k * cone Hessian (hess-active rows), J W, the limit
    // diagonal (in g) and the lower packed entries of M + J^T W J + diag.
    for (int k = t; k < K; k += nt) {
      cone_hessian6(N[k], Y1[k], Y2[k], mu[k], fric[k], hact[k], W + 6 * k);
      for (int i = 0; i < 6; ++i) W[6 * k + i] *= D[k];
    }
    for (int v = t; v < nv; v += nt) {
      float s = 0.f;
      for (int j = 0; j < 2; ++j) {
        const int i = dlim[2 * v + j];
        if (i >= 0) s += Dl[i] * (jl[i] < 0.f ? al[i] : 0.f);
      }
      g[v] = s + 1e-12f;
    }
    __syncthreads();
    for (int q = t; q < R3 * nv; q += nt) {
      const int r = q / nv, v = q - r * nv;
      const int k = r / 3, c = r % 3;
      const float* w = W + 6 * k;
      // row c of the symmetric block: (00 01 02 | 01 11 12 | 02 12 22)
      const float w0 = c == 0 ? w[0] : (c == 1 ? w[1] : w[2]);
      const float w1 = c == 0 ? w[1] : (c == 1 ? w[3] : w[4]);
      const float w2 = c == 0 ? w[2] : (c == 1 ? w[4] : w[5]);
      JH[q] = w0 * Js[(3 * k) * nv + v] + w1 * Js[(3 * k + 1) * nv + v] +
              w2 * Js[(3 * k + 2) * nv + v];
    }
    __syncthreads();
    const int dm = p.dm, nr = p.nr, rowlen = (dm + nr) * dm;
    for (int q = t; q < msize; q += nt) {
      const int blk = q / rowlen, rem = q - blk * rowlen;
      const int row = rem / dm, col = rem - row * dm;
      int vi = -1, vj = -1;
      if (blk < p.nl) {
        const int d = p.d[blk], lo = p.lo[blk];
        if (row < dm) {
          if (row < d && col <= row) vi = lo + row, vj = lo + col;
        } else if (col < d) {
          vi = row - dm, vj = lo + col;
        }
      } else if (row < nr && col <= row) {
        vi = row, vj = col;
      }
      if (vi >= 0) {
        float s = 0.f;
        for (int r = 0; r < R3; ++r) s += Js[r * nv + vi] * JH[r * nv + vj];
        float h = Me[q] + s;
        if (vi == vj) h += g[vi];
        A[q] = h;
      }
    }
    // Woodbury rows of the selected cross-limb slots: U = G^T V.
    const int SB = SB3 / 3;
    const int* bs = a.bsel + (size_t)e * SB;
    for (int s = t; s < SB; s += nt) {
      const int k = bs[s];
      float w6[6];
      cone_hessian6(N[k], Y1[k], Y2[k], mu[k], fric[k], act[k] - hact[k], w6);
      for (int i = 0; i < 6; ++i) w6[i] *= D[k];
      chol3(w6, G + 6 * s);
    }
    __syncthreads();
    for (int q = t; q < SB3 * nv; q += nt) {
      const int r = q / nv, v = q - r * nv;
      const int s = r / 3, c = r % 3;
      const float* gs = G + 6 * s;  // a b c d e f
      const float* j0 = Js + (3 * bs[s]) * nv;
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
  }

  // ---- Factor, Z = A^-1 U, capacitance I + U Z and its Cholesky (the
  // reuse iterations take all three as given), then its inverse.
  if constexpr (kMode != kReuse) {
    arrow_factor(A, p);
    for (int i = t; i < SB3 * nv; i += nt) Z[i] = Ut[i];
    __syncthreads();
    arrow_solve(A, Z, SB3, nv, p);
    for (int q = t; q < SB3 * SB3; q += nt) {
      const int i = q / SB3, j = q - i * SB3;
      if (j <= i) {
        float s = 0.f;
        for (int v = 0; v < nv; ++v) s += Ut[i * nv + v] * Z[j * nv + v];
        C[q] = i == j ? (1.f + s) + 1e-10f : s;
      }
    }
    __syncthreads();
    for (int k = 0; k < SB3; ++k) {
      const float inv = rsqrtf(fmaxf(C[k * SB3 + k], 1e-30f));
      __syncthreads();
      for (int i = k + t; i < SB3; i += nt) C[i * SB3 + k] *= inv;
      __syncthreads();
      const int m = SB3 - k - 1;
      for (int q = t; q < m * m; q += nt) {
        const int i = k + 1 + q / m, j = k + 1 + q % m;
        if (j <= i) C[i * SB3 + j] -= C[i * SB3 + k] * C[j * SB3 + k];
      }
      __syncthreads();
    }
  }
  for (int c = t; c < SB3; c += nt) {  // Ci = LC^-1 (lower), column c
    for (int i = c; i < SB3; ++i) {
      float s = i == c ? 1.f : 0.f;
      for (int k = c; k < i; ++k) s -= C[i * SB3 + k] * Ci[k * SB3 + c];
      Ci[i * SB3 + c] = s / C[i * SB3 + i];
    }
  }
  __syncthreads();

  LsRows rows;
  rows.jl = jl, rows.vl = vl, rows.al = al, rows.Dl = Dl;
  rows.n0 = N, rows.t10 = Y1, rows.t20 = Y2;
  rows.v0 = V0, rows.v1 = V1, rows.v2 = V2;
  rows.mu = mu, rows.fric = fric, rows.act = act, rows.D = D;
  rows.L = L, rows.K = K;

  // ---- Newton iterations on the fixed factor.
  for (int it = 0; it < a.n_iters; ++it) {
    for (int i = t; i < L; i += nt) fl[i] = jl[i] < 0.f ? -Dl[i] * jl[i] * al[i] : 0.f;
    for (int k = t; k < K; k += nt) {
      float r[3];
      cone_residual3(N[k], Y1[k], Y2[k], mu[k], fric[k], r);
      const float Da = D[k] * act[k];
      fc[3 * k] = -Da * r[0];
      fc[3 * k + 1] = -Da * r[1];
      fc[3 * k + 2] = -Da * r[2];
    }
    __syncthreads();
    for (int v = t; v < nv; v += nt) {
      float jt = 0.f;
#pragma unroll 8
      for (int r = 0; r < R3; ++r) jt += Jp[(size_t)r * nv + v] * fc[r];
      g[v] = (msm[v] - lim_scatter(dlim, fl, lsign, v)) - jt;
    }
    __syncthreads();
    arrow_solve(A, g, 1, nv, p);  // g <- t = A^-1 g
    for (int r = warp; r < SB3; r += nw) {
      float s = 0.f;
      for (int v = lane; v < nv; v += 32) s += Ut[r * nv + v] * g[v];
      s = warp_sum(s);
      if (lane == 0) wu[r] = s;
    }
    __syncthreads();
    for (int i = t; i < SB3; i += nt) {
      float s = 0.f;
      for (int j = 0; j <= i; ++j) s += Ci[i * SB3 + j] * wu[j];
      wv[i] = s;
    }
    __syncthreads();
    for (int i = t; i < SB3; i += nt) {
      float s = 0.f;
      for (int j = i; j < SB3; ++j) s += Ci[j * SB3 + i] * wv[j];
      wu[i] = s;
    }
    __syncthreads();
    for (int v = t; v < nv; v += nt) {
      float s = 0.f;
      for (int r = 0; r < SB3; ++r) s += Z[r * nv + v] * wu[r];
      dx[v] = -(g[v] - s);
    }
    __syncthreads();
    if (dense_m)
      dense_matvec(Me, dx, mdx, nv);
    else
      arrow_matvec(Mm, dx, mdx, p);
    for (int r0 = kRows * warp; r0 < R3; r0 += kRows * nw) {
      // kRows rows a warp at once, so their loads are in flight together.
      const int nu = min(kRows, R3 - r0);
      float s[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) s[u] = 0.f;
      for (int v = lane; v < nv; v += 32) {
        const float xv = dx[v];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          if (u < nu) s[u] += Jp[(size_t)(r0 + u) * nv + v] * xv;
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) s[u] = warp_sum(s[u]);
      if (lane == 0)
        for (int u = 0; u < nu; ++u)
          pl[(3 + (r0 + u) % 3) * K + (r0 + u) / 3] = s[u];
    }
    for (int i = t; i < L; i += nt) vl[i] = dx[ldof[i]] * lsign[i];
    __syncthreads();
    if (warp == 0) {
      float s0 = 0.f, s1 = 0.f;
      for (int v = lane; v < nv; v += 32) {
        s0 += msm[v] * dx[v];
        s1 += dx[v] * mdx[v];
      }
      s0 = warp_sum(s0);
      s1 = warp_sum(s1);
      const float alpha = ls_alpha_warp(rows, s0, s1, 6, a.ls_iters, lane);
      if (lane == 0) red[1] = alpha;
    }
    __syncthreads();
    const float alpha = red[1];
    for (int v = t; v < nv; v += nt) {
      x[v] += alpha * dx[v];
      msm[v] += alpha * mdx[v];
    }
    for (int i = t; i < L; i += nt) jl[i] += alpha * vl[i];
    for (int q = t; q < R3; q += nt) pl[q] += alpha * pl[R3 + q];
    __syncthreads();
  }

  // ---- Outputs.
  if constexpr (!kWholeSolve) {
    for (int v = t; v < nv; v += nt) {
      a.o0[(size_t)e * nv + v] = x[v];
      a.o1[(size_t)e * nv + v] = msm[v];
    }
    for (int i = t; i < L; i += nt) a.o2[(size_t)e * L + i] = jl[i];
    for (int q = t; q < R3; q += nt) a.o3[(size_t)e * R3 + q] = pl[(q % 3) * K + q / 3];
  } else {
    for (int i = t; i < L; i += nt) fl[i] = -Dl[i] * jl[i] * (jl[i] < 0.f ? al[i] : 0.f);
    for (int k = t; k < K; k += nt) {
      float r[3];
      cone_residual3(N[k], Y1[k], Y2[k], mu[k], fric[k], r);
      const float Da = D[k] * act[k];
      fc[3 * k] = -Da * r[0];
      fc[3 * k + 1] = -Da * r[1];
      fc[3 * k + 2] = -Da * r[2];
    }
    __syncthreads();
    for (int v = t; v < nv; v += nt) {
      float jt = 0.f;
      for (int r = 0; r < R3; ++r) jt += Jp[r * nv + v] * fc[r];
      a.o0[(size_t)e * nv + v] = x[v];
      a.o1[(size_t)e * nv + v] = lim_scatter(dlim, fl, lsign, v) + jt;
    }
    for (int i = t; i < L; i += nt) a.o2[(size_t)e * L + i] = fl[i];
    for (int q = t; q < R3; q += nt) a.o3[(size_t)e * R3 + q] = fc[q];
  }
}

template <int kMode>
int launch(const NewtonArgs& a, int B, void* stream) {
  if (a.p.nl > 16 || a.p.nl < 1 || a.SB3 < 1 || B < 1) return -1;
  const int msize = (a.p.nl + 1) * (a.p.dm + a.p.nr) * a.p.dm;
  const Layout o = newton_layout(a.K, a.SB3, a.L, a.p.nv, msize, kMode,
                                 kMode == kReuse && a.dense_m);
  const size_t smem = sizeof(float) * (size_t)o.total;
  if (smem > 232448) return -1;  // Hopper's shared memory per block
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        newton_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  newton_kernel<kMode><<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
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
  a.K = K, a.SB3 = SB3, a.L = L, a.ls_iters = ls_iters, a.n_iters = n_iters;
  return launch<kBlock>(a, B, stream);
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
  a.K = K, a.SB3 = 3 * SB, a.L = L, a.ls_iters = ls_iters, a.n_iters = n_iters;
  return launch<kBlockFull>(a, B, stream);
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
  a.K = K, a.SB3 = 3 * SB, a.L = L, a.ls_iters = ls_iters, a.n_iters = n_iters;
  return launch<kWhole>(a, B, stream);
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
  a.K = K, a.SB3 = SB3, a.L = L, a.ls_iters = ls_iters, a.n_iters = n_iters;
  a.dense_m = dense_m;
  return launch<kReuse>(a, B, stream);
}
