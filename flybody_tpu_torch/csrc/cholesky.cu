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
// the column loop once for all of them; here a block owns an env.
//
// Rows 14 and 15 keep their first design (cholesky.cuh: the triangle packed
// by columns, a left-looking factor with one barrier a column, the single
// right-hand side substituted with one barrier a row).
//
// Row 17 (chol_solve_kernel; 256 threads, two blocks an SM at n = 216,
// n <= 256) keeps the triangle packed by rows (cholesky.cuh) and gives the
// first design's outputs bit for bit: the two-fly gate of chip_smoke.py
// (f64_anchored over 16 envs after 5 substeps) passes or fails with the
// state that row 17's roundings lead to, whatever the substep's kernels
// (PERF.md section 6), so the factor keeps chol_factor's order: each entry
// (i, k) sums its terms L[i][j] L[k][j] in four partial sums (term j in
// partial j mod 4, ascending; the last k mod 4 in partial 0), combined as
// (s0 + s1) + (s2 + s3) and subtracted from A[i][k]; the pivot is
// rsqrt(max(d, 1e-30)) (fmaxf), the diagonal d * rsqrt. It factors by
// panels of kNb columns, left-looking:
//   1. stage-in: a bulk copy a row (and one for b) on an mbarrier;
//   2. a panel at a time: thread t forms row k0 + t's partial sums of the
//      panel's columns over the columns left of the panel (its own row by
//      16-byte loads, the panel's rows by broadcast 16-byte loads, in
//      registers); warp 0 adds the diagonal block's own columns (lane r
//      holds row r, row c's entries by shuffles), takes the pivots and
//      solves the block's rows of L y = b (y_c = r_c / L[c][c], the owner
//      lane dividing); then every row below adds the panel's columns and
//      takes them, and subtracts its forward-substitution terms in column
//      order: two barriers a panel;
//   3. backward substitution, a panel at a time from the last: warp 0
//      solves the panel's rows with shuffles, then every thread takes a row
//      above and subtracts the panel's terms, the last row first (row j of
//      L read along consecutive columns): two barriers a panel;
//   4. store: L a warp a row by 16-byte stores (zeros above the diagonal
//      without reading shared memory), then x.
// What holds it (phase clocks, PERF.md): the broadcast loads of the
// panel's rows, which every warp repeats for its rows, and warp 0's chain
// of shuffles, rsqrt and divisions in each diagonal block.
//
// Row 16 (cho_solve_multi_kernel; 256 threads, two blocks an SM at n = 216)
// splits X into chunks of 8 kTC columns, a block a chunk: kTC = 4 for m <=
// 32 (one block an env at the bench preset's m 32), else 8 (two at m 128).
// Warp w owns kTC columns and every row of them: lane l holds rows l + 32 u
// (u < kMultiU) of its columns in registers. Both sweeps go by row panels
// of kMultiNb rows:
//   1. the owners write the panel's rows to the panel buffer PB (double
//      buffered); barrier;
//   2. a thread a column (threads below 8 kTC) solves the panel's
//      triangle, while the other threads copy the panel's columns of L
//      below the diagonal, transposed, to PL (forward sweep); barrier;
//   3. the owners take the solved rows back, and every lane subtracts the
//      panel's terms from its rows below (forward: L[i][q] from PL, one
//      conflict-free load for kTC products) or above (backward: L[j][i]
//      along row j of the triangle, consecutive lanes on consecutive
//      words), each solved row of PB a broadcast 16-byte load; the first
//      (last) register row that takes part is a template argument, so the
//      rows that take no part cost nothing.
// Two barriers a panel each way. A panel is 12 rows so that two blocks of 8
// kTC = 64 columns fit on an SM (PL and PB grow with it); 8 columns a warp
// halve the loads a product against 4 and read faster at m 128 on an H100
// (PERF.md). R and X move between global memory and
// registers by 16-byte accesses (m % 4 == 0, aligned), else by elements.
// Row 17 divides by L[k][k] where the plain versions do; row 16 multiplies
// by 1 / L[k][k] (rounded once), shortening its panels' chains.

#include "cholesky.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kNb = 16;       // row 17: panel width (a multiple of 4)
constexpr int kMultiNb = 12;  // row 16: panel height
constexpr int kMultiU = 7;    // row 16: rows a lane (n <= 32 kMultiU)
constexpr int kPhases = 4;    // ops/cholesky.PHASES

long long* g_clk = nullptr;  // host: where the clock instantiations add
int g_clk_stride = 1;

struct Clk {
  long long* clk;  // (ceil(B / stride), kPhases), or null
  int stride;
};

// Phase i of the env ends: thread 0 adds the cycles since the last mark
// to phase i (clock instantiations only; the block has synchronised).
#define PHASE(i)                        \
  do {                                  \
    if constexpr (kClock) {             \
      __syncthreads();                  \
      if (threadIdx.x == 0) {           \
        const long long c_ = clock64(); \
        ph[i] += c_ - c_last;           \
        c_last = c_;                    \
      }                                 \
    }                                   \
  } while (0)

// ------------------------------------------------------------------ row 17

// Shared floats of chol_solve_kernel: the mbarrier (4), the triangle, v
// (pad4(n)) and the panel's rsqrt pivots (kNb).
__host__ __device__ __forceinline__ size_t cs_floats(int n) {
  return 4 + (size_t)row_off(n) + pad4(n) + kNb;
}

// Partial sum (0-3) of the term j of entry (i, k) in the first design's
// left-looking factor (cholesky.cuh chol_factor): j mod 4 below 4 (k / 4),
// partial 0 from there up to k. kc = k - k0, jc = j - k0, with k0 a
// multiple of 4.
__host__ __device__ constexpr int part_of(int jc, int kc) {
  return jc < 4 * (kc / 4) ? jc & 3 : 0;
}

// An entry (i, k) of the panel: its A value less the combined partial sums,
// as chol_factor forms it.
__device__ __forceinline__ float entry(float a, const float* p) {
  return a - ((p[0] + p[1]) + (p[2] + p[3]));
}

// Warp 0: the diagonal block of rows and columns k0..k0+kb-1 (lane r holds
// row k0 + r: its A values in a, its partial sums over the columns left of
// the panel in p). Column by column: each entry (r, c) adds the terms of
// the block's columns left of c (row c's from lane c) to its partial sums;
// the pivot rsqrt(max(d, 1e-30)) scales the column below it and the
// diagonal becomes d rsqrt(d), as chol_factor does. Writes the rows back,
// the pivots' rsqrt to inv, and solves the block's rows of L y = b: v[k0 +
// r] <- y, y_c = r_c / L[c][c] (their terms from the rows above the block
// were subtracted before).
template <bool kFull>
__device__ __forceinline__ void diag_block(float* S, float* v, float* inv,
                                           float (&p)[kNb][4], int k0,
                                           int kb) {
  if constexpr (kFull) kb = kNb;
  const int r = threadIdx.x & 31;
  const bool on = r < kb;
  float* row = S + row_off(k0 + (on ? r : 0)) + k0;
  float a[kNb], diag = 1.f;
#pragma unroll
  for (int c = 0; c < kNb; ++c) a[c] = on && c <= r ? row[c] : 0.f;
#pragma unroll
  for (int c = 0; c < kNb; ++c) {
    if (c < kb) {
#pragma unroll
      for (int j = 0; j < c; ++j) {
        const float l = __shfl_sync(kAllLanes, a[j], c);
        // Lanes past the block hold rows below it: their sums stay theirs.
        if (on) p[c][part_of(j, c)] = fmaf(a[j], l, p[c][part_of(j, c)]);
      }
      const float e = entry(a[c], p[c]);
      const float d = __shfl_sync(kAllLanes, e, c);
      const float s = rsqrtf(fmaxf(d, 1e-30f));
      if (r == c) diag = a[c] = d * s;
      else a[c] = e * s;  // lanes above c or past the block: unused
      if (r == 0) inv[c] = s;
    }
  }
  if (on) {
#pragma unroll
    for (int c = 0; c < kNb; ++c)
      if (c <= r) row[c] = a[c];
  }
  float y = on ? v[k0 + r] : 0.f;
#pragma unroll
  for (int c = 0; c < kNb; ++c) {
    if (c < kb) {
      float q = 0.f;
      if (r == c) q = y / diag;  // the owner alone divides
      const float yc = __shfl_sync(kAllLanes, q, c);
      if (r == c) y = yc;
      else if (r > c) y = fmaf(-a[c], yc, y);
    }
  }
  if (on) v[k0 + r] = y;
}

// A row i below the diagonal block of the full panel k0 (p: its partial
// sums over the columns left of the panel): column by column, its entry
// adds the terms of the panel's columns left of c (row k0 + c from shared
// memory, broadcast) and takes the pivot, as chol_factor does; then its
// forward-substitution terms v[i] -= L[i][k0+c] y[k0+c] in column order.
__device__ __forceinline__ void panel_row(float* S, float* v, const float* inv,
                                          float (&p)[kNb][4], int k0, int i) {
  float4* row4 = reinterpret_cast<float4*>(S + row_off(i) + k0);
  float a[kNb];
#pragma unroll
  for (int g = 0; g < kNb / 4; ++g) {
    const float4 q = row4[g];
    a[4 * g] = q.x, a[4 * g + 1] = q.y, a[4 * g + 2] = q.z, a[4 * g + 3] = q.w;
  }
#pragma unroll
  for (int c = 0; c < kNb; ++c) {
    const float4* l4 =
        reinterpret_cast<const float4*>(S + row_off(k0 + c) + k0);
#pragma unroll
    for (int g = 0; 4 * g < c; ++g) {
      const float4 q = l4[g];
      const float l[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * g + u;
        if (j < c) p[c][part_of(j, c)] = fmaf(a[j], l[u], p[c][part_of(j, c)]);
      }
    }
    a[c] = entry(a[c], p[c]) * inv[c];
  }
  float y = v[i];
#pragma unroll
  for (int c = 0; c < kNb; ++c) y = fmaf(-a[c], v[k0 + c], y);
  v[i] = y;
#pragma unroll
  for (int g = 0; g < kNb / 4; ++g)
    row4[g] = make_float4(a[4 * g], a[4 * g + 1], a[4 * g + 2], a[4 * g + 3]);
}

// Warp 0: the backward substitution of the rows k0..k0+kb-1 (their terms
// from the rows below the block subtracted before): lane r holds row k0 + r;
// for c from the last row up, x_c = v_c / L[c][c], and every row above it
// in the block subtracts L[k0+c][k0+r] x_c. The lane's column of the block
// and the diagonal are loaded before the chain.
template <bool kFull>
__device__ __forceinline__ void diag_back(const float* S, float* v, int k0,
                                          int kb) {
  if constexpr (kFull) kb = kNb;
  const int r = threadIdx.x & 31;
  float lc[kNb], di[kNb];
#pragma unroll
  for (int c = 0; c < kNb; ++c) {
    lc[c] = di[c] = 1.f;
    if (c < kb) {
      const float* row = S + row_off(k0 + c) + k0;
      lc[c] = row[min(r, c)], di[c] = row[c];
    }
  }
  float val = r < kb ? v[k0 + r] : 0.f;
#pragma unroll
  for (int c = kNb - 1; c >= 0; --c) {
    if (c < kb) {
      float q = 0.f;
      if (r == c) q = val / di[c];  // the owner alone divides
      const float xc = __shfl_sync(kAllLanes, q, c);
      if (r == c) val = xc;
      else if (r < c) val = fmaf(-lc[c], xc, val);
    }
  }
  if (r < kb) v[k0 + r] = val;
}

template <bool kClock>
__global__ void __launch_bounds__(kThreads, 2)
    chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                      float* __restrict__ L, float* __restrict__ x, int n,
                      Clk ck) {
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, w = t >> 5;
  const size_t e = blockIdx.x;
  long long ph[kPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  float* S = sm + 4;
  float* v = S + row_off(n);
  float* inv = v + pad4(n);

  rows_load(A + e * n * n, b + e * n, S, v, n, bar);
  PHASE(0);

  // ---- Factor and forward substitution, a panel at a time: thread t
  // holds row k0 + t's partial sums over the columns left of the panel.
  for (int k0 = 0; k0 < n; k0 += kNb) {
    const int kb = min(kNb, n - k0), i = k0 + t;
    float p[kNb][4];
#pragma unroll
    for (int c = 0; c < kNb; ++c) p[c][0] = p[c][1] = p[c][2] = p[c][3] = 0.f;
    if (i < n) {
      const float* own = S + row_off(i);
      for (int j = 0; j < k0; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(own + j);
#pragma unroll
        for (int c = 0; c < kNb; ++c) {
          if (c < kb) {
            const float4 l =
                *reinterpret_cast<const float4*>(S + row_off(k0 + c) + j);
            p[c][0] = fmaf(q.x, l.x, p[c][0]);
            p[c][1] = fmaf(q.y, l.y, p[c][1]);
            p[c][2] = fmaf(q.z, l.z, p[c][2]);
            p[c][3] = fmaf(q.w, l.w, p[c][3]);
          }
        }
      }
    }
    if (w == 0) {
      if (kb == kNb) diag_block<true>(S, v, inv, p, k0, kb);
      else diag_block<false>(S, v, inv, p, k0, kb);
    }
    __syncthreads();
    if (kb == kNb && t >= kNb && i < n) panel_row(S, v, inv, p, k0, i);
    __syncthreads();
  }
  PHASE(1);

  // ---- Backward substitution, a panel at a time from the last; each row
  // takes the terms of the rows below it from the last up.
  for (int k0 = ((n - 1) / kNb) * kNb; k0 >= 0; k0 -= kNb) {
    const int kb = min(kNb, n - k0);
    if (w == 0) {
      if (kb == kNb) diag_back<true>(S, v, k0, kb);
      else diag_back<false>(S, v, k0, kb);
    }
    __syncthreads();
    if (k0 == 0) break;
    for (int k = t; k < k0; k += blockDim.x) {
      float s = v[k];
#pragma unroll
      for (int c = kNb - 1; c >= 0; --c)
        if (c < kb) s = fmaf(-S[row_off(k0 + c) + k], v[k0 + c], s);
      v[k] = s;
    }
    __syncthreads();
  }
  PHASE(2);

  // ---- Store.
  rows_store(S, L + e * n * n, n);
  for (int i = t; i < n; i += blockDim.x) x[e * n + i] = v[i];
  PHASE(3);
  if constexpr (kClock) {
    if (t == 0 && e % ck.stride == 0)
      for (int i = 0; i < kPhases; ++i)
        ck.clk[(e / ck.stride) * kPhases + i] += ph[i];
  }
}

// ------------------------------------------------------------------ row 16

// Shared floats of cho_solve_multi_kernel<kTC>: the mbarrier (4), the
// triangle, the panel's columns of L below it, transposed (PL: kMultiNb x
// pad4(n)), the diagonal's reciprocals (pad4(n)), the panel buffer PB (2 x
// kMultiNb x 8 kTC).
__host__ __device__ __forceinline__ size_t csm_floats(int n, int tc) {
  return 4 + (size_t)row_off(n) + (size_t)(kMultiNb + 1) * pad4(n) +
         2 * kMultiNb * 8 * tc;
}

// Thread t < kW: column t of the panel's rows in PB (k0..k0+kb-1). Forward
// (L y = r), left-looking: row r subtracts L[k0+r][k0+r2] y_r2 in column
// order, then y_r = (that) dinv_r. Backward (L^T x = y) from the last row
// up, right-looking: x_r = y_r dinv_r, then every earlier row r2 subtracts
// L[k0+r][k0+r2] x_r. Either way each row takes its terms in the order the
// sweep solves the rows. kFull (kb == kMultiNb) drops the guards, so every
// load can be issued ahead of the chain.
template <int kW, bool kForward, bool kFull>
__device__ __forceinline__ void panel_solve(const float* S, const float* dinv,
                                            float* PB, int k0, int kb) {
  const int t = threadIdx.x;
  float col[kMultiNb];
#pragma unroll
  for (int r = 0; r < kMultiNb; ++r)
    col[r] = kFull || r < kb ? PB[r * kW + t] : 0.f;
  if constexpr (kForward) {
#pragma unroll
    for (int r = 0; r < kMultiNb; ++r) {
      if (kFull || r < kb) {
        const float4* l4 =
            reinterpret_cast<const float4*>(S + row_off(k0 + r) + k0);
        float s = col[r];
#pragma unroll
        for (int g = 0; 4 * g < r; ++g) {
          const float4 q = l4[g];
          s = fmaf(-q.x, col[4 * g], s);
          if (4 * g + 1 < r) s = fmaf(-q.y, col[4 * g + 1], s);
          if (4 * g + 2 < r) s = fmaf(-q.z, col[4 * g + 2], s);
          if (4 * g + 3 < r) s = fmaf(-q.w, col[4 * g + 3], s);
        }
        col[r] = s * dinv[k0 + r];
      }
    }
  } else {
#pragma unroll
    for (int r = kMultiNb - 1; r >= 0; --r) {
      if (kFull || r < kb) {
        const float4* l4 =
            reinterpret_cast<const float4*>(S + row_off(k0 + r) + k0);
        col[r] *= dinv[k0 + r];
#pragma unroll
        for (int g = 0; 4 * g < r; ++g) {
          const float4 q = l4[g];
          col[4 * g] = fmaf(-q.x, col[r], col[4 * g]);
          if (4 * g + 1 < r) col[4 * g + 1] = fmaf(-q.y, col[r], col[4 * g + 1]);
          if (4 * g + 2 < r) col[4 * g + 2] = fmaf(-q.z, col[r], col[4 * g + 2]);
          if (4 * g + 3 < r) col[4 * g + 3] = fmaf(-q.w, col[r], col[4 * g + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMultiNb; ++r)
    if (kFull || r < kb) PB[r * kW + t] = col[r];
}

template <int kW, bool kForward>
__device__ __forceinline__ void panel_solve(const float* S, const float* dinv,
                                            float* PB, int k0, int kb) {
  if (kb == kMultiNb) panel_solve<kW, kForward, true>(S, dinv, PB, k0, kb);
  else panel_solve<kW, kForward, false>(S, dinv, PB, k0, kb);
}

// x[c] -= l y[c] for this lane's kTC columns.
template <int kTC>
__device__ __forceinline__ void sub_row(float* x, float l, const float* y) {
#pragma unroll
  for (int c = 0; c < kTC; ++c) x[c] = fmaf(-l, y[c], x[c]);
}

// kTC consecutive floats of shared memory (16-byte aligned) into y.
template <int kTC>
__device__ __forceinline__ void load_cols(float* y, const float* src) {
#pragma unroll
  for (int g = 0; g < kTC / 4; ++g) {
    const float4 q = reinterpret_cast<const float4*>(src)[g];
    y[4 * g] = q.x, y[4 * g + 1] = q.y, y[4 * g + 2] = q.z, y[4 * g + 3] = q.w;
  }
}

template <int kTC>
__device__ __forceinline__ void store_cols(float* dst, const float* y) {
#pragma unroll
  for (int g = 0; g < kTC / 4; ++g)
    reinterpret_cast<float4*>(dst)[g] =
        make_float4(y[4 * g], y[4 * g + 1], y[4 * g + 2], y[4 * g + 3]);
}

// The forward sweep's update of a lane's rows below the panel (i >= t0):
// register rows U0.. (u = U0 split at t0, the rest whole: rows at or past
// n only ever hold values that are not stored), every row taking
// L[i][k0+q] y_q for q in order, L[i][k0+q] from pl = PL + lane (the
// panel's columns, transposed), y_q from yb = the warp's columns of PB.
// The first row is a template argument, so no register row is indexed at
// run time and the rows above the panel cost nothing.
template <int kTC, int U0>
__device__ __forceinline__ void rows_below(float (&xr)[kMultiU][kTC],
                                           const float* pl, const float* yb,
                                           int ldp, int kW, int lane,
                                           int t0) {
#pragma unroll 4
  for (int q = 0; q < kMultiNb; ++q) {
    float y[kTC];
    load_cols<kTC>(y, yb + q * kW);
#pragma unroll
    for (int u = U0; u < kMultiU; ++u) {
      const float l = pl[q * ldp + 32 * u];
      if (u > U0 || lane + 32 * u >= t0) sub_row<kTC>(xr[u], l, y);
    }
  }
}

// rows_below<kTC, u0> for the run-time u0 (< kMultiU).
template <int kTC, int U = 0>
__device__ __forceinline__ void from_rows(int u0, float (&xr)[kMultiU][kTC],
                                          const float* pl, const float* yb,
                                          int ldp, int kW, int lane, int t0) {
  if constexpr (U < kMultiU) {
    if (u0 == U) rows_below<kTC, U>(xr, pl, yb, ldp, kW, lane, t0);
    else from_rows<kTC, U + 1>(u0, xr, pl, yb, ldp, kW, lane, t0);
  }
}

// The backward sweep's update of a lane's rows above the panel (i < k0):
// register rows ..U1 (u = U1 split at k0), every row taking L[k0+j][i]
// x_j for j from the panel's last row up (row k0 + j of the triangle,
// consecutive lanes on consecutive words).
template <int kTC, int U1>
__device__ __forceinline__ void rows_above(float (&xr)[kMultiU][kTC],
                                           const float* S, int k0, int kb,
                                           const float* yb, int kW, int lane) {
#pragma unroll 4
  for (int j = kb - 1; j >= 0; --j) {
    float y[kTC];
    load_cols<kTC>(y, yb + j * kW);
    const float* lj = S + row_off(k0 + j) + lane;
#pragma unroll
    for (int u = 0; u <= U1; ++u) {
      const float l = lj[32 * u];
      if (u < U1 || lane + 32 * u < k0) sub_row<kTC>(xr[u], l, y);
    }
  }
}

// rows_above<kTC, u1> for the run-time u1 (< kMultiU; none at k0 0).
template <int kTC, int U = 0>
__device__ __forceinline__ void to_rows(int u1, float (&xr)[kMultiU][kTC],
                                        const float* S, int k0, int kb,
                                        const float* yb, int kW, int lane) {
  if constexpr (U < kMultiU) {
    if (k0 == 0) return;
    if (u1 == U) rows_above<kTC, U>(xr, S, k0, kb, yb, kW, lane);
    else to_rows<kTC, U + 1>(u1, xr, S, k0, kb, yb, kW, lane);
  }
}

// kTC columns a warp, 8 kTC a block: 4 (m <= 32) or 8.
template <int kTC, bool kClock>
__global__ void __launch_bounds__(kThreads, 2)
    cho_solve_multi_kernel(const float* __restrict__ Lg,
                           const float* __restrict__ R, float* __restrict__ X,
                           int n, int m, int chunks, Clk ck) {
  constexpr int kW = 8 * kTC;
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const size_t e = blockIdx.x / chunks;
  const int c0 = (blockIdx.x % chunks) * kW + kTC * w;  // this warp's columns
  long long ph[kPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  const int ldp = pad4(n);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  float* S = sm + 4;
  float* PL = S + row_off(n);
  float* dinv = PL + kMultiNb * ldp;
  float* PB = dinv + ldp;
  const float* Re = R + e * n * m;
  float* Xe = X + e * n * m;
  const bool vec = (m & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(R) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(X) & 15) == 0;

  // ---- Stage-in: this lane's rows of its columns into registers (the
  // loads in flight while the triangle's bulk copies land).
  float xr[kMultiU][kTC];
#pragma unroll
  for (int u = 0; u < kMultiU; ++u) {
    const int i = lane + 32 * u;
#pragma unroll
    for (int c = 0; c < kTC; ++c) xr[u][c] = 0.f;
    if (i < n && c0 < m) {
      if (vec) {
#pragma unroll
        for (int g = 0; g < kTC / 4; ++g)
          if (c0 + 4 * g < m) {
            const float4 q = *reinterpret_cast<const float4*>(
                Re + (size_t)i * m + c0 + 4 * g);
            xr[u][4 * g] = q.x, xr[u][4 * g + 1] = q.y;
            xr[u][4 * g + 2] = q.z, xr[u][4 * g + 3] = q.w;
          }
      } else {
#pragma unroll
        for (int c = 0; c < kTC; ++c)
          if (c0 + c < m) xr[u][c] = Re[(size_t)i * m + c0 + c];
      }
    }
  }
  rows_load(Lg + e * n * n, nullptr, S, nullptr, n, bar);
  for (int i = t; i < n; i += blockDim.x) dinv[i] = 1.f / S[row_off(i) + i];
  PHASE(0);

  int buf = 0;
  // ---- Forward sweep: L Y = R.
  for (int k0 = 0; k0 < n; k0 += kMultiNb, buf ^= 1) {
    const int kb = min(kMultiNb, n - k0), t0 = k0 + kb;
    float* pb = PB + buf * kMultiNb * kW;
#pragma unroll
    for (int u = 0; u < kMultiU; ++u) {
      const int r = lane + 32 * u - k0;
      if (r >= 0 && r < kb) store_cols<kTC>(pb + r * kW + kTC * w, xr[u]);
    }
    __syncthreads();
    if (t < kW) {
      panel_solve<kW, true>(S, dinv, pb, k0, kb);
    } else {  // the panel's columns of L below it, transposed
      for (int i = t0 + t - kW; i < n; i += blockDim.x - kW) {
        const float4* row4 =
            reinterpret_cast<const float4*>(S + row_off(i) + k0);
#pragma unroll
        for (int g = 0; g < kMultiNb / 4; ++g) {
          const float4 q = row4[g];
          PL[(4 * g) * ldp + i] = q.x, PL[(4 * g + 1) * ldp + i] = q.y;
          PL[(4 * g + 2) * ldp + i] = q.z, PL[(4 * g + 3) * ldp + i] = q.w;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kMultiU; ++u) {
      const int r = lane + 32 * u - k0;
      if (r >= 0 && r < kb) load_cols<kTC>(xr[u], pb + r * kW + kTC * w);
    }
    if (t0 < n)  // kb == kMultiNb
      from_rows<kTC>(t0 >> 5, xr, PL + lane, pb + kTC * w, ldp, kW, lane,
                     t0);
  }
  PHASE(1);

  // ---- Backward sweep: L^T X = Y, a panel at a time from the last.
  for (int k0 = ((n - 1) / kMultiNb) * kMultiNb; k0 >= 0;
       k0 -= kMultiNb, buf ^= 1) {
    const int kb = min(kMultiNb, n - k0);
    float* pb = PB + buf * kMultiNb * kW;
#pragma unroll
    for (int u = 0; u < kMultiU; ++u) {
      const int r = lane + 32 * u - k0;
      if (r >= 0 && r < kb) store_cols<kTC>(pb + r * kW + kTC * w, xr[u]);
    }
    __syncthreads();
    if (t < kW) panel_solve<kW, false>(S, dinv, pb, k0, kb);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kMultiU; ++u) {
      const int r = lane + 32 * u - k0;
      if (r >= 0 && r < kb) load_cols<kTC>(xr[u], pb + r * kW + kTC * w);
    }
    to_rows<kTC>(k0 >> 5, xr, S, k0, kb, pb + kTC * w, kW, lane);
  }
  PHASE(2);

  // ---- Store.
#pragma unroll
  for (int u = 0; u < kMultiU; ++u) {
    const int i = lane + 32 * u;
    if (i < n && c0 < m) {
      if (vec) {
#pragma unroll
        for (int g = 0; g < kTC / 4; ++g)
          if (c0 + 4 * g < m)
            *reinterpret_cast<float4*>(Xe + (size_t)i * m + c0 + 4 * g) =
                make_float4(xr[u][4 * g], xr[u][4 * g + 1], xr[u][4 * g + 2],
                            xr[u][4 * g + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < kTC; ++c)
          if (c0 + c < m) Xe[(size_t)i * m + c0 + c] = xr[u][c];
      }
    }
  }
  PHASE(3);
  if constexpr (kClock) {
    if (t == 0 && e % ck.stride == 0)
      for (int i = 0; i < kPhases; ++i)
        atomicAdd(reinterpret_cast<unsigned long long*>(
                      &ck.clk[(e / ck.stride) * kPhases + i]),
                  (unsigned long long)ph[i]);
  }
}

// ------------------------------------------------------ rows 14 and 15

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

// Allows the dynamic shared memory a launch needs and asks for the largest
// shared-memory carveout of the SM's L1, so that two blocks fit on one SM
// (the default carveout may leave room for one).
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

// Launches (B >= 1) or only sizes (B 0: blocks an SM into *blocks, and the
// main instantiation's attributes into *fa when given) row 17.
int chol_solve_run(const float* A, const float* b, float* L, float* x, int B,
                   int n, void* stream, int* blocks, cudaFuncAttributes* fa) {
  if (n < 1 || n > kThreads) return -1;  // a thread a row
  const size_t smem = sizeof(float) * cs_floats(n);
  const Clk ck{g_clk, g_clk_stride};
  const bool clock = B > 0 && g_clk;
  auto kern = clock ? chol_solve_kernel<true> : chol_solve_kernel<false>;
  int rc = set_smem(kern, smem);
  if (rc) return rc;
  if (fa) rc = (int)cudaFuncGetAttributes(fa, kern);
  if (!rc && blocks)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                            kThreads, smem);
  if (rc || B < 1) return rc;
  kern<<<B, kThreads, smem, (cudaStream_t)stream>>>(A, b, L, x, n, ck);
  return (int)cudaGetLastError();
}

// The same for row 16: 32 columns a block for m <= 32, else 64 (grid: B
// envs x chunks).
template <int kTC>
int multi_run(const float* L, const float* R, float* X, int B, int n, int m,
              void* stream, int* blocks, cudaFuncAttributes* fa) {
  const int chunks = (m + 8 * kTC - 1) / (8 * kTC);
  const size_t smem = sizeof(float) * csm_floats(n, kTC);
  const Clk ck{g_clk, g_clk_stride};
  const bool clock = B > 0 && g_clk;
  auto kern = clock ? cho_solve_multi_kernel<kTC, true>
                    : cho_solve_multi_kernel<kTC, false>;
  int rc = set_smem(kern, smem);
  if (rc) return rc;
  if (fa) rc = (int)cudaFuncGetAttributes(fa, kern);
  if (!rc && blocks)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                            kThreads, smem);
  if (rc || B < 1) return rc;
  kern<<<(unsigned)B * chunks, kThreads, smem, (cudaStream_t)stream>>>(
      L, R, X, n, m, chunks, ck);
  return (int)cudaGetLastError();
}

int multi_tc(int m) { return m <= 32 ? 4 : 8; }

int cho_solve_multi_run(const float* L, const float* R, float* X, int B,
                        int n, int m, void* stream, int* blocks,
                        cudaFuncAttributes* fa) {
  if (n < 1 || m < 1 || n > 32 * kMultiU) return -1;
  return multi_tc(m) == 4
             ? multi_run<4>(L, R, X, B, n, m, stream, blocks, fa)
             : multi_run<8>(L, R, X, B, n, m, stream, blocks, fa);
}

}  // namespace

FB_API int chol_solve_f32(const float* A, const float* b, float* L, float* x,
                          int B, int n, void* stream) {
  if (B < 1) return -1;
  return chol_solve_run(A, b, L, x, B, n, stream, nullptr, nullptr);
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
  if (B < 1) return -1;
  return cho_solve_multi_run(L, R, X, B, n, m, stream, nullptr, nullptr);
}

// Phase clocks: while clk is set, every chol_solve_f32 and
// cho_solve_multi_f32 launch runs its clock instantiation and adds the
// cycles of each phase (ops/cholesky.PHASES) of every stride-th env to clk
// ((ceil(B / stride), 4) int64; row 16 adds every chunk block of the env);
// nullptr turns it off.
FB_API int cholesky_phase_clock(long long* clk, int stride) {
  if (stride < 1) return -1;
  g_clk = clk, g_clk_stride = stride;
  return 0;
}

// Resources of row 17 (m 0) or row 16 (m >= 1) at n: out = registers a
// thread, shared bytes a block, blocks an SM, grid blocks for B envs.
FB_API int cholesky_info(int B, int n, int m, int* out) {
  cudaFuncAttributes fa;
  int blocks = 0;
  const int rc = m < 1 ? chol_solve_run(nullptr, nullptr, nullptr, nullptr, 0,
                                        n, nullptr, &blocks, &fa)
                       : cho_solve_multi_run(nullptr, nullptr, nullptr, 0, n,
                                             m, nullptr, &blocks, &fa);
  if (rc) return rc;
  out[0] = fa.numRegs;
  out[1] = (int)(sizeof(float) *
                 (m < 1 ? cs_floats(n) : csm_floats(n, multi_tc(m))));
  out[2] = blocks;
  out[3] = m < 1 ? B : B * ((m + 8 * multi_tc(m) - 1) / (8 * multi_tc(m)));
  return 0;
}
