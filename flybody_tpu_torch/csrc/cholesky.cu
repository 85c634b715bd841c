// Rows 14, 15, 16 and 17: the dense batched Cholesky family.
//
// Replaces flybody_tpu/ops/cholesky.py:
//   * chol_f32 (row 14): _chol_pallas (:79, the Pallas call at :84), the
//     factor alone: A (B, n, n) -> L lower with zeros above. smooth.factor_m
//     runs it on a model without an arrow partition, and the arrow Newton
//     step on an unpacked M on its capacitance I + U^T Z + 1e-10 I (n = 3 SB
//     = 24 at SB 8; physics/solver.py); tools/profile_micro.py on the walking
//     model's Hessian (n 108);
//   * chol_solve_f32 (row 17): _chol_solve_pallas (:333, the Pallas call at
//     :337), the fused factor + single-RHS solve: A (B, n, n), b (B, n) ->
//     L (B, n, n) lower with zeros above, x with A x = b. The dense path
//     runs it for the smooth acceleration, every fresh Newton step and the
//     damped Euler solve;
//   * cho_solve_f32 (row 15): _solve_pallas (:186, call :190), the
//     single-RHS substitution L L^T x = b given L (reuse Newton steps; the
//     capacitance's solve, n 24);
//   * cho_solve_multi_f32 (row 16): _solve_multi_pallas (:256, call :262),
//     L L^T X = R for R (B, n, m) (the noslip's M^-1 J_t^T, m = 2K).
// Semantics: chol_ref / chol_solve_ref / cho_solve_ref / cho_solve_multi_ref
// in flybody_tpu_torch/ops/cholesky.py.
//
// What bounds them: bytes for rows 14, 15 and 17 (per env at n = 216 the lower
// triangle in, 93.7 KB, and for row 17 the full factor out, 187 KB; the
// factor is n^3/3 = 3.4 MFLOP), operations for row 16 at m = 128 (2 n^2 m
// = 11.9 MFLOP per env). The TPU kernels put 128 envs on the lanes and ran
// the column loop once for all of them; here a block or a warp owns an env.
//
// Every factor here sums in the first design's order, and rows 14, 15 and
// 17 give that design's outputs bit for bit: the two-fly gate of
// chip_smoke.py (f64_anchored over 16 envs after 5 substeps) and the bench
// all-finite gate pass or fail with the states that these roundings lead to
// (PERF.md section 6). The order: each entry (i, k) sums its terms L[i][j]
// L[k][j] in four partial sums (term j in partial j mod 4 for j < 4 (k /
// 4), ascending; the terms from there up to k - 1 in partial 0), combined
// as (s0 + s1) + (s2 + s3) and subtracted from A[i][k]; the pivot is
// rsqrt(max(d, 1e-30)) (fmaxf; the TPU kernel's clamp), the rows below are
// scaled by it and the diagonal becomes d * rsqrt; no jitter is added (the
// callers add their own). The single right-hand side: forward, y_k = r_k /
// L[k][k] and every row below subtracts L[i][k] y_k, each row's terms in
// column order; backward, x_k = r_k / L[k][k] and every row j < k
// subtracts L[k][j] x_k, k descending. Each product-and-subtract is one
// fmaf, and each division a division.
//
// Row 17 (chol_solve_kernel; 256 threads, two blocks an SM at n = 216,
// n <= 256) keeps the triangle packed by rows (cholesky.cuh) and factors
// by panels of kNb columns, left-looking:
//   1. stage-in: a bulk copy a row (and one for b) on an mbarrier;
//   2. a panel at a time: thread t holds row k0 + t's partial sums of the
//      panel's columns over the columns left of the panel (in registers;
//      formed by thread pairs, left_sums2); warp 0 adds the diagonal
//      block's own columns (lane r holds row r, row c's entries by
//      shuffles), takes the pivots and solves the block's rows of L y = b
//      (y_c = r_c / L[c][c], the owner lane dividing); then every row below
//      adds the panel's columns and takes them, and subtracts its
//      forward-substitution terms in column order: two barriers a panel;
//   3. backward substitution, a panel at a time from the last: warp 0
//      solves the panel's rows with shuffles, then every thread takes a row
//      above and subtracts the panel's terms, the last row first (row j of
//      L read along consecutive columns): two barriers a panel;
//   4. store: L a warp a row by 16-byte stores (zeros above the diagonal
//      without reading shared memory), then x.
// What holds it (phase clocks, PERF.md): the partial sums over the
// columns left of each panel (the broadcast loads of the panel's rows,
// which every warp repeats for its rows), and warp 0's chain of shuffles,
// rsqrt and divisions in each diagonal block.
//
// Row 14 has three forms (chol_run; at n 24 the warp kernel reads more
// than twice as fast as the one-warp panel kernel, PERF.md):
//   * n <= 32 (the capacitance, n 24; chol_warp_kernel): a warp an env,
//     four a block. The warp stages the triangle in shared memory by rows
//     (one coalesced load a row, no division), lane r takes row r into
//     registers, and the columns go one after another with no barrier:
//     row k's entries by shuffles from lane k, the pivot by a shuffle; the
//     rows go back through shared memory to coalesced stores;
//   * n <= 256 (n 108; chol_panel_kernel): row 17's factor phase without
//     the right-hand side, a block an env: the triangle packed by rows in
//     shared memory, panels of kNb columns, two barriers a panel. At n <=
//     128 the block is one warp (the rows past 32 below a panel in further
//     passes), so its barriers cost little and nine envs share an SM
//     (shared memory bounds them); that read faster than 128 threads an
//     env, which wait at each panel's barriers for warp 0's diagonal
//     chain. Above, 256 threads. Each pair of threads forms the partial sums
//     of two rows over half the panel's columns (left_sums2; row 17's
//     panels take it too), so a
//     broadcast load of a panel row serves two rows (10 shared loads for
//     64 FMAs, against 17), then swaps halves by shuffles: the sums over
//     the columns left of the panel are most of the factor's time
//     (PERF.md section 5);
//   * 256 < n <= 512: the same panels on a row-major workspace in global
//     memory (the wrapper's W, rows padded to 16 bytes), two rows a thread.
//
// Row 15 has two forms (cho_solve_run; at n 24 the staged kernel reads
// faster than the tiled one), a warp an env, four a block, each
// row's running right-hand side with the lane that owns it and every
// solved value broadcast by a shuffle from its owner lane (who alone
// divides, div_rn): no barrier.
//   * n <= 32 (cho_solve_warp32_kernel): the triangle staged in shared
//     memory by rows, then lane r holds row r (the forward sweep's terms)
//     and after it column r (the backward's) in registers;
//   * n > 32 (cho_solve_tiles_kernel): lane l owns rows l + 32 u (their
//     running values in shared memory), and L streams through the warp's
//     shared memory in 32 x 32 tiles (each tile row one 128-byte line of
//     L), by asynchronous copies a tile ahead of the lanes, a row strip
//     at a time (neighbouring tiles share DRAM pages). Forward, row block
//     u: each tile left of the diagonal subtracts its 32 terms from the
//     block's rows (the solved values broadcast from shared memory), then
//     the diagonal tile solves the block's rows with shuffles; backward,
//     row block U from the last: the diagonal tile solves with its
//     columns (x into registers), then each tile left of it subtracts its
//     terms from the rows of its column block. L is read twice (0.23 ms
//     of tiles at 3.35 TB/s at n 216, batch 4096), but no block holds an
//     env's triangle, so five blocks (twenty envs) share an SM. Streaming
//     16- or 32-byte pieces of each row straight from global memory read
//     slower (DRAM served those scattered sectors well below its rate),
//     and so did a forward sweep by column strips (PERF.md section 6).
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
// Rows 14, 15 and 17 divide by L[k][k] where the plain versions do; row 16
// multiplies by 1 / L[k][k] (rounded once), shortening its panels' chains.

#include <type_traits>

#include "cholesky.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kNb = 16;       // rows 14 and 17: panel width (a multiple of 4)
constexpr int kMultiNb = 12;  // row 16: panel height
constexpr int kMultiU = 7;    // row 16: rows a lane (n <= 32 kMultiU)
constexpr int kPhases = 4;    // ops/cholesky.PHASES
constexpr int kMaxN = 512;    // rows 14 and 15
constexpr int kSmemRows = 256;  // row 14: the triangle in shared memory
constexpr int kWarpEnvs = 4;  // rows 14 (n <= 32) and 15: warps (envs) a block
constexpr int kPitch = 36;    // n <= 32: a staged row's floats (16-byte rows;
                              // lanes on rows or on columns hit no conflict)

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

// The same for a warp an env (lane 0; the warp has synchronised).
#define WARP_PHASE(i)                   \
  do {                                  \
    if constexpr (kClock) {             \
      __syncwarp();                     \
      if (lane == 0) {                  \
        const long long c_ = clock64(); \
        ph[i] += c_ - c_last;           \
        c_last = c_;                    \
      }                                 \
    }                                   \
  } while (0)

// The rows of the triangle a factor works on: packed by rows in shared
// memory (cholesky.cuh row_off), or a row-major workspace in global memory
// whose rows are padded to a multiple of 4 floats (ld). Either way each
// row starts 16-byte aligned.
struct PackedRows {
  float* S;
  __device__ __forceinline__ float* row(int i) const { return S + row_off(i); }
};

struct PitchRows {
  float* W;
  int ld;
  __device__ __forceinline__ float* row(int i) const {
    return W + (size_t)i * ld;
  }
};

// ------------------------------------------------------------ rows 14, 17

// Shared floats of chol_solve_kernel: the mbarrier (4), the triangle, v
// (pad4(n)) and the panel's rsqrt pivots (kNb).
__host__ __device__ __forceinline__ size_t cs_floats(int n) {
  return 4 + (size_t)row_off(n) + pad4(n) + kNb;
}

// Partial sum (0-3) of the term j of entry (i, k) in the first design's
// order: j mod 4 below 4 (k / 4), partial 0 from there up to k. kc = k -
// k0, jc = j - k0, with k0 a multiple of 4.
__host__ __device__ constexpr int part_of(int jc, int kc) {
  return jc < 4 * (kc / 4) ? jc & 3 : 0;
}

// An entry (i, k) of the panel: its A value less the combined partial sums.
__device__ __forceinline__ float entry(float a, const float* p) {
  return a - ((p[0] + p[1]) + (p[2] + p[3]));
}

// Rows 14 and 17: the partial sums p of row i = k0 + t over the columns
// left of the panel k0 (term j in partial j mod 4), for the panel's kb
// columns. Thread pair (t, t ^ 1) forms rows i0 = k0 + (t & ~1) and i0 + 1
// together, each thread over half the panel's columns (h = t & 1: columns
// 8 h .. 8 h + 7), so a broadcast load of a panel row serves two rows (own
// rows by 16-byte loads, panel rows by broadcast 16-byte loads); then the
// pair swaps halves by shuffles. Zeros for i >= n. Every thread of the
// warp calls it.
template <class R>
__device__ __forceinline__ void left_sums2(const R& T, float (&p)[kNb][4],
                                           int k0, int kb, int i, int n) {
  constexpr int kH = kNb / 2;
  const int h = threadIdx.x & 1, i0 = i - h;
  float q0[kH][4], q1[kH][4];
#pragma unroll
  for (int c = 0; c < kH; ++c)
#pragma unroll
    for (int m = 0; m < 4; ++m) q0[c][m] = q1[c][m] = 0.f;
  if (i0 < n) {
    const float* own0 = T.row(i0);
    const float* own1 = T.row(min(i0 + 1, n - 1));
    for (int j = 0; j < k0; j += 4) {
      const float4 a = *reinterpret_cast<const float4*>(own0 + j);
      const float4 b = *reinterpret_cast<const float4*>(own1 + j);
#pragma unroll
      for (int c = 0; c < kH; ++c) {
        if (kH * h + c < kb) {
          const float4 l =
              *reinterpret_cast<const float4*>(T.row(k0 + kH * h + c) + j);
          q0[c][0] = fmaf(a.x, l.x, q0[c][0]);
          q0[c][1] = fmaf(a.y, l.y, q0[c][1]);
          q0[c][2] = fmaf(a.z, l.z, q0[c][2]);
          q0[c][3] = fmaf(a.w, l.w, q0[c][3]);
          q1[c][0] = fmaf(b.x, l.x, q1[c][0]);
          q1[c][1] = fmaf(b.y, l.y, q1[c][1]);
          q1[c][2] = fmaf(b.z, l.z, q1[c][2]);
          q1[c][3] = fmaf(b.w, l.w, q1[c][3]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kH; ++c)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float got = __shfl_xor_sync(kAllLanes, h ? q0[c][m] : q1[c][m], 1);
      p[c][m] = h ? got : q0[c][m];
      p[kH + c][m] = h ? q1[c][m] : got;
    }
}

// Warp 0: the diagonal block of rows and columns k0..k0+kb-1 (lane r holds
// row k0 + r: its A values in a, its partial sums over the columns left of
// the panel in p). Column by column: each entry (r, c) adds the terms of
// the block's columns left of c (row c's from lane c) to its partial sums;
// the pivot rsqrt(max(d, 1e-30)) scales the column below it and the
// diagonal becomes d rsqrt(d). Writes the rows back and the pivots' rsqrt
// to inv; kSolve (row 17) also solves the block's rows of L y = b: v[k0 +
// r] <- y, y_c = r_c / L[c][c] (their terms from the rows above the block
// were subtracted before).
template <bool kFull, bool kSolve, class R>
__device__ __forceinline__ void diag_block(const R& T, float* v, float* inv,
                                           float (&p)[kNb][4], int k0,
                                           int kb) {
  if constexpr (kFull) kb = kNb;
  const int r = threadIdx.x & 31;
  const bool on = r < kb;
  float* row = T.row(k0 + (on ? r : 0)) + k0;
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
  if constexpr (kSolve) {
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
}

// A row i below the diagonal block of the full panel k0 (p: its partial
// sums over the columns left of the panel): column by column, its entry
// adds the terms of the panel's columns left of c (row k0 + c, broadcast)
// and takes the pivot; kSolve (row 17): then its forward-substitution terms
// v[i] -= L[i][k0+c] y[k0+c] in column order.
template <bool kSolve, class R>
__device__ __forceinline__ void panel_row(const R& T, float* v,
                                          const float* inv,
                                          float (&p)[kNb][4], int k0, int i) {
  float4* row4 = reinterpret_cast<float4*>(T.row(i) + k0);
  float a[kNb];
#pragma unroll
  for (int g = 0; g < kNb / 4; ++g) {
    const float4 q = row4[g];
    a[4 * g] = q.x, a[4 * g + 1] = q.y, a[4 * g + 2] = q.z, a[4 * g + 3] = q.w;
  }
#pragma unroll
  for (int c = 0; c < kNb; ++c) {
    const float4* l4 = reinterpret_cast<const float4*>(T.row(k0 + c) + k0);
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
  if constexpr (kSolve) {
    float y = v[i];
#pragma unroll
    for (int c = 0; c < kNb; ++c) y = fmaf(-a[c], v[k0 + c], y);
    v[i] = y;
  }
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
  const PackedRows T{S};

  rows_load(A + e * n * n, b + e * n, S, v, n, bar);
  PHASE(0);

  // ---- Factor and forward substitution, a panel at a time: thread t
  // holds row k0 + t's partial sums over the columns left of the panel.
  for (int k0 = 0; k0 < n; k0 += kNb) {
    const int kb = min(kNb, n - k0), i = k0 + t;
    float p[kNb][4];
    left_sums2(T, p, k0, kb, i, n);
    if (w == 0) {
      if (kb == kNb) diag_block<true, true>(T, v, inv, p, k0, kb);
      else diag_block<false, true>(T, v, inv, p, k0, kb);
    }
    __syncthreads();
    if (kb == kNb && t >= kNb && i < n) panel_row<true>(T, v, inv, p, k0, i);
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

// Row 14 at 32 < n <= 512: chol_solve_kernel's factor without b, kT
// threads; the rows past kT below a panel go in further passes of the
// same threads. kGlobal: the triangle in the workspace W (n > 256, where
// it does not fit in shared memory; rows padded to pad4(n)), else packed
// by rows in shared memory.
template <int kT, bool kGlobal, bool kClock>
__global__ void __launch_bounds__(kT, kT == 32 ? 16 : 2)
    chol_panel_kernel(const float* __restrict__ A, float* __restrict__ L,
                      float* W, int n, Clk ck) {
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const size_t e = blockIdx.x;
  long long ph[kPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  const float* Ae = A + e * n * n;
  float* Le = L + e * n * n;
  float* inv = sm + 4;  // after the mbarrier
  using Rows = std::conditional_t<kGlobal, PitchRows, PackedRows>;
  Rows T;
  if constexpr (kGlobal) {  // a warp a row
    T = PitchRows{W + e * n * pad4(n), pad4(n)};
    for (int i = w; i < n; i += kT / 32)
      for (int j = lane; j <= i; j += 32) T.row(i)[j] = Ae[(size_t)i * n + j];
    __syncthreads();
  } else {
    T = PackedRows{inv + kNb};
    rows_load(Ae, nullptr, T.S, nullptr, n, reinterpret_cast<uint64_t*>(sm));
  }
  PHASE(0);

  for (int k0 = 0; k0 < n; k0 += kNb) {
    const int kb = min(kNb, n - k0), i = k0 + t;
    float p[kNb][4];
    left_sums2(T, p, k0, kb, i, n);
    if (w == 0) {
      if (kb == kNb) diag_block<true, false>(T, nullptr, inv, p, k0, kb);
      else diag_block<false, false>(T, nullptr, inv, p, k0, kb);
    }
    __syncthreads();
    if (kb == kNb) {
      if (t >= kNb && i < n) panel_row<false>(T, nullptr, inv, p, k0, i);
      for (int base = k0 + kT; base < n; base += kT) {  // rows past kT
        left_sums2(T, p, k0, kb, base + t, n);
        if (base + t < n) panel_row<false>(T, nullptr, inv, p, k0, base + t);
      }
    }
    __syncthreads();
  }
  PHASE(1);
  PHASE(2);  // no substitution

  if constexpr (kGlobal) {
    for (int i = w; i < n; i += kT / 32)
      for (int j = lane; j < n; j += 32)
        Le[(size_t)i * n + j] = j <= i ? T.row(i)[j] : 0.f;
  } else {
    rows_store(T.S, Le, n);
  }
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

// --------------------------------------------------- rows 14, 15 at n <= 32

// Row i < n of the env's row-major (n, n) matrix M (global), columns j <=
// i, to St + kPitch i: lanes over columns, one coalesced load a row, eight
// rows' loads in flight before their stores. Ends with the warp
// synchronised.
__device__ __forceinline__ void warp_stage(const float* __restrict__ M,
                                           float* St, int n, int lane) {
  for (int i0 = 0; i0 < n; i0 += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u;
      v[u] = i < n && lane <= i ? M[(size_t)i * n + lane] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u;
      if (i < n && lane <= i) St[kPitch * i + lane] = v[u];
    }
  }
  __syncwarp();
}

// Lane r's row of the staged triangle, columns below `below` (zeros from
// there, and for rows at or past n): two 16-byte loads a quarter-warp
// cycle (the rows' starts kPitch apart spread the lanes over the banks).
__device__ __forceinline__ void staged_row(const float* St, int r, int below,
                                           int n, float (&a)[32]) {
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const float4 q = r < n ? reinterpret_cast<const float4*>(St + kPitch * r)[g]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float c[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) a[4 * g + u] = 4 * g + u < below ? c[u] : 0.f;
  }
}

// Row 14 at n <= 32: lane r holds row r; column k from the left: the
// entry adds its terms L[r][j] L[k][j] (row k's from lane k), takes the
// pivot from lane k, and lane k keeps d rsqrt(d). The rows go back through
// St to coalesced stores, zeros above the diagonal.
template <bool kClock>
__global__ void __launch_bounds__(32 * kWarpEnvs)
    chol_warp_kernel(const float* __restrict__ A, float* __restrict__ L,
                     int B, int n, Clk ck) {
  __shared__ __align__(16) float st[kWarpEnvs][32 * kPitch];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t e = (size_t)blockIdx.x * kWarpEnvs + w;
  if (e >= (size_t)B) return;
  long long ph[kPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  float* St = st[w];
  warp_stage(A + e * n * n, St, n, lane);
  float a[32];
  staged_row(St, lane, lane + 1, n, a);
  WARP_PHASE(0);

#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k < n) {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < k; ++j) {
        const float l = __shfl_sync(kAllLanes, a[j], k);
        p[part_of(j, k)] = fmaf(a[j], l, p[part_of(j, k)]);
      }
      const float ek = entry(a[k], p);
      const float d = __shfl_sync(kAllLanes, ek, k);
      const float s = rsqrtf(fmaxf(d, 1e-30f));
      if (lane == k) a[k] = d * s;
      else if (lane > k) a[k] = ek * s;
    }
  }
  WARP_PHASE(1);
  WARP_PHASE(2);  // no substitution

  if (lane < n) {
#pragma unroll
    for (int g = 0; g < 8; ++g)
      reinterpret_cast<float4*>(St + kPitch * lane)[g] =
          make_float4(a[4 * g], a[4 * g + 1], a[4 * g + 2], a[4 * g + 3]);
  }
  __syncwarp();
  float* Le = L + e * n * n;
  for (int i0 = 0; i0 < n; i0 += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = St[kPitch * min(i0 + u, 31) + lane];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u < n && lane < n) Le[(size_t)(i0 + u) * n + lane] = v[u];
  }
  WARP_PHASE(3);
  if constexpr (kClock) {
    if (lane == 0 && e % ck.stride == 0)
      for (int i = 0; i < kPhases; ++i)
        ck.clk[(e / ck.stride) * kPhases + i] += ph[i];
  }
}

// Row 15 at n <= 32: lane r holds row r of the staged triangle (the
// forward sweep's terms), then column r (the backward's; loaded after the
// forward sweep, so the two never hold registers together), and its
// running right-hand side; solved values go out by shuffles from their
// owners.
template <bool kClock>
__global__ void __launch_bounds__(32 * kWarpEnvs)
    cho_solve_warp32_kernel(const float* __restrict__ L,
                            const float* __restrict__ b,
                            float* __restrict__ x, int B, int n, Clk ck) {
  __shared__ __align__(16) float st[kWarpEnvs][32 * kPitch];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t e = (size_t)blockIdx.x * kWarpEnvs + w;
  if (e >= (size_t)B) return;
  long long ph[kPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  const bool on = lane < n;
  float r = on ? b[e * n + lane] : 0.f;
  float* St = st[w];
  warp_stage(L + e * n * n, St, n, lane);
  float row[32], col[32];
  staged_row(St, lane, lane, n, row);  // L[lane][k], k < lane
  const float dg = on ? St[kPitch * lane + lane] : 1.f;
  WARP_PHASE(0);

#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k < n) {
      float q = 0.f;
      if (lane == k) q = div_rn(r, dg);  // the owner alone divides
      const float y = __shfl_sync(kAllLanes, q, k);
      if (lane == k) r = y;
      else if (lane > k) r = fmaf(-row[k], y, r);
    }
  }
  WARP_PHASE(1);
#pragma unroll
  for (int k = 0; k < 32; ++k)  // L[k][lane], lane < k < n
    col[k] = k > lane && k < n ? St[kPitch * k + lane] : 0.f;
#pragma unroll
  for (int k = 31; k >= 0; --k) {
    if (k < n) {
      float q = 0.f;
      if (lane == k) q = div_rn(r, dg);
      const float xk = __shfl_sync(kAllLanes, q, k);
      if (lane == k) r = xk;
      else if (lane < k) r = fmaf(-col[k], xk, r);
    }
  }
  WARP_PHASE(2);
  if (on) x[e * n + lane] = r;
  WARP_PHASE(3);
  if constexpr (kClock) {
    if (lane == 0 && e % ck.stride == 0)
      for (int i = 0; i < kPhases; ++i)
        ck.clk[(e / ck.stride) * kPhases + i] += ph[i];
  }
}

// ------------------------------------------------------- row 15 at n > 32

// The env's L streams through two tile buffers (kTile x kTile, rows
// kTp floats apart) of the warp's shared memory, the next tile's
// asynchronous copies in flight while the lanes work on the current one.
constexpr int kTile = 32;
constexpr int kTp = 36;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for all but the lane's last committed group, then for the warp.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncwarp();
}

// Tile (u, v) of the env's L (rows 32 u.., columns 32 v..) into Tl: with
// vec, 16-byte chunks, a warp instruction four rows' 128 bytes; else
// elements, one row's at a time. Entries at or past n, and a diagonal
// tile's chunks wholly above its diagonal, are not copied.
__device__ __forceinline__ void tile_load(float* Tl,
                                          const float* __restrict__ Le,
                                          int n, int u, int v, int lane,
                                          bool vec) {
  const int r0 = kTile * u, c0 = kTile * v, above = u == v ? 0 : kTile;
  if (vec) {
    const int cc = 4 * (lane & 7);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int r = 4 * s + (lane >> 3);
      if (r0 + r < n && c0 + cc < n && cc <= r + above)
        cp_async16(Tl + kTp * r + cc, Le + (size_t)(r0 + r) * n + c0 + cc);
    }
  } else {
    for (int r = 0; r < kTile && r0 + r < n; ++r)
      if (c0 + lane < n && lane <= r + above)
        cp_async4(Tl + kTp * r + lane, Le + (size_t)(r0 + r) * n + c0 + lane);
  }
  cp_async_commit();
}

// Lane l's row of a staged tile, all 32 columns (two quarter-warp cycles a
// 16-byte load; the rows kTp floats apart spread the lanes over the banks).
__device__ __forceinline__ void tile_row(const float* Tl, int l,
                                         float (&a)[kTile]) {
#pragma unroll
  for (int g = 0; g < kTile / 4; ++g) {
    const float4 q = reinterpret_cast<const float4*>(Tl + kTp * l)[g];
    a[4 * g] = q.x, a[4 * g + 1] = q.y, a[4 * g + 2] = q.z, a[4 * g + 3] = q.w;
  }
}

// Forward, the diagonal tile of block U (kb = its columns below n): lane c
// divides r by its diagonal, y_c goes out by a shuffle, every lane below
// subtracts L[32 U + lane][32 U + c] y_c, c ascending; the block's y end
// in Ru.
__device__ __forceinline__ void fwd_diag(const float* Tl, float* Ru, int kb,
                                         int lane) {
  float a[kTile];
  tile_row(Tl, lane, a);
  const float d = Tl[kTp * lane + lane];
  float r = Ru[lane];
#pragma unroll
  for (int c = 0; c < kTile; ++c) {
    if (c < kb) {
      float q = 0.f;
      if (lane == c) q = div_rn(r, d);  // the owner alone divides
      const float y = __shfl_sync(kAllLanes, q, c);
      if (lane == c) r = y;
      else if (lane > c) r = fmaf(-a[c], y, r);
    }
  }
  Ru[lane] = r;
}

// Forward, a tile left of the diagonal (rows 32 u.., columns 32 v.., v <
// u, block v solved): row 32 u + lane subtracts L[..][32 v + c] y_c, c
// ascending, y_c broadcast from Rv.
__device__ __forceinline__ void fwd_left(const float* Tl, float* Ru,
                                         const float* Rv, int lane) {
  float a[kTile];
  tile_row(Tl, lane, a);
  float r = Ru[lane];
#pragma unroll
  for (int g = 0; g < kTile / 4; ++g) {
    const float4 y = reinterpret_cast<const float4*>(Rv)[g];
    r = fmaf(-a[4 * g], y.x, r);
    r = fmaf(-a[4 * g + 1], y.y, r);
    r = fmaf(-a[4 * g + 2], y.z, r);
    r = fmaf(-a[4 * g + 3], y.w, r);
  }
  Ru[lane] = r;
}

// Backward, the diagonal tile of block U: lane c divides, x_c goes out by a
// shuffle (and into x), every lane above subtracts L[32 U + c][32 U + lane]
// x_c (column lane of the tile), c descending.
__device__ __forceinline__ void back_diag(const float* Tl, float* Ru, int kb,
                                          int lane, float (&x)[kTile]) {
  float col[kTile];
#pragma unroll
  for (int c = 0; c < kTile; ++c) col[c] = Tl[kTp * c + lane];
  const float d = Tl[kTp * lane + lane];
  float r = Ru[lane];
#pragma unroll
  for (int c = kTile - 1; c >= 0; --c) {
    if (c < kb) {
      float q = 0.f;
      if (lane == c) q = div_rn(r, d);
      x[c] = __shfl_sync(kAllLanes, q, c);
      if (lane == c) r = x[c];
      else if (lane < c) r = fmaf(-col[c], x[c], r);
    }
  }
  Ru[lane] = r;
}

// Backward, a tile left of the diagonal (rows 32 U.., columns 32 v..):
// row 32 v + lane subtracts L[32 U + c][32 v + lane] x_c, c descending.
__device__ __forceinline__ void back_left(const float* Tl, float* Rv, int kb,
                                          int lane, const float (&x)[kTile]) {
  float r = Rv[lane];
#pragma unroll
  for (int c = kTile - 1; c >= 0; --c)
    if (c < kb) r = fmaf(-Tl[kTp * c + lane], x[c], r);
  Rv[lane] = r;
}

// Shared floats of a warp of cho_solve_tiles_kernel at nb = ceil(n / 32)
// blocks: two tiles and the running right-hand sides R (32 nb).
__host__ __device__ __forceinline__ int tiles_floats(int nb) {
  return 2 * kTile * kTp + kTile * nb;
}

// Row 15 at n > 32: a warp an env; lane l owns rows l + 32 u, their
// running right-hand sides in R. The tiles come in the sweeps' order, a
// row strip at a time: forward, for each row block u, (u, 0) .. (u, u);
// backward, for each U from the last, (U, U) and then (U, U - 1) .. (U,
// 0).
template <bool kClock>
__global__ void __launch_bounds__(32 * kWarpEnvs)
    cho_solve_tiles_kernel(const float* __restrict__ L,
                           const float* __restrict__ b, float* __restrict__ x,
                           int B, int n, Clk ck) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t e = (size_t)blockIdx.x * kWarpEnvs + w;
  if (e >= (size_t)B) return;
  long long ph[kPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  const int nb = (n + kTile - 1) / kTile;
  float* buf[2];
  buf[0] = sm + w * tiles_floats(nb);
  buf[1] = buf[0] + kTile * kTp;
  float* R = buf[1] + kTile * kTp;
  const float* Le = L + e * n * n;
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(L) & 15) == 0;
  for (int i = lane; i < n; i += 32) R[i] = b[e * n + i];
  tile_load(buf[0], Le, n, 0, 0, lane, vec);
  WARP_PHASE(0);

  float xs[kTile];  // backward: the diagonal block's solved values
  bool fwd = true;
  int u = 0, v = 0, cur = 0;
  for (;;) {
    // The next tile in the sweeps' order; its copies start now.
    int nu = u, nv = v;
    bool nfwd = fwd, more = true;
    if (fwd) {
      if (++nv > nu) {
        if (++nu < nb) nv = 0;
        else nfwd = false, nu = nv = nb - 1;
      }
    } else if (--nv < 0) {
      more = --nu >= 0;
      nv = nu;
    }
    if (more) tile_load(buf[cur ^ 1], Le, n, nu, nv, lane, vec);
    else cp_async_commit();
    cp_async_wait_prev();
    const float* Tl = buf[cur];
    if (fwd) {
      if (u == v) fwd_diag(Tl, R + kTile * u, min(kTile, n - kTile * u), lane);
      else fwd_left(Tl, R + kTile * u, R + kTile * v, lane);
      if (!nfwd) WARP_PHASE(1);
    } else {
      const int kb = min(kTile, n - kTile * u);
      if (u == v) back_diag(Tl, R + kTile * u, kb, lane, xs);
      else back_left(Tl, R + kTile * v, kb, lane, xs);
    }
    __syncwarp();  // the tile read and R written before the next tile
    if (!more) break;
    u = nu, v = nv, fwd = nfwd, cur ^= 1;
  }
  WARP_PHASE(2);
  for (int i = lane; i < n; i += 32) x[e * n + i] = R[i];
  WARP_PHASE(3);
  if constexpr (kClock) {
    if (lane == 0 && e % ck.stride == 0)
      for (int i = 0; i < kPhases; ++i)
        ck.clk[(e / ck.stride) * kPhases + i] += ph[i];
  }
}

// ------------------------------------------------------------- launches

// A kernel's resources (cholesky_info).
struct Info {
  cudaFuncAttributes fa;
  int blocks, grid;
  size_t smem;  // static and dynamic bytes a block
};

// Sets the launch's dynamic shared memory (smem bytes; above 48 KB only by
// the attribute) and asks for the SM's largest shared-memory carveout of
// its L1 (every kernel here stages in shared memory, and the default
// carveout may leave room for fewer blocks). Then fills *info (no launch)
// or launches.
template <typename K, typename... Args>
int launch(K kernel, int grid, int threads, size_t smem, void* stream,
           Info* info, Args... args) {
  if (smem > 232448) return -1;  // Hopper's shared memory per block
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && info) {
    info->grid = grid;
    err = cudaFuncGetAttributes(&info->fa, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info->blocks,
                                                          kernel, threads,
                                                          smem);
    info->smem = smem + info->fa.sharedSizeBytes;
    return (int)err;
  }
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// Each run function launches its row on B >= 1 envs, or with info only
// sizes it (the main instantiation). While g_clk is set, launches run the
// clock instantiations.
int chol_solve_run(const float* A, const float* b, float* L, float* x, int B,
                   int n, void* stream, Info* info) {
  if (n < 1 || n > kThreads) return -1;  // a thread a row
  const Clk ck{g_clk, g_clk_stride};
  auto kern = !info && g_clk ? chol_solve_kernel<true>
                             : chol_solve_kernel<false>;
  return launch(kern, B, kThreads, sizeof(float) * cs_floats(n), stream,
                info, A, b, L, x, n, ck);
}

// Row 16: 32 columns a block for m <= 32, else 64 (grid: B envs x chunks).
template <int kTC>
int multi_run(const float* L, const float* R, float* X, int B, int n, int m,
              void* stream, Info* info) {
  const int chunks = (m + 8 * kTC - 1) / (8 * kTC);
  const Clk ck{g_clk, g_clk_stride};
  auto kern = !info && g_clk ? cho_solve_multi_kernel<kTC, true>
                             : cho_solve_multi_kernel<kTC, false>;
  return launch(kern, B * chunks, kThreads,
                sizeof(float) * csm_floats(n, kTC), stream, info, L, R, X, n,
                m, chunks, ck);
}

int cho_solve_multi_run(const float* L, const float* R, float* X, int B,
                        int n, int m, void* stream, Info* info) {
  if (n < 1 || m < 1 || n > 32 * kMultiU) return -1;
  return m <= 32 ? multi_run<4>(L, R, X, B, n, m, stream, info)
                 : multi_run<8>(L, R, X, B, n, m, stream, info);
}

template <int kT, bool kGlobal>
int panel_run(const float* A, float* L, float* W, int B, int n, void* stream,
              Info* info) {
  const Clk ck{g_clk, g_clk_stride};
  auto kern = !info && g_clk ? chol_panel_kernel<kT, kGlobal, true>
                             : chol_panel_kernel<kT, kGlobal, false>;
  const size_t smem =
      sizeof(float) * (4 + kNb + (kGlobal ? 0 : row_off(n)));
  return launch(kern, B, kT, smem, stream, info, A, L, W, n, ck);
}

// Row 14: a warp an env at n <= 32, else a block an env (the triangle in
// shared memory at n <= 256, in W above).
int chol_run(const float* A, float* L, float* W, int B, int n, void* stream,
             Info* info) {
  if (n < 1 || n > kMaxN) return -1;
  if (n <= 32) {
    const Clk ck{g_clk, g_clk_stride};
    auto kern = !info && g_clk ? chol_warp_kernel<true>
                               : chol_warp_kernel<false>;
    return launch(kern, (B + kWarpEnvs - 1) / kWarpEnvs, 32 * kWarpEnvs, 0,
                  stream, info, A, L, B, n, ck);
  }
  if (n <= 128) return panel_run<32, false>(A, L, W, B, n, stream, info);
  if (n <= kSmemRows)
    return panel_run<kThreads, false>(A, L, W, B, n, stream, info);
  if (!info && !W) return -1;
  return panel_run<kThreads, true>(A, L, W, B, n, stream, info);
}

// Row 15: a warp an env, four a block; the triangle staged whole at n <=
// 32, else streamed by tiles.
int cho_solve_run(const float* L, const float* b, float* x, int B, int n,
                  void* stream, Info* info) {
  if (n < 1 || n > kMaxN) return -1;
  const Clk ck{g_clk, g_clk_stride};
  const int grid = (B + kWarpEnvs - 1) / kWarpEnvs;
  if (n <= 32) {
    auto kern = !info && g_clk ? cho_solve_warp32_kernel<true>
                               : cho_solve_warp32_kernel<false>;
    return launch(kern, grid, 32 * kWarpEnvs, 0, stream, info, L, b, x, B,
                  n, ck);
  }
  auto kern = !info && g_clk ? cho_solve_tiles_kernel<true>
                             : cho_solve_tiles_kernel<false>;
  const size_t smem =
      sizeof(float) * kWarpEnvs * tiles_floats((n + kTile - 1) / kTile);
  return launch(kern, grid, 32 * kWarpEnvs, smem, stream, info, L, b, x, B,
                n, ck);
}

}  // namespace

FB_API int chol_solve_f32(const float* A, const float* b, float* L, float* x,
                          int B, int n, void* stream) {
  if (B < 1) return -1;
  return chol_solve_run(A, b, L, x, B, n, stream, nullptr);
}

// W: a (B, n, pad4(n)) float32 workspace for n > 256, else null.
FB_API int chol_f32(const float* A, float* L, float* W, int B, int n,
                    void* stream) {
  if (B < 1) return -1;
  return chol_run(A, L, W, B, n, stream, nullptr);
}

FB_API int cho_solve_f32(const float* L, const float* b, float* x, int B,
                         int n, void* stream) {
  if (B < 1) return -1;
  return cho_solve_run(L, b, x, B, n, stream, nullptr);
}

FB_API int cho_solve_multi_f32(const float* L, const float* R, float* X, int B,
                               int n, int m, void* stream) {
  if (B < 1) return -1;
  return cho_solve_multi_run(L, R, X, B, n, m, stream, nullptr);
}

// Phase clocks: while clk is set, every launch of rows 14-17 runs its clock
// instantiation and adds the cycles of each phase (ops/cholesky.PHASES) of
// every stride-th env to clk ((ceil(B / stride), 4) int64; row 16 adds
// every chunk block of the env); nullptr turns it off.
FB_API int cholesky_phase_clock(long long* clk, int stride) {
  if (stride < 1) return -1;
  g_clk = clk, g_clk_stride = stride;
  return 0;
}

// Resources of row `row` (14-17) at n (row 16: m right-hand sides) for B
// envs: out = registers a thread, shared bytes a block, blocks an SM, grid.
FB_API int cholesky_info(int row, int B, int n, int m, int* out) {
  if (B < 1) return -1;
  Info info{};
  int rc = -1;
  if (row == 14) rc = chol_run(nullptr, nullptr, nullptr, B, n, nullptr, &info);
  if (row == 15)
    rc = cho_solve_run(nullptr, nullptr, nullptr, B, n, nullptr, &info);
  if (row == 16)
    rc = cho_solve_multi_run(nullptr, nullptr, nullptr, B, n, m, nullptr,
                             &info);
  if (row == 17)
    rc = chol_solve_run(nullptr, nullptr, nullptr, nullptr, B, n, nullptr,
                        &info);
  if (rc) return rc;
  out[0] = info.fa.numRegs;
  out[1] = (int)info.smem;
  out[2] = info.blocks;
  out[3] = info.grid;
  return 0;
}
