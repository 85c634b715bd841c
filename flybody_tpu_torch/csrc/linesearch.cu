// Row 13: the standalone exact Newton line search of the dense path.
//
// Replaces flybody_tpu/ops/linesearch.py::_ls_pallas (:229, the Pallas call
// at :235), reached through make_ls_pe on every Newton step of the dense
// solve. Per env: the limit rows lim (4, L) [jar0 | jv | active | D], the
// contact slots con (10, K) [jar0 xyz | jv xyz | mu | frictional | active
// | D] and sc (2) [sm0 | smm] -> alpha. Semantics: alpha_ref in
// flybody_tpu_torch/ops/linesearch.py (bracket doubling from 1, then
// guarded Newton/bisection on phi', fixed trip counts).
//
// What bounds it: bytes, and only barely: per env it reads 4L + 10K + 2
// floats (9.1 KB at L = 408, K = 64) and evaluates phi' ls_iters * 2 +
// expand_iters + 1 times (23 at the default preset), ~60 flops a slot
// each. The TPU kernel put 128 envs on the lanes; here one warp owns one
// env and every evaluation sums a lane's rows i = lane mod 32 in order,
// limit rows then contact slots, and the lanes by warp_sum, as the Newton
// kernels' inlined ls_alpha_warp does (linesearch.cuh), so alpha is that
// function's bit for bit.
//
// linesearch_kernel (K <= 64, L <= 512) stages each env once: the limit
// planes into shared memory by asynchronous copies, the lane's contact
// slots in registers with their alpha-independent cone constants (LsCon:
// 1 / max(mu, 1e-6), 1 + amu^2 and its inverse), and skips the limit rows
// that add +-0 at every step (ls_row_dead: most limit rows are inactive,
// lim_active = dist < margin; on the path's operands it keeps under 1%).
// Before it, each evaluation re-read the env's 9.1 KB from L2 and
// recomputed the cone constants. linesearch_rows_kernel, the first
// design (every row from global memory at every evaluation), takes the
// shapes off that tile.

#include "bulk.cuh"
#include "linesearch.cuh"

namespace {

constexpr int kWarps = 4;      // envs per block, a warp each
constexpr int kMaxSlots = 2;   // contact slots a lane in registers (K 64)
constexpr int kMaxRows = 16;   // limit rows a lane (L 512)
constexpr int kPhases = 4;     // ops/linesearch.PHASES

long long* g_clk = nullptr;  // host: where the clock instantiation adds
int g_clk_stride = 1;        // every stride-th env is recorded

struct LsArgs {
  const float *lim, *con, *sc;
  float* alpha;
  int B, L, K, expand_iters, ls_iters;
  long long* clk;  // clock instantiation: (ceil(B / stride), kPhases)
  int clk_stride;
};

__device__ __forceinline__ LsRows env_rows(const LsArgs& a, size_t e) {
  const int L = a.L, K = a.K;
  const float* l = a.lim + e * 4 * L;
  const float* c = a.con + e * 10 * K;
  LsRows r;
  r.jl = l, r.vl = l + L, r.al = l + 2 * L, r.Dl = l + 3 * L;
  r.n0 = c, r.t10 = c + K, r.t20 = c + 2 * K;
  r.v0 = c + 3 * K, r.v1 = c + 4 * K, r.v2 = c + 5 * K;
  r.mu = c + 6 * K, r.fric = c + 7 * K, r.act = c + 8 * K, r.D = c + 9 * K;
  r.L = L, r.K = K;
  return r;
}

// The first design: every evaluation reads the rows from global memory.
__global__ void __launch_bounds__(32 * kWarps)
    linesearch_rows_kernel(const __grid_constant__ LsArgs a) {
  const int lane = threadIdx.x & 31;
  const size_t e = (size_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (e >= (size_t)a.B) return;  // the whole warp leaves together
  const float al = ls_alpha_warp(env_rows(a, e), a.sc[2 * e],
                                 a.sc[2 * e + 1], a.expand_iters,
                                 a.ls_iters, lane);
  if (lane == 0) a.alpha[e] = al;
}

// Cycles since the last mark to phase i (lane 0, clock instantiation).
#define PHASE(i)                        \
  do {                                  \
    if constexpr (kClock) {             \
      const long long c_ = clock64();   \
      ph[i] += c_ - c_last;             \
      c_last = c_;                      \
    }                                   \
  } while (0)

// A warp an env, kWarps a block. Shared memory: each warp's limit planes
// (4, L) [jl | vl | al | Dl], copied once by 4-byte asynchronous copies;
// each lane keeps a mask of its live rows (bit q: row lane + 32 q) and its
// contact slots' LsCon in registers. kSlots: contact slots a lane.
template <bool kClock, int kSlots>
__global__ void __launch_bounds__(32 * kWarps, 6)
    linesearch_kernel(const __grid_constant__ LsArgs a) {
  extern __shared__ float planes_sm[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t e = (size_t)blockIdx.x * kWarps + w;
  if (e >= (size_t)a.B) return;  // the whole warp leaves together
  long long ph[kPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  const LsRows r = env_rows(a, e);
  const int L = a.L, K = a.K, nq = (L + 31) >> 5;
  float* P = planes_sm + (size_t)w * 4 * L;

  // ---- Stage-in: the planes in flight, the slots' constants meanwhile.
  for (int i = lane; i < 4 * L; i += 32) cp_async4(P + i, r.jl + i);
  const float sm0 = a.sc[2 * e], smm = a.sc[2 * e + 1];
  LsCon cs[kSlots];
#pragma unroll
  for (int u = 0; u < kSlots; ++u)
    if (lane + 32 * u < K) cs[u] = ls_con(r, lane + 32 * u);
  cp_async_wait_all();
  __syncwarp();
  const float amax = ldexpf(1.f, a.expand_iters);
  unsigned live = 0;
  for (int q = 0; q < nq; ++q) {
    const int i = lane + 32 * q;
    if (i < L && !ls_row_dead(P[i], P[L + i], P[2 * L + i], P[3 * L + i],
                              amax))
      live |= 1u << q;
  }
  const int nmax = __reduce_max_sync(0xffffffffu, __popc(live));
  PHASE(0);

  // phi'(a) and phi''(a): the lane's live rows in order, then its slots,
  // then warp_sum, as ls_slope_curv.
  auto eval = [&](float at, float* slope, float* curv) {
    float s = 0.f, c = 0.f;
    unsigned mk = live;
    for (int t = 0; t < nmax; ++t)
      if (mk) {
        const int i = lane + 32 * (__ffs(mk) - 1);
        mk &= mk - 1;
        const LsLim v{P[i], P[L + i], P[2 * L + i], P[3 * L + i]};
        ls_add(ls_lim_term(v, at), s, c);
      }
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
      if (lane + 32 * u < K) ls_add(ls_con_term(opaque(cs[u]), at), s, c);
    s = warp_sum(s);
    c = warp_sum(c);
    *slope = sm0 + at * smm + s;
    *curv = fmaxf(smm + c, 1e-15f);
  };

  // ---- The search: ls_alpha_warp's steps.
  float s, c;
  float hi = 1.f;
  for (int it = 0; it < a.expand_iters; ++it) {
    eval(hi, &s, &c);
    if (s < 0.f) hi *= 2.f;
  }
  PHASE(1);
  float lo = 0.f;
  for (int it = 0; it < a.ls_iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    eval(mid, &s, &c);
    const float cand = mid - s / c;
    const float probe = (cand > lo && cand < hi) ? cand : mid;
    float sp;
    eval(probe, &sp, &c);
    if (sp < 0.f)
      lo = probe;
    else
      hi = probe;
  }
  PHASE(2);
  const float alpha = 0.5f * (lo + hi);
  eval(0.f, &s, &c);
  if (lane == 0) a.alpha[e] = s < 0.f ? alpha : 0.f;
  PHASE(3);
  if constexpr (kClock) {
    if (lane == 0 && e % a.clk_stride == 0)
      for (int i = 0; i < kPhases; ++i)
        a.clk[(e / a.clk_stride) * kPhases + i] += ph[i];
  }
}

// Whether linesearch_kernel takes these widths.
bool staged(int L, int K) {
  return K <= 32 * kMaxSlots && L <= 32 * kMaxRows;
}

size_t staged_smem(int L) { return sizeof(float) * 4 * kWarps * (size_t)L; }

template <bool kClock, int kSlots>
cudaError_t staged_launch(const LsArgs& a, void* stream, int* blocks) {
  auto kern = linesearch_kernel<kClock, kSlots>;
  const size_t smem = staged_smem(a.L);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                      32 * kWarps, smem);
  if (err != cudaSuccess || a.B < 1) return err;
  kern<<<(a.B + kWarps - 1) / kWarps, 32 * kWarps, smem,
         (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

// Launches (a.B >= 1) or only sizes (a.B 0) the staged instantiation.
cudaError_t staged_run(const LsArgs& a, void* stream, int* blocks,
                       cudaFuncAttributes* fa) {
  const bool one = a.K <= 32;
  if (fa)
    return cudaFuncGetAttributes(fa, one ? linesearch_kernel<false, 1>
                                         : linesearch_kernel<false, 2>);
  if (a.clk)
    return one ? staged_launch<true, 1>(a, stream, blocks)
               : staged_launch<true, 2>(a, stream, blocks);
  return one ? staged_launch<false, 1>(a, stream, blocks)
             : staged_launch<false, 2>(a, stream, blocks);
}

}  // namespace

FB_API int line_search_f32(const float* lim, const float* con, const float* sc,
                           float* alpha, int B, int L, int K, int expand_iters,
                           int ls_iters, void* stream) {
  if (B < 1 || L < 0 || K < 0 || expand_iters < 0 || ls_iters < 0) return -1;
  const LsArgs a{lim, con, sc, alpha, B, L, K, expand_iters, ls_iters,
                 g_clk, g_clk_stride};
  if (!staged(L, K)) {
    linesearch_rows_kernel<<<(B + kWarps - 1) / kWarps, 32 * kWarps, 0,
                             (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  int blocks = 0;
  return (int)staged_run(a, stream, &blocks, nullptr);
}

// Phase clocks: while clk is set, every staged line_search_f32 launch runs
// the clock instantiation and adds the cycles of each phase of every
// stride-th env to clk ((ceil(B / stride), kPhases) int64); nullptr turns
// it off.
FB_API int line_search_phase_clock(long long* clk, int stride) {
  if (stride < 1) return -1;
  g_clk = clk, g_clk_stride = stride;
  return 0;
}

// Resources of linesearch_kernel's main instantiation at these widths:
// registers a thread, shared bytes a block, blocks an SM, grid blocks
// for B envs; -1 off the staged tile.
FB_API int line_search_info(int B, int L, int K, int* out) {
  if (L < 0 || K < 0 || !staged(L, K)) return -1;
  const LsArgs a{nullptr, nullptr, nullptr, nullptr, 0, L, K, 0, 0,
                 nullptr, 1};
  cudaFuncAttributes fa;
  cudaError_t err = staged_run(a, nullptr, nullptr, &fa);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = staged_run(a, nullptr, &blocks, nullptr);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs, out[1] = (int)staged_smem(L);
  out[2] = blocks, out[3] = (B + kWarps - 1) / kWarps;
  return 0;
}
