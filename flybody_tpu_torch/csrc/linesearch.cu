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
// floats (9.1 KB at L = 408, K = 64) and evaluates phi' about 2 ls + 7
// times, ~60 flops a slot each. The TPU kernel put 128 envs on the lanes;
// here one warp owns one env and runs the search that the Newton kernels
// inline (ls_alpha_warp, linesearch.cuh), reading its rows straight from
// global memory (they stay in L1 across the evaluations).

#include "linesearch.cuh"

namespace {

constexpr int kWarps = 4;  // envs per block

__global__ void __launch_bounds__(32 * kWarps)
    linesearch_kernel(const float* __restrict__ lim,
                      const float* __restrict__ con,
                      const float* __restrict__ sc, float* __restrict__ alpha,
                      int B, int L, int K, int expand_iters, int ls_iters) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (e >= B) return;  // the whole warp leaves together
  const float* l = lim + (size_t)e * 4 * L;
  const float* c = con + (size_t)e * 10 * K;
  LsRows r;
  r.jl = l, r.vl = l + L, r.al = l + 2 * L, r.Dl = l + 3 * L;
  r.n0 = c, r.t10 = c + K, r.t20 = c + 2 * K;
  r.v0 = c + 3 * K, r.v1 = c + 4 * K, r.v2 = c + 5 * K;
  r.mu = c + 6 * K, r.fric = c + 7 * K, r.act = c + 8 * K, r.D = c + 9 * K;
  r.L = L, r.K = K;
  const float a = ls_alpha_warp(r, sc[2 * (size_t)e], sc[2 * (size_t)e + 1],
                                expand_iters, ls_iters, lane);
  if (lane == 0) alpha[e] = a;
}

}  // namespace

FB_API int line_search_f32(const float* lim, const float* con, const float* sc,
                           float* alpha, int B, int L, int K, int expand_iters,
                           int ls_iters, void* stream) {
  if (B < 1 || L < 0 || K < 0 || expand_iters < 0 || ls_iters < 0) return -1;
  linesearch_kernel<<<(B + kWarps - 1) / kWarps, 32 * kWarps, 0,
                      (cudaStream_t)stream>>>(lim, con, sc, alpha, B, L, K,
                                              expand_iters, ls_iters);
  return (int)cudaGetLastError();
}
