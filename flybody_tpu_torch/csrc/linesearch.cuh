// The exact Newton line search as a warp-level device function, the
// counterpart of flybody_tpu/ops/linesearch.py::search_planes (:130),
// which the TPU's Newton kernels inline. Semantics: alpha_ref in
// flybody_tpu_torch/ops/linesearch.py: bracket doubling from a = 1
// (expand steps), then ls_iters rounds of a guarded Newton probe on phi'
// with bisection, fixed trip counts.
//
// One warp runs the whole search: each evaluation of phi'(a) and phi''(a)
// strides the limit rows and contact slots over the 32 lanes and sums
// them with a butterfly reduction, so every lane holds the same totals
// and takes the same branches without a block barrier.
#pragma once

#include "common.cuh"

// The alpha-independent precomputes of one env, in shared memory.
struct LsRows {
  const float *jl, *vl, *al, *Dl;   // L limit rows: jar0, jv, active, D
  const float *n0, *t10, *t20;      // K contact slots: jar0 (normal, t1, t2)
  const float *v0, *v1, *v2;        // jv (normal, t1, t2)
  const float *mu, *fric, *act, *D;
  int L, K;
};

__device__ __forceinline__ void ls_slope_curv(const LsRows& r, float a,
                                              float sm0, float smm, int lane,
                                              float* slope, float* curv) {
  float s = 0.f, c = 0.f;
  for (int i = lane; i < r.L; i += 32) {
    const float jar = r.jl[i] + a * r.vl[i];
    const float act = jar < 0.f ? r.al[i] : 0.f;
    const float f = -r.Dl[i] * jar * act;
    s -= f * r.vl[i];
    c += r.Dl[i] * act * r.vl[i] * r.vl[i];
  }
  for (int k = lane; k < r.K; k += 32) {
    const float v0 = r.v0[k], v1 = r.v1[k], v2 = r.v2[k];
    const float N = r.n0[k] + a * v0;
    const float y1 = r.t10[k] + a * v1;
    const float y2 = r.t20[k] + a * v2;
    const float mu = r.mu[k];
    const float T = sqrtf(y1 * y1 + y2 * y2);
    const float amu = 1.f / fmaxf(mu, 1e-6f);
    const float safeT = fmaxf(T, 1e-15f);
    const float w = (N + amu * T) / (1.f + amu * amu);
    const bool top = N >= mu * T;
    const bool bottom = mu * N + T <= 0.f;
    const float coef = 1.f - amu * w / safeT;
    float r0 = bottom ? N : N - w;
    float r1 = bottom ? y1 : y1 * coef;
    float r2 = bottom ? y2 : y2 * coef;
    if (top) r0 = r1 = r2 = 0.f;
    const bool fp = r.fric[k] > 0.f;
    if (!fp) {
      r0 = fminf(N, 0.f);
      r1 = r2 = 0.f;
    }
    const float Da = r.D[k] * r.act[k];
    s += Da * (r0 * v0 + r1 * v1 + r2 * v2);
    const float yv = (y1 / safeT) * v1 + (y2 / safeT) * v2;
    const float vt2 = v1 * v1 + v2 * v2;
    const float cc = 1.f / (1.f + amu * amu);
    const float qdP = cc * v0 * v0 + 2.f * amu * cc * v0 * yv +
                      amu * amu * cc * yv * yv +
                      (amu * w / safeT) * (vt2 - yv * yv);
    float q = bottom ? v0 * v0 + vt2 : v0 * v0 + vt2 - qdP;
    if (top) q = 0.f;
    if (!fp) q = N < 0.f ? v0 * v0 : 0.f;
    c += Da * q;
  }
  s = warp_sum(s);
  c = warp_sum(c);
  *slope = sm0 + a * smm + s;
  *curv = fmaxf(smm + c, 1e-15f);
}

// Step size along the direction; every lane of the calling warp returns it.
__device__ __forceinline__ float ls_alpha_warp(const LsRows& r, float sm0,
                                               float smm, int expand_iters,
                                               int ls_iters, int lane) {
  float s, c;
  float hi = 1.f;
  for (int e = 0; e < expand_iters; ++e) {
    ls_slope_curv(r, hi, sm0, smm, lane, &s, &c);
    if (s < 0.f) hi *= 2.f;
  }
  float lo = 0.f;
  for (int it = 0; it < ls_iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    ls_slope_curv(r, mid, sm0, smm, lane, &s, &c);
    const float cand = mid - s / c;
    const float probe = (cand > lo && cand < hi) ? cand : mid;
    float sp;
    ls_slope_curv(r, probe, sm0, smm, lane, &sp, &c);
    if (sp < 0.f)
      lo = probe;
    else
      hi = probe;
  }
  const float alpha = 0.5f * (lo + hi);
  ls_slope_curv(r, 0.f, sm0, smm, lane, &s, &c);
  return s < 0.f ? alpha : 0.f;
}
