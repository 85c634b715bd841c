// The exact Newton line search as a warp-level device function, the
// counterpart of flybody_tpu/ops/linesearch.py::search_planes (:130),
// which the TPU's Newton kernels inline. Semantics: alpha_ref in
// flybody_tpu_torch/ops/linesearch.py: bracket doubling from a = 1
// (expand steps), then ls_iters rounds of a guarded Newton probe on phi'
// with bisection, fixed trip counts.
//
// ls_alpha_warp runs the whole search on one warp: each evaluation of
// phi'(a) and phi''(a) strides the limit rows and contact slots over the
// 32 lanes and sums them with a butterfly reduction, so every lane holds
// the same totals and takes the same branches without a block barrier.
// ls_alpha_split (the Newton kernels) computes each evaluation's terms
// over the whole block and sums them as ls_alpha_warp does.
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

// One limit row's and one contact slot's operands (with the slot's
// alpha-independent cone constants), and their terms in phi'(a) and
// phi''(a) as the products the sums take: s += ms xs, c += mc xc.
struct LsLim {
  float jl, vl, al, Dl;
};
struct LsCon {
  float n0, t10, t20, v0, v1, v2, mu, fric, Da;
  float amu, den, cc;  // 1 / max(mu, 1e-6), 1 + amu^2, 1 / den
};
struct LsTerm {
  float ms, xs, mc, xc;
};

__device__ __forceinline__ LsLim ls_lim(const LsRows& r, int i) {
  return LsLim{r.jl[i], r.vl[i], r.al[i], r.Dl[i]};
}

__device__ __forceinline__ LsCon ls_con(const LsRows& r, int k) {
  const float amu = 1.f / fmaxf(r.mu[k], 1e-6f);
  const float den = 1.f + amu * amu;
  return LsCon{r.n0[k], r.t10[k],  r.t20[k], r.v0[k], r.v1[k],
               r.v2[k], r.mu[k],   r.fric[k], r.D[k] * r.act[k],
               amu,     den,       1.f / den};
}

__device__ __forceinline__ LsTerm ls_lim_term(const LsLim& l, float a) {
  const float jar = l.jl + a * l.vl;
  const float act = jar < 0.f ? l.al : 0.f;
  const float f = -l.Dl * jar * act;
  return LsTerm{-f, l.vl, l.Dl * act * l.vl, l.vl};
}

__device__ __forceinline__ void ls_add(const LsTerm& u, float& s, float& c) {
  s += u.ms * u.xs;
  c += u.mc * u.xc;
}

__device__ __forceinline__ LsTerm ls_con_term(const LsCon& k, float a) {
  const float v0 = k.v0, v1 = k.v1, v2 = k.v2;
  const float N = k.n0 + a * v0;
  const float y1 = k.t10 + a * v1;
  const float y2 = k.t20 + a * v2;
  const float mu = k.mu;
  const float T = sqrtf(y1 * y1 + y2 * y2);
  const float amu = k.amu;
  const float safeT = fmaxf(T, 1e-15f);
  const float w = (N + amu * T) / k.den;
  const bool top = N >= mu * T;
  const bool bottom = mu * N + T <= 0.f;
  const float coef = 1.f - amu * w / safeT;
  float r0 = bottom ? N : N - w;
  float r1 = bottom ? y1 : y1 * coef;
  float r2 = bottom ? y2 : y2 * coef;
  if (top) r0 = r1 = r2 = 0.f;
  const bool fp = k.fric > 0.f;
  if (!fp) {
    r0 = fminf(N, 0.f);
    r1 = r2 = 0.f;
  }
  const float Da = k.Da;
  const float dot = r0 * v0 + r1 * v1 + r2 * v2;
  const float yv = (y1 / safeT) * v1 + (y2 / safeT) * v2;
  const float vt2 = v1 * v1 + v2 * v2;
  const float cc = k.cc;
  const float qdP = cc * v0 * v0 + 2.f * amu * cc * v0 * yv +
                    amu * amu * cc * yv * yv +
                    (amu * w / safeT) * (vt2 - yv * yv);
  float q = bottom ? v0 * v0 + vt2 : v0 * v0 + vt2 - qdP;
  if (top) q = 0.f;
  if (!fp) q = N < 0.f ? v0 * v0 : 0.f;
  return LsTerm{Da, dot, Da, q};
}

__device__ __forceinline__ void ls_slope_curv(const LsRows& r, float a,
                                              float sm0, float smm, int lane,
                                              float* slope, float* curv) {
  float s = 0.f, c = 0.f;
  for (int i = lane; i < r.L; i += 32)
    ls_add(ls_lim_term(ls_lim(r, i), a), s, c);
  for (int k = lane; k < r.K; k += 32)
    ls_add(ls_con_term(ls_con(r, k), a), s, c);
  s = warp_sum(s);
  c = warp_sum(c);
  *slope = sm0 + a * smm + s;
  *curv = fmaxf(smm + c, 1e-15f);
}

// Whether a limit row adds +-0 to both of the lane's sums at every step a
// of the search (0 <= a <= amax = 2^expand_iters: hi doubles at most that
// often from 1 and every probe lies in [lo, hi]): its weight al Dl is
// zero, every operand is finite, and no product of ls_lim_term can
// overflow (|jar| <= |jl| + amax |vl| and |Dl jar| stay far inside the
// float range), so -Dl jar act and Dl act jv are +-0 and so are the terms
// times jv. A running sum that is not -0 plus +-0 is itself; the sums
// start at +0 and reach -0 only by underflowing, and a zero sum's sign
// changes no comparison and no step. A row with a non-finite operand
// stays, so NaN and infinities propagate as before.
__device__ __forceinline__ bool ls_row_dead(float jl, float vl, float al,
                                            float Dl, float amax) {
  if (!(al == 0.f || Dl == 0.f)) return false;
  const float jar = fabsf(jl) + amax * fabsf(vl);
  return jar <= 1e37f && fabsf(Dl) * jar <= 1e37f && fabsf(al) <= 1e37f;
}

// The slot's staged constants as values the compiler cannot carry over
// from an earlier evaluation: without this it hoists the alpha-independent
// products of ls_con_term out of the search loop, and an add whose
// product was hoisted no longer fuses into the multiply-add the first
// design's evaluation forms (its last bits then differ on frictional
// slots).
__device__ __forceinline__ LsCon opaque(LsCon k) {
  asm volatile(""
               : "+f"(k.n0), "+f"(k.t10), "+f"(k.t20), "+f"(k.v0),
                 "+f"(k.v1), "+f"(k.v2), "+f"(k.mu), "+f"(k.fric),
                 "+f"(k.Da), "+f"(k.amu), "+f"(k.den), "+f"(k.cc));
  return k;
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

// The same search with the block computing each evaluation's terms: a
// thread a limit row (from the first thread) and a contact slot (from the
// last), their products' operands into `terms` (L + K float4), then warp 0
// sums them exactly as ls_alpha_warp's lanes do (the same products in the
// same order, a butterfly), so the step is that function's bit for bit;
// `red` (2 floats) hands the sums to the block. Every thread calls it and
// gets the step.
__device__ __forceinline__ float ls_alpha_split(const LsRows& r, float sm0,
                                                float smm, int expand_iters,
                                                int ls_iters, float4* terms,
                                                float* red) {
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31;
  auto eval = [&](float a, float* slope, float* curv) {
    for (int i = t; i < r.L; i += nt) {
      const LsTerm u = ls_lim_term(ls_lim(r, i), a);
      terms[i] = make_float4(u.ms, u.xs, u.mc, u.xc);
    }
    for (int k = nt - 1 - t; k < r.K; k += nt) {
      const LsTerm u = ls_con_term(ls_con(r, k), a);
      terms[r.L + k] = make_float4(u.ms, u.xs, u.mc, u.xc);
    }
    __syncthreads();
    if (t < 32) {
      float s = 0.f, c = 0.f;
      auto add = [&](int q) {
        const float4 u = terms[q];
        ls_add(LsTerm{u.x, u.y, u.z, u.w}, s, c);
      };
#pragma unroll 8
      for (int i = lane; i < r.L; i += 32) add(i);
#pragma unroll 2
      for (int k = lane; k < r.K; k += 32) add(r.L + k);
      s = warp_sum(s);
      c = warp_sum(c);
      if (lane == 0) {
        red[0] = sm0 + a * smm + s;
        red[1] = fmaxf(smm + c, 1e-15f);
      }
    }
    __syncthreads();
    *slope = red[0];
    *curv = red[1];
  };
  float s, c;
  float hi = 1.f;
  for (int e = 0; e < expand_iters; ++e) {
    eval(hi, &s, &c);
    if (s < 0.f) hi *= 2.f;
  }
  float lo = 0.f;
  for (int it = 0; it < ls_iters; ++it) {
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
  const float alpha = 0.5f * (lo + hi);
  eval(0.f, &s, &c);
  return s < 0.f ? alpha : 0.f;
}
