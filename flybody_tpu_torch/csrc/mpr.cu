// Kernels 6 and 20: merged mixed-type MPR and per-type-pair MPR.
//
// Kernel 6 replaces flybody_tpu/ops/mpr_kernel.py::_mpr_merged_pallas
// (:360, the Pallas call at :371), kernel 20 _mpr_pallas (:334, the call
// at :344; make_mpr_pe). Semantics: mpr_merged_ref and mpr_pair_ref in
// flybody_tpu_torch/ops/mpr_kernel.py, i.e. physics/mpr.py's
// mpr_penetration, with per-pair type codes (merged) or with the pair's two
// types fixed and no smooth mask (per pair): margin-inflated supports,
// portal discovery (10 iterations), refinement (24), then `polish`
// projected-gradient steps on the contact normal, accepted on smooth
// (cylinder-free) pairs when they find a shallower separating direction.
// Trip counts are fixed and every update is masked by the done /
// separated / converged flags, as in the plain version (no early exit).
//
// The fixed-count float32 iteration carries rounding from step to step,
// so on a pair whose iteration is sensitive to it the kernel and its plain
// version may end on different portals (chip_smoke.py holds it per pair).
//
// What bounds it: operations. Per candidate it reads 35 floats and writes
// 7 (168 B) but evaluates the Minkowski support S(d) 3 + 10 + 24 +
// polish + 1 times (two geom supports each) with a few cross products per
// iteration. Design: one thread per (env, candidate); the portal (v0-v3),
// the witness sums s1-s3, both geoms' poses and the flags live in
// registers. One template holds both kernels: in the merged kernel the
// support is dispatched per geom with a switch on its type code, so a
// thread evaluates one support where the TPU evaluated all four and
// selected one (the same value); the per-pair kernel is an instantiation
// with both types fixed at compile time (the seven convex pairs of the
// walking model), so its supports carry no branch on the type.

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kDiscovery = 10;
constexpr int kRefine = 24;
constexpr float kEps = 1e-12f;
// MuJoCo geom types (model/spec.py); kAny: the type code is read per pair.
constexpr int kSphere = 2, kCapsule = 3, kEllipsoid = 4, kCylinder = 5;
constexpr int kAny = -1;

__device__ __forceinline__ V3 unit(V3 v) { return v / fmaxf(norm(v), kEps); }

struct Geom {
  V3 pos;
  M3 mat;
  V3 size;
  float margin;
  int type;
};

__device__ __forceinline__ V3 sphere_support(const Geom& g, V3 d) {
  return g.pos + g.size.x * d;
}

__device__ __forceinline__ V3 capsule_support(const Geom& g, V3 d) {
  const V3 dl = mul_t(g.mat, d);
  return g.pos + mul(g.mat, v3(0.f, 0.f, sgn(dl.z) * g.size.y)) + g.size.x * d;
}

__device__ __forceinline__ V3 cylinder_support(const Geom& g, V3 d) {
  const V3 dl = mul_t(g.mat, d);
  const float rn = sqrtf(dl.x * dl.x + dl.y * dl.y);
  float rx = 0.f, ry = 0.f;
  if (rn > 1e-10f) {
    const float c = fmaxf(rn, kEps);
    rx = dl.x / c;
    ry = dl.y / c;
  }
  const float r = g.size.x;
  return g.pos + mul(g.mat, v3(r * rx, r * ry, sgn(dl.z) * g.size.y));
}

__device__ __forceinline__ V3 ellipsoid_support(const Geom& g, V3 d) {
  const V3 dl = mul_t(g.mat, d);
  const V3 s = g.size;
  const V3 s2n = v3(s.x * s.x * dl.x, s.y * s.y * dl.y, s.z * s.z * dl.z);
  const float den = norm(v3(s.x * dl.x, s.y * dl.y, s.z * dl.z));
  return g.pos + mul(g.mat, s2n / fmaxf(den, kEps));
}

// World-frame support point in unit direction d (physics/mpr.py
// support_all) of a geom of type T, or for T = kAny of the geom's own type
// code: sphere, capsule, cylinder, or ellipsoid (any other code).
template <int T>
__device__ __forceinline__ V3 support(const Geom& g, V3 d) {
  if constexpr (T == kSphere) {
    return sphere_support(g, d);
  } else if constexpr (T == kCapsule) {
    return capsule_support(g, d);
  } else if constexpr (T == kCylinder) {
    return cylinder_support(g, d);
  } else if constexpr (T == kEllipsoid) {
    return ellipsoid_support(g, d);
  } else {
    switch (g.type) {
      case kSphere:
        return sphere_support(g, d);
      case kCapsule:
        return capsule_support(g, d);
      case kCylinder:
        return cylinder_support(g, d);
      default:
        return ellipsoid_support(g, d);
    }
  }
}

// Minkowski difference support and witness sum in direction d.
template <int T1, int T2>
__device__ __forceinline__ void S(const Geom& g1, const Geom& g2, V3 d, V3* v,
                                  V3* s) {
  const V3 a = support<T1>(g1, d) + g1.margin * d;
  const V3 b = support<T2>(g2, -d) - g2.margin * d;
  *v = a - b;
  *s = a + b;
}

// A pair's geom from its pose row c [pos | row-major mat] and its
// parameter row prm [size1 (3) | margin1 | size2 (3) | margin2 | type1 |
// type2 | smooth] (the per-pair kernel's rows stop after margin2); off 0
// for geom 1, 4 for geom 2.
template <int T>
__device__ __forceinline__ Geom load_geom(const float* c, const float* prm,
                                          int off) {
  Geom g;
  g.pos = ld3(c);
  g.mat = ld9(c + 3);
  g.size = ld3(prm + off);
  g.margin = prm[off + 3];
  g.type = T == kAny ? (int)lrintf(prm[8 + off / 4]) : T;
  return g;
}

// T1, T2: the pair's geom types, or kAny (the merged kernel: the types and
// the smooth flag come from each pair's parameter row of 11 floats). With
// fixed types the row has 8 floats and polish is accepted on every pair,
// as the TPU's per-pair kernel (no smooth mask).
template <int T1, int T2>
__global__ void __launch_bounds__(kThreads)
    mpr_kernel(const float* __restrict__ c1, const float* __restrict__ c2,
               const float* __restrict__ prm, float* __restrict__ dist_o,
               float* __restrict__ nrm_o, float* __restrict__ pos_o,
               int count, int polish) {
  constexpr bool kMerged = T1 == kAny;
  constexpr int kPrm = kMerged ? 11 : 8;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  const float* pr = prm + (size_t)t * kPrm;
  const Geom g1 = load_geom<T1>(c1 + (size_t)t * 12, pr, 0);
  const Geom g2 = load_geom<T2>(c2 + (size_t)t * 12, pr, 4);
  const bool smooth = kMerged ? pr[10] > 0.5f : true;

  V3 v0 = g1.pos - g2.pos;
  if (norm(v0) < 1e-10f) v0 = v3(1e-7f, 0.f, 0.f);
  V3 n = unit(-v0);
  V3 v1, s1, v2, s2, v3_, s3;
  S<T1, T2>(g1, g2, n, &v1, &s1);
  bool sep = dot(v1, n) <= 0.f;

  V3 n1 = cross(v1, v0);
  const bool degen = norm(n1) < 1e-14f;
  V3 alt = cross(v1 - v0, v3(1.0f, 0.013f, 0.021f));
  const V3 alt2 = cross(v1 - v0, v3(0.021f, 1.0f, 0.013f));
  if (norm(alt) < 1e-14f) alt = alt2;
  n1 = unit(degen ? alt : n1);
  S<T1, T2>(g1, g2, n1, &v2, &s2);
  sep = sep || dot(v2, n1) <= 0.f;

  V3 n2 = cross(v1 - v0, v2 - v0);
  if (dot(n2, v0) > 0.f) {
    const V3 tv = v1, ts = s1;
    v1 = v2;
    s1 = s2;
    v2 = tv;
    s2 = ts;
    n2 = -n2;
  }
  n2 = unit(n2);
  S<T1, T2>(g1, g2, n2, &v3_, &s3);
  sep = sep || dot(v3_, n2) <= 0.f;

  bool done = false;
#pragma unroll 1
  for (int it = 0; it < kDiscovery; ++it) {
    const bool out1 = dot(cross(v1, v3_), v0) < 0.f;
    const bool out2 = dot(cross(v3_, v2), v0) < 0.f;
    const bool act = !done && !sep;
    const bool rep2 = act && out1;
    const bool rep1 = act && !out1 && out2;
    done = done || (act && !out1 && !out2);
    if (rep2) {
      v2 = v3_;
      s2 = s3;
    }
    if (rep1) {
      v1 = v3_;
      s1 = s3;
    }
    const V3 n_new = unit(rep2 ? cross(v1 - v0, v3_ - v0)
                               : cross(v3_ - v0, v2 - v0));
    V3 v3n, s3n;
    S<T1, T2>(g1, g2, n_new, &v3n, &s3n);
    const bool cont = rep1 || rep2;
    sep = sep || (cont && dot(v3n, n_new) <= 0.f);
    if (cont) {
      v3_ = v3n;
      s3 = s3n;
    }
  }

  bool conv = false;
  V3 best_n = v3(0.f, 0.f, 1.f);
  float best_depth = 0.f;
#pragma unroll 1
  for (int it = 0; it < kRefine; ++it) {
    const V3 nn = unit(cross(v2 - v1, v3_ - v1));
    V3 v4, s4;
    S<T1, T2>(g1, g2, nn, &v4, &s4);
    const float depth = dot(v1, nn);
    const float gap = dot(v4 - v3_, nn);
    if (!conv) {
      best_n = nn;
      best_depth = depth;
    }
    conv = conv || gap < 1e-10f;
    const float d1 = dot(cross(v4, v1), v0);
    const float d2 = dot(cross(v4, v2), v0);
    const float d3 = dot(cross(v4, v3_), v0);
    const bool rep_v1 = (d1 < 0.f && d2 < 0.f) || (d1 >= 0.f && d3 >= 0.f);
    const bool rep_v3 = d1 < 0.f && d2 >= 0.f;
    const bool rep_v2 = d1 >= 0.f && d3 < 0.f;
    if (!conv) {
      if (rep_v1) {
        v1 = v4;
        s1 = s4;
      }
      if (rep_v2) {
        v2 = v4;
        s2 = s4;
      }
      if (rep_v3) {
        v3_ = v4;
        s3 = s4;
      }
    }
  }
  n = best_n;
  float depth = best_depth;

  // Witness midpoint from the barycentric weights of the origin's
  // projection on the final portal.
  const V3 p = depth * n;
  const V3 area = cross(v2 - v1, v3_ - v1);
  float w1 = dot(cross(v2 - p, v3_ - p), area);
  float w2 = dot(cross(v3_ - p, v1 - p), area);
  float w3 = dot(cross(v1 - p, v2 - p), area);
  const float wsum = w1 + w2 + w3;
  if (fabsf(wsum) < 1e-20f) {
    w1 = 1.f;
    w2 = 0.f;
    w3 = 0.f;
  } else {
    w1 = w1 / wsum;
    w2 = w2 / wsum;
    w3 = w3 / wsum;
  }
  V3 pos = 0.5f * (w1 * s1 + w2 * s2 + w3 * s3);

  if (polish > 0) {
    const float scale =
        fmaxf(fmaxf(fmaxf(g1.size.x, g1.size.y), g1.size.z),
              fmaxf(fmaxf(g2.size.x, g2.size.y), g2.size.z));
    V3 u = n;
#pragma unroll 1
    for (int it = 0; it < polish; ++it) {
      V3 xd, unused;
      S<T1, T2>(g1, g2, u, &xd, &unused);
      const V3 grad = xd - dot(xd, u) * u;
      u = unit(u - (0.3f * grad) / scale);
    }
    V3 vp, sp;
    S<T1, T2>(g1, g2, u, &vp, &sp);
    const float depth_p = dot(vp, u);
    if (depth_p < depth && smooth) {
      n = u;
      depth = depth_p;
      pos = 0.5f * sp;
    }
  }

  dist_o[t] = sep ? 1.0f : (g1.margin + g2.margin) - depth;
  st3(nrm_o + 3 * (size_t)t, n);
  st3(pos_o + 3 * (size_t)t, sep ? v3(0.f, 0.f, 0.f) : pos);
}

template <int T1, int T2>
int launch(const float* c1, const float* c2, const float* prm, float* dist,
           float* normal, float* pos, int n, int polish, void* stream) {
  mpr_kernel<T1, T2><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(c1, c2, prm, dist, normal, pos,
                                               n, polish);
  return launch_status();
}

}  // namespace

FB_API int mpr_merged_f32(const float* c1, const float* c2, const float* prm,
                          float* dist, float* normal, float* pos, int n,
                          int polish, void* stream) {
  if (n < 1 || polish < 0) return -1;
  return launch<kAny, kAny>(c1, c2, prm, dist, normal, pos, n, polish,
                            stream);
}

// Kernel 20: the candidates of one type pair (type1 <= type2), prm rows of
// 8 floats. Returns -2 for a pair with no instantiation.
FB_API int mpr_pair_f32(int type1, int type2, const float* c1,
                        const float* c2, const float* prm, float* dist,
                        float* normal, float* pos, int n, int polish,
                        void* stream) {
  if (n < 1 || polish < 0) return -1;
  switch (type1 * 8 + type2) {
#define FB_MPR_PAIR(A, B) \
  case A * 8 + B:         \
    return launch<A, B>(c1, c2, prm, dist, normal, pos, n, polish, stream);
    FB_MPR_PAIR(kSphere, kEllipsoid)
    FB_MPR_PAIR(kSphere, kCylinder)
    FB_MPR_PAIR(kCapsule, kEllipsoid)
    FB_MPR_PAIR(kCapsule, kCylinder)
    FB_MPR_PAIR(kEllipsoid, kEllipsoid)
    FB_MPR_PAIR(kEllipsoid, kCylinder)
    FB_MPR_PAIR(kCylinder, kCylinder)
#undef FB_MPR_PAIR
    default:
      return -2;
  }
}
