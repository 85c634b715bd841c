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
// iteration. Design: one thread per candidate; the portal (v0-v3), the
// witness sums s1-s3, both geoms' poses and the flags live in registers.
// In the merged kernel (mpr_kernel<kAny, kAny>) the support is dispatched
// per geom with a switch on its type code, so a thread evaluates one
// support where the TPU evaluated all four and selected one (the same
// value). Its IEEE divisions and square roots stay as they were: its
// outputs feed the walk's stepping gates, which are lotteries over
// roundings, so its instructions stay those of its first design (the
// template keeps that design's fixed-type branches, which no launch
// instantiates, and its source).
//
// Kernel 20 (mpr_pair_kernel<T1, T2>) has both types fixed at compile time
// (the seven convex pairs of the walking model), so its supports carry no
// branch on the type, and it feeds no stepping gate (only the collision
// tools run it), so it rounds otherwise: its normalisations are one
// reciprocal square root (MUFU.RSQ) and three products where the merged
// kernel's are an IEEE square root and three IEEE divisions, each a
// sequence with a slow-path branch; a capsule's axis end is the frame's
// axis column times h. The clocks of the first design showed a thread's
// chain issue-bound (five or six blocks an SM, ~80 thousand cycles a
// candidate, ~2.4 times its latency alone) with refinement ~50% and
// discovery ~25% of it (PERF.md section 5), so fewer instructions, not more
// in flight, shorten it: two candidates a thread would add registers to a
// kernel whose warps already fill the issue slots. It runs at six blocks
// an SM (kPairBlocks).
//
// The merged kernel's lanes take its candidates in the order of their
// type-pair key (pair_key: both geoms' support branches and the smooth
// flag), stable, so that the lanes of a warp share one branch of each
// switch and one polish decision: the broadphase hands each env's top-P
// pairs in distance order, which mixes the walking model's seven type
// pairs in every warp. The order comes from a pre-pass (mpr_order_kernel:
// a stable counting sort of each window of kWindow candidates, written to
// `order`): on the walk state ~98% of the warps are then type-uniform (a
// sort of each block's own 128 candidates in shared memory left ~19%, and
// ran 1.5x slower). Each lane writes its results at its candidate's own
// index. Polish runs only on smooth pairs (elsewhere its result was never
// taken), its 8 steps fixed.

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kDiscovery = 10;
constexpr int kRefine = 24;
constexpr float kEps = 1e-12f;
// MuJoCo geom types (model/spec.py); kAny: the type code is read per pair.
constexpr int kSphere = 2, kCapsule = 3, kEllipsoid = 4, kCylinder = 5;
constexpr int kAny = -1;
constexpr int kKeys = 32;  // pair_key's range
constexpr int kOrderThreads = 1024, kOrderRounds = 8;
constexpr int kWindow = kOrderThreads * kOrderRounds;  // a pre-pass block's
constexpr int kPhases = 6;  // ops/mpr_kernel.PHASES (kernel 20's clock)
// Kernel 20's blocks an SM: its registers capped at 80 (six gained ~1-3%
// on 5-7 uncapped; seven spilled and lost, PERF.md section 6).
constexpr int kPairBlocks = 6;

// The support branch a type code takes (support<kAny>'s switch).
__device__ __forceinline__ int branch(int type) {
  return type == kSphere ? 0 : type == kCapsule ? 1 : type == kCylinder ? 2 : 3;
}

// A merged candidate's order key from its parameter row: both geoms'
// support branches and the smooth flag (ops/mpr_kernel.pair_keys).
__device__ __forceinline__ int pair_key(const float* pr) {
  return (branch((int)lrintf(pr[8])) * 4 + branch((int)lrintf(pr[9]))) * 2 +
         (pr[10] > 0.5f ? 1 : 0);
}

// Stable counting sort of a window's n <= R * NT items by key(i) in [0,
// kKeys), by the NT threads of a block: out[rank] = base + i. Items are
// ranked by (key, i): i = r * NT + thread, so by (key, round, warp, lane).
// cnt: kKeys * R * NT / 32 ints, wsum: 32 ints of shared memory.
template <int NT, int R, typename KeyFn>
__device__ __forceinline__ void window_order(int n, KeyFn key, int* cnt,
                                             int* wsum, int* out, int base) {
  constexpr int NW = NT / 32;
  static_assert(kKeys * NW == NT, "each thread scans R counts");
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  for (int j = t; j < kKeys * R * NW; j += NT) cnt[j] = 0;
  __syncthreads();
  int k[R], rank[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * NT + t;
    k[r] = i < n ? key(i) : kKeys;
    const unsigned peers = __match_any_sync(0xffffffffu, k[r]);
    rank[r] = __popc(peers & ((1u << lane) - 1u));
    if (k[r] < kKeys && rank[r] == 0)
      cnt[(k[r] * R + r) * NW + w] = __popc(peers);
  }
  __syncthreads();
  // Exclusive scan of cnt in index order, R entries a thread.
  int loc[R], sum = 0;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    loc[q] = cnt[t * R + q];
    sum += loc[q];
  }
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int v = lane < NW ? wsum[lane] : 0;
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    if (lane < NW) wsum[lane] = inc - v;
  }
  __syncthreads();
  int at = wsum[w] + incl - sum;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    cnt[t * R + q] = at;
    at += loc[q];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (k[r] < kKeys)
      out[cnt[(k[r] * R + r) * NW + w] + rank[r]] = base + r * NT + t;
}

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
// the smooth flag come from each pair's parameter row of 11 floats; lane g
// takes candidate order[g]). With fixed types the row has 8 floats and
// polish is accepted on every pair, as the TPU's per-pair kernel (no
// smooth mask).
template <int T1, int T2>
__global__ void __launch_bounds__(kThreads)
    mpr_kernel(const float* __restrict__ c1, const float* __restrict__ c2,
               const float* __restrict__ prm, float* __restrict__ dist_o,
               float* __restrict__ nrm_o, float* __restrict__ pos_o,
               int count, int polish, const int* __restrict__ order) {
  constexpr bool kMerged = T1 == kAny;
  constexpr int kPrm = kMerged ? 11 : 8;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= count) return;
  const int t = kMerged ? order[g] : g;  // this lane's candidate
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

  if (polish > 0 && smooth) {
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

// Kernel 20's own code path: the supports and the normalisations of
// kernel 6 (above, whose instructions stay as they were) with fewer IEEE
// divisions and roots. v / max(|v|, kEps) becomes v * rsqrt(max(|v|^2,
// kEps^2)): one MUFU.RSQ and three products in place of an IEEE square
// root and three IEEE divisions, each a multi-instruction sequence with a
// slow-path branch (another rounding: kernel 20 feeds no stepping gate).
__device__ __forceinline__ V3 unit_fast(V3 v) {
  return v * rsqrtf(fmaxf(dot(v, v), kEps * kEps));
}

// The axis end from the axis column alone (three products in place of
// M (0, 0, h)).
__device__ __forceinline__ V3 capsule_support_fast(const Geom& g, V3 d) {
  const V3 a = col(g.mat, 2);
  return g.pos + a * (sgn(dot(a, d)) * g.size.y) + g.size.x * d;
}

__device__ __forceinline__ V3 cylinder_support_fast(const Geom& g, V3 d) {
  const V3 dl = mul_t(g.mat, d);
  const float q = dl.x * dl.x + dl.y * dl.y;
  const float inv = rsqrtf(q);
  const float rx = q > 1e-20f ? dl.x * inv : 0.f;
  const float ry = q > 1e-20f ? dl.y * inv : 0.f;
  const float r = g.size.x;
  return g.pos + mul(g.mat, v3(r * rx, r * ry, sgn(dl.z) * g.size.y));
}

__device__ __forceinline__ V3 ellipsoid_support_fast(const Geom& g, V3 d) {
  const V3 dl = mul_t(g.mat, d);
  const V3 s = g.size;
  const V3 s2n = v3(s.x * s.x * dl.x, s.y * s.y * dl.y, s.z * s.z * dl.z);
  const V3 sd = v3(s.x * dl.x, s.y * dl.y, s.z * dl.z);
  return g.pos + mul(g.mat, s2n * rsqrtf(fmaxf(dot(sd, sd), kEps * kEps)));
}

template <int T>
__device__ __forceinline__ V3 support_fast(const Geom& g, V3 d) {
  if constexpr (T == kSphere)
    return sphere_support(g, d);
  else if constexpr (T == kCapsule)
    return capsule_support_fast(g, d);
  else if constexpr (T == kCylinder)
    return cylinder_support_fast(g, d);
  else
    return ellipsoid_support_fast(g, d);
}

template <int T1, int T2>
__device__ __forceinline__ void S_fast(const Geom& g1, const Geom& g2, V3 d,
                                       V3* v, V3* s) {
  const V3 a = support_fast<T1>(g1, d) + g1.margin * d;
  const V3 b = support_fast<T2>(g2, -d) - g2.margin * d;
  *v = a - b;
  *s = a + b;
}

// Kernel 20's phase clocks (mpr_pair_phase_clock): where the clock
// instantiation adds, every d_clk_stride-th candidate; g_clk on the host.
__device__ long long* d_clk;
__device__ int d_clk_stride;
long long* g_clk = nullptr;

// Phase i of a candidate ends: its thread adds the cycles since the last
// mark to phase i (clock instantiation only).
#define PHASE(i)                        \
  do {                                  \
    if constexpr (kClock) {             \
      const long long c_ = clock64();   \
      ph[i] += c_ - c_last;             \
      c_last = c_;                      \
    }                                   \
  } while (0)

// Kernel 20: lane t takes candidate t of the type pair (T1, T2); the
// merged kernel's iteration with fixed types, no smooth mask and the fast
// supports and normalisations. kClock: the phase clocks of
// ops/mpr_kernel.PHASES, every d_clk_stride-th candidate's cycles added to
// d_clk[(t / d_clk_stride) * kPhases + phase].
template <int T1, int T2, bool kClock>
__global__ void __launch_bounds__(kThreads, kPairBlocks)
    mpr_pair_kernel(const float* __restrict__ c1,
                    const float* __restrict__ c2,
                    const float* __restrict__ prm, float* __restrict__ dist_o,
                    float* __restrict__ nrm_o, float* __restrict__ pos_o,
                    int count, int polish) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  long long ph[kPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  const float* pr = prm + (size_t)t * 8;
  const Geom g1 = load_geom<T1>(c1 + (size_t)t * 12, pr, 0);
  const Geom g2 = load_geom<T2>(c2 + (size_t)t * 12, pr, 4);

  V3 v0 = g1.pos - g2.pos;
  if (dot(v0, v0) < 1e-20f) v0 = v3(1e-7f, 0.f, 0.f);
  V3 n = unit_fast(-v0);
  V3 v1, s1, v2, s2, v3_, s3;
  S_fast<T1, T2>(g1, g2, n, &v1, &s1);
  bool sep = dot(v1, n) <= 0.f;

  V3 n1 = cross(v1, v0);
  const bool degen = dot(n1, n1) < 1e-28f;
  V3 alt = cross(v1 - v0, v3(1.0f, 0.013f, 0.021f));
  const V3 alt2 = cross(v1 - v0, v3(0.021f, 1.0f, 0.013f));
  if (dot(alt, alt) < 1e-28f) alt = alt2;
  n1 = unit_fast(degen ? alt : n1);
  S_fast<T1, T2>(g1, g2, n1, &v2, &s2);
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
  n2 = unit_fast(n2);
  S_fast<T1, T2>(g1, g2, n2, &v3_, &s3);
  sep = sep || dot(v3_, n2) <= 0.f;
  PHASE(0);

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
    const V3 n_new = unit_fast(rep2 ? cross(v1 - v0, v3_ - v0)
                                    : cross(v3_ - v0, v2 - v0));
    V3 v3n, s3n;
    S_fast<T1, T2>(g1, g2, n_new, &v3n, &s3n);
    const bool cont = rep1 || rep2;
    sep = sep || (cont && dot(v3n, n_new) <= 0.f);
    if (cont) {
      v3_ = v3n;
      s3 = s3n;
    }
  }
  PHASE(1);

  bool conv = false;
  V3 best_n = v3(0.f, 0.f, 1.f);
  float best_depth = 0.f;
#pragma unroll 1
  for (int it = 0; it < kRefine; ++it) {
    const V3 nn = unit_fast(cross(v2 - v1, v3_ - v1));
    V3 v4, s4;
    S_fast<T1, T2>(g1, g2, nn, &v4, &s4);
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
  PHASE(2);

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
    const float iw = 1.f / wsum;
    w1 = w1 * iw;
    w2 = w2 * iw;
    w3 = w3 * iw;
  }
  V3 pos = 0.5f * (w1 * s1 + w2 * s2 + w3 * s3);
  PHASE(3);

  if (polish > 0) {
    const float scale =
        fmaxf(fmaxf(fmaxf(g1.size.x, g1.size.y), g1.size.z),
              fmaxf(fmaxf(g2.size.x, g2.size.y), g2.size.z));
    const float step = 0.3f / scale;
    V3 u = n;
#pragma unroll 1
    for (int it = 0; it < polish; ++it) {
      V3 xd, unused;
      S_fast<T1, T2>(g1, g2, u, &xd, &unused);
      const V3 grad = xd - dot(xd, u) * u;
      u = unit_fast(u - grad * step);
    }
    V3 vp, sp;
    S_fast<T1, T2>(g1, g2, u, &vp, &sp);
    const float depth_p = dot(vp, u);
    if (depth_p < depth) {
      n = u;
      depth = depth_p;
      pos = 0.5f * sp;
    }
  }
  PHASE(4);

  dist_o[t] = sep ? 1.0f : (g1.margin + g2.margin) - depth;
  st3(nrm_o + 3 * (size_t)t, n);
  st3(pos_o + 3 * (size_t)t, sep ? v3(0.f, 0.f, 0.f) : pos);
  PHASE(5);
  if constexpr (kClock) {
    if (t % d_clk_stride == 0)
      for (int i = 0; i < kPhases; ++i)
        d_clk[(size_t)(t / d_clk_stride) * kPhases + i] += ph[i];
  }
}

// The pre-pass: `order` (count ints) takes each window of kWindow
// candidates in pair_key order.
__global__ void __launch_bounds__(kOrderThreads)
    mpr_order_kernel(const float* __restrict__ prm, int count,
                     int* __restrict__ order) {
  __shared__ int cnt[kKeys * kOrderRounds * (kOrderThreads / 32)], wsum[32];
  const int w0 = blockIdx.x * kWindow, n = min(kWindow, count - w0);
  window_order<kOrderThreads, kOrderRounds>(
      n, [&](int i) { return pair_key(prm + (size_t)(w0 + i) * 11); }, cnt,
      wsum, order + w0, w0);
}

int order_launch(const float* prm, int n, int* order, void* stream) {
  mpr_order_kernel<<<(n + kWindow - 1) / kWindow, kOrderThreads, 0,
                     (cudaStream_t)stream>>>(prm, n, order);
  return launch_status();
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// The C entries' switch over kernel 20's type pairs: F<T1, T2>() for the
// pair (type1, type2), -2 for a pair with no instantiation.
template <template <int, int> class F, typename... A>
int pair_dispatch(int type1, int type2, A... a) {
  switch (type1 * 8 + type2) {
#define FB_MPR_PAIR(T1, T2) \
  case T1 * 8 + T2:         \
    return F<T1, T2>::run(a...);
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

template <int T1, int T2>
struct PairLaunch {
  static int run(const float* c1, const float* c2, const float* prm,
                 float* dist, float* normal, float* pos, int n, int polish,
                 void* stream) {
    if (g_clk)
      mpr_pair_kernel<T1, T2, true>
          <<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
              c1, c2, prm, dist, normal, pos, n, polish);
    else
      mpr_pair_kernel<T1, T2, false>
          <<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
              c1, c2, prm, dist, normal, pos, n, polish);
    return launch_status();
  }
};

// Resources of a kernel: out = registers a thread, shared bytes a block,
// blocks an SM, grid blocks for n candidates.
template <typename K>
int kernel_info(K kernel, int n, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = blocks, out[3] = blocks_for(n);
  return 0;
}

template <int T1, int T2>
struct PairInfo {
  static int run(int n, int* out) {
    return kernel_info(mpr_pair_kernel<T1, T2, false>, n, out);
  }
};

}  // namespace

// Kernel 6: the pre-pass writes the lanes' order into `order` (n ints of
// scratch), then the main kernel runs.
FB_API int mpr_merged_f32(const float* c1, const float* c2, const float* prm,
                          float* dist, float* normal, float* pos, int n,
                          int polish, int* order, void* stream) {
  if (n < 1 || polish < 0 || !order) return -1;
  const int rc = order_launch(prm, n, order, stream);
  if (rc) return rc;
  mpr_kernel<kAny, kAny><<<blocks_for(n), kThreads, 0,
                           (cudaStream_t)stream>>>(c1, c2, prm, dist, normal,
                                                   pos, n, polish, order);
  return launch_status();
}

// Kernel 6's pre-pass alone (for its check against the plain order).
FB_API int mpr_order_f32(const float* prm, int n, int* order, void* stream) {
  if (n < 1) return -1;
  return order_launch(prm, n, order, stream);
}

// Resources of kernel 6's main kernel: out = registers a thread, shared
// bytes a block, blocks an SM, grid blocks for n candidates.
FB_API int mpr_merged_info(int n, int* out) {
  return kernel_info(mpr_kernel<kAny, kAny>, n, out);
}

// Kernel 20: the candidates of one type pair (type1 <= type2), prm rows of
// 8 floats. Returns -2 for a pair with no instantiation.
FB_API int mpr_pair_f32(int type1, int type2, const float* c1,
                        const float* c2, const float* prm, float* dist,
                        float* normal, float* pos, int n, int polish,
                        void* stream) {
  if (n < 1 || polish < 0) return -1;
  return pair_dispatch<PairLaunch>(type1, type2, c1, c2, prm, dist, normal,
                                   pos, n, polish, stream);
}

// Resources of kernel 20's kernel for a type pair: out = registers a
// thread, shared bytes a block, blocks an SM, grid blocks for n candidates.
FB_API int mpr_pair_info(int type1, int type2, int n, int* out) {
  if (n < 1) return -1;
  return pair_dispatch<PairInfo>(type1, type2, n, out);
}

// Kernel 20's phase clocks: while clk is set, every launch runs the clock
// instantiation and adds the cycles of each phase of every stride-th
// candidate to clk ((ceil(n / stride), kPhases) int64); nullptr turns it
// off.
FB_API int mpr_pair_phase_clock(long long* clk, int stride) {
  if (stride < 1) return -1;
  cudaError_t err = cudaMemcpyToSymbol(d_clk, &clk, sizeof(clk));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(d_clk_stride, &stride, sizeof(stride));
  if (err != cudaSuccess) return (int)err;
  g_clk = clk;
  return 0;
}
