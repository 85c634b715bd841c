// Kernel 5: the analytic narrowphase.
//
// Replaces flybody_tpu/ops/narrowphase.py::_np_pallas (:269, the Pallas
// call at :278). Semantics: narrowphase_ref in
// flybody_tpu_torch/ops/narrowphase.py, the per-type row formulas
// (plane-sphere, plane-capsule (2 rows), plane-ellipsoid, plane-cylinder
// (3 rows), sphere-sphere, sphere-capsule, capsule-capsule) in canonical
// pair-major slot order: a pair's rows land at slots first .. first + k - 1.
//
// What bounds it: bytes. Per env it reads the poses of the geoms its
// pairs name (12 floats each) and writes 7 floats per slot; the walking
// model's 115 pairs (174 slots) of the compact collide read 7.7 KB and
// write 4.9 KB; the dense collide's 1,154 pairs (1,213 slots, the
// capsule-capsule group's 1,039 pairs among them) write 34 KB. Design: one
// thread per (env, pair), pairs of one env on neighbouring threads. The
// pair table [type, geom1, geom2, first slot] is a small int array read
// through the read-only cache; each thread gathers by index only the pose
// and size entries its pair type's formulas read (a plane's normal, a
// capsule's axis: a column of the frame; the whole frame for an
// ellipsoid), 8-21 loads a thread where it issued 30, and since pairs
// are grouped by type, a warp takes one branch but at the seams of the
// type segments. The phase clocks of the first design
// put 80% of a thread's cycles in its gather (PERF.md section 5). A table
// that fits one block (the compact one) gives each env a block of its own
// (blockIdx.y), so that a block reads one env's poses; a wider one deals
// the (env, pair) items to consecutive threads with 32-bit index
// arithmetic (the first design divided a 64-bit index). The row formulas
// are the first design's, term for term, so every output keeps its bits:
// staging the rows in shared memory for coalesced stores, and the formulas
// rewritten over frame columns, both moved bits or ran slower (PERF.md
// section 6).

#include "geom.cuh"

namespace {

// Type codes: ops/narrowphase.py KERNEL_KEYS.
enum PairType {
  kPlaneSphere = 0,
  kPlaneCapsule = 1,
  kPlaneEllipsoid = 2,
  kPlaneCylinder = 3,
  kSphereSphere = 4,
  kSphereCapsule = 5,
  kCapsuleCapsule = 6,
};

constexpr float kEps = 1e-15f;
constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;  // envs a launch's grid spans

struct Row {
  float dist;
  V3 pos, normal;
};

__device__ __forceinline__ V3 normalize(V3 a, float* n) {
  *n = norm(a);
  return a * (1.0f / fmaxf(*n, kEps));
}

__device__ __forceinline__ Row plane_sphere_row(V3 pp, V3 pn, V3 c, float r) {
  Row o;
  o.dist = dot(c - pp, pn) - r;
  o.pos = c - pn * (r + 0.5f * o.dist);
  o.normal = pn;
  return o;
}

__device__ __forceinline__ Row sphere_sphere_row(V3 c1, float r1, V3 c2,
                                                 float r2) {
  float dn;
  const V3 n = normalize(c2 - c1, &dn);
  Row o;
  o.dist = dn - r1 - r2;
  o.pos = c1 + n * (r1 + 0.5f * o.dist);
  o.normal = n;
  return o;
}

__device__ __forceinline__ Row plane_ellipsoid_row(V3 p1, const M3& m1, V3 p2,
                                                   const M3& m2, V3 s2) {
  const V3 pn = col(m1, 2);
  const V3 nl = mul_t(m2, pn);
  const float a = s2.x * nl.x, b = s2.y * nl.y, c = s2.z * nl.z;
  const float denom = sqrtf(a * a + b * b + c * c);
  const float inv = -1.0f / fmaxf(denom, kEps);
  const V3 xl = v3(s2.x * s2.x * nl.x * inv, s2.y * s2.y * nl.y * inv,
                   s2.z * s2.z * nl.z * inv);
  const V3 point = p2 + mul(m2, xl);
  Row o;
  o.dist = dot(point - p1, pn);
  o.pos = point - pn * (0.5f * o.dist);
  o.normal = pn;
  return o;
}

// The three rows of a plane-cylinder pair: the deepest rim point and two
// more rim points 120 degrees away, or, for a cylinder lying on the plane
// (|cos| < 1e-4), the two ends of its lowest line (row 2 then far away).
__device__ __forceinline__ void plane_cylinder_rows(V3 p1, const M3& m1,
                                                    V3 p2, const M3& m2,
                                                    V3 s2, Row* rows) {
  const V3 n = col(m1, 2), a = col(m2, 2);
  const float r = s2.x, h = s2.y;
  const float ca = dot(a, n);
  const V3 lower = p2 - a * (sgn(ca) * h);
  float un;
  const V3 u_n = normalize(n - a * ca, &un);
  const V3 u = sel(un > 1e-12f, u_n, col(m2, 0));
  const V3 w = cross(a, u);
  const V3 deep = lower - u * r;
  const float c120 = -0.5f, s120 = 0.866025403784439f;
  const V3 rim2 = lower - (u * (r * c120) + w * (r * s120));
  const V3 rim3 = lower - (u * (r * c120) - w * (r * s120));
  const V3 side1 = (p2 + a * h) - u_n * r;
  const V3 side2 = (p2 - a * h) - u_n * r;
  const bool lying = fabsf(ca) < 1e-4f;
  const V3 pts[3] = {sel(lying, side1, deep), sel(lying, side2, rim2),
                     sel(lying, side2, rim3)};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float dist = dot(pts[i] - p1, n);
    if (i == 2 && lying) dist = 1e10f;
    rows[i].dist = dist;
    rows[i].pos = pts[i] - n * (0.5f * dist);
    rows[i].normal = n;
  }
}

// Capsule-capsule: the closest points of the two axis segments p +- h a
// (the clamped line-line parameters, refined once from each side), a
// perpendicular nudge where the segments cross, then the sphere-sphere row
// of the two closest points.
__device__ __forceinline__ Row capsule_capsule_row(V3 p1, const M3& m1, V3 s1,
                                                   V3 p2, const M3& m2,
                                                   V3 s2) {
  const V3 a1 = col(m1, 2), a2 = col(m2, 2);
  const float h1 = s1.y, h2 = s2.y;
  const V3 rv = p1 - p2;
  const float aa = dot(a1, a1), ee = dot(a2, a2), ff = dot(a2, rv);
  const float cd = dot(a1, rv), bb = dot(a1, a2);
  const float denom = aa * ee - bb * bb;
  float s = denom > 1e-14f ? (bb * ff - cd * ee) / fmaxf(denom, kEps) : 0.f;
  s = fminf(fmaxf(s, -h1), h1);
  float t = (bb * s + ff) / fmaxf(ee, kEps);
  const float t_cl = fminf(fmaxf(t, -h2), h2);
  s = fminf(fmaxf((bb * t_cl - cd) / fmaxf(aa, kEps), -h1), h1);
  t = fminf(fmaxf((bb * s + ff) / fmaxf(ee, kEps), -h2), h2);
  const V3 q1 = p1 + a1 * s;
  V3 q2 = p2 + a2 * t;
  if (norm(q2 - q1) < 1e-12f) {
    V3 fb = cross(a1, a2);
    const float fbn = norm(fb);
    fb = fbn > 1e-12f ? fb * (1.0f / fmaxf(fbn, kEps))
                      : cross(a1, v3(1.f, 0.f, 0.f));
    q2 = q2 + fb * 1e-12f;
  }
  return sphere_sphere_row(q1, s1.x, q2, s2.x);
}

constexpr int kPhases = 3;  // ops/narrowphase.PHASES

// Kernel 5's phase clocks (narrowphase_phase_clock): where the clock
// instantiation adds, every d_clk_stride-th env; g_clk on the host.
__device__ long long* d_clk;
__device__ int d_clk_stride;
long long* g_clk = nullptr;

// Phase i of a thread ends: it adds the cycles since the last mark to
// phase i (clock instantiation only).
#define PHASE(i)                        \
  do {                                  \
    if constexpr (kClock) {             \
      const long long c_ = clock64();   \
      ph[i] += c_ - c_last;             \
      c_last = c_;                      \
    }                                   \
  } while (0)

// Waits for v (clock instantiation only): a branch on it, so that the
// loads behind v are counted in the phase that issued them.
__device__ __forceinline__ void settle(float v) {
  if (v == -1.2345678e30f) __trap();
}

// One (env, pair)'s rows, stored at slots first .. first + k - 1 of env e.
// kClock: the phase clocks of ops/narrowphase.PHASES, the thread adding its
// cycles to d_clk[(e / d_clk_stride) * kPhases + phase] for every
// d_clk_stride-th env.
template <bool kClock>
__device__ __forceinline__ void pair_rows(
    int e, int p, const float* __restrict__ xpos,
    const float* __restrict__ xmat, const float* __restrict__ size,
    const int4* __restrict__ pairs, float* __restrict__ dist_o,
    float* __restrict__ pos_o, float* __restrict__ nrm_o, int ngeom, int S) {
  long long ph[kPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  const int4 pr = __ldg(pairs + p);  // type, geom1, geom2, first slot
  const float* xp = xpos + (size_t)e * ngeom * 3;
  const float* xm = xmat + (size_t)e * ngeom * 9;
  const V3 p1 = ld3(xp + 3 * pr.y), p2 = ld3(xp + 3 * pr.z);
  // Only the entries the pair's formulas read (the others stay zero).
  M3 m1, m2;
  for (int i = 0; i < 9; ++i) m1.m[i] = m2.m[i] = 0.f;
  V3 s1 = v3(0.f, 0.f, 0.f), s2 = v3(0.f, 0.f, 0.f);
  const float* a = xm + 9 * pr.y;
  const float* b = xm + 9 * pr.z;
  const float* z1 = size + 3 * pr.y;
  const float* z2 = size + 3 * pr.z;
  s2.x = z2[0];
  switch (pr.x) {
    case kPlaneSphere:
      m1.m[2] = a[2], m1.m[5] = a[5], m1.m[8] = a[8];
      break;
    case kPlaneCapsule:
      m1.m[2] = a[2], m1.m[5] = a[5], m1.m[8] = a[8];
      m2.m[2] = b[2], m2.m[5] = b[5], m2.m[8] = b[8];
      s2.y = z2[1];
      break;
    case kPlaneEllipsoid:
      m1.m[2] = a[2], m1.m[5] = a[5], m1.m[8] = a[8];
      m2 = ld9(b);
      s2.y = z2[1], s2.z = z2[2];
      break;
    case kPlaneCylinder:
      m1.m[2] = a[2], m1.m[5] = a[5], m1.m[8] = a[8];
      m2.m[0] = b[0], m2.m[3] = b[3], m2.m[6] = b[6];
      m2.m[2] = b[2], m2.m[5] = b[5], m2.m[8] = b[8];
      s2.y = z2[1];
      break;
    case kSphereSphere:
      s1.x = z1[0];
      break;
    case kSphereCapsule:
      m2.m[2] = b[2], m2.m[5] = b[5], m2.m[8] = b[8];
      s1.x = z1[0];
      s2.y = z2[1];
      break;
    default:  // kCapsuleCapsule
      m1.m[2] = a[2], m1.m[5] = a[5], m1.m[8] = a[8];
      m2.m[2] = b[2], m2.m[5] = b[5], m2.m[8] = b[8];
      s1.x = z1[0], s1.y = z1[1];
      s2.y = z2[1];
      break;
  }
  if constexpr (kClock) {
    float v = p1.x + p2.x + s1.x + s2.x;
    for (int i = 0; i < 9; ++i) v += m1.m[i] + m2.m[i];
    settle(v);
  }
  PHASE(0);

  Row rows[3];
  int k = 1;
  switch (pr.x) {
    case kPlaneSphere:
      rows[0] = plane_sphere_row(p1, col(m1, 2), p2, s2.x);
      break;
    case kPlaneCapsule: {
      const V3 pn = col(m1, 2), axis = col(m2, 2);
      rows[0] = plane_sphere_row(p1, pn, p2 + axis * s2.y, s2.x);
      rows[1] = plane_sphere_row(p1, pn, p2 - axis * s2.y, s2.x);
      k = 2;
      break;
    }
    case kPlaneEllipsoid:
      rows[0] = plane_ellipsoid_row(p1, m1, p2, m2, s2);
      break;
    case kPlaneCylinder:
      plane_cylinder_rows(p1, m1, p2, m2, s2, rows);
      k = 3;
      break;
    case kSphereSphere:
      rows[0] = sphere_sphere_row(p1, s1.x, p2, s2.x);
      break;
    case kSphereCapsule: {
      const V3 a = col(m2, 2);
      const float h = s2.y;
      const float tt = fminf(fmaxf(dot(p1 - p2, a), -h), h);
      rows[0] = sphere_sphere_row(p1, s1.x, p2 + a * tt, s2.x);
      break;
    }
    default:  // kCapsuleCapsule
      rows[0] = capsule_capsule_row(p1, m1, s1, p2, m2, s2);
      break;
  }
  if constexpr (kClock) settle(rows[0].dist + rows[0].pos.x);
  PHASE(1);
  for (int r = 0; r < k; ++r) {
    const size_t s = (size_t)e * S + pr.w + r;
    dist_o[s] = rows[r].dist;
    st3(pos_o + 3 * s, rows[r].pos);
    st3(nrm_o + 3 * s, rows[r].normal);
  }
  PHASE(2);
  if constexpr (kClock) {
    if (e % d_clk_stride == 0)
      for (int i = 0; i < kPhases; ++i)
        atomicAdd(reinterpret_cast<unsigned long long*>(
                      d_clk + (size_t)(e / d_clk_stride) * kPhases + i),
                  (unsigned long long)ph[i]);
  }
}

// A thread a pair of one env. kEnvBlocks (the pair table fits one block):
// block (1, e) takes env e's P pairs (and e + gridDim.y, ...), so that a
// block reads one env's poses; else the (env, pair) items are dealt to
// consecutive threads, item t = e P + p (no block idles past a last
// partial chunk of pairs).
template <bool kClock, bool kEnvBlocks>
__global__ void __launch_bounds__(kThreads)
    narrowphase_kernel(const float* __restrict__ xpos,
                       const float* __restrict__ xmat,
                       const float* __restrict__ size,
                       const int4* __restrict__ pairs,
                       float* __restrict__ dist_o, float* __restrict__ pos_o,
                       float* __restrict__ nrm_o, int B, int ngeom, int P,
                       int S) {
  if constexpr (kEnvBlocks) {
    const int p = threadIdx.x;
    if (p >= P) return;
    for (int e = blockIdx.y; e < B; e += gridDim.y)
      pair_rows<kClock>(e, p, xpos, xmat, size, pairs, dist_o, pos_o, nrm_o,
                        ngeom, S);
  } else {
    const unsigned t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= (unsigned)B * (unsigned)P) return;
    const int e = (int)(t / (unsigned)P);
    pair_rows<kClock>(e, (int)(t - e * (unsigned)P), xpos, xmat, size,
                      pairs, dist_o, pos_o, nrm_o, ngeom, S);
  }
}

// narrowphase_kernel's kEnvBlocks, and the launch's grid.
bool fits_block(int P) { return P <= kThreads; }

dim3 grid_for(int B, int P) {
  if (fits_block(P)) return dim3(1, min(B, kMaxGridY));
  return dim3((unsigned)(((long long)B * P + kThreads - 1) / kThreads));
}

}  // namespace

FB_API int narrowphase_f32(const float* xpos, const float* xmat,
                           const float* size, const int* pairs, float* dist,
                           float* pos, float* normal, int B, int ngeom, int P,
                           int S, void* stream) {
  if (B < 1 || P < 1) return -1;
  if (!fits_block(P) && (long long)B * P >= (1LL << 31)) return -1;
  const dim3 grid = grid_for(B, P);
  const int4* pt = reinterpret_cast<const int4*>(pairs);
  cudaStream_t st = (cudaStream_t)stream;
#define FB_NARROW(C, E)                                                \
  narrowphase_kernel<C, E><<<grid, kThreads, 0, st>>>(               \
      xpos, xmat, size, pt, dist, pos, normal, B, ngeom, P, S)
  if (fits_block(P)) {
    if (g_clk) FB_NARROW(true, true); else FB_NARROW(false, true);
  } else {
    if (g_clk) FB_NARROW(true, false); else FB_NARROW(false, false);
  }
#undef FB_NARROW
  return launch_status();
}

// Phase clocks: while clk is set, every launch runs the clock instantiation
// and adds the cycles of each phase of every stride-th env (the sum over
// its pairs' threads) to clk ((ceil(B / stride), kPhases) int64); nullptr
// turns it off.
FB_API int narrowphase_phase_clock(long long* clk, int stride) {
  if (stride < 1) return -1;
  cudaError_t err = cudaMemcpyToSymbol(d_clk, &clk, sizeof(clk));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(d_clk_stride, &stride, sizeof(stride));
  if (err != cudaSuccess) return (int)err;
  g_clk = clk;
  return 0;
}

// Resources of the kernel for P pairs: out = registers a thread, shared
// bytes a block (none), blocks an SM, grid blocks for B envs.
FB_API int narrowphase_info(int B, int P, int* out) {
  if (B < 1 || P < 1) return -1;
  cudaFuncAttributes fa;
  auto kernel = fits_block(P) ? narrowphase_kernel<false, true>
                                 : narrowphase_kernel<false, false>;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs, out[1] = (int)fa.sharedSizeBytes, out[2] = blocks;
  const dim3 grid = grid_for(B, P);
  out[3] = (int)(grid.x * grid.y);
  return 0;
}
