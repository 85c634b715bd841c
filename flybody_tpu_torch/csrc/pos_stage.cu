// Kernel K1: the whole position stage for a batch of flies.
//
// Replaces flybody_tpu/ops/pos_stage.py::_run_pallas (the fused Pallas
// position-stage kernel reached through make_pos_stage_pe): joint local
// transforms, world frames of bodies, geoms and sites, subtree CoM,
// cinert, cdof, joint world anchors/axes and fixed-tendon lengths, from
// qpos alone. Semantics: flybody_tpu_torch/physics/kinematics.py (the
// plain version), free and hinge joints only.
//
// What bounds it: bytes. Per env it reads 109 floats and writes ~7.9k
// (31.7 KB: 15 outputs, cinert alone 9.8 KB); the arithmetic is a few
// thousand flops. The TPU kernel had to turn every tree gather into a
// one-hot matmul and walk the tree by pointer doubling.
//
// Design: one block of 128 threads an env, grid = B. The model tables
// the tree walk reads (qpos0, body_pos, body_quat, jnt_pos, jnt_axis and
// the tree, joint and level tables: the packs' prefixes) come into shared
// memory by two 1-D bulk asynchronous copies (bulk.cuh), qpos by coalesced
// element loads; the other tables are read from global memory (the same
// for every env, so L1 and L2 hold them). Each value is computed by the
// arithmetic of the one-thread-per-env kernel this replaced (so the
// outputs are bit for bit that kernel's):
//   body frames root to leaves one thread a body, level by level (a body
//   reads only its parent's frame; force_stage.body_levels), its hinge
//   chain in order in that thread, the tendon lengths beside the world
//   body one thread a tendon; geom and site frames one thread an object;
//   the subtree CoM's leaf-to-root sums one thread a component, over the
//   bodies in descending order; cinert one thread a body; cdof one thread
//   a dof. The outputs but the geom and site frames are assembled in
//   shared memory and leave as soon as they are final, by a 1-D bulk copy
//   from shared to global memory where the slab an env is 16-byte aligned
//   and a multiple of 16 bytes (_cuda.bulk_mask), by coalesced element
//   stores otherwise; cinert's room holds the staged tables until the walk
//   and the subtree sums are done with them. The geom and site frames go
//   from their threads straight to global memory: staging them took 7.7 KB
//   a block (seven blocks an SM instead of nine) and ran slower.

#include "bulk.cuh"
#include "common.cuh"

namespace {

// The staged tables come first in each pack (ops/pos_stage.py `pack`).
enum FTab {
  F_QPOS0, F_BODY_POS, F_BODY_QUAT, F_JNT_POS, F_JNT_AXIS,  // staged
  F_BODY_IPOS, F_BODY_IQUAT, F_MASS, F_SUBTREEMASS, F_INERTIA, F_GEOM_POS,
  F_GEOM_QUAT, F_SITE_POS, F_SITE_QUAT, F_TEN_LQ, F_PAD, NF
};
enum ITab {
  I_DIMS, I_PARENT, I_JNTADR, I_JNTNUM, I_JNT_TYPE, I_JNT_QPOSADR,
  I_LEVEL_BODY, I_LEVEL_OFF,  // staged
  I_ROOT, I_GEOM_BODY, I_GEOM_SF, I_SITE_BODY, I_SITE_SF, I_DOF_BODY,
  I_DOF_JNT, I_DOF_MODE, I_DOF_K, I_PAD, NI
};
// dof modes: 0 translation along world axis k, 1 rotation about body
// axis k, 2 hinge (rotation about the joint's world axis).
// The host's copy of the dims table (ops/pos_stage.py `dims`).
enum Dim { D_NQ, D_NV, D_NB, D_NJ, D_NG, D_NS, D_NT, D_NLEV, kDims };
// Outputs, in the wrapper's order.
enum Out {
  O_XPOS, O_XQUAT, O_XMAT, O_XIPOS, O_XIMAT, O_GPOS, O_GMAT, O_SPOS, O_SMAT,
  O_SCOM, O_CINERT, O_CDOF, O_JANC, O_JAXIS, O_TEN, kOuts
};

constexpr int kThreads = 128;
constexpr int kPhases = 6;  // ops/pos_stage.PHASES
constexpr unsigned kTree = 1u << O_XPOS | 1u << O_XQUAT | 1u << O_XMAT |
                           1u << O_XIPOS | 1u << O_XIMAT | 1u << O_JANC |
                           1u << O_JAXIS | 1u << O_TEN;

// Shared-memory offsets in floats (host-computed): the mbarrier, qpos,
// the staged outputs (the geom and site frames take no room); the staged
// float and int tables lie in cinert's room.
struct Layout {
  int qpos, out[kOuts], ftab, itab, total;
};

struct Args {
  const float* qpos;
  float* out[kOuts];
  const float* fpack;
  const int* ipack;
  int d[kDims];
  int len[kOuts];   // floats an env of each output
  int nfs, nis;     // staged floats and ints (multiples of 4)
  unsigned bulk;    // bit o: output o leaves by bulk copy
  long long* clk;   // clock instantiation: (ceil(B / stride), kPhases)
  int clk_stride;
  Layout L;
};

long long* g_clk = nullptr;  // host: where the clock instantiation adds
int g_clk_stride = 1;        // every stride-th env is recorded

// Body b's world frame from its parent's (both in shared memory): its
// joints in order, then xpos, xquat, xmat, xipos, ximat and the joints'
// world anchors and axes. Ts: the staged tables, T: those in global memory.
__device__ __forceinline__ void body_frame(int b, const Tables& Ts,
                                           const Tables& T, const float* qpos,
                                           float* xpos, float* xquat,
                                           float* xmat, float* xipos,
                                           float* ximat, float* janc,
                                           float* jaxis) {
  const int* parent = Ts.I(I_PARENT);
  const int* jntadr = Ts.I(I_JNTADR);
  const int* jntnum = Ts.I(I_JNTNUM);
  const int* jtype = Ts.I(I_JNT_TYPE);
  const int* jqadr = Ts.I(I_JNT_QPOSADR);
  const float* qpos0 = Ts.F(F_QPOS0);
  const float* jpos_t = Ts.F(F_JNT_POS);
  const float* jaxis_t = Ts.F(F_JNT_AXIS);
  float lp[3], lq[4];
  for (int k = 0; k < 3; ++k) lp[k] = Ts.F(F_BODY_POS)[b * 3 + k];
  for (int k = 0; k < 4; ++k) lq[k] = Ts.F(F_BODY_QUAT)[b * 4 + k];
  const int p = parent[b];
  const float* pq = xquat + p * 4;
  const float* pp = xpos + p * 3;
  int free_j = -1;
  for (int s = 0; s < jntnum[b]; ++s) {
    const int j = jntadr[b] + s;
    if (jtype[j] == 0) {  // free: local frame straight from qpos
      const int a = jqadr[j];
      for (int k = 0; k < 3; ++k) lp[k] = qpos[a + k];
      for (int k = 0; k < 4; ++k) lq[k] = qpos[a + 3 + k];
      qnormalize(lq);
      free_j = j;
      continue;
    }
    // Hinge: anchor/axis in the frame accumulated so far, then world.
    const float* ja = jpos_t + j * 3;
    const float* jx = jaxis_t + j * 3;
    float v[3], w[3];
    qrot(lq, ja, v);
    for (int k = 0; k < 3; ++k) v[k] += lp[k];
    qrot(pq, v, w);
    for (int k = 0; k < 3; ++k) janc[j * 3 + k] = pp[k] + w[k];
    qrot(lq, jx, v);
    qrot(pq, v, w);
    for (int k = 0; k < 3; ++k) jaxis[j * 3 + k] = w[k];
    const float ang = qpos[jqadr[j]] - qpos0[jqadr[j]];
    float sh, chh;
    sincosf(0.5f * ang, &sh, &chh);
    const float hq[4] = {chh, sh * jx[0], sh * jx[1], sh * jx[2]};
    float ra[3], jp[3], rj[3], nq4[4];
    qrot(hq, ja, ra);
    for (int k = 0; k < 3; ++k) jp[k] = ja[k] - ra[k];
    qrot(lq, jp, rj);
    for (int k = 0; k < 3; ++k) lp[k] += rj[k];
    qmul(lq, hq, nq4);
    for (int k = 0; k < 4; ++k) lq[k] = nq4[k];
  }
  float wp[3], wq[4];
  if (b == 0) {
    for (int k = 0; k < 3; ++k) wp[k] = lp[k];
    for (int k = 0; k < 4; ++k) wq[k] = lq[k];
  } else {
    qrot(pq, lp, wp);
    for (int k = 0; k < 3; ++k) wp[k] += pp[k];
    qmul(pq, lq, wq);
  }
  qnormalize(wq);
  for (int k = 0; k < 3; ++k) xpos[b * 3 + k] = wp[k];
  for (int k = 0; k < 4; ++k) xquat[b * 4 + k] = wq[k];
  qmat(wq, xmat + b * 9);
  float ip[3], iq[4];
  qrot(wq, T.F(F_BODY_IPOS) + b * 3, ip);
  for (int k = 0; k < 3; ++k) xipos[b * 3 + k] = wp[k] + ip[k];
  qmul(wq, T.F(F_BODY_IQUAT) + b * 4, iq);
  qmat(iq, ximat + b * 9);
  if (free_j >= 0) {
    for (int k = 0; k < 3; ++k) janc[free_j * 3 + k] = wp[k];
    jaxis[free_j * 3 + 0] = 0.f;
    jaxis[free_j * 3 + 1] = 0.f;
    jaxis[free_j * 3 + 2] = 1.f;
  }
}

// World frames of objects g0, g0 + kThreads, ... < n (geoms or sites) of
// bodies body[g]: the body's frame (sf 1), its inertial frame (sf 2), or
// its local offset; sf 3 / 4 keep the body's / inertial rotation with an
// offset position. A call, not inlined: the one-thread kernel's nvcc
// compiled this loop as a called function, and inlined into the kernel
// its multiply-adds contract otherwise (~3% of the rotation matrices'
// entries then differ in their last bit).
__device__ __noinline__ void object_frames(const Tables& T, int g0, int n,
                                           int tbody, int tsf, int tpos,
                                           int tquat, const float* xpos,
                                           const float* xquat,
                                           const float* xipos,
                                           const float* xmat,
                                           const float* ximat, float* opos,
                                           float* omat) {
  const int* body = T.I(tbody);
  const int* sf = T.I(tsf);
  const float* lp = T.F(tpos);
  const float* lq = T.F(tquat);
  for (int g = g0; g < n; g += kThreads) {
    int b = body[g];
    int s = sf[g];
    float p[3], m[9];
    if (s == 1) {
      for (int k = 0; k < 3; ++k) p[k] = xpos[b * 3 + k];
    } else if (s == 2) {
      for (int k = 0; k < 3; ++k) p[k] = xipos[b * 3 + k];
    } else {
      qrot(xquat + b * 4, lp + g * 3, p);
      for (int k = 0; k < 3; ++k) p[k] += xpos[b * 3 + k];
    }
    if (s == 1 || s == 3) {
      for (int k = 0; k < 9; ++k) m[k] = xmat[b * 9 + k];
    } else if (s == 2 || s == 4) {
      for (int k = 0; k < 9; ++k) m[k] = ximat[b * 9 + k];
    } else {
      float q[4];
      qmul(xquat + b * 4, lq + g * 4, q);
      qmat(q, m);
    }
    for (int k = 0; k < 3; ++k) opos[g * 3 + k] = p[k];
    for (int k = 0; k < 9; ++k) omat[g * 9 + k] = m[k];
  }
}

// Body b's cinert about the subtree CoM of its kinematic root.
__device__ __forceinline__ void body_cinert(int b, const float* R,
                                            const float* xipos,
                                            const float* ref, float m,
                                            const float* inertia, float* ci) {
  float r[3];
  for (int k = 0; k < 3; ++k) r[k] = xipos[b * 3 + k] - ref[k];
  const float r2 = dot3(r, r);
  const float sk[9] = {0.f, -r[2], r[1], r[2], 0.f, -r[0], -r[1], r[0], 0.f};
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      float ic = R[3 * i] * R[3 * j] * inertia[b * 3] +
                 R[3 * i + 1] * R[3 * j + 1] * inertia[b * 3 + 1] +
                 R[3 * i + 2] * R[3 * j + 2] * inertia[b * 3 + 2];
      ci[i * 6 + j] = ic + m * ((i == j ? r2 : 0.f) - r[i] * r[j]);
      ci[i * 6 + 3 + j] = m * sk[3 * i + j];
      ci[(3 + i) * 6 + j] = -m * sk[3 * i + j];
      ci[(3 + i) * 6 + 3 + j] = (i == j) ? m : 0.f;
    }
  }
}

// Dof i's motion vector at the subtree CoM of its body's root.
__device__ __forceinline__ void dof_cdof(int i, const Tables& T,
                                         const float* xmat, const float* janc,
                                         const float* jaxis,
                                         const float* scom, float* cd) {
  const int b = T.I(I_DOF_BODY)[i], j = T.I(I_DOF_JNT)[i],
            mode = T.I(I_DOF_MODE)[i], k = T.I(I_DOF_K)[i];
  float ax[3];
  if (mode == 0) {
    for (int c = 0; c < 3; ++c) cd[c] = 0.f;
    for (int c = 0; c < 3; ++c) cd[3 + c] = (c == k) ? 1.f : 0.f;
    return;
  }
  if (mode == 1) {
    for (int c = 0; c < 3; ++c) ax[c] = xmat[b * 9 + c * 3 + k];
  } else {
    for (int c = 0; c < 3; ++c) ax[c] = jaxis[j * 3 + c];
  }
  const float* ref = scom + T.I(I_ROOT)[b] * 3;
  float arm[3], lin[3];
  for (int c = 0; c < 3; ++c) arm[c] = ref[c] - janc[j * 3 + c];
  cross3(ax, arm, lin);
  for (int c = 0; c < 3; ++c) {
    cd[c] = ax[c];
    cd[3 + c] = lin[c];
  }
}

// Sends the outputs in `which`, final in shared memory, to env e's slabs:
// thread 0 issues the bulk copies (one group), every thread the element
// stores. The threads that wrote them fenced and the block synchronised.
__device__ __forceinline__ void write_out(const Args& a, const float* sm,
                                          size_t e, unsigned which) {
  const int t = threadIdx.x;
  if (t == 0 && (which & a.bulk)) {
    for (int o = 0; o < kOuts; ++o)
      if ((which & a.bulk) >> o & 1)
        bulk_store(a.out[o] + e * a.len[o], sm + a.L.out[o], 4u * a.len[o]);
    bulk_commit();
  }
  for (int o = 0; o < kOuts; ++o) {
    if (!((which & ~a.bulk) >> o & 1)) continue;
    const int n = a.len[o];
    float* g = a.out[o] + e * n;
    const float* s = sm + a.L.out[o];
    for (int k = t; k < n; k += kThreads) g[k] = s[k];
  }
}

// The block's shared-memory writes so far are visible to the bulk copies
// and to every thread.
#define SYNC_OUT()         \
  do {                     \
    fence_proxy_async();   \
    __syncthreads();       \
  } while (0)

// Phase i of the env ends: thread 0 adds the cycles since the last mark
// to phase i (clock instantiation only; the block has synchronised).
#define PHASE(i)                        \
  do {                                  \
    if constexpr (kClock) {             \
      __syncthreads();                  \
      if (t == 0) {                     \
        const long long c_ = clock64(); \
        ph[i] += c_ - c_last;           \
        c_last = c_;                    \
      }                                 \
    }                                   \
  } while (0)

template <bool kClock>
__global__ void __launch_bounds__(kThreads)
    pos_stage_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x;
  const size_t e = blockIdx.x;
  long long ph[kPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  const Layout& L = a.L;
  const int nq = a.d[D_NQ], nv = a.d[D_NV], nb = a.d[D_NB], ng = a.d[D_NG],
            ns = a.d[D_NS], nt = a.d[D_NT], nlev = a.d[D_NLEV];
  Tables T;  // the tables in global memory
  T.f = a.fpack;
  T.i = a.ipack;
  T.nf = NF;
  // The staged ones: Ts.F(t), Ts.I(t) for t before F_BODY_IPOS, I_ROOT.
  Tables Ts = T;
  Ts.f = sm + L.ftab;
  Ts.i = reinterpret_cast<const int*>(sm + L.itab);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  float* qpos = sm + L.qpos;
  float *xpos = sm + L.out[O_XPOS], *xquat = sm + L.out[O_XQUAT];
  float *xmat = sm + L.out[O_XMAT], *xipos = sm + L.out[O_XIPOS];
  float *ximat = sm + L.out[O_XIMAT], *scom = sm + L.out[O_SCOM];
  float *janc = sm + L.out[O_JANC], *jaxis = sm + L.out[O_JAXIS];

  // ---- Stage-in: the tables' prefixes by bulk copy, qpos by elements.
  if (t == 0) {
    mbar_init(bar, 1);
    mbar_expect_bytes(bar, 4u * (a.nfs + a.nis));
    bulk_load(sm + L.ftab, a.fpack, 4u * a.nfs, bar);
    bulk_load(sm + L.itab, a.ipack, 4u * a.nis, bar);
  }
  for (int k = t; k < nq; k += kThreads) qpos[k] = a.qpos[e * nq + k];
  __syncthreads();
  mbar_wait(bar, 0);
  PHASE(0);

  // ---- Body frames, root to leaves a level at a time; the tendon
  // lengths (Lq qpos) beside the world body, from the last threads.
  if (t == 0)
    body_frame(0, Ts, T, qpos, xpos, xquat, xmat, xipos, ximat, janc, jaxis);
  {
    const float* Lq = T.F(F_TEN_LQ);
    float* ten = sm + L.out[O_TEN];
    for (int u = kThreads - 1 - t; u < nt; u += kThreads) {
      float s = 0.f;
      for (int q = 0; q < nq; ++q) s += Lq[u * nq + q] * qpos[q];
      ten[u] = s;
    }
  }
  __syncthreads();
  {
    const int* lbody = Ts.I(I_LEVEL_BODY);
    const int* loff = Ts.I(I_LEVEL_OFF);
    for (int l = 0; l < nlev; ++l) {
      for (int q = loff[l] + t; q < loff[l + 1]; q += kThreads)
        body_frame(lbody[q], Ts, T, qpos, xpos, xquat, xmat, xipos, ximat,
                   janc, jaxis);
      if (l + 1 < nlev) __syncthreads();
    }
  }
  SYNC_OUT();
  PHASE(1);
  write_out(a, sm, e, kTree);

  // ---- Geom and site frames a thread an object, straight to global
  // memory; mass-weighted positions a thread a (body, component).
  object_frames(T, t, ng, I_GEOM_BODY, I_GEOM_SF, F_GEOM_POS, F_GEOM_QUAT,
                xpos, xquat, xipos, xmat, ximat,
                a.out[O_GPOS] + e * a.len[O_GPOS],
                a.out[O_GMAT] + e * a.len[O_GMAT]);
  object_frames(T, t, ns, I_SITE_BODY, I_SITE_SF, F_SITE_POS, F_SITE_QUAT,
                xpos, xquat, xipos, xmat, ximat,
                a.out[O_SPOS] + e * a.len[O_SPOS],
                a.out[O_SMAT] + e * a.len[O_SMAT]);
  {
    const float* mass = T.F(F_MASS);
    for (int q = t; q < 3 * nb; q += kThreads)
      scom[q] = mass[q / 3] * xipos[q];
  }
  __syncthreads();
  PHASE(2);

  // ---- Subtree CoM: the sums child -> parent a thread a component,
  // bodies in descending order; then the division by the subtree mass a
  // thread a (body, component).
  if (t < 3) {
    const int* parent = Ts.I(I_PARENT);
    for (int b = nb - 1; b > 0; --b)
      scom[parent[b] * 3 + t] += scom[b * 3 + t];
  }
  __syncthreads();
  {
    const float* stm = T.F(F_SUBTREEMASS);
    for (int q = t; q < 3 * nb; q += kThreads) {
      const float inv = 1.0f / stm[q / 3];
      scom[q] *= inv;
    }
  }
  SYNC_OUT();
  PHASE(3);
  write_out(a, sm, e, 1u << O_SCOM);

  // ---- cinert a thread a body (over the staged tables: the walk and the
  // sums are done with them), cdof a thread a dof.
  {
    const int* root = T.I(I_ROOT);
    const float* mass = T.F(F_MASS);
    const float* inertia = T.F(F_INERTIA);
    float* cin = sm + L.out[O_CINERT];
    for (int b = t; b < nb; b += kThreads)
      body_cinert(b, ximat + b * 9, xipos, scom + root[b] * 3, mass[b],
                  inertia, cin + b * 36);
    float* cdof = sm + L.out[O_CDOF];
    for (int i = t; i < nv; i += kThreads)
      dof_cdof(i, T, xmat, janc, jaxis, scom, cdof + i * 6);
  }
  SYNC_OUT();
  PHASE(4);
  write_out(a, sm, e, 1u << O_CINERT | 1u << O_CDOF);
  if (t == 0 && a.bulk) bulk_wait_read();
  PHASE(5);
  if constexpr (kClock) {
    if (t == 0 && e % a.clk_stride == 0)
      for (int i = 0; i < kPhases; ++i)
        a.clk[(e / a.clk_stride) * kPhases + i] += ph[i];
  }
}

int up4(int n) { return (n + 3) & ~3; }

// Host: the outputs' lengths an env and the shared-memory layout.
Layout layout(const int* d, int nfs, int nis, int* len) {
  const int nv = d[D_NV], nb = d[D_NB], nj = d[D_NJ], ng = d[D_NG],
            ns = d[D_NS], nt = d[D_NT];
  const int n[kOuts] = {3 * nb, 4 * nb, 9 * nb, 3 * nb, 9 * nb,
                        3 * ng, 9 * ng, 3 * ns, 9 * ns, 3 * nb,
                        36 * nb, 6 * nv, 3 * nj, 3 * nj, nt};
  Layout L;
  int off = 4;  // the mbarrier
  L.qpos = off;
  off += up4(d[D_NQ]);
  for (int o = 0; o < kOuts; ++o) {
    len[o] = n[o];
    L.out[o] = off;
    if (o == O_GPOS || o == O_GMAT || o == O_SPOS || o == O_SMAT) continue;
    off += up4(o == O_CINERT && nfs + nis > n[o] ? nfs + nis : n[o]);
  }
  L.ftab = L.out[O_CINERT];
  L.itab = L.ftab + nfs;
  L.total = off;
  return L;
}

template <bool kClock>
cudaError_t geometry(size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      pos_stage_kernel<kClock>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, pos_stage_kernel<kClock>, kThreads, smem);
}

}  // namespace

// outs: the 15 outputs in Out's order; nfs / nis: the floats / ints of the
// packs' staged prefixes (multiples of 4; the packs 16-byte aligned);
// dims: the host's copy of the dims table; bulk: bit o set when output o
// starts 16-byte aligned and holds a multiple of 16 bytes an env.
FB_API int pos_stage_f32(const float* qpos, float* const* outs,
                         const float* fpack, const int* ipack, int nf, int ni,
                         int nfs, int nis, const int* dims, int ndims,
                         unsigned bulk, int B, void* stream) {
  if (nf != NF || ni != NI || ndims != kDims) return -1;  // layout mismatch
  if (B < 1 || nfs % 4 || nis % 4 || (uintptr_t)fpack % 16 ||
      (uintptr_t)ipack % 16)
    return -1;
  Args a{};
  a.qpos = qpos;
  for (int o = 0; o < kOuts; ++o) a.out[o] = outs[o];
  a.fpack = fpack, a.ipack = ipack;
  for (int k = 0; k < kDims; ++k) a.d[k] = dims[k];
  a.nfs = nfs, a.nis = nis;
  a.L = layout(dims, nfs, nis, a.len);
  a.bulk = bulk;
  const size_t smem = sizeof(float) * (size_t)a.L.total;
  if (smem > 232448) return -1;  // Hopper's shared memory per block
  int blocks = 0;
  cudaError_t err;
  if (g_clk) {
    a.clk = g_clk, a.clk_stride = g_clk_stride;
    err = geometry<true>(smem, &blocks);
    if (err != cudaSuccess) return (int)err;
    pos_stage_kernel<true><<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  } else {
    err = geometry<false>(smem, &blocks);
    if (err != cudaSuccess) return (int)err;
    pos_stage_kernel<false><<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// Phase clocks: while clk is set, every launch runs the clock instantiation
// and adds the cycles of each phase of every stride-th env to clk
// ((ceil(B / stride), kPhases) int64); nullptr turns it off.
FB_API int pos_stage_phase_clock(long long* clk, int stride) {
  if (stride < 1) return -1;
  g_clk = clk, g_clk_stride = stride;
  return 0;
}

// Resources of the main instantiation for this model: out = registers a
// thread, shared bytes a block, blocks an SM, grid blocks for B envs.
FB_API int pos_stage_info(int nfs, int nis, const int* dims, int ndims, int B,
                          int* out) {
  if (ndims != kDims) return -1;
  int len[kOuts];
  const size_t smem = sizeof(float) * (size_t)layout(dims, nfs, nis, len).total;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, pos_stage_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = geometry<false>(smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs, out[1] = (int)smem, out[2] = blocks, out[3] = B;
  return 0;
}
