// Kernel K2: the fused velocity + force stage for a batch of flies.
//
// Replaces flybody_tpu/ops/force_stage.py::_run_pallas (reached through
// make_force_stage_pe): body velocities and dof motion derivatives, tendon
// velocities, the packed block-arrow CRB mass matrix, RNE bias forces,
// passive springs/dampers, both fluid models, actuator forces and
// activation derivatives. Semantics: the plain chain com_vel -> tendon_vel
// -> crb_packed -> rne -> passive -> fluid -> actuation in
// flybody_tpu_torch/physics/{smooth,fluid}.py.
//
// What bounds it: bytes. Per env it reads ~4.5k floats of state and
// position-stage output (cinert 2.4k, cdof 648, ...; geom frames too when
// the ellipsoid fluid model is active) and writes ~5.3k (the packed mass
// matrix is 3,640 of them), ~39 KB in all, against a few tens of
// thousands of flops. The TPU kernel expressed every tree recursion as a
// masked matmul over dof/body masks.
//
// Design: one block of 128 threads an env. The env's slabs come into
// shared memory by 1-D bulk asynchronous copies (bulk.cuh) where a slab is
// 16-byte aligned and a multiple of 16 bytes an env, by coalesced loads
// otherwise (qpos, act, ctrl); every intermediate (cacc, the RNE and fluid
// wrenches, the composite inertias, which overwrite cinert in place, and
// buf = I_c cdof) stays in shared memory. The work runs in parallel inside
// the env, each value computed by the arithmetic of the one-thread-per-env
// kernel this replaced, every sum in its order (so the outputs are bit for
// bit that kernel's):
//   velocities root to leaves one thread a body, level by level (a body
//   only reads its parent's); per body the RNE wrench and the inertia-box
//   fluid wrench, per fluid geom the ellipsoid wrench; the leaf-to-root
//   sums one thread a component (6 + 6 + 36), over the bodies in
//   descending order; bias, fluid force and buf one thread a dof; the
//   packed mass matrix one thread a packed entry, from a host table naming
//   each entry's (dof, ancestor dof) pair, armature or identity padding;
//   tendon velocities one thread a tendon, passive forces one thread a
//   dof over the tendons in order; actuator forces one thread an
//   actuator, qfrc_actuator one thread a dof over its nonzero moments in
//   the order of the moment list. Stores are coalesced: per-dof and
//   per-actuator values and the mass matrix straight from the threads,
//   cvel and cdof_dot from shared memory at the end. The tree and dof
//   tables the recursions walk are staged in shared memory with the slabs;
//   the other model tables are read from global memory (the same for every
//   env, so L1 and L2 hold them), the mass-matrix codes four ahead.

#include "bulk.cuh"
#include "common.cuh"

namespace {

enum FTab {
  F_GRAVITY, F_WIND, F_FLUID, F_ARMATURE, F_DAMPING, F_STIFF, F_SPRINGREF,
  F_TEN_J, F_TEN_STIFF, F_TEN_DAMP, F_TEN_LS, F_BOX, F_BOX_MASK, F_ACT,
  F_MOM_COEF, F_ELL, NF
};
enum ITab {
  I_DIMS, I_PARENT, I_ROOT, I_DOFADR, I_DOFNUM, I_DOF_BODY, I_DOF_KIND,
  I_LEVEL_BODY, I_LEVEL_OFF, I_MASS_CODE, I_DOF_QADR, I_ACT_Q, I_ACT_D,
  I_ACT_ADR, I_MOM_U, I_MOM_PTR, I_MOM_K, I_ELL, NI
};
// F_ELL: per ellipsoid-fluid geom, geom_fluid (12) then size (3);
// I_ELL: per such geom, (geom id, body id). I_LEVEL_BODY: bodies 1..nb-1
// by tree depth (parents first), I_LEVEL_OFF: where each depth starts.
// I_MASS_CODE: per packed mass-matrix entry, -1 (zero), -2 (identity
// padding) or (i << 16) | (j << 1) | armature for the entry buf_i .
// cdof_j (+ dof_armature[i]). I_MOM_PTR / I_MOM_K: per dof, the indices k
// of its nonzero moments (mom_u[k], mom_coef[k]) in ascending order.
// Per-actuator float row (F_ACT), kActRow values each:
enum ActCol {
  A_CLO, A_CHI, A_TAU, A_GAIN, A_B0, A_B1, A_B2, A_AFFINE, A_FLIM, A_FLO,
  A_FHI, A_GEAR, A_HASACT, A_JOINT, A_TENDON, kActRow
};
// The host's copy of the dims table (ops/force_stage.py `dims`).
enum Dim {
  D_NQ, D_NV, D_NB, D_NT, D_NU, D_NA, D_NL, D_DM, D_NR, D_NNZ, D_NELL, D_NG,
  D_NLEV, kDims
};

constexpr int kThreads = 128;
constexpr int kSlabs = 10;  // staged input slabs, in In's order
constexpr int kPhases = 9;  // ops/force_stage.PHASES

struct In {
  const float *qpos, *qvel, *act, *ctrl, *cdof, *cinert, *xipos, *ximat,
      *scom, *gpos, *gmat, *ten_length;
};

struct Out {
  float *cvel, *cdof_dot, *ten_vel, *bias, *passive, *fluid, *qact, *afrc,
      *act_dot, *Mp;
};

// Shared-memory offsets in floats (host-computed): the staged slabs, in
// In's order up to ten_length, then the working buffers.
struct Layout {
  int slab[kSlabs];  // qpos qvel act ctrl cdof cinert xipos ximat scom tenl
  int cvel, cacc, fb, ff, cdd, buf, tfrc, tvel, afrc, ell, topo, total;
};

struct Args {
  In in;
  Out o;
  const float* fpack;
  const int* ipack;
  int d[kDims];
  int slab_len[kSlabs];  // floats an env
  unsigned bulk;         // bit s: slab s goes by bulk copy
  int B, mp;             // envs, packed mass-matrix floats an env
  int ntopo;             // ints of the int pack before the mass codes
  long long* clk;        // clock instantiation: (ceil(B / stride), kPhases)
  int clk_stride;
  Layout L;
};

long long* g_clk = nullptr;  // host: where the clock instantiation adds
int g_clk_stride = 1;        // every stride-th env is recorded

// Ellipsoid fluid wrench of one geom (MuJoCo's model, the plain version's
// fluid._ellipsoid_forces): torque about `ref` and force, world frame.
__device__ void ellipsoid_wrench(const float* gf, const float* sz,
                                 const float* p, const float* R,
                                 const float* v, const float* ref,
                                 const float* wind, float dens, float visc,
                                 float* out) {
  const float kPi = 3.14159265358979323846f, kMin = 1e-15f;
  float arm[3], wv[3], vat[3], lw[3], lv[3], lwind[3];
  for (int k = 0; k < 3; ++k) arm[k] = p[k] - ref[k];
  cross3(v, arm, wv);
  for (int k = 0; k < 3; ++k) vat[k] = v[3 + k] + wv[k];
  matTvec(R, v, lw);
  matTvec(R, vat, lv);
  matTvec(R, wind, lwind);
  for (int k = 0; k < 3; ++k) lv[k] -= lwind[k];
  const float s0 = sz[0], s1 = sz[1], s2 = sz[2];
  float vl[3], va[3], fA[3], gA[3], t1[3], fM[3];
  for (int k = 0; k < 3; ++k) {
    vl[k] = dens * gf[6 + k] * lv[k];
    va[k] = dens * gf[9 + k] * lw[k];
  }
  cross3(vl, lw, fA);
  cross3(vl, lv, gA);
  cross3(va, lw, t1);
  for (int k = 0; k < 3; ++k) gA[k] += t1[k];
  const float volume = 4.0f / 3.0f * kPi * s0 * s1 * s2;
  cross3(lw, lv, fM);
  for (int k = 0; k < 3; ++k) fM[k] *= gf[5] * dens * volume;
  const float dmax = fmaxf(s0, fmaxf(s1, s2)), dmin = fminf(s0, fminf(s1, s2));
  const float dmid = s0 + s1 + s2 - dmax - dmin;
  const float Amax = kPi * dmax * dmid;
  const float a12 = s1 * s2, a20 = s2 * s0, a01 = s0 * s1;
  const float den = a12 * a12 * a12 * a12 * lv[0] * lv[0] +
                    a20 * a20 * a20 * a20 * lv[1] * lv[1] +
                    a01 * a01 * a01 * a01 * lv[2] * lv[2];
  const float num = (a12 * lv[0]) * (a12 * lv[0]) +
                    (a20 * lv[1]) * (a20 * lv[1]) +
                    (a01 * lv[2]) * (a01 * lv[2]);
  const float Aproj = kPi * sqrtf(den / fmaxf(kMin, num));
  const float nrm[3] = {a12 * a12 * lv[0], a20 * a20 * lv[1],
                        a01 * a01 * lv[2]};
  const float speed = sqrtf(dot3(lv, lv));
  const float cosa = num / fmaxf(kMin, speed * den);
  float circ[3], fK[3];
  cross3(nrm, lv, circ);
  for (int k = 0; k < 3; ++k) circ[k] *= gf[4] * dens * cosa * Aproj;
  cross3(circ, lv, fK);
  const float eqD = 2.0f / 3.0f * (s0 + s1 + s2);
  const float linf = 3.0f * kPi * eqD, lint = kPi * eqD * eqD * eqD;
  const float ss[3] = {s0, s1, s2};
  float mv[3];
  const float dmax4 = dmax * dmax * dmax * dmax;
  const float Imax = 8.0f / 15.0f * kPi * dmid * dmax4;
  for (int k = 0; k < 3; ++k) {
    const float m = fmaxf(ss[(k + 1) % 3], ss[(k + 2) % 3]);
    const float II = 8.0f / 15.0f * kPi * ss[k] * m * m * m * m;
    mv[k] = lw[k] * (gf[3] * II + gf[2] * (Imax - II));
  }
  const float dlin =
      visc * linf + dens * speed * (Aproj * gf[1] + gf[2] * (Amax - Aproj));
  const float dang = visc * lint + dens * sqrtf(dot3(mv, mv));
  float lt[3], lf[3], wt[3], wf[3], tr[3];
  for (int k = 0; k < 3; ++k) {
    lt[k] = (gA[k] - dang * lw[k]) * gf[0];
    lf[k] = (fA[k] + fM[k] + fK[k] - dlin * lv[k]) * gf[0];
  }
  matvec(R, lt, wt);
  matvec(R, lf, wf);
  cross3(arm, wf, tr);
  for (int k = 0; k < 3; ++k) {
    out[k] = wt[k] + tr[k];
    out[3 + k] = wf[k];
  }
}

// Body b's velocity and bias acceleration from its parent's. cdof_dot
// follows mj_comVel: hinge dofs see the velocity of the dofs before them;
// the 3 rotational dofs of a free joint all see the velocity including its
// translations; translational free dofs have cdof_dot = 0.
__device__ __forceinline__ void body_velocity(
    int b, const int* parent, const int* dofadr, const int* dofnum,
    const int* dkind, const float* cdof, const float* qvel, float* cvel,
    float* cacc, float* cdd) {
  float v[6], a[6], pend[6];
  for (int k = 0; k < 6; ++k) {
    v[k] = cvel[parent[b] * 6 + k];
    a[k] = cacc[parent[b] * 6 + k];
    pend[k] = 0.f;
  }
  for (int i = dofadr[b]; i < dofadr[b] + dofnum[b]; ++i) {
    const float* c = cdof + i * 6;
    float* cd = cdd + i * 6;
    const int kind = dkind[i];
    if (kind != 1) {
      for (int k = 0; k < 6; ++k) v[k] += pend[k];
      for (int k = 0; k < 6; ++k) pend[k] = 0.f;
    }
    if (kind == 0) {
      for (int k = 0; k < 6; ++k) cd[k] = 0.f;
      for (int k = 0; k < 6; ++k) v[k] += c[k] * qvel[i];
    } else {
      motion_cross(v, c, cd);
      for (int k = 0; k < 6; ++k) {
        if (kind == 1) pend[k] += c[k] * qvel[i];
        else v[k] += c[k] * qvel[i];
      }
    }
    for (int k = 0; k < 6; ++k) a[k] += cd[k] * qvel[i];
  }
  for (int k = 0; k < 6; ++k) {
    cvel[b * 6 + k] = v[k] + pend[k];
    cacc[b * 6 + k] = a[k];
  }
}

// Body b's RNE wrench and inertia-box fluid wrench (mj_objectVelocity at
// the inertial frame, in that frame).
__device__ __forceinline__ void body_wrench(int b, const Tables& T,
                                            const float* cinert,
                                            const float* cvel,
                                            const float* cacc,
                                            const float* ximat,
                                            const float* xipos,
                                            const float* scom, float* fb,
                                            float* ff) {
  const float dens = T.F(F_FLUID)[0], visc = T.F(F_FLUID)[1];
  const float* wind = T.F(F_WIND);
  const float* box = T.F(F_BOX);
  const float kPi = 3.14159265358979323846f;
  const float* I = cinert + b * 36;
  const float* v = cvel + b * 6;
  float Iv[6], Ia[6], fx[6];
  mat6vec(I, v, Iv);
  mat6vec(I, cacc + b * 6, Ia);
  force_cross(v, Iv, fx);
  for (int k = 0; k < 6; ++k) fb[b * 6 + k] = Ia[k] + fx[k];
  for (int k = 0; k < 6; ++k) ff[b * 6 + k] = 0.f;
  if (T.F(F_BOX_MASK)[b] == 0.f) return;
  const float* R = ximat + b * 9;
  const float* ref = scom + T.I(I_ROOT)[b] * 3;
  float arm[3], wv[3], vat[3], lw[3], lv[3], lwind[3];
  for (int k = 0; k < 3; ++k) arm[k] = xipos[b * 3 + k] - ref[k];
  cross3(v, arm, wv);
  for (int k = 0; k < 3; ++k) vat[k] = v[3 + k] + wv[k];
  matTvec(R, v, lw);
  matTvec(R, vat, lv);
  matTvec(R, wind, lwind);
  for (int k = 0; k < 3; ++k) lv[k] -= lwind[k];
  const float b0 = box[b * 3], b1 = box[b * 3 + 1], b2 = box[b * 3 + 2];
  const float diam = (b0 + b1 + b2) / 3.0f;
  float lt[3], lf[3];
  for (int k = 0; k < 3; ++k) {
    lt[k] = -kPi * diam * diam * diam * visc * lw[k];
    lf[k] = -3.0f * kPi * diam * visc * lv[k];
  }
  lf[0] -= 0.5f * dens * b1 * b2 * fabsf(lv[0]) * lv[0];
  lf[1] -= 0.5f * dens * b0 * b2 * fabsf(lv[1]) * lv[1];
  lf[2] -= 0.5f * dens * b0 * b1 * fabsf(lv[2]) * lv[2];
  const float b04 = b0 * b0 * b0 * b0, b14 = b1 * b1 * b1 * b1,
              b24 = b2 * b2 * b2 * b2;
  lt[0] -= dens / 64.0f * b0 * (b14 + b24) * fabsf(lw[0]) * lw[0];
  lt[1] -= dens / 64.0f * b1 * (b04 + b24) * fabsf(lw[1]) * lw[1];
  lt[2] -= dens / 64.0f * b2 * (b04 + b14) * fabsf(lw[2]) * lw[2];
  float wt[3], wf[3], tr[3];
  matvec(R, lt, wt);
  matvec(R, lf, wf);
  cross3(arm, wf, tr);
  for (int k = 0; k < 3; ++k) {
    ff[b * 6 + k] = wt[k] + tr[k];
    ff[b * 6 + 3 + k] = wf[k];
  }
}

// Phase i of the env ends: the block synchronises and thread 0 adds the
// cycles since the last mark to phase i (clock instantiation only).
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
    force_stage_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float sm[];
  const int e = blockIdx.x, t = threadIdx.x;
  long long ph[kPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  Tables T;  // the tables in global memory
  T.f = a.fpack;
  T.i = a.ipack;
  T.nf = NF;
  // The int pack up to the mass codes (offsets, dims, the tree and dof
  // tables the recursions walk) is staged in shared memory: Ts.I(t) for
  // t < I_MASS_CODE.
  int* topo = reinterpret_cast<int*>(sm + a.L.topo);
  Tables Ts = T;
  Ts.i = topo;
  const Layout& L = a.L;
  const int nv = a.d[D_NV], nb = a.d[D_NB], nt = a.d[D_NT], nu = a.d[D_NU],
            na = a.d[D_NA], nell = a.d[D_NELL], nlev = a.d[D_NLEV];
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);

  // ---- Stage-in: the env's slabs.
  const float* src[kSlabs] = {a.in.qpos,  a.in.qvel,  a.in.act,
                              a.in.ctrl,  a.in.cdof,  a.in.cinert,
                              a.in.xipos, a.in.ximat, a.in.scom,
                              a.in.ten_length};
  if (t == 0) {
    mbar_init(bar, 1);
    uint32_t bytes = 0;
    for (int s = 0; s < kSlabs; ++s)
      if (a.bulk >> s & 1) bytes += 4u * a.slab_len[s];
    mbar_expect_bytes(bar, bytes);
    for (int s = 0; s < kSlabs; ++s)
      if (a.bulk >> s & 1)
        bulk_load(sm + L.slab[s], src[s] + (size_t)e * a.slab_len[s],
                  4u * a.slab_len[s], bar);
  }
  for (int k = t; k < a.ntopo; k += kThreads) topo[k] = a.ipack[k];
  for (int s = 0; s < kSlabs; ++s) {
    if (a.bulk >> s & 1) continue;
    const int n = a.slab_len[s];
    const float* g = src[s] + (size_t)e * n;
    for (int k = t; k < n; k += kThreads) sm[L.slab[s] + k] = g[k];
  }
  const float *qpos = sm + L.slab[0], *qvel = sm + L.slab[1];
  const float *act = sm + L.slab[2], *ctrl = sm + L.slab[3];
  const float *cdof = sm + L.slab[4], *xipos = sm + L.slab[6];
  const float *ximat = sm + L.slab[7], *scom = sm + L.slab[8];
  const float* tlen = sm + L.slab[9];
  float* crb = sm + L.slab[5];  // cinert, then the composite inertias
  float *cvel = sm + L.cvel, *cacc = sm + L.cacc, *fb = sm + L.fb;
  float *ff = sm + L.ff, *cdd = sm + L.cdd, *buf = sm + L.buf;
  float *tfrc = sm + L.tfrc, *tvel = sm + L.tvel, *afrc = sm + L.afrc;
  float* ell6 = sm + L.ell;
  if (t < 6) {
    cvel[t] = 0.f;
    cacc[t] = t < 3 ? 0.f : -T.F(F_GRAVITY)[t - 3];
  }
  __syncthreads();
  mbar_wait(bar, 0);
  PHASE(0);

  // ---- Velocities and bias accelerations, root to leaves, a level at a
  // time.
  const int* parent = Ts.I(I_PARENT);
  const int* lbody = Ts.I(I_LEVEL_BODY);
  const int* loff = Ts.I(I_LEVEL_OFF);
  for (int l = 0; l < nlev; ++l) {
    for (int q = loff[l] + t; q < loff[l + 1]; q += kThreads)
      body_velocity(lbody[q], parent, Ts.I(I_DOFADR), Ts.I(I_DOFNUM),
                    Ts.I(I_DOF_KIND), cdof, qvel, cvel, cacc, cdd);
    __syncthreads();
  }
  PHASE(1);

  // ---- Per body: RNE wrench, inertia-box fluid wrench; per fluid geom
  // the ellipsoid wrench, added to its body's in geom order.
  for (int b = t; b < nb; b += kThreads)
    body_wrench(b, Ts, crb, cvel, cacc, ximat, xipos, scom, fb, ff);
  if (nell > 0) {
    const float* ell = T.F(F_ELL);
    const int* ellid = T.I(I_ELL);
    const int* root = Ts.I(I_ROOT);
    const int ng = a.d[D_NG];
    for (int q = t; q < nell; q += kThreads) {
      const int gid = ellid[2 * q], b = ellid[2 * q + 1];
      ellipsoid_wrench(ell + q * 15, ell + q * 15 + 12,
                       a.in.gpos + ((size_t)e * ng + gid) * 3,
                       a.in.gmat + ((size_t)e * ng + gid) * 9, cvel + b * 6,
                       scom + root[b] * 3, T.F(F_WIND), T.F(F_FLUID)[0],
                       T.F(F_FLUID)[1], ell6 + q * 6);
    }
    __syncthreads();
    for (int b = t; b < nb; b += kThreads)
      for (int q = 0; q < nell; ++q)
        if (ellid[2 * q + 1] == b)
          for (int k = 0; k < 6; ++k) ff[b * 6 + k] += ell6[q * 6 + k];
  }
  __syncthreads();
  PHASE(2);

  // ---- Subtree sums, leaves to root: a thread a component.
  if (t < 48) {
    float* base = t < 6 ? fb : t < 12 ? ff : crb;
    const int w = t < 12 ? 6 : 36, k = t < 6 ? t : t < 12 ? t - 6 : t - 12;
    for (int b = nb - 1; b > 0; --b) base[parent[b] * w + k] += base[b * w + k];
  }
  __syncthreads();
  PHASE(3);

  // ---- Per dof: bias, fluid force, buf = I_c cdof.
  const int* dbody = Ts.I(I_DOF_BODY);
  for (int i = t; i < nv; i += kThreads) {
    const float* c = cdof + i * 6;
    a.o.bias[(size_t)e * nv + i] = dot6(c, fb + dbody[i] * 6);
    a.o.fluid[(size_t)e * nv + i] = dot6(c, ff + dbody[i] * 6);
    mat6vec(crb + dbody[i] * 36, c, buf + i * 6);
  }
  __syncthreads();
  PHASE(4);

  // ---- Packed mass matrix, an entry a thread: buf_i . cdof_j along each
  // dof's ancestor chain (+ armature on the diagonal), identity padding.
  // Four entries' codes are loaded ahead of their arithmetic.
  {
    const int* code = T.I(I_MASS_CODE);
    const float* arm = T.F(F_ARMATURE);
    float* Mp = a.o.Mp + (size_t)e * a.mp;
    constexpr int kAhead = 4;
    for (int q0 = t; q0 < a.mp; q0 += kAhead * kThreads) {
      int cs[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int q = q0 + u * kThreads;
        cs[u] = q < a.mp ? __ldg(code + q) : -1;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int q = q0 + u * kThreads, c = cs[u];
        if (q >= a.mp) break;
        float val;
        if (c == -1) {
          val = 0.f;
        } else if (c == -2) {
          val = 1.f;
        } else {
          const int i = c >> 16, j = (c >> 1) & 0x7fff;
          val = dot6(buf + i * 6, cdof + j * 6);
          if (c & 1) val += arm[i];
        }
        Mp[q] = val;
      }
    }
  }
  PHASE(5);

  // ---- Tendon velocities and forces a thread a tendon; passive forces a
  // thread a dof: dof dampers, hinge springs, then the tendons' springs
  // (deadband) and dampers in tendon order.
  const float* tJ = T.F(F_TEN_J);
  for (int u = t; u < nt; u += kThreads) {
    const float* tls = T.F(F_TEN_LS);
    float v = 0.f;
    for (int i = 0; i < nv; ++i) v += tJ[u * nv + i] * qvel[i];
    tvel[u] = v;
    a.o.ten_vel[(size_t)e * nt + u] = v;
    const float len = tlen[u];
    float disp = 0.f;
    if (len > tls[2 * u + 1]) disp = len - tls[2 * u + 1];
    else if (len < tls[2 * u]) disp = len - tls[2 * u];
    tfrc[u] = -T.F(F_TEN_STIFF)[u] * disp - T.F(F_TEN_DAMP)[u] * v;
  }
  __syncthreads();
  {
    const float* damp = T.F(F_DAMPING);
    const float* stiff = T.F(F_STIFF);
    const float* sref = T.F(F_SPRINGREF);
    const int* dqadr = T.I(I_DOF_QADR);
    for (int i = t; i < nv; i += kThreads) {
      float f = -damp[i] * qvel[i];
      if (dqadr[i] >= 0) f -= stiff[i] * (qpos[dqadr[i]] - sref[i]);
      for (int u = 0; u < nt; ++u) f += tJ[u * nv + i] * tfrc[u];
      a.o.passive[(size_t)e * nv + i] = f;
    }
  }
  PHASE(6);

  // ---- Actuation: a thread an actuator, then qfrc_actuator a thread a
  // dof over its nonzero moments.
  {
    const float* A = T.F(F_ACT);
    const int* aq = T.I(I_ACT_Q);
    const int* ad = T.I(I_ACT_D);
    const int* aadr = T.I(I_ACT_ADR);
    for (int u = t; u < nu; u += kThreads) {
      const float* r = A + u * kActRow;
      const float c = fminf(fmaxf(ctrl[u], r[A_CLO]), r[A_CHI]);
      const int ia = aadr[u];
      const float a_u = ia >= 0 ? act[ia] : 0.f;
      if (ia >= 0) a.o.act_dot[(size_t)e * na + ia] = (c - a_u) / r[A_TAU];
      const float inp = r[A_HASACT] * a_u + (1.f - r[A_HASACT]) * c;
      float len = 0.f, vel = 0.f;
      if (r[A_JOINT] > 0.f) {
        len = qpos[aq[u]];
        vel = qvel[ad[u]];
      } else if (r[A_TENDON] > 0.f) {
        len = tlen[aq[u]];
        vel = tvel[aq[u]];
      }
      len *= r[A_GEAR];
      vel *= r[A_GEAR];
      float f = r[A_GAIN] * inp +
                r[A_AFFINE] * (r[A_B0] + r[A_B1] * len + r[A_B2] * vel);
      if (r[A_FLIM] > 0.f) f = fminf(fmaxf(f, r[A_FLO]), r[A_FHI]);
      afrc[u] = f;
      a.o.afrc[(size_t)e * nu + u] = f;
    }
    __syncthreads();
    const int* mu_ = T.I(I_MOM_U);
    const int* mptr = T.I(I_MOM_PTR);
    const int* mk = T.I(I_MOM_K);
    const float* mc = T.F(F_MOM_COEF);
    for (int i = t; i < nv; i += kThreads) {
      float s = 0.f;
      for (int q = mptr[i]; q < mptr[i + 1]; ++q) {
        const int k = mk[q];
        s += mc[k] * afrc[mu_[k]];
      }
      a.o.qact[(size_t)e * nv + i] = s;
    }
  }
  PHASE(7);

  // ---- Write-out of the per-body and per-dof spatial vectors.
  for (int k = t; k < 6 * nb; k += kThreads)
    a.o.cvel[(size_t)e * 6 * nb + k] = cvel[k];
  for (int k = t; k < 6 * nv; k += kThreads)
    a.o.cdof_dot[(size_t)e * 6 * nv + k] = cdd[k];
  PHASE(8);
  if constexpr (kClock) {
    if (t == 0 && e % a.clk_stride == 0)
      for (int i = 0; i < kPhases; ++i)
        a.clk[(size_t)(e / a.clk_stride) * kPhases + i] += ph[i];
  }
}

int up4(int n) { return (n + 3) & ~3; }

// Host: the dims, slab lengths and shared-memory layout.
Layout layout(const int* d, int ntopo, int* slab_len) {
  const int nq = d[D_NQ], nv = d[D_NV], nb = d[D_NB], nt = d[D_NT],
            nu = d[D_NU], na = d[D_NA], nell = d[D_NELL];
  const int len[kSlabs] = {nq,     nv,     na,     nu,     6 * nv,
                           36 * nb, 3 * nb, 9 * nb, 3 * nb, nt};
  Layout L;
  int off = 4;  // the mbarrier
  for (int s = 0; s < kSlabs; ++s) {
    slab_len[s] = len[s];
    L.slab[s] = off;
    off += up4(len[s]);
  }
  auto take = [&](int n) {
    const int o = off;
    off += up4(n);
    return o;
  };
  // cacc is dead after the body wrenches: the tendon and actuator forces
  // of the later phases reuse its room.
  L.cvel = take(6 * nb);
  L.cacc = off, L.tfrc = off, L.tvel = off + up4(nt);
  L.afrc = L.tvel + up4(nt);
  take(6 * nb > L.afrc + nu - off ? 6 * nb : L.afrc + nu - off);
  L.fb = take(6 * nb), L.ff = take(6 * nb), L.cdd = take(6 * nv);
  L.buf = take(6 * nv), L.ell = take(6 * nell), L.topo = take(ntopo);
  L.total = off;
  return L;
}

template <bool kClock>
cudaError_t geometry(size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      force_stage_kernel<kClock>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, force_stage_kernel<kClock>, kThreads, smem);
}

}  // namespace

// ins: the 12 inputs in In's order; outs: the 10 outputs in Out's order;
// ntopo: ints of the int pack before the mass codes (staged in shared
// memory); dims: the host's copy of the dims table; bulk: bit s set when
// input slab s (In's order up to ten_length) is 16-byte aligned and a
// multiple of 16 bytes an env.
FB_API int force_stage_f32(const float* const* ins, float* const* outs,
                           const float* fpack, const int* ipack, int nf,
                           int ni, int ntopo, const int* dims, int ndims,
                           unsigned bulk, int B, void* stream) {
  if (nf != NF || ni != NI || ndims != kDims) return -1;  // layout mismatch
  if (B < 1) return -1;
  Args a{};
  a.in = In{ins[0], ins[1], ins[2], ins[3],  ins[4],  ins[5],
            ins[6], ins[7], ins[8], ins[9], ins[10], ins[11]};
  a.o = Out{outs[0], outs[1], outs[2], outs[3], outs[4],
            outs[5], outs[6], outs[7], outs[8], outs[9]};
  a.fpack = fpack, a.ipack = ipack;
  for (int k = 0; k < kDims; ++k) a.d[k] = dims[k];
  a.L = layout(dims, ntopo, a.slab_len);
  a.ntopo = ntopo;
  a.bulk = bulk;
  a.B = B;
  a.mp = (dims[D_NL] + 1) * (dims[D_DM] + dims[D_NR]) * dims[D_DM];
  const size_t smem = sizeof(float) * (size_t)a.L.total;
  if (smem > 232448) return -1;  // Hopper's shared memory per block
  int blocks = 0;
  cudaError_t err;
  if (g_clk) {
    a.clk = g_clk, a.clk_stride = g_clk_stride;
    err = geometry<true>(smem, &blocks);
    if (err != cudaSuccess) return (int)err;
    force_stage_kernel<true><<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  } else {
    err = geometry<false>(smem, &blocks);
    if (err != cudaSuccess) return (int)err;
    force_stage_kernel<false><<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// Phase clocks: while clk is set, every launch runs the clock instantiation
// and adds the cycles of each phase of every stride-th env to clk
// ((ceil(B / stride), kPhases) int64); nullptr turns it off.
FB_API int force_stage_phase_clock(long long* clk, int stride) {
  if (stride < 1) return -1;
  g_clk = clk, g_clk_stride = stride;
  return 0;
}

// Resources of the main instantiation for this model: out = registers a
// thread, shared bytes a block, blocks an SM, grid blocks for B envs.
FB_API int force_stage_info(int ntopo, const int* dims, int ndims, int B,
                            int* out) {
  if (ndims != kDims) return -1;
  int slab_len[kSlabs];
  const size_t smem =
      sizeof(float) * (size_t)layout(dims, ntopo, slab_len).total;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, force_stage_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = geometry<false>(smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs, out[1] = (int)smem, out[2] = blocks, out[3] = B;
  return 0;
}
