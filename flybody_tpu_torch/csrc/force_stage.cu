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
// matrix is 3,640 of them), ~39 KB in all, against a few tens of thousands of flops. The
// TPU kernel expressed every tree recursion as a masked matmul over
// dof/body masks; here one thread owns one env and
// runs the recursions directly: velocities and accelerations root to
// leaves, composite inertias and body wrenches leaves to root (in a
// per-env scratch buffer), and the mass matrix by walking each dof's
// ancestor chain, writing straight into the packed layout. Model tables
// sit in shared memory. Like K1, this first design is one thread per env
// with uncoalesced per-env runs of stores. Both fluid models are here: the
// inertia box per body and the ellipsoid model per fluid geom (flight's
// wings; the walking model activates none).

#include "common.cuh"

namespace {

enum FTab {
  F_GRAVITY, F_WIND, F_FLUID, F_ARMATURE, F_DAMPING, F_STIFF, F_SPRINGREF,
  F_TEN_J, F_TEN_STIFF, F_TEN_DAMP, F_TEN_LS, F_BOX, F_BOX_MASK, F_ACT,
  F_MOM_COEF, F_ELL, NF
};
enum ITab {
  I_DIMS, I_PARENT, I_ROOT, I_DOFADR, I_DOFNUM, I_DOF_BODY, I_DOF_KIND,
  I_DOF_PARENT, I_DOF_LIMB, I_DOF_POS, I_DOF_QADR, I_ACT_Q, I_ACT_D,
  I_ACT_ADR, I_MOM_U, I_MOM_DOF, I_ELL, NI
};
// F_ELL: per ellipsoid-fluid geom, geom_fluid (12) then size (3);
// I_ELL: per such geom, (geom id, body id).
// Per-actuator float row (F_ACT), kActRow values each:
enum ActCol {
  A_CLO, A_CHI, A_TAU, A_GAIN, A_B0, A_B1, A_B2, A_AFFINE, A_FLIM, A_FLO,
  A_FHI, A_GEAR, A_HASACT, A_JOINT, A_TENDON, kActRow
};

struct In {
  const float *qpos, *qvel, *act, *ctrl, *cdof, *cinert, *xipos, *ximat,
      *scom, *gpos, *gmat, *ten_length;
};

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

struct Out {
  float *cvel, *cdof_dot, *ten_vel, *bias, *passive, *fluid, *qact, *afrc,
      *act_dot, *Mp, *scratch;
};

__global__ void force_stage_kernel(In in, Out o, const float* fpack,
                                   int nfloat, const int* ipack, int nint,
                                   int B) {
  Tables T = stage_tables(fpack, nfloat, ipack, nint, NF);
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const int* dims = T.I(I_DIMS);
  const int nq = dims[0], nv = dims[1], nb = dims[2], nt = dims[3],
            nu = dims[4], na = dims[5], nl = dims[6], dm = dims[7],
            nr = dims[8], nnz = dims[9], nell = dims[10], ng = dims[11];
  const float* qpos = in.qpos + (size_t)e * nq;
  const float* qvel = in.qvel + (size_t)e * nv;
  const float* act = in.act + (size_t)e * na;
  const float* ctrl = in.ctrl + (size_t)e * nu;
  const float* cdof = in.cdof + (size_t)e * nv * 6;
  const float* cinert = in.cinert + (size_t)e * nb * 36;
  const float* xipos = in.xipos + (size_t)e * nb * 3;
  const float* ximat = in.ximat + (size_t)e * nb * 9;
  const float* scom = in.scom + (size_t)e * nb * 3;
  const float* gpos = in.gpos + (size_t)e * ng * 3;
  const float* gmat = in.gmat + (size_t)e * ng * 9;
  const float* tlen = in.ten_length + (size_t)e * nt;
  float* cvel = o.cvel + (size_t)e * nb * 6;
  float* cdd = o.cdof_dot + (size_t)e * nv * 6;
  float* tvel = o.ten_vel + (size_t)e * nt;
  float* bias = o.bias + (size_t)e * nv;
  float* pas = o.passive + (size_t)e * nv;
  float* fld = o.fluid + (size_t)e * nv;
  float* qact = o.qact + (size_t)e * nv;
  float* afrc = o.afrc + (size_t)e * nu;
  float* adot = o.act_dot + (size_t)e * na;
  const int mp_size = (nl + 1) * (dm + nr) * dm;
  float* Mp = o.Mp + (size_t)e * mp_size;
  // Scratch: cacc (nb x 6) | rne wrench (nb x 6) | fluid wrench (nb x 6) |
  // composite inertia (nb x 36) | buf (nv x 6).
  float* cacc = o.scratch + (size_t)e * (54 * nb + 6 * nv);
  float* fb = cacc + 6 * nb;
  float* ff = fb + 6 * nb;
  float* crb = ff + 6 * nb;
  float* buf = crb + 36 * nb;

  const int* parent = T.I(I_PARENT);
  const int* root = T.I(I_ROOT);
  const int* dofadr = T.I(I_DOFADR);
  const int* dofnum = T.I(I_DOFNUM);
  const int* dbody = T.I(I_DOF_BODY);
  const int* dkind = T.I(I_DOF_KIND);
  const float* g = T.F(F_GRAVITY);

  // Velocities and bias accelerations, root to leaves. cdof_dot follows
  // mj_comVel: hinge dofs see the velocity of the dofs before them; the
  // 3 rotational dofs of a free joint all see the velocity including its
  // translations; translational free dofs have cdof_dot = 0.
  for (int k = 0; k < 6; ++k) {
    cvel[k] = 0.f;
    cacc[k] = 0.f;
  }
  cacc[3] = -g[0];
  cacc[4] = -g[1];
  cacc[5] = -g[2];
  for (int b = 1; b < nb; ++b) {
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

  // Per-body RNE wrench, inertia-box fluid wrench, composite inertia init.
  const float dens = T.F(F_FLUID)[0], visc = T.F(F_FLUID)[1];
  const float* wind = T.F(F_WIND);
  const float* box = T.F(F_BOX);
  const float* boxm = T.F(F_BOX_MASK);
  const float kPi = 3.14159265358979323846f;
  for (int b = 0; b < nb; ++b) {
    const float* I = cinert + b * 36;
    const float* v = cvel + b * 6;
    float Iv[6], Ia[6], fx[6];
    mat6vec(I, v, Iv);
    mat6vec(I, cacc + b * 6, Ia);
    force_cross(v, Iv, fx);
    for (int k = 0; k < 6; ++k) fb[b * 6 + k] = Ia[k] + fx[k];
    for (int k = 0; k < 36; ++k) crb[b * 36 + k] = I[k];
    for (int k = 0; k < 6; ++k) ff[b * 6 + k] = 0.f;
    if (boxm[b] == 0.f) continue;
    // mj_objectVelocity at the inertial frame, in that frame.
    const float* R = ximat + b * 9;
    const float* ref = scom + root[b] * 3;
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
  // Ellipsoid fluid model, per fluid geom, onto its body.
  const float* ell = T.F(F_ELL);
  const int* ellid = T.I(I_ELL);
  for (int q = 0; q < nell; ++q) {
    const int gid = ellid[2 * q], b = ellid[2 * q + 1];
    float w6[6];
    ellipsoid_wrench(ell + q * 15, ell + q * 15 + 12, gpos + gid * 3,
                     gmat + gid * 9, cvel + b * 6, scom + root[b] * 3, wind,
                     dens, visc, w6);
    for (int k = 0; k < 6; ++k) ff[b * 6 + k] += w6[k];
  }
  // Subtree sums, leaves to root.
  for (int b = nb - 1; b > 0; --b) {
    const int p = parent[b];
    for (int k = 0; k < 6; ++k) {
      fb[p * 6 + k] += fb[b * 6 + k];
      ff[p * 6 + k] += ff[b * 6 + k];
    }
    for (int k = 0; k < 36; ++k) crb[p * 36 + k] += crb[b * 36 + k];
  }
  for (int i = 0; i < nv; ++i) {
    const float* c = cdof + i * 6;
    bias[i] = dot6(c, fb + dbody[i] * 6);
    fld[i] = dot6(c, ff + dbody[i] * 6);
    mat6vec(crb + dbody[i] * 36, c, buf + i * 6);
  }

  // Packed mass matrix: M[i, j] = buf_i . cdof_j along each dof's
  // ancestor chain, written into the block-arrow layout.
  const int* dpar = T.I(I_DOF_PARENT);
  const int* dlimb = T.I(I_DOF_LIMB);
  const int* dpos = T.I(I_DOF_POS);
  const float* arm = T.F(F_ARMATURE);
  const int rowlen = (dm + nr) * dm;
  for (int k = 0; k < mp_size; ++k) Mp[k] = 0.f;
  for (int l = 0; l < nl; ++l)
    for (int a = 0; a < dm; ++a) Mp[l * rowlen + a * dm + a] = 1.f;
  for (int i = 0; i < nv; ++i) {
    const int li = dlimb[i], ai = dpos[i];
    for (int j = i; j >= 0; j = dpar[j]) {
      float val = dot6(buf + i * 6, cdof + j * 6);
      const int lj = dlimb[j], aj = dpos[j];
      if (li >= 0 && lj >= 0) {
        if (i == j) val += arm[i];
        float* D = Mp + li * rowlen;
        D[ai * dm + aj] = val;
        D[aj * dm + ai] = val;
      } else if (li >= 0) {
        Mp[li * rowlen + (dm + aj) * dm + ai] = val;
      } else {
        if (i == j) val += arm[i];
        float* R = Mp + nl * rowlen;
        R[ai * dm + aj] = val;
        R[aj * dm + ai] = val;
      }
    }
  }

  // Passive: dof dampers, hinge springs, tendon springs (deadband) and
  // dampers.
  const float* damp = T.F(F_DAMPING);
  const float* stiff = T.F(F_STIFF);
  const float* sref = T.F(F_SPRINGREF);
  const int* dqadr = T.I(I_DOF_QADR);
  for (int i = 0; i < nv; ++i) {
    float f = -damp[i] * qvel[i];
    if (dqadr[i] >= 0) f -= stiff[i] * (qpos[dqadr[i]] - sref[i]);
    pas[i] = f;
  }
  const float* tJ = T.F(F_TEN_J);
  const float* tls = T.F(F_TEN_LS);
  for (int t = 0; t < nt; ++t) {
    float v = 0.f;
    for (int i = 0; i < nv; ++i) v += tJ[t * nv + i] * qvel[i];
    tvel[t] = v;
    const float len = tlen[t];
    float disp = 0.f;
    if (len > tls[2 * t + 1]) disp = len - tls[2 * t + 1];
    else if (len < tls[2 * t]) disp = len - tls[2 * t];
    const float frc = -T.F(F_TEN_STIFF)[t] * disp - T.F(F_TEN_DAMP)[t] * v;
    for (int i = 0; i < nv; ++i) pas[i] += tJ[t * nv + i] * frc;
  }

  // Actuation.
  const float* A = T.F(F_ACT);
  const int* aq = T.I(I_ACT_Q);
  const int* ad = T.I(I_ACT_D);
  const int* aadr = T.I(I_ACT_ADR);
  for (int u = 0; u < nu; ++u) {
    const float* r = A + u * kActRow;
    const float c = fminf(fmaxf(ctrl[u], r[A_CLO]), r[A_CHI]);
    const int ia = aadr[u];
    const float a_u = ia >= 0 ? act[ia] : 0.f;
    if (ia >= 0) adot[ia] = (c - a_u) / r[A_TAU];
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
  }
  for (int i = 0; i < nv; ++i) qact[i] = 0.f;
  const int* mu_ = T.I(I_MOM_U);
  const int* md = T.I(I_MOM_DOF);
  const float* mc = T.F(F_MOM_COEF);
  for (int k = 0; k < nnz; ++k) qact[md[k]] += mc[k] * afrc[mu_[k]];
}

}  // namespace

FB_API int force_stage_f32(const float* const* ins, float* const* outs,
                           const float* fpack, int nfloat, const int* ipack,
                           int nint, int nf, int ni, int B, void* stream) {
  if (nf != NF || ni != NI) return -1;  // table layout mismatch
  In in = {ins[0], ins[1], ins[2], ins[3],  ins[4],  ins[5],
           ins[6], ins[7], ins[8], ins[9], ins[10], ins[11]};
  Out o = {outs[0], outs[1], outs[2], outs[3], outs[4], outs[5],
           outs[6], outs[7], outs[8], outs[9], outs[10]};
  size_t smem = table_smem(force_stage_kernel, nfloat, nint);
  force_stage_kernel<<<env_blocks(B), kEnvThreads, smem,
                       (cudaStream_t)stream>>>(in, o, fpack, nfloat, ipack,
                                               nint, B);
  return (int)cudaGetLastError();
}
