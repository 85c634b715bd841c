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
// one-hot matmul and walk the tree by pointer doubling; here one thread
// owns one env and walks the bodies in id order (MuJoCo orders parents
// before children), reading parent frames back from its own outputs, with
// all model tables staged once per block in shared memory. This first
// design leaves the writes uncoalesced (each thread writes its own 31.7 KB
// run) and runs 8192 threads in all; a warp-per-env layout with coalesced
// stores is the next step.

#include "common.cuh"

namespace {

enum FTab {
  F_QPOS0, F_BODY_POS, F_BODY_QUAT, F_BODY_IPOS, F_BODY_IQUAT, F_MASS,
  F_SUBTREEMASS, F_INERTIA, F_JNT_POS, F_JNT_AXIS, F_GEOM_POS, F_GEOM_QUAT,
  F_SITE_POS, F_SITE_QUAT, F_TEN_LQ, NF
};
enum ITab {
  I_DIMS, I_PARENT, I_ROOT, I_JNTADR, I_JNTNUM, I_JNT_TYPE, I_JNT_QPOSADR,
  I_GEOM_BODY, I_GEOM_SF, I_SITE_BODY, I_SITE_SF, I_DOF_BODY, I_DOF_JNT,
  I_DOF_MODE, I_DOF_K, NI
};
// dof modes: 0 translation along world axis k, 1 rotation about body
// axis k, 2 hinge (rotation about the joint's world axis).

struct Outs {
  float *xpos, *xquat, *xmat, *xipos, *ximat, *gpos, *gmat, *spos, *smat,
      *scom, *cinert, *cdof, *janc, *jaxis, *ten;
};

__device__ void object_frames(const Tables& T, int n, int tbody, int tsf,
                              int tpos, int tquat, const float* xpos,
                              const float* xquat, const float* xipos,
                              const float* xmat, const float* ximat,
                              float* opos, float* omat) {
  const int* body = T.I(tbody);
  const int* sf = T.I(tsf);
  const float* lp = T.F(tpos);
  const float* lq = T.F(tquat);
  for (int g = 0; g < n; ++g) {
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

__global__ void pos_stage_kernel(const float* __restrict__ qpos_all,
                                 Outs o, const float* fpack, int nfloat,
                                 const int* ipack, int nint, int B) {
  Tables T = stage_tables(fpack, nfloat, ipack, nint, NF);
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const int* dims = T.I(I_DIMS);
  const int nq = dims[0], nv = dims[1], nb = dims[2], nj = dims[3],
            ng = dims[4], ns = dims[5], nt = dims[6];
  const float* qpos = qpos_all + (size_t)e * nq;
  float* xpos = o.xpos + (size_t)e * nb * 3;
  float* xquat = o.xquat + (size_t)e * nb * 4;
  float* xmat = o.xmat + (size_t)e * nb * 9;
  float* xipos = o.xipos + (size_t)e * nb * 3;
  float* ximat = o.ximat + (size_t)e * nb * 9;
  float* scom = o.scom + (size_t)e * nb * 3;
  float* janc = o.janc + (size_t)e * nj * 3;
  float* jaxis = o.jaxis + (size_t)e * nj * 3;

  const int* parent = T.I(I_PARENT);
  const int* jntadr = T.I(I_JNTADR);
  const int* jntnum = T.I(I_JNTNUM);
  const int* jtype = T.I(I_JNT_TYPE);
  const int* jqadr = T.I(I_JNT_QPOSADR);
  const float* qpos0 = T.F(F_QPOS0);
  const float* jpos_t = T.F(F_JNT_POS);
  const float* jaxis_t = T.F(F_JNT_AXIS);

  // Bodies in id order: parents are final before their children.
  for (int b = 0; b < nb; ++b) {
    float lp[3], lq[4];
    for (int k = 0; k < 3; ++k) lp[k] = T.F(F_BODY_POS)[b * 3 + k];
    for (int k = 0; k < 4; ++k) lq[k] = T.F(F_BODY_QUAT)[b * 4 + k];
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

  object_frames(T, ng, I_GEOM_BODY, I_GEOM_SF, F_GEOM_POS, F_GEOM_QUAT, xpos,
                xquat, xipos, xmat, ximat, o.gpos + (size_t)e * ng * 3,
                o.gmat + (size_t)e * ng * 9);
  object_frames(T, ns, I_SITE_BODY, I_SITE_SF, F_SITE_POS, F_SITE_QUAT, xpos,
                xquat, xipos, xmat, ximat, o.spos + (size_t)e * ns * 3,
                o.smat + (size_t)e * ns * 9);

  // Subtree CoM: mass-weighted positions summed child -> parent.
  const float* mass = T.F(F_MASS);
  for (int b = 0; b < nb; ++b)
    for (int k = 0; k < 3; ++k) scom[b * 3 + k] = mass[b] * xipos[b * 3 + k];
  for (int b = nb - 1; b > 0; --b)
    for (int k = 0; k < 3; ++k) scom[parent[b] * 3 + k] += scom[b * 3 + k];
  for (int b = 0; b < nb; ++b) {
    const float inv = 1.0f / T.F(F_SUBTREEMASS)[b];
    for (int k = 0; k < 3; ++k) scom[b * 3 + k] *= inv;
  }

  // cinert about the subtree CoM of each body's kinematic root.
  const int* root = T.I(I_ROOT);
  const float* inertia = T.F(F_INERTIA);
  for (int b = 0; b < nb; ++b) {
    const float* R = ximat + b * 9;
    const float* ref = scom + root[b] * 3;
    float r[3];
    for (int k = 0; k < 3; ++k) r[k] = xipos[b * 3 + k] - ref[k];
    const float m = mass[b];
    const float r2 = dot3(r, r);
    const float sk[9] = {0.f, -r[2], r[1], r[2], 0.f, -r[0], -r[1], r[0], 0.f};
    float* ci = o.cinert + ((size_t)e * nb + b) * 36;
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

  // cdof: per-dof motion vector at the root subtree CoM.
  const int* dbody = T.I(I_DOF_BODY);
  const int* djnt = T.I(I_DOF_JNT);
  const int* dmode = T.I(I_DOF_MODE);
  const int* dk = T.I(I_DOF_K);
  for (int i = 0; i < nv; ++i) {
    const int b = dbody[i], j = djnt[i], mode = dmode[i], k = dk[i];
    float* cd = o.cdof + ((size_t)e * nv + i) * 6;
    float ax[3];
    if (mode == 0) {
      for (int c = 0; c < 3; ++c) cd[c] = 0.f;
      for (int c = 0; c < 3; ++c) cd[3 + c] = (c == k) ? 1.f : 0.f;
      continue;
    }
    if (mode == 1) {
      for (int c = 0; c < 3; ++c) ax[c] = xmat[b * 9 + c * 3 + k];
    } else {
      for (int c = 0; c < 3; ++c) ax[c] = jaxis[j * 3 + c];
    }
    const float* ref = scom + root[b] * 3;
    float arm[3], lin[3];
    for (int c = 0; c < 3; ++c) arm[c] = ref[c] - janc[j * 3 + c];
    cross3(ax, arm, lin);
    for (int c = 0; c < 3; ++c) {
      cd[c] = ax[c];
      cd[3 + c] = lin[c];
    }
  }

  // Fixed tendons: length = Lq qpos.
  const float* Lq = T.F(F_TEN_LQ);
  for (int t = 0; t < nt; ++t) {
    float s = 0.f;
    for (int q = 0; q < nq; ++q) s += Lq[t * nq + q] * qpos[q];
    o.ten[(size_t)e * nt + t] = s;
  }
}

}  // namespace

FB_API int pos_stage_f32(const float* qpos, float* const* outs,
                         const float* fpack, int nfloat, const int* ipack,
                         int nint, int nf, int ni, int B, void* stream) {
  if (nf != NF || ni != NI) return -1;  // table layout mismatch
  Outs o = {outs[0], outs[1], outs[2],  outs[3],  outs[4],
            outs[5], outs[6], outs[7],  outs[8],  outs[9],
            outs[10], outs[11], outs[12], outs[13], outs[14]};
  size_t smem = table_smem(pos_stage_kernel, nfloat, nint);
  pos_stage_kernel<<<env_blocks(B), kEnvThreads, smem,
                     (cudaStream_t)stream>>>(qpos, o, fpack, nfloat, ipack,
                                             nint, B);
  return (int)cudaGetLastError();
}
