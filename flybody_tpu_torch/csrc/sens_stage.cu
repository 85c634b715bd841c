// Kernel K4: rnePostConstraint and the whole sensordata vector.
//
// Replaces flybody_tpu/ops/sens_stage.py::_run_pallas (reached through
// make_sens_stage_pe): post-constraint body accelerations, contact
// wrenches scattered to bodies, subtree internal forces, and every sensor
// (gyro, velocimeter, accelerometer, force, touch) with cutoff clipping.
// Semantics: flybody_tpu_torch/physics/sensors.py (the plain version).
//
// What bounds it: bytes. Per env it reads ~5.5k floats (cinert 2.4k,
// cdof and cdof_dot 1.3k, the K = 64 contact rows ~0.8k) and writes 33;
// the work is a few thousand flops. The TPU kernel built the contact ->
// body scatter from lane-wise compares summed over all K slots for every
// body; here one thread per env walks the tree (accelerations root to
// leaves, internal forces leaves to root, in a per-env scratch buffer)
// and adds each contact's wrench to its two bodies directly. Model tables
// sit in shared memory.

#include "common.cuh"

namespace {

enum FTab { F_GRAVITY, F_CUTOFF, NF };
enum ITab { I_DIMS, I_PARENT, I_ROOT, I_DOFADR, I_DOFNUM, I_SENS, NI };
// I_SENS: per sensor (type, site, adr, dim, site body), in adr order.
enum SensType { S_TOUCH = 0, S_ACC = 1, S_VEL = 2, S_GYRO = 3, S_FORCE = 4 };

struct In {
  const float *qacc, *qvel, *cvel, *cdof, *cdof_dot, *cinert, *spos, *smat,
      *scom, *cpos, *cnormal, *cb12, *cactive, *fc;
};

__global__ void sens_stage_kernel(In in, float* out, float* scratch,
                                  const float* fpack, int nfloat,
                                  const int* ipack, int nint, int K, int B) {
  Tables T = stage_tables(fpack, nfloat, ipack, nint, NF);
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const int* dims = T.I(I_DIMS);
  const int nv = dims[0], nb = dims[1], ns = dims[2], nsd = dims[3],
            nsens = dims[4];
  const float* qacc = in.qacc + (size_t)e * nv;
  const float* qvel = in.qvel + (size_t)e * nv;
  const float* cvel = in.cvel + (size_t)e * nb * 6;
  const float* cdof = in.cdof + (size_t)e * nv * 6;
  const float* cdd = in.cdof_dot + (size_t)e * nv * 6;
  const float* cinert = in.cinert + (size_t)e * nb * 36;
  const float* spos = in.spos + (size_t)e * ns * 3;
  const float* smat = in.smat + (size_t)e * ns * 9;
  const float* scom = in.scom + (size_t)e * nb * 3;
  const float* cpos = in.cpos + (size_t)e * K * 3;
  const float* cn = in.cnormal + (size_t)e * K * 3;
  const float* cb12 = in.cb12 + (size_t)e * 2 * K;
  const float* cact = in.cactive + (size_t)e * K;
  const float* fc = in.fc + (size_t)e * K * 3;
  float* sd = out + (size_t)e * nsd;
  float* cacc = scratch + (size_t)e * nb * 12;  // (nb, 6) accelerations
  float* fint = cacc + nb * 6;                  // (nb, 6) internal forces

  const int* parent = T.I(I_PARENT);
  const int* root = T.I(I_ROOT);
  const int* dofadr = T.I(I_DOFADR);
  const int* dofnum = T.I(I_DOFNUM);
  const float* g = T.F(F_GRAVITY);

  for (int k = 0; k < 3; ++k) cacc[k] = 0.f;
  for (int k = 0; k < 3; ++k) cacc[3 + k] = -g[k];
  for (int b = 1; b < nb; ++b) {
    float a[6];
    for (int k = 0; k < 6; ++k) a[k] = cacc[parent[b] * 6 + k];
    for (int i = dofadr[b]; i < dofadr[b] + dofnum[b]; ++i)
      for (int k = 0; k < 6; ++k)
        a[k] += cdof[i * 6 + k] * qacc[i] + cdd[i * 6 + k] * qvel[i];
    for (int k = 0; k < 6; ++k) cacc[b * 6 + k] = a[k];
  }
  for (int b = 0; b < nb; ++b) {
    float Iv[6], Ia[6], fx[6];
    mat6vec(cinert + b * 36, cvel + b * 6, Iv);
    mat6vec(cinert + b * 36, cacc + b * 6, Ia);
    force_cross(cvel + b * 6, Iv, fx);
    for (int k = 0; k < 6; ++k) fint[b * 6 + k] = Ia[k] + fx[k];
  }
  // Contact wrenches: +f on body2, -f on body1, about each body's root
  // subtree CoM (net = h - cfrc_ext).
  for (int c = 0; c < K; ++c) {
    const float* n = cn + c * 3;
    float helper[3] = {1.f, 0.f, 0.f};
    if (fabsf(n[0]) > 0.9f) {
      helper[0] = 0.f;
      helper[2] = 1.f;
    }
    float t1[3], t2[3];
    cross3(n, helper, t1);
    const float inv = 1.0f / fmaxf(sqrtf(dot3(t1, t1)), 1e-15f);
    for (int k = 0; k < 3; ++k) t1[k] *= inv;
    cross3(n, t1, t2);
    const float* f = fc + c * 3;
    float fw[3];
    for (int k = 0; k < 3; ++k) fw[k] = f[0] * n[k] + f[1] * t1[k] + f[2] * t2[k];
    const float act = cact[c];
    for (int side = 0; side < 2; ++side) {
      const int b = (int)rintf(cb12[(1 - side) * K + c]);
      const float sgn = side == 0 ? 1.f : -1.f;
      const float* ref = scom + root[b] * 3;
      float arm[3], fs[3], tq[3];
      for (int k = 0; k < 3; ++k) {
        arm[k] = cpos[c * 3 + k] - ref[k];
        fs[k] = sgn * fw[k];
      }
      cross3(arm, fs, tq);
      for (int k = 0; k < 3; ++k) {
        fint[b * 6 + k] -= tq[k] * act;
        fint[b * 6 + 3 + k] -= fs[k] * act;
      }
    }
  }
  for (int b = nb - 1; b > 0; --b)
    for (int k = 0; k < 6; ++k) fint[parent[b] * 6 + k] += fint[b * 6 + k];

  const int* sens = T.I(I_SENS);
  const float* cut = T.F(F_CUTOFF);
  for (int s = 0; s < nsens; ++s) {
    const int type = sens[s * 5], site = sens[s * 5 + 1],
              adr = sens[s * 5 + 2], b = sens[s * 5 + 4];
    const float* R = smat + site * 9;
    const float* w = cvel + b * 6;
    const float* v = w + 3;
    const float* ref = scom + root[b] * 3;
    float arm[3], vat[3], val[3];
    for (int k = 0; k < 3; ++k) arm[k] = spos[site * 3 + k] - ref[k];
    cross3(w, arm, vat);
    for (int k = 0; k < 3; ++k) vat[k] += v[k];
    if (type == S_GYRO) {
      matTvec(R, w, val);
    } else if (type == S_VEL) {
      matTvec(R, vat, val);
    } else if (type == S_ACC) {
      const float* wa = cacc + b * 6;
      float t1[3], t2[3], acc[3];
      cross3(wa, arm, t1);
      cross3(w, vat, t2);
      for (int k = 0; k < 3; ++k) acc[k] = wa[3 + k] + t1[k] + t2[k];
      matTvec(R, acc, val);
    } else if (type == S_FORCE) {
      matTvec(R, fint + b * 6 + 3, val);
    } else {  // touch: normal force of active contacts touching the body
      float tot = 0.f;
      for (int c = 0; c < K; ++c) {
        const bool inv = fabsf(cb12[c] - b) < 0.5f ||
                         fabsf(cb12[K + c] - b) < 0.5f;
        if (inv) tot += fmaxf(fc[c * 3], 0.f) * cact[c];
      }
      val[0] = tot;
    }
    const int dim = sens[s * 5 + 3];
    for (int k = 0; k < dim; ++k) {
      float x = val[k];
      const float cu = cut[adr + k];
      if (cu > 0.f) x = fminf(fmaxf(x, -cu), cu);
      sd[adr + k] = x;
    }
  }
}

}  // namespace

FB_API int sens_stage_f32(const float* const* ins, float* out, float* scratch,
                          const float* fpack, int nfloat, const int* ipack,
                          int nint, int nf, int ni, int K, int B,
                          void* stream) {
  if (nf != NF || ni != NI) return -1;  // table layout mismatch
  In in = {ins[0], ins[1], ins[2], ins[3],  ins[4],  ins[5],  ins[6],
           ins[7], ins[8], ins[9], ins[10], ins[11], ins[12], ins[13]};
  size_t smem = table_smem(sens_stage_kernel, nfloat, nint);
  sens_stage_kernel<<<env_blocks(B), kEnvThreads, smem,
                      (cudaStream_t)stream>>>(in, out, scratch, fpack, nfloat,
                                              ipack, nint, K, B);
  return (int)cudaGetLastError();
}
