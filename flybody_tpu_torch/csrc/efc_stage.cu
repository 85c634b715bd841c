// Kernel 7: contact constraint rows.
//
// Replaces flybody_tpu/ops/efc_stage.py::_efc_pallas (:241, the Pallas
// call at :259). Semantics: contact_rows_ref in
// flybody_tpu_torch/ops/efc_stage.py (the JAX package's
// solver._contact_rows_ref): the K candidates with the smallest
// score = dist - includemargin (a stable sort: the lower index first among
// ties, NaN scores last), then for each selected slot its contact frame,
// Jacobian rows J[k, r, v] = (sum_c gkr[k, r, c] cdof[v, c])
// (mask[body2, v] - mask[body1, v]), velocity J qvel, impedance, aref, D
// and the active / frictional / cross-limb flags.
//
// What bounds it: bytes. Per env it reads two floats of each of the C
// candidates (dist, includemargin) and the whole row (22 floats) of the K
// selected ones, cdof and qvel, and writes con_J (K x 3 x nv) and 19 rows
// of K: at C = 430, K = 64, nv = 108 about 100 KB, 83 KB of it con_J. The
// dense make_efc hands it C = 2,048 candidates: the keys then take 16 KB of
// shared memory, 30 KB in all, under the 48 KB default. Design: one
// block of 128 threads per env. Selection is by rank: each candidate's
// score becomes a 64-bit key (order-preserving bits of the float, NaN
// largest, then the index), so keys are distinct and a candidate's rank is
// the count of smaller keys; the candidate of rank k < K fills slot k. No
// sort and no barrier per selected slot, and ties and NaN order as the
// plain version's stable sort. Then one thread per slot builds its frame
// and the 18 entries of gkr in shared memory; each half-warp takes whole
// (slot, frame row) rows of con_J, its lanes spanning the dofs, so the
// writes are coalesced; the body masks are read by body id (rows of
// body_dof_mask through the read-only cache), not by one-hot products.

#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kNF = 22;  // dist, pos (3), normal (3), 14 params, slot id
constexpr int kRows = 19;

__device__ __forceinline__ unsigned long long sort_key(float s, int c) {
  if (s == 0.f) s = 0.f;  // -0 ties with +0, as in a comparison sort
  unsigned int b = __float_as_uint(s);
  if (isnan(s))
    b = 0xffffffffu;
  else
    b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 32) | (unsigned int)c;
}

// solver.impedance: MuJoCo's solimp sigmoid.
__device__ __forceinline__ float impedance(const float* si, float r) {
  const float d0 = si[0], dmax = si[1], width = si[2], mid = si[3],
              power = si[4];
  const float x = fminf(fmaxf(fabsf(r) / fmaxf(width, 1e-15f), 0.f), 1.f);
  const float lo = powf(x, power) / fmaxf(powf(mid, power - 1.f), 1e-15f);
  const float hi = 1.f - powf(1.f - x, power) /
                             fmaxf(powf(1.f - mid, power - 1.f), 1e-15f);
  const float imp = d0 + (x <= mid ? lo : hi) * (dmax - d0);
  return fminf(fmaxf(imp, 1e-5f), 1.f - 1e-5f);
}

__global__ void __launch_bounds__(kThreads)
    efc_kernel(const float* __restrict__ cand_b,
               const float* __restrict__ cand_u,
               const float* __restrict__ cand_g,
               const float* __restrict__ qvel_all,
               const float* __restrict__ cdof_all,
               const float* __restrict__ com_all,
               const float* __restrict__ mask, const float* __restrict__ limb,
               float* __restrict__ J_o, float* __restrict__ s_o, int B, int C,
               int K, int nv) {
  extern __shared__ unsigned long long smem_keys[];
  const int e = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nw = nt >> 5;
  unsigned long long* keys = smem_keys;               // (C)
  float* feat = reinterpret_cast<float*>(keys + C);   // (K, kNF)
  float* gkr = feat + K * kNF;                        // (K, 3, 6)
  float* cdof = gkr + K * 18;                         // (nv, 6)
  float* qvel = cdof + nv * 6;                        // (nv)
  float* vel = qvel + nv;                             // (K, 3)
  int* sel = reinterpret_cast<int*>(vel + 3 * K);     // (K)

  const float* Be = cand_b + (size_t)e * C * 7;
  const float* Ue = cand_u + (size_t)e * C * 14;
  for (int c = t; c < C; c += nt) keys[c] = sort_key(Be[c * 7] - Ue[c * 14], c);
  for (int i = t; i < nv * 6; i += nt) cdof[i] = cdof_all[(size_t)e * nv * 6 + i];
  for (int v = t; v < nv; v += nt) qvel[v] = qvel_all[(size_t)e * nv + v];
  __syncthreads();

  for (int c = t; c < C; c += nt) {
    const unsigned long long kc = keys[c];
    int rank = 0;
    for (int j = 0; j < C; ++j) rank += keys[j] < kc;
    if (rank < K) sel[rank] = c;
  }
  __syncthreads();

  const V3 com = ld3(com_all + (size_t)e * 3);
  for (int k = t; k < K; k += nt) {
    const int c = sel[k];
    float* f = feat + k * kNF;
    for (int i = 0; i < 7; ++i) f[i] = Be[c * 7 + i];
    for (int i = 0; i < 14; ++i) f[7 + i] = Ue[c * 14 + i];
    f[21] = cand_g[(size_t)e * C + c];
    // Contact frame (solver.make_frame): normal, t1, t2.
    const V3 n = ld3(f + 4);
    const V3 helper = fabsf(n.x) > 0.9f ? v3(0.f, 0.f, 1.f) : v3(1.f, 0.f, 0.f);
    V3 t1 = cross(n, helper);
    t1 = t1 / fmaxf(norm(t1), 1e-15f);
    const V3 fr[3] = {n, t1, cross(n, t1)};
    const V3 arm = ld3(f + 1) - com;
    for (int r = 0; r < 3; ++r) {
      st3(gkr + k * 18 + r * 6, cross(arm, fr[r]));
      st3(gkr + k * 18 + r * 6 + 3, fr[r]);
    }
  }
  __syncthreads();

  // con_J rows, a half-warp per (slot, frame row); the row's velocity
  // J qvel on the way, reduced across the half-warp.
  const int half = lane >> 4, j = lane & 15;
  for (int q0 = 2 * warp; q0 < 3 * K; q0 += 2 * nw) {
    const int q = q0 + half;
    const bool has_row = q < 3 * K;
    float acc = 0.f;
    if (has_row) {
      const int k = q / 3;
      const float* g = gkr + q * 6;
      const float* m1 = mask + (size_t)lrintf(feat[k * kNF + 18]) * nv;
      const float* m2 = mask + (size_t)lrintf(feat[k * kNF + 19]) * nv;
      float* Jrow = J_o + ((size_t)e * 3 * K + q) * nv;
      for (int v = j; v < nv; v += 16) {
        const float* cd = cdof + v * 6;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i) s += g[i] * cd[i];
        const float Jv = s * (__ldg(m2 + v) - __ldg(m1 + v));
        Jrow[v] = Jv;
        acc += Jv * qvel[v];
      }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (has_row && j == 0) vel[q] = acc;
  }
  __syncthreads();

  for (int k = t; k < K; k += nt) {
    const float* f = feat + k * kNF;
    const float dist = f[0], incl = f[7];
    const float* solref = f + 9;
    const float* solimp = f + 11;
    const float r_c = dist - incl;
    const float imp = impedance(solimp, r_c);
    const float dmax = solimp[1], tc = solref[0], dr = solref[1];
    float Kc, Bc;
    if (tc > 0.f) {
      const float a = dmax * tc * dr;
      Kc = 1.f / fmaxf(a * a, 1e-15f);
      Bc = 2.f / fmaxf(dmax * tc, 1e-15f);
    } else {
      Kc = -solref[0] / fmaxf(dmax * dmax, 1e-15f);
      Bc = -solref[1] / fmaxf(dmax, 1e-15f);
    }
    const float* vk = vel + 3 * k;
    const float R = fmaxf((1.f - imp) / imp * f[17], 1e-12f);
    const float l1 = __ldg(limb + lrintf(f[18]));
    const float l2 = __ldg(limb + lrintf(f[19]));
    const float row[kRows] = {
        dist,
        dist < incl ? 1.f : 0.f,
        f[16] >= 3.f ? 1.f : 0.f,
        f[8],
        1.f / R,
        -Bc * vk[0] - Kc * imp * r_c,
        -Bc * vk[1],
        -Bc * vk[2],
        f[1], f[2], f[3], f[4], f[5], f[6],
        f[18], f[19], f[20],
        (fabsf(l1 - l2) > 0.5f && l1 > -0.5f && l2 > -0.5f) ? 1.f : 0.f,
        f[21]};
    for (int i = 0; i < kRows; ++i) s_o[((size_t)i * B + e) * K + k] = row[i];
  }
}

}  // namespace

FB_API int efc_contacts_f32(const float* cand_b, const float* cand_u,
                            const float* cand_g, const float* qvel,
                            const float* cdof, const float* com,
                            const float* mask, const float* limb, float* J,
                            float* scal, int B, int C, int K, int nv,
                            int nbody, void* stream) {
  if (B < 1 || C < 1 || K < 1 || K > C || nv < 1 || nbody < 1) return -1;
  const size_t smem = sizeof(unsigned long long) * C +
                      sizeof(float) * ((size_t)K * (kNF + 18 + 3) + nv * 7) +
                      sizeof(int) * K;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        efc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  efc_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      cand_b, cand_u, cand_g, qvel, cdof, com, mask, limb, J, scal, B, C, K,
      nv);
  return launch_status();
}
