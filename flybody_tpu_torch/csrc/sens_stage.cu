// Kernel K4: rnePostConstraint and the whole sensordata vector.
//
// Replaces flybody_tpu/ops/sens_stage.py::_run_pallas (reached through
// make_sens_stage_pe): post-constraint body accelerations, contact
// wrenches scattered to bodies, subtree internal forces, and every sensor
// (gyro, velocimeter, accelerometer, force, touch) with cutoff clipping.
// Semantics: flybody_tpu_torch/physics/sensors.py (the plain version).
//
// What bounds it: bytes. Per env it reads ~5.4k floats (cinert 2.4k,
// cdof and cdof_dot 1.3k, the K = 64 contact rows ~0.8k) and writes 33;
// the work is a few thousand flops. The TPU kernel built the contact ->
// body scatter from lane-wise compares summed over all K slots for every
// body.
//
// Design: one block of 128 threads an env, grid = B. The env's operands
// come into shared memory by 1-D bulk asynchronous copies on an mbarrier
// (bulk.cuh) where the slab an env is 16-byte aligned and a multiple of 16
// bytes (_cuda.bulk_mask; on the walk every operand but the site frames),
// by coalesced element loads otherwise; the model tables are read from
// global memory (the same for every env, so L1 and L2 hold them). The
// kernel forms only what the sensors read (ops/sens_stage.plan): the body
// forces and subtree sums of the force sensors' subtrees, the
// accelerations of those bodies and of the accelerometers'. Each value is
// computed by the arithmetic of the one-thread-per-env kernel this
// replaced, in the same order, so sensordata is that kernel's bit for bit:
//   the accelerations a thread a (body, component), over the dofs of the
//   body's chain of ancestors from the world (the loop's sums, parent
//   before child, without a synchronisation a level);
//   the contact wrenches a thread a contact (both sides, that kernel's
//   loop body), then for each body a warp ballot a chunk of 32 (contact,
//   side) entries marks those on it, and for each touch sensor the
//   contacts it counts;
//   the body forces a thread a body, which then subtracts the wrenches on
//   its body in contact order, side 0 before side 1, times the contact's
//   active flag (an inactive contact with a NaN force gives NaN, as in the
//   loop);
//   the subtree sums a thread a (top force-sensor body, component), over
//   its descendants in descending id (the loop's order);
//   the sensors a thread a sensor (touch over its marked contacts, in
//   order).
// The acceleration-only operands (qacc, qvel, cdof, cdof_dot) lie first;
// the wrenches, marks and internal forces reuse their room after the
// accelerations where they fit.

#include "bulk.cuh"
#include "common.cuh"

namespace {

enum FTab { F_GRAVITY, F_CUTOFF, NF };
enum ITab {
  I_PARENT, I_ROOT, I_SENS, I_NEED, I_SUB, I_SUB_OFF, I_ACC, I_DOFS,
  I_DOF_OFF, NI
};
// I_SENS: per sensor (type, site, adr, dim, site body), in adr order.
enum SensType { S_TOUCH = 0, S_ACC = 1, S_VEL = 2, S_GYRO = 3, S_FORCE = 4 };
// The sizes the launch passes (ops/sens_stage.py `pack`, `dims`).
enum Dim {
  D_NV, D_NB, D_NS, D_NSD, D_NSENS, D_NACC, D_NNEED, D_NTOP, kDims
};
// Operands, in the wrapper's order.
enum In {
  IN_QACC, IN_QVEL, IN_CVEL, IN_CDOF, IN_CDD, IN_CINERT, IN_SPOS, IN_SMAT,
  IN_SCOM, IN_CPOS, IN_CN, IN_CB12, IN_CACT, IN_FC, kIns
};

constexpr int kThreads = 128;
constexpr int kPhases = 6;  // ops/sens_stage.PHASES

// Shared-memory offsets in floats (host-computed): the mbarrier, each
// operand's slab, the accelerations (nb, 6); the contact wrenches (K, 2
// sides, torque and force), the marks of each needed body's (contact,
// side) entries and of each touch sensor's contacts (a bit each), and the
// entries' bodies (K, 2), whose room the internal forces (nb, 6) take
// over once the marks are made.
struct Layout {
  int in[kIns], cacc, wr, bmask, tmask, cbody, fint, total;
};

struct Args {
  const float* in[kIns];
  float* out;
  const float* fpack;
  const int* ipack;
  int d[kDims];
  int len[kIns];   // floats an env of each operand
  int K;
  unsigned bulk;   // bit i: operand i comes by bulk copy
  long long* clk;  // clock instantiation: (ceil(B / stride), kPhases)
  int clk_stride;
  Layout L;
};

long long* g_clk = nullptr;  // host: where the clock instantiation adds
int g_clk_stride = 1;        // every stride-th env is recorded

// Contact c's world force and its torques about each side's root subtree
// CoM (the one-thread kernel's loop body): w[side] = (torque; force), +f
// on body2 (side 0), -f on body1 (side 1), cbody[side] the side's body.
__device__ __forceinline__ void contact_wrench(int c, int K, const int* root,
                                               const float* cpos,
                                               const float* cn,
                                               const float* cb12,
                                               const float* fc,
                                               const float* scom, float* wr,
                                               int* cbody) {
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
    float* w = wr + (c * 2 + side) * 6;
    for (int k = 0; k < 3; ++k) {
      w[k] = tq[k];
      w[3 + k] = fs[k];
    }
    cbody[c * 2 + side] = b;
  }
}

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
    sens_stage_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const size_t e = blockIdx.x;
  long long ph[kPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  const Layout& L = a.L;
  const int nsd = a.d[D_NSD], nsens = a.d[D_NSENS], nacc = a.d[D_NACC],
            nneed = a.d[D_NNEED], ntop = a.d[D_NTOP], K = a.K;
  const int nch = (2 * K + 31) / 32, tch = (K + 31) / 32;
  Tables T;  // the tables in global memory
  T.f = a.fpack;
  T.i = a.ipack;
  T.nf = NF;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  const float* qacc = sm + L.in[IN_QACC];
  const float* qvel = sm + L.in[IN_QVEL];
  const float* cvel = sm + L.in[IN_CVEL];
  const float* cdof = sm + L.in[IN_CDOF];
  const float* cdd = sm + L.in[IN_CDD];
  const float* cinert = sm + L.in[IN_CINERT];
  const float* spos = sm + L.in[IN_SPOS];
  const float* smat = sm + L.in[IN_SMAT];
  const float* scom = sm + L.in[IN_SCOM];
  const float* cpos = sm + L.in[IN_CPOS];
  const float* cn = sm + L.in[IN_CN];
  const float* cb12 = sm + L.in[IN_CB12];
  const float* cact = sm + L.in[IN_CACT];
  const float* fc = sm + L.in[IN_FC];
  float* cacc = sm + L.cacc;  // (nb, 6) accelerations
  float* wr = sm + L.wr;      // (K, 2, 6) contact wrenches
  unsigned* bmask = reinterpret_cast<unsigned*>(sm + L.bmask);  // (nneed, nch)
  unsigned* tmask = reinterpret_cast<unsigned*>(sm + L.tmask);  // (nsens, tch)
  int* cbody = reinterpret_cast<int*>(sm + L.cbody);            // (K, 2)
  float* fint = sm + L.fint;  // (nb, 6) internal forces, after the marks
  const int* parent = T.I(I_PARENT);
  const int* root = T.I(I_ROOT);
  const int* sens = T.I(I_SENS);
  const int* need = T.I(I_NEED);

  // ---- Stage-in: the operands by bulk copy (else by elements).
  if (t == 0 && a.bulk) {
    uint32_t bytes = 0;
    for (int i = 0; i < kIns; ++i)
      if (a.bulk >> i & 1) bytes += 4u * a.len[i];
    mbar_init(bar, 1);
    mbar_expect_bytes(bar, bytes);
    for (int i = 0; i < kIns; ++i)
      if (a.bulk >> i & 1)
        bulk_load(sm + L.in[i], a.in[i] + e * a.len[i], 4u * a.len[i], bar);
  }
  for (int i = 0; i < kIns; ++i) {
    if (a.bulk >> i & 1) continue;
    const int n = a.len[i];
    const float* g = a.in[i] + e * n;
    float* s = sm + L.in[i];
    for (int k = t; k < n; k += kThreads) s[k] = g[k];
  }
  __syncthreads();
  if (a.bulk) mbar_wait(bar, 0);
  PHASE(0);

  // ---- Accelerations a thread a (body, component), from the world's
  // (0, -gravity) over the dofs of the body's chain of ancestors.
  {
    const int* acc = T.I(I_ACC);
    const int* dofs = T.I(I_DOFS);
    const int* doff = T.I(I_DOF_OFF);
    const float* g = T.F(F_GRAVITY);
    for (int q = t; q < 6 * nacc; q += kThreads) {
      const int n = q / 6, k = q % 6;
      float v = k < 3 ? 0.f : -g[k - 3];
#pragma unroll 4
      for (int u = doff[n]; u < doff[n + 1]; ++u) {
        const int i = dofs[u];
        v += cdof[i * 6 + k] * qacc[i] + cdd[i * 6 + k] * qvel[i];
      }
      cacc[acc[n] * 6 + k] = v;
    }
  }
  __syncthreads();
  PHASE(1);

  // ---- Contact wrenches a thread a contact; then a warp ballot a chunk
  // marks the (contact, side) entries on each needed body and the
  // contacts each touch sensor counts.
  for (int c = t; c < K; c += kThreads)
    contact_wrench(c, K, root, cpos, cn, cb12, fc, scom, wr, cbody);
  __syncthreads();
  for (int n = w; n < nneed; n += kThreads / 32) {
    const int b = need[n];
    for (int ch = 0; ch < nch; ++ch) {
      const int q = ch * 32 + lane;
      const unsigned m = __ballot_sync(0xffffffffu, q < 2 * K && cbody[q] == b);
      if (lane == 0) bmask[n * nch + ch] = m;
    }
  }
  for (int s = w; s < nsens; s += kThreads / 32) {
    if (sens[s * 5] != S_TOUCH) continue;
    const int b = sens[s * 5 + 4];
    for (int ch = 0; ch < tch; ++ch) {
      const int c = ch * 32 + lane;
      const bool hit = c < K && (fabsf(cb12[c] - b) < 0.5f ||
                                 fabsf(cb12[K + c] - b) < 0.5f);
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) tmask[s * tch + ch] = m;
    }
  }
  __syncthreads();
  PHASE(2);

  // ---- Body forces a thread a needed body, less the wrenches on it.
  for (int n = t; n < nneed; n += kThreads) {
    const int b = need[n];
    float Iv[6], Ia[6], fx[6], f[6];
    mat6vec(cinert + b * 36, cvel + b * 6, Iv);
    mat6vec(cinert + b * 36, cacc + b * 6, Ia);
    force_cross(cvel + b * 6, Iv, fx);
    for (int k = 0; k < 6; ++k) f[k] = Ia[k] + fx[k];
    for (int ch = 0; ch < nch; ++ch) {
      for (unsigned m = bmask[n * nch + ch]; m; m &= m - 1) {
        const int q = ch * 32 + __ffs(m) - 1;
        const float act = cact[q >> 1];
        const float* wq = wr + q * 6;
        for (int k = 0; k < 3; ++k) {
          f[k] -= wq[k] * act;
          f[3 + k] -= wq[3 + k] * act;
        }
      }
    }
    for (int k = 0; k < 6; ++k) fint[b * 6 + k] = f[k];
  }
  __syncthreads();
  PHASE(3);

  // ---- Subtree sums a thread a (top force-sensor body, component): its
  // descendants in descending id, each added to its parent.
  {
    const int* sub = T.I(I_SUB);
    const int* soff = T.I(I_SUB_OFF);
    for (int q = t; q < 6 * ntop; q += kThreads) {
      const int j = q / 6, k = q % 6;
      for (int u = soff[j]; u < soff[j + 1]; ++u) {
        const int b = sub[u];
        fint[parent[b] * 6 + k] += fint[b * 6 + k];
      }
    }
  }
  __syncthreads();
  PHASE(4);

  // ---- Sensors, a thread a sensor.
  {
    const float* cut = T.F(F_CUTOFF);
    float* sd = a.out + e * nsd;
    for (int s = t; s < nsens; s += kThreads) {
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
        for (int ch = 0; ch < tch; ++ch) {
          for (unsigned m = tmask[s * tch + ch]; m; m &= m - 1) {
            const int c = ch * 32 + __ffs(m) - 1;
            tot += fmaxf(fc[c * 3], 0.f) * cact[c];
          }
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
  PHASE(5);
  if constexpr (kClock) {
    if (t == 0 && e % a.clk_stride == 0)
      for (int i = 0; i < kPhases; ++i)
        a.clk[(e / a.clk_stride) * kPhases + i] += ph[i];
  }
}

int up4(int n) { return (n + 3) & ~3; }

// Host: the operands' lengths an env and the shared-memory layout.
Layout layout(const int* d, int K, int* len) {
  const int nv = d[D_NV], nb = d[D_NB], ns = d[D_NS];
  const int n[kIns] = {nv,     nv,     6 * nb, 6 * nv, 6 * nv,
                       36 * nb, 3 * ns, 9 * ns, 3 * nb, 3 * K,
                       3 * K,  2 * K,  K,      3 * K};
  // The acceleration-only operands first, then the others.
  const int order[kIns] = {IN_QACC, IN_QVEL,   IN_CDOF, IN_CDD, IN_CVEL,
                           IN_CINERT, IN_SPOS, IN_SMAT, IN_SCOM, IN_CPOS,
                           IN_CN,   IN_CB12,   IN_CACT, IN_FC};
  Layout L;
  int off = 4;  // the mbarrier
  for (int o = 0; o < kIns; ++o) {
    const int i = order[o];
    len[i] = n[i];
    L.in[i] = off;
    off += up4(n[i]);
  }
  const int early = L.in[IN_CVEL] - 4;  // the acceleration-only room
  L.cacc = off;
  off += up4(6 * nb);
  const int nch = (2 * K + 31) / 32, tch = (K + 31) / 32;
  const int bm = up4(d[D_NNEED] * nch), tm = up4(d[D_NSENS] * tch);
  const int cf = up4(2 * K) > up4(6 * nb) ? up4(2 * K) : up4(6 * nb);
  const int scratch = 12 * K + bm + tm + cf;
  L.wr = scratch <= early ? 4 : off;
  if (scratch > early) off += scratch;
  L.bmask = L.wr + 12 * K;
  L.tmask = L.bmask + bm;
  L.cbody = L.fint = L.tmask + tm;
  L.total = off;
  return L;
}

template <bool kClock>
cudaError_t geometry(size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      sens_stage_kernel<kClock>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sens_stage_kernel<kClock>, kThreads, smem);
}

}  // namespace

// ins: the 14 operands in In's order; dims: the host's copy of the dims
// table; bulk: bit i set when operand i starts 16-byte aligned and holds a
// multiple of 16 bytes an env.
FB_API int sens_stage_f32(const float* const* ins, float* out,
                          const float* fpack, const int* ipack, int nf,
                          int ni, const int* dims, int ndims, unsigned bulk,
                          int K, int B, void* stream) {
  if (nf != NF || ni != NI || ndims != kDims) return -1;  // layout mismatch
  if (B < 1 || K < 0) return -1;
  Args a{};
  for (int i = 0; i < kIns; ++i) a.in[i] = ins[i];
  a.out = out;
  a.fpack = fpack, a.ipack = ipack;
  for (int k = 0; k < kDims; ++k) a.d[k] = dims[k];
  a.K = K;
  a.bulk = bulk;
  a.L = layout(dims, K, a.len);
  for (int i = 0; i < kIns; ++i)  // no copy of an empty slab (K = 0)
    if (a.len[i] == 0) a.bulk &= ~(1u << i);
  const size_t smem = sizeof(float) * (size_t)a.L.total;
  if (smem > 232448) return -1;  // Hopper's shared memory per block
  int blocks = 0;
  cudaError_t err;
  if (g_clk) {
    a.clk = g_clk, a.clk_stride = g_clk_stride;
    err = geometry<true>(smem, &blocks);
    if (err != cudaSuccess) return (int)err;
    sens_stage_kernel<true><<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  } else {
    err = geometry<false>(smem, &blocks);
    if (err != cudaSuccess) return (int)err;
    sens_stage_kernel<false><<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// Phase clocks: while clk is set, every launch runs the clock instantiation
// and adds the cycles of each phase of every stride-th env to clk
// ((ceil(B / stride), kPhases) int64); nullptr turns it off.
FB_API int sens_stage_phase_clock(long long* clk, int stride) {
  if (stride < 1) return -1;
  g_clk = clk, g_clk_stride = stride;
  return 0;
}

// Resources of the main instantiation for this model and K: out =
// registers a thread, shared bytes a block, blocks an SM, grid blocks for
// B envs.
FB_API int sens_stage_info(const int* dims, int ndims, int K, int B,
                           int* out) {
  if (ndims != kDims) return -1;
  int len[kIns];
  const size_t smem = sizeof(float) * (size_t)layout(dims, K, len).total;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, sens_stage_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = geometry<false>(smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs, out[1] = (int)smem, out[2] = blocks, out[3] = B;
  return 0;
}
