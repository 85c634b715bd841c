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
// and the active / frictional / cross-limb flags. The body masks come as
// bits (ops/efc_stage.mask_bits: body_dof_mask holds only 0 and 1), so
// each difference is the float one of 0 / 1 values.
//
// What bounds it: bytes. Per env it reads two floats of each of the C
// candidates (dist, includemargin) and the whole row (22 floats) of the K
// selected ones, cdof and qvel, and writes con_J (K x 3 x nv) and 19 rows
// of K: at C = 430, K = 64, nv = 108 about 100 KB, 83 KB of it con_J.
//
// Design: one block of 128 threads per env, in five phases
// (ops/efc_stage.PHASES; phase clocks in the clock instantiation).
// 1. Keys: cdof and qvel by 1-D bulk copies (bulk.cuh load_floats) and the
//    mask bits by element loads, while each candidate's score becomes the
//    high word of a 64-bit key (sort_key: order-preserving bits of the
//    float, -0 as +0, NaN largest; the low word is the index), so keys are
//    distinct. The two score floats are read one a row, four rows a
//    thread in flight: a row of cand_b is 28 bytes and of cand_u 56, so
//    these loads touch every sector a whole-row read of cand_b would and
//    about 4 in 7 of cand_u's. Contiguous float4 spans of cand_b, or of
//    both slabs, took this phase 1.4-1.8x as long (PERF.md section 6).
// 2. Selection: a radix select finds the K-th smallest key, by 8-bit digit
//    histograms in shared memory over the high words (at most 4 passes: it
//    stops once the K-th key is the last of its digit's keys), then over
//    the indices of the keys that tie with it where the tie is split (1-2
//    passes); a warp whose candidates share one digit adds them with
//    one atomic, and the histograms alternate between two buffers. The
//    keys at or below it, exactly K, are compacted and ranked among
//    themselves (K^2 compares in all), the key of rank k filling slot k.
//    The work grows like C + K^2, not C^2.
// 3. Features and frames: a thread a slot copies its candidate's row (22
//    floats), builds its frame and the 18 entries of gkr (frame_gkr).
// 4. con_J and velocities: a half-warp takes a slot's three frame rows,
//    its 16 lanes spanning the dofs (lane j: v = j mod 16, ascending),
//    kSpan dofs' operands (cdof, qvel, the mask bits of the slot's bodies)
//    in registers at a time, each read once for three entries; each row's
//    velocity J qvel is summed in that order and reduced across the
//    half-warp (xor tree 8, 4, 2, 1). A warp's two slots, six contiguous
//    rows of con_J, are assembled in its shared staging buffer and sent by
//    one 1-D bulk store (bulk.cuh store_floats: its 16-byte aligned middle
//    in bulk, the floats around it by plain stores).
// 5. Row scalars: a thread a slot, the 19 rows.
// Phases 3-5 run by tiles of kTile slots, so any K <= C fits shared memory
// (one tile at the presets' K). Every expression is the rank-count
// kernel's, in its order, and the frame's roundings are spelled out as it
// was compiled (frame_gkr), so the outputs are bit for bit its outputs.

#include "bulk.cuh"
#include "geom.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kNF = 22;  // dist, pos (3), normal (3), 14 params, slot id
constexpr int kRows = 19;
constexpr int kBins = 256;
constexpr int kSpan = 4;  // dofs a lane takes at a time in con_J
constexpr int kTile = 64;  // slots a tile of phases 3-5
constexpr int kPhases = 5;  // ops/efc_stage.PHASES
constexpr unsigned kAll = 0xffffffffu;

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

// The frame's arithmetic with its roundings spelled out, as nvcc compiled
// the rank-count kernel's inlined frame code (its SASS): each component of
// a cross product a x b a fused multiply-add on the first product less the
// rounded second one (cross_fma), |t1|^2 as fma(x, x, fma(... y * y)), and
// the x component of t2 = n x t1 from two rounded products (its products
// fell into other basic blocks than their difference, around the divisions
// of t1). Spelled out, the rows keep their bits whatever the compiler makes
// of the code around them.
__device__ __forceinline__ V3 cross_fma(V3 a, V3 b) {
  return v3(__fmaf_rn(a.y, b.z, -__fmul_rn(a.z, b.y)),
            __fmaf_rn(a.z, b.x, -__fmul_rn(a.x, b.z)),
            __fmaf_rn(a.x, b.y, -__fmul_rn(a.y, b.x)));
}

// Slot k's frame (solver.make_frame: normal, t1, t2) and its 18 entries of
// gkr [arm x frame row | frame row], from its features f and the root's
// subtree CoM.
__device__ __forceinline__ void frame_gkr(const float* f, V3 com, float* g) {
  const V3 n = ld3(f + 4);
  const V3 helper = fabsf(n.x) > 0.9f ? v3(0.f, 0.f, 1.f) : v3(1.f, 0.f, 0.f);
  V3 t1 = cross_fma(n, helper);
  const float nn =
      __fmaf_rn(t1.z, t1.z, __fmaf_rn(t1.x, t1.x, __fmul_rn(t1.y, t1.y)));
  t1 = t1 / fmaxf(sqrtf(nn), 1e-15f);
  V3 t2 = cross_fma(n, t1);
  t2.x = __fsub_rn(__fmul_rn(n.y, t1.z), __fmul_rn(n.z, t1.y));
  const V3 fr[3] = {n, t1, t2};
  const V3 arm = ld3(f + 1) - com;
  for (int r = 0; r < 3; ++r) {
    st3(g + r * 6, cross_fma(arm, fr[r]));
    st3(g + r * 6 + 3, fr[r]);
  }
}

// Shared-memory layout in 4-byte words, each piece 16-byte aligned: the
// mbarrier, the slots' candidates (K), a tile's features (kt, kNF), gkr
// (kt, 3, 6) and velocities (kt, 3) (kt = min(K, kTile)), cdof (nv, 6) and
// qvel (nv) (each with 3 floats of room for its shift), four control
// words, the mask bits (nbody, ceil(nv / 64), 64-bit), then one room used
// twice: by the selection (the selected keys (K, 64-bit), the candidates'
// key high words (C), the two digit histograms), and after it by each
// warp's con_J staging buffer (six rows and the shift).
struct Layout {
  int bar, sel, feat, gkr, cdof, qvel, vel, ctl, bits, skey, hk, hist,
      stage, slen, total;
};

__host__ __device__ inline int take(int& off, int n) {
  const int at = off;
  off += (n + 3) & ~3;
  return at;
}

__host__ __device__ inline Layout layout(int C, int K, int nv, int nbody) {
  Layout L;
  int o = 0;
  L.bar = take(o, 2);
  const int kt = K < kTile ? K : kTile;
  L.sel = take(o, K);
  L.feat = take(o, kt * kNF);
  L.gkr = take(o, kt * 18);
  L.cdof = take(o, nv * 6 + 3);
  L.qvel = take(o, nv + 3);
  L.vel = take(o, 3 * kt);
  L.ctl = take(o, 4);
  L.bits = take(o, 2 * nbody * ((nv + 63) / 64));
  int sel_end = o, stage_end = o;
  L.skey = take(sel_end, 2 * K);
  L.hk = take(sel_end, C);
  L.hist = take(sel_end, 2 * kBins);
  L.slen = (6 * nv + 3 + 3) & ~3;
  L.stage = take(stage_end, kWarps * L.slen);
  L.total = sel_end > stage_end ? sel_end : stage_end;
  return L;
}

// One pass of the radix select, by the whole block. Of the candidates
// whose value v (the key's high word hk[c]; with by_index, the index c of
// a candidate whose high word is hstar) agrees with `pre` on the bits of
// `msk`, it counts each 8-bit digit (v >> shift) & 255 into `hist` (zero
// on entry), and finds the digit that holds the need-th smallest of them
// (need counts from 1). It adds the digit to pre and msk, leaves in need
// its rank among that digit's values and in cnt how many there are, and
// zeroes `next`, the next pass's histogram.
__device__ __forceinline__ void radix_pass(const unsigned* hk, int C,
                                           bool by_index, unsigned hstar,
                                           int shift, unsigned& pre,
                                           unsigned& msk, int& need,
                                           int& cnt, unsigned* hist,
                                           unsigned* next, int* ctl) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int c0 = warp * 32; c0 < C; c0 += kThreads) {
    const int c = c0 + lane;
    bool part = false;
    unsigned dig = 0u;
    if (c < C) {
      const unsigned h = hk[c];
      const unsigned v = by_index ? (unsigned)c : h;
      part = (!by_index || h == hstar) && (v & msk) == pre;
      dig = (v >> shift) & 255u;
    }
    const unsigned act = __ballot_sync(kAll, part);
    if (act == 0u) continue;
    const int first = __ffs(act) - 1;
    const unsigned d0 = __shfl_sync(kAll, dig, first);
    if (__ballot_sync(kAll, part && dig == d0) == act) {
      if (lane == first) atomicAdd(hist + d0, (unsigned)__popc(act));
    } else if (part) {
      atomicAdd(hist + dig, 1u);
    }
  }
  __syncthreads();
  if (warp != 0) {
    for (int i = t - 32; i < kBins; i += kThreads - 32) next[i] = 0u;
  } else {
    const uint4 a = *reinterpret_cast<const uint4*>(hist + lane * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(hist + lane * 8 + 4);
    const unsigned c8[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    unsigned s = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) s += c8[i];
    unsigned inc = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(kAll, inc, o);
      if (lane >= o) inc += n;
    }
    unsigned run = inc - s;
    const unsigned nd = (unsigned)need;
    if (run < nd && nd <= inc) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (run + c8[i] >= nd) {
          ctl[0] = lane * 8 + i;
          ctl[1] = (int)(nd - run);
          ctl[2] = (int)c8[i];
          break;
        }
        run += c8[i];
      }
    }
  }
  __syncthreads();
  const unsigned d = (unsigned)ctl[0];
  need = ctl[1];
  cnt = ctl[2];
  pre |= d << shift;
  msk |= 255u << shift;
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
    efc_kernel(const float* __restrict__ cand_b,
               const float* __restrict__ cand_u,
               const float* __restrict__ cand_g,
               const float* __restrict__ qvel_all,
               const float* __restrict__ cdof_all,
               const float* __restrict__ com_all,
               const unsigned long long* __restrict__ mbits,
               const float* __restrict__ limb, float* __restrict__ J_o,
               float* __restrict__ s_o, int B, int C, int K, int nv,
               int nbody, long long* __restrict__ clk, int clk_stride) {
  extern __shared__ __align__(16) float sm[];
  const int e = blockIdx.x, t = threadIdx.x, nt = kThreads;
  const int lane = t & 31, warp = t >> 5, nw = kWarps;
  long long ph[kPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  const Layout L = layout(C, K, nv, nbody);
  const int nwd = (nv + 63) / 64;  // mask words a body
  unsigned long long* skey =
      reinterpret_cast<unsigned long long*>(sm + L.skey);  // (K)
  unsigned* hk = reinterpret_cast<unsigned*>(sm + L.hk);   // (C)
  int* sel = reinterpret_cast<int*>(sm + L.sel);           // (K)
  float* feat = sm + L.feat;                               // (kt, kNF)
  float* gkr = sm + L.gkr;                                 // (kt, 3, 6)
  const float* cd_g = cdof_all + (size_t)e * nv * 6;
  const float* qv_g = qvel_all + (size_t)e * nv;
  float* cdof = sm + L.cdof + stage_shift(cd_g);           // (nv, 6)
  float* qvel = sm + L.qvel + stage_shift(qv_g);           // (nv)
  float* vel = sm + L.vel;                                 // (kt, 3)
  unsigned* hist = reinterpret_cast<unsigned*>(sm + L.hist);  // (2, kBins)
  int* ctl = reinterpret_cast<int*>(sm + L.ctl);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L.bar);
  unsigned long long* bits =
      reinterpret_cast<unsigned long long*>(sm + L.bits);  // (nbody, nwd)

  // ---- Keys; cdof and qvel by bulk copy.
  if (t == 0) {
    mbar_init(bar, 1);
    mbar_expect_bytes(bar, 4u * (aligned_span(cd_g, 6 * nv).body +
                                 aligned_span(qv_g, nv).body));
  }
  load_floats(cdof, cd_g, 6 * nv, t, nt, bar);
  load_floats(qvel, qv_g, nv, t, nt, bar);
  const float* Be = cand_b + (size_t)e * C * 7;
  const float* Ue = cand_u + (size_t)e * C * 14;
  for (int c0 = t; c0 < C; c0 += 4 * nt) {
    float b[4], u[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = c0 + r * nt;
      if (c < C) b[r] = Be[c * 7], u[r] = Ue[c * 14];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = c0 + r * nt;
      if (c < C) hk[c] = (unsigned)(sort_key(b[r] - u[r], c) >> 32);
    }
  }
  for (int i = t; i < nbody * nwd; i += nt) bits[i] = mbits[i];
  for (int i = t; i < kBins; i += nt) hist[i] = 0u;
  if (t == 0) ctl[3] = 0;
  __syncthreads();
  mbar_wait(bar, 0);
  PHASE(0);

  // ---- Selection: the K-th smallest key (hstar, cstar), by digits of
  // the high words, then of the indices where the tie at hstar is split.
  unsigned hstar = 0u, msk = 0u;
  int need = K, cnt = 0;
  int pass = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    radix_pass(hk, C, false, 0u, shift, hstar, msk, need, cnt,
               hist + (pass & 1) * kBins, hist + (~pass & 1) * kBins, ctl);
    ++pass;
    if (need == cnt) {  // the K-th key ends its digit's keys: take them all
      hstar |= ~msk;
      break;
    }
  }
  unsigned cstar = 0xffffffffu;
  if (need < cnt) {
    unsigned ipre = 0u, imsk = 0u;
    const int ibits = 32 - __clz(C - 1);  // bits of the largest index
    for (int shift = ((ibits - 1) / 8) * 8; shift >= 0; shift -= 8, ++pass)
      radix_pass(hk, C, true, hstar, shift, ipre, imsk, need, cnt,
                 hist + (pass & 1) * kBins, hist + (~pass & 1) * kBins,
                 ctl);
    cstar = ipre;
  }
  // The K keys at or below it, compacted, then ranked among themselves.
  for (int c0 = warp * 32; c0 < C; c0 += nt) {
    const int c = c0 + lane;
    bool take_it = false;
    unsigned h = 0u;
    if (c < C) {
      h = hk[c];
      take_it = h < hstar || (h == hstar && (unsigned)c <= cstar);
    }
    const unsigned m = __ballot_sync(kAll, take_it);
    if (m == 0u) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(ctl + 3, __popc(m));
    base = __shfl_sync(kAll, base, 0);
    const int at = base + __popc(m & ((1u << lane) - 1u));
    if (take_it && at < K)
      skey[at] = ((unsigned long long)h << 32) | (unsigned int)c;
  }
  __syncthreads();
  for (int s = t; s < K; s += nt) {
    const unsigned long long ks = skey[s];
    int rank = 0;
    for (int j = 0; j < K; ++j) rank += skey[j] < ks;
    sel[rank] = (int)(unsigned int)ks;
  }
  __syncthreads();
  PHASE(1);

  // Phases 3-5 by tiles of kTile slots (one at the presets' K).
  const V3 com = ld3(com_all + (size_t)e * 3);
  const int half = lane >> 4, j = lane & 15;
  float* Je = J_o + (size_t)e * 3 * K * nv;
  float* stage = sm + L.stage + warp * L.slen;
  for (int kb = 0; kb < K; kb += kTile) {
    const int kn = min(kTile, K - kb);  // the tile's slots

    // ---- Features of the selected rows, frames and gkr a thread a slot.
    for (int k = t; k < kn; k += nt) {
      const int c = sel[kb + k];
      float* f = feat + k * kNF;
      for (int i = 0; i < 7; ++i) f[i] = Be[c * 7 + i];
      for (int i = 0; i < 14; ++i) f[7 + i] = Ue[c * 14 + i];
      f[21] = cand_g[(size_t)e * C + c];
      frame_gkr(f, com, gkr + k * 18);
    }
    __syncthreads();
    PHASE(2);

    // ---- con_J rows, a half-warp per slot (its three frame rows); each
    // row's velocity J qvel on the way, reduced across the half-warp. A
    // lane takes kSpan of its dofs at a time. A warp's two slots go out
    // from its staging buffer by one bulk store.
    for (int k0 = 2 * warp; k0 < kn; k0 += 2 * nw) {
      const int k = k0 + half;
      float* dst = Je + (size_t)(kb + k0) * 3 * nv;
      float* st = stage + stage_shift(dst);
      if (lane == 0) bulk_wait_read();  // the last store has read the buffer
      __syncwarp();
      float acc[3] = {0.f, 0.f, 0.f};
      if (k < kn) {
        float g[18];  // in registers: the staging stores may alias gkr
#pragma unroll
        for (int c = 0; c < 18; ++c) g[c] = gkr[k * 18 + c];
        const unsigned long long* m1 =
            bits + lrintf(feat[k * kNF + 18]) * nwd;
        const unsigned long long* m2 =
            bits + lrintf(feat[k * kNF + 19]) * nwd;
        float* Jrow = st + half * 3 * nv;
        for (int vb = j; vb < nv; vb += 16 * kSpan) {
          // kSpan dofs' operands into registers first (a dof past nv
          // reads the last one and adds nothing), so their loads are not
          // held behind the stores into the staging buffer.
          float w[kSpan], cd[kSpan][6], qv[kSpan];
#pragma unroll
          for (int i = 0; i < kSpan; ++i) {
            const int v = min(vb + 16 * i, nv - 1);
            w[i] = vb + 16 * i < nv
                       ? (float)(unsigned)(m2[v >> 6] >> (v & 63) & 1ull) -
                             (float)(unsigned)(m1[v >> 6] >> (v & 63) & 1ull)
                       : 0.f;
#pragma unroll
            for (int c = 0; c < 6; ++c) cd[i][c] = cdof[v * 6 + c];
            qv[i] = qvel[v];
          }
#pragma unroll
          for (int i = 0; i < kSpan; ++i) {
            const int v = vb + 16 * i;
#pragma unroll
            for (int r = 0; r < 3; ++r) {
              float s = 0.f;
#pragma unroll
              for (int c = 0; c < 6; ++c) s += g[r * 6 + c] * cd[i][c];
              const float Jv = s * w[i];
              if (v < nv) {
                Jrow[r * nv + v] = Jv;
                acc[r] += Jv * qv[i];
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          acc[r] += __shfl_xor_sync(kAll, acc[r], o);
        if (k < kn && j == 0) vel[3 * k + r] = acc[r];
      }
      fence_proxy_async();
      __syncwarp();
      store_floats(dst, st, min(2, kn - k0) * 3 * nv, lane, 32);
    }
    if (lane == 0) bulk_wait_read();
    __syncthreads();
    PHASE(3);

    // ---- Row scalars a thread a slot.
    for (int k = t; k < kn; k += nt) {
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
      for (int i = 0; i < kRows; ++i)
        s_o[((size_t)i * B + e) * K + kb + k] = row[i];
    }
    if (kb + kTile < K) __syncthreads();  // the tile's rooms are free
    PHASE(4);
  }
  if constexpr (kClock) {
    if (t == 0 && e % clk_stride == 0)
      for (int i = 0; i < kPhases; ++i)
        clk[(e / clk_stride) * kPhases + i] += ph[i];
  }
}

long long* g_clk = nullptr;  // host: where the clock instantiation adds
int g_clk_stride = 1;        // every stride-th env is recorded

template <bool kClock>
cudaError_t geometry(size_t smem, int* blocks) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        efc_kernel<kClock>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (!blocks) return cudaSuccess;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, efc_kernel<kClock>, kThreads, smem);
}

bool valid(int B, int C, int K, int nv, int nbody) {
  return B >= 1 && C >= 1 && K >= 1 && K <= C && nv >= 1 && nbody >= 1;
}

}  // namespace

// mbits: (nbody, ceil(nv / 64)) the body masks' bits (mask_bits).
FB_API int efc_contacts_f32(const float* cand_b, const float* cand_u,
                            const float* cand_g, const float* qvel,
                            const float* cdof, const float* com,
                            const long long* mbits, const float* limb,
                            float* J, float* scal, int B, int C, int K,
                            int nv, int nbody, void* stream) {
  if (!valid(B, C, K, nv, nbody)) return -1;
  const size_t smem = sizeof(float) * (size_t)layout(C, K, nv, nbody).total;
  const unsigned long long* mb =
      reinterpret_cast<const unsigned long long*>(mbits);
  if (smem > 232448) return -1;  // Hopper's shared memory per block
  cudaError_t err;
  if (g_clk) {
    err = geometry<true>(smem, nullptr);
    if (err != cudaSuccess) return (int)err;
    efc_kernel<true><<<B, kThreads, smem, (cudaStream_t)stream>>>(
        cand_b, cand_u, cand_g, qvel, cdof, com, mb, limb, J, scal, B, C, K,
        nv, nbody, g_clk, g_clk_stride);
  } else {
    err = geometry<false>(smem, nullptr);
    if (err != cudaSuccess) return (int)err;
    efc_kernel<false><<<B, kThreads, smem, (cudaStream_t)stream>>>(
        cand_b, cand_u, cand_g, qvel, cdof, com, mb, limb, J, scal, B, C, K,
        nv, nbody, nullptr, 1);
  }
  return launch_status();
}

// Phase clocks: while clk is set, every launch runs the clock instantiation
// and adds the cycles of each phase of every stride-th env to clk
// ((ceil(B / stride), kPhases) int64); nullptr turns it off.
FB_API int efc_contacts_phase_clock(long long* clk, int stride) {
  if (stride < 1) return -1;
  g_clk = clk, g_clk_stride = stride;
  return 0;
}

// Resources of the main instantiation at these widths: out = registers a
// thread, shared bytes a block, blocks an SM, grid blocks for B envs.
FB_API int efc_contacts_info(int B, int C, int K, int nv, int nbody,
                             int* out) {
  if (!valid(B, C, K, nv, nbody)) return -1;
  const size_t smem = sizeof(float) * (size_t)layout(C, K, nv, nbody).total;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, efc_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = geometry<false>(smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs, out[1] = (int)smem, out[2] = blocks, out[3] = B;
  return 0;
}
