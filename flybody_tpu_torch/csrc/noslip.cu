// Kernel 11: the fused noslip post-pass.
//
// Replaces flybody_tpu/ops/noslip_gs.py::make_noslip_fused_pe (:227, the
// Pallas call at :283). Semantics: noslip_fused_ref in
// flybody_tpu_torch/ops/noslip_gs.py: P = M^-1 J_t^T with the packed arrow
// factor of M (2K right-hand sides), the closed-form inverses of the 2x2
// blocks A_k = J_t,k P_k, then `iterations` Gauss-Seidel sweeps over the K
// contact slots: each updates the slot's two tangent forces from the
// residual J_t,k x - aref, clamps them to the friction circle of radius
// mu f_n, and moves x by P_k times the change. A slot with use = 0 keeps
// its forces, so it moves x by P_k 0.
//
// What bounds it: bytes. Per env it reads the factor (14.6 KB) and J_t
// (2K x nv: 55 KB at K = 64) and writes x and the tangent forces: ~73 KB
// at K = 64, ~30 KB at K = 16.
//
// Design: one block of 128 threads an env, over the env's list of slots
// with use > 0 (ascending; make_efc's slots are ordered by depth, so a few
// of the K). Only listed slots get their two right-hand sides in the arrow
// substitution (arrow.cuh), their 2x2 inverse and their place in the
// sweeps. An unlisted slot's update is an exact zero (x moves by P_k 0)
// when its P_k and forces are finite, so skipping it leaves x and the
// forces as the every-slot kernel computes them, bit for bit but for the
// sign of a zero. Guard: an env whose factor, J_t rows, x0 or ft0 hold a
// non-finite value sweeps all K slots as the every-slot kernel does; so
// does one whose unlisted P columns could overflow (a bound solve with |F|
// on the largest |J_t| entry of each dof over the unlisted rows reaches
// 1e30): one warp computes the bound while another runs the first sweep,
// and such an env starts again from x0 and ft0. The factor comes in by a
// 1-D bulk copy (bulk.cuh), each listed slot's two J_t rows (contiguous)
// by one; the listed slots are processed in chunks of at most kChunk, so
// that shared memory holds kChunk slots' columns of P (five blocks an SM
// at K = 64): a list that fits one chunk is solved once for all sweeps, a
// longer one (or the every-slot path at K = 64) re-solves each chunk in
// each sweep, with the same arithmetic. The sweeps run in one warp as
// before: two 108-long dot products with butterfly sums (each lane's dofs
// lane + 32 q) and a 108-long update of x per slot, the next listed slot's
// J_t rows loaded from L2 while the current one updates.

#include "arrow.cuh"
#include "bulk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerLane = 4;  // dofs per lane in the sweeps: nv <= 128
constexpr int kChunk = 32;   // slots whose P columns shared memory holds
constexpr int kPhases = 6;   // ops/noslip_gs.PHASES
constexpr float kBound = 1e30f;  // the guard's limit on |P| entries

long long* g_clk = nullptr;  // host: where the clock instantiation adds
int g_clk_stride = 1;        // every stride-th env is recorded

// Shared-memory offsets in floats (host-computed).
struct Layout {
  int A, P, Ai, x, ft, ar, lm, us, list, bnd, red, total;
};

struct NoslipArgs {
  const float *F, *Jt, *aref, *lim, *use, *x0, *ft0;
  float *x_o, *ft_o;
  int K, iterations, C;  // C: slots a chunk
  long long* clk;        // clock instantiation: (ceil(B / stride), kPhases)
  int clk_stride;
  ArrowPart p;
  Layout L;
};

// In place on b (dof layout, nonnegative): an upper bound of |F^-T F^-1 y|
// over every y with |y| <= b entrywise, the substitution of arrow_solve
// (arrow.cuh) with |F| and sums of absolute values. One warp calls it: a
// lane a limb, a root dof, lane 0 the root block.
__device__ void arrow_bound(const float* F, float* b, const ArrowPart& p) {
  const int t = threadIdx.x & 31;
  const int dm = p.dm, nr = p.nr, nl = p.nl;
  const int rowlen = (dm + nr) * dm;
  if (t < nl) {
    const float* D = F + t * rowlen;
    float* y = b + p.lo[t];
    for (int k = 0; k < p.d[t]; ++k) {
      float s = y[k];
      for (int i = 0; i < k; ++i) s += fabsf(D[k * dm + i]) * y[i];
      y[k] = s / fabsf(D[k * dm + k]);
    }
  }
  __syncwarp();
  if (t < nr) {
    float s = b[t];
    for (int l = 0; l < nl; ++l) {
      const float* LB = F + l * rowlen + dm * dm;
      for (int k = 0; k < p.d[l]; ++k)
        s += fabsf(LB[t * dm + k]) * b[p.lo[l] + k];
    }
    b[t] = s;
  }
  __syncwarp();
  if (t == 0) {
    const float* LR = F + nl * rowlen;
    for (int k = 0; k < nr; ++k) {
      float s = b[k];
      for (int i = 0; i < k; ++i) s += fabsf(LR[k * dm + i]) * b[i];
      b[k] = s / fabsf(LR[k * dm + k]);
    }
    for (int k = nr - 1; k >= 0; --k) {
      float s = b[k];
      for (int i = k + 1; i < nr; ++i) s += fabsf(LR[i * dm + k]) * b[i];
      b[k] = s / fabsf(LR[k * dm + k]);
    }
  }
  __syncwarp();
  if (t < nl) {
    const float* D = F + t * rowlen;
    float* y = b + p.lo[t];
    const int d = p.d[t];
    for (int a = 0; a < d; ++a) {
      float s = y[a];
      for (int r = 0; r < nr; ++r) s += fabsf(D[(dm + r) * dm + a]) * b[r];
      y[a] = s;
    }
    for (int k = d - 1; k >= 0; --k) {
      float s = y[k];
      for (int i = k + 1; i < d; ++i) s += fabsf(D[i * dm + k]) * y[i];
      y[k] = s / fabsf(D[k * dm + k]);
    }
  }
  __syncwarp();
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
    noslip_kernel(const __grid_constant__ NoslipArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int e = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nw = kThreads >> 5;
  const ArrowPart& p = a.p;
  const Layout& L = a.L;
  const int nv = p.nv, K = a.K, K2 = 2 * K;
  const int msize = (p.nl + 1) * (p.dm + p.nr) * p.dm;
  long long ph[kPhases], c_last = 0;
  if constexpr (kClock) {
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    c_last = clock64();
  }
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  float* A = sm + L.A;    // packed factor
  float* P = sm + L.P;    // (2C, nv): a chunk's J_t rows -> P columns
  float* Ai = sm + L.Ai;  // (C, 4) the chunk's 2x2 inverses, row-major
  float* x = sm + L.x;    // (nv)
  float* ft = sm + L.ft;  // (K, 2)
  float* ar = sm + L.ar;  // (K, 2) tangent aref
  float* lm = sm + L.lm;  // (K) friction-circle radii
  float* us = sm + L.us;  // (K) active frictional slots
  int* list = reinterpret_cast<int*>(sm + L.list);  // (K) slots swept
  float* bnd = sm + L.bnd;                          // (nv) the guard's bound
  int* red = reinterpret_cast<int*>(sm + L.red);    // [n listed]
  const float* Je = a.Jt + (size_t)e * K2 * nv;
  uint32_t parity = 0;  // of the barrier's next phase

  // ---- Stage-in: the factor (bulk), the slot list, the state; the scan
  // of every J_t row for the guard.
  if (t == 0) {
    mbar_init(bar, 1);
    mbar_expect_bytes(bar, 4u * msize);
    bulk_load(A, a.F + (size_t)e * msize, 4u * msize, bar);
  }
  bool bad = false;
  for (int v = t; v < nv; v += kThreads) {
    const float xv = a.x0[(size_t)e * nv + v];
    x[v] = xv;
    bad |= !isfinite(xv);
  }
  for (int q = t; q < K2; q += kThreads) {
    const float f = a.ft0[(size_t)e * K2 + q];
    ft[q] = f;
    bad |= !isfinite(f);
    ar[q] = a.aref[(size_t)e * K2 + q];
  }
  for (int k = t; k < K; k += kThreads) {
    lm[k] = a.lim[(size_t)e * K + k];
    us[k] = a.use[(size_t)e * K + k];
  }
  __syncthreads();
  if (warp == 0) {  // the list, ascending, by ballots
    int n = 0;
    for (int base = 0; base < K; base += 32) {
      const bool on = base + lane < K && us[base + lane] > 0.f;
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (on) list[n + __popc(m & ((1u << lane) - 1u))] = base + lane;
      n += __popc(m);
    }
    if (lane == 0) red[0] = n;
  }
  if (t < nv) {  // a dof a thread: every row, largest unlisted |entry|
    float m = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float j0 = Je[(2 * k) * nv + t], j1 = Je[(2 * k + 1) * nv + t];
      bad |= !isfinite(j0) || !isfinite(j1);
      if (!(us[k] > 0.f)) m = fmaxf(m, fmaxf(fabsf(j0), fabsf(j1)));
    }
    bnd[t] = m;
  }
  mbar_wait(bar, parity);
  parity ^= 1;
  for (int i = t; i < msize; i += kThreads) bad |= !isfinite(A[i]);
  bad = __syncthreads_or(bad);
  int n = red[0];
  PHASE(0);

  // ---- Chunks of the list: solve, inverses, sweeps. While warp 0 runs
  // the first chunk's first sweep, warp 1 computes the guard's bound; if
  // it reaches kBound, the env starts again from x0 and ft0 over every
  // slot.
  bool need_bound = !bad && n < K;
  if (bad) {
    for (int k = t; k < K; k += kThreads) list[k] = k;
    n = K;
  }
  const int C = a.C;
  // This lane's entries (dofs lane + 32 q) of a slot's two tangent rows;
  // the next listed slot's rows load while this one updates.
  float c0[kPerLane], c1[kPerLane], n0r[kPerLane], n1r[kPerLane];
  auto load_rows = [&](int k, float* a0, float* a1) {
    const float* j0 = Je + (2 * k) * nv;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int v = lane + 32 * q;
      a0[q] = v < nv ? j0[v] : 0.f;
      a1[q] = v < nv ? j0[nv + v] : 0.f;
    }
  };
  while (true) {
    __syncthreads();
    const int nch = (n + C - 1) / C;
    if (warp == 0 && n > 0) load_rows(list[0], c0, c1);
    for (int it = 0; it < a.iterations; ++it) {
      for (int ch = 0; ch < nch; ++ch) {
        const int lo = ch * C, cn = min(C, n - lo);
        if (nch > 1 || it == 0) {
          // The chunk's J_t rows into P; everyone is done with P first.
          __syncthreads();
          if (t == 0) {
            fence_proxy_async();
            mbar_expect_bytes(bar, 8u * nv * cn);
            for (int c = 0; c < cn; ++c)
              bulk_load(P + 2 * c * nv, Je + (size_t)(2 * list[lo + c]) * nv,
                        8u * nv, bar);
          }
          mbar_wait(bar, parity);
          parity ^= 1;
          arrow_solve(A, P, 2 * cn, nv, p);
          PHASE(2);
          for (int c = warp; c < cn; c += nw) {
            const float* j0 = Je + (2 * list[lo + c]) * nv;
            const float* j1 = j0 + nv;
            const float* p0 = P + (2 * c) * nv;
            const float* p1 = p0 + nv;
            float a_ = 0.f, b = 0.f, c_ = 0.f, d = 0.f;
            for (int v = lane; v < nv; v += 32) {
              a_ += j0[v] * p0[v];
              b += j0[v] * p1[v];
              c_ += j1[v] * p0[v];
              d += j1[v] * p1[v];
            }
            a_ = warp_sum(a_), b = warp_sum(b), c_ = warp_sum(c_);
            d = warp_sum(d);
            if (lane == 0) {
              float det = a_ * d - b * c_;
              if (!(fabsf(det) > 1e-12f)) det = det >= 0.f ? 1e-12f : -1e-12f;
              Ai[4 * c] = d / det;
              Ai[4 * c + 1] = -b / det;
              Ai[4 * c + 2] = -c_ / det;
              Ai[4 * c + 3] = a_ / det;
            }
          }
          __syncthreads();
          PHASE(3);
        }
        if (warp == 1 && need_bound && it == 0 && ch == 0)
          arrow_bound(A, bnd, p);
        if (warp == 0) {
          for (int c = 0; c < cn; ++c) {
            const int j = lo + c, k = list[j];
            load_rows(list[j + 1 < n ? j + 1 : 0], n0r, n1r);
            float r0 = 0.f, r1 = 0.f;
#pragma unroll
            for (int q = 0; q < kPerLane; ++q) {
              const int v = lane + 32 * q;
              if (v < nv) {
                r0 += c0[q] * x[v];
                r1 += c1[q] * x[v];
              }
            }
            r0 = warp_sum(r0) - ar[2 * k];
            r1 = warp_sum(r1) - ar[2 * k + 1];
            const float* ai = Ai + 4 * c;
            const float f0 = ft[2 * k], f1 = ft[2 * k + 1];
            float n0 = f0 - (ai[0] * r0 + ai[1] * r1);
            float n1 = f1 - (ai[2] * r0 + ai[3] * r1);
            const float norm = sqrtf(n0 * n0 + n1 * n1);
            const float lk = lm[k];
            if (norm > lk) {
              const float s = lk / fmaxf(norm, 1e-15f);
              n0 *= s;
              n1 *= s;
            }
            if (!(us[k] > 0.f)) n0 = f0, n1 = f1;
            const float d0 = n0 - f0, d1 = n1 - f1;
            const float* p0 = P + (2 * c) * nv;
            const float* p1 = p0 + nv;
            for (int v = lane; v < nv; v += 32) x[v] += p0[v] * d0 + p1[v] * d1;
            __syncwarp();
            if (lane == 0) {
              ft[2 * k] = n0;
              ft[2 * k + 1] = n1;
            }
            __syncwarp();
#pragma unroll
            for (int q = 0; q < kPerLane; ++q) c0[q] = n0r[q], c1[q] = n1r[q];
          }
        }
        PHASE(4);
      }
    }
    if (!need_bound) break;
    if (warp == 1 && n == 0) arrow_bound(A, bnd, p);  // no sweep ran
    bool over = false;
    __syncthreads();
    for (int v = t; v < nv; v += kThreads) over |= !(bnd[v] < kBound);
    need_bound = false;
    const bool restart = __syncthreads_or(over);
    PHASE(1);
    if (!restart) break;
    for (int v = t; v < nv; v += kThreads) x[v] = a.x0[(size_t)e * nv + v];
    for (int q = t; q < K2; q += kThreads) ft[q] = a.ft0[(size_t)e * K2 + q];
    for (int k = t; k < K; k += kThreads) list[k] = k;
    n = K;
  }
  __syncthreads();
  for (int v = t; v < nv; v += kThreads) a.x_o[(size_t)e * nv + v] = x[v];
  for (int q = t; q < K2; q += kThreads) a.ft_o[(size_t)e * K2 + q] = ft[q];
  PHASE(5);
  if constexpr (kClock) {
    if (t == 0 && e % a.clk_stride == 0)
      for (int i = 0; i < kPhases; ++i)
        a.clk[(size_t)(e / a.clk_stride) * kPhases + i] += ph[i];
  }
}

int up4(int n) { return (n + 3) & ~3; }

// Host: the chunk size and the shared-memory layout at K slots.
Layout layout(int K, int C, const ArrowPart& p) {
  const int nv = p.nv, msize = (p.nl + 1) * (p.dm + p.nr) * p.dm;
  Layout L;
  int off = 4;  // the mbarrier
  auto take = [&](int n) {
    const int o = off;
    off += up4(n);
    return o;
  };
  L.A = take(msize), L.P = take(2 * C * nv), L.Ai = take(4 * C);
  L.x = take(nv), L.ft = take(2 * K), L.ar = take(2 * K), L.lm = take(K);
  L.us = take(K), L.list = take(K), L.bnd = take(nv), L.red = take(1);
  L.total = off;
  return L;
}

bool supported(int B, int K, const ArrowPart& p) {
  return p.nl >= 1 && p.nl <= 16 && K >= 1 && B >= 1 &&
         p.nv <= 32 * kPerLane && p.nl <= kThreads && p.nv <= kThreads;
}

template <bool kClock>
cudaError_t geometry(size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      noslip_kernel<kClock>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, noslip_kernel<kClock>, kThreads, smem);
}

}  // namespace

// F and Jt start 16-byte aligned; an env's factor and a slot's two J_t rows
// are multiples of 16 bytes (the bulk copies' terms; the wrapper checks).
FB_API int noslip_fused_f32(const float* F, const float* Jt, const float* aref,
                            const float* lim, const float* use,
                            const float* x0, const float* ft0, float* x,
                            float* ft, int B, int K, int iterations,
                            const ArrowPart* part, void* stream) {
  if (!supported(B, K, *part)) return -1;
  NoslipArgs a{};
  a.F = F, a.Jt = Jt, a.aref = aref, a.lim = lim, a.use = use;
  a.x0 = x0, a.ft0 = ft0, a.x_o = x, a.ft_o = ft;
  a.K = K, a.iterations = iterations, a.C = K < kChunk ? K : kChunk;
  a.p = *part;
  a.L = layout(K, a.C, *part);
  const size_t smem = sizeof(float) * (size_t)a.L.total;
  if (smem > 232448) return -1;  // Hopper's shared memory per block
  int blocks = 0;
  cudaError_t err;
  if (g_clk) {
    a.clk = g_clk, a.clk_stride = g_clk_stride;
    err = geometry<true>(smem, &blocks);
    if (err != cudaSuccess) return (int)err;
    noslip_kernel<true><<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  } else {
    err = geometry<false>(smem, &blocks);
    if (err != cudaSuccess) return (int)err;
    noslip_kernel<false><<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// Phase clocks: while clk is set, every launch runs the clock instantiation
// and adds the cycles of each phase of every stride-th env to clk
// ((ceil(B / stride), kPhases) int64); nullptr turns it off.
FB_API int noslip_phase_clock(long long* clk, int stride) {
  if (stride < 1) return -1;
  g_clk = clk, g_clk_stride = stride;
  return 0;
}

// Resources of the main instantiation at K slots: out = registers a
// thread, shared bytes a block, blocks an SM, grid blocks for B envs.
FB_API int noslip_info(int B, int K, const ArrowPart* part, int* out) {
  if (!supported(B, K, *part)) return -1;
  const int C = K < kChunk ? K : kChunk;
  const size_t smem = sizeof(float) * (size_t)layout(K, C, *part).total;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, noslip_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = geometry<false>(smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs, out[1] = (int)smem, out[2] = blocks, out[3] = B;
  return 0;
}
