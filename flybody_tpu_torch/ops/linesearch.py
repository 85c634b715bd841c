"""Exact Newton line search along a direction: row 13.

Counterpart of flybody_tpu/ops/linesearch.py (`alpha_ref`, and the same
math as `search_planes`, which the TPU's Newton kernels inline). Along
x + a dx the cost's slope phi'(a) and curvature phi''(a) are per-row
functions of jar0 + a jv, so the search needs only these precomputes: the
limit rows (jar0, jv, active, D), the contact slots (jar0 xyz, jv xyz, mu,
frictional, active, D) and the smooth terms sm0 = msm.dx, smm = dx.M dx.
Bracket doubling from a = 1, then guarded Newton/bisection on phi'; fixed
trip counts. Its CUDA counterpart is `ls_alpha_warp` in
csrc/linesearch.cuh, which the Newton kernels (csrc/newton.cu) inline and
the standalone kernel of the dense path (`line_search`, row 13, the TPU's
`_ls_pallas`; csrc/linesearch.cu) runs one warp per env, with each env's
operands staged once (contact slots in registers, the limit rows that can
carry weight in shared memory).
"""

from __future__ import annotations

import ctypes

import torch

from flybody_tpu_torch.ops import _cuda

launches = 0  # line_search kernel launches

# Phases of the staged kernel's clock instantiation (record_phases), in
# order: the operands staged, the bracket doubling, the guarded
# Newton/bisection steps, the slope at 0 and the store.
PHASES = ('stage-in', 'bracket', 'refinement', 'final slope')


def slope_curv(a, lim, con, sm0, smm):
    """phi'(a), phi''(a) per env. lim: 4 x (B, L); con: 10 x (B, K)."""
    jar0_l, jv_l, act0_l, D_l = lim
    jar_l = jar0_l + a[:, None] * jv_l
    act_l = act0_l * (jar_l < 0)
    f_l = -D_l * jar_l * act_l
    slope = sm0 + a * smm - torch.sum(f_l * jv_l, -1)
    curv = smm + torch.sum(D_l * act_l * jv_l ** 2, -1)
    n0, t10, t20, v0, v1, v2, mu, fric, act, D = con
    N = n0 + a[:, None] * v0
    y1 = t10 + a[:, None] * v1
    y2 = t20 + a[:, None] * v2
    T = torch.sqrt(y1 * y1 + y2 * y2)
    amu = 1.0 / torch.clamp(mu, min=1e-6)
    safe_T = torch.clamp(T, min=1e-15)
    w = (N + amu * T) / (1.0 + amu * amu)
    top = N >= mu * T
    bottom = mu * N + T <= 0.0
    coef = 1.0 - amu * w / safe_T
    zero = torch.zeros_like(N)
    r0 = torch.where(bottom, N, N - w)
    r1 = torch.where(bottom, y1, y1 * coef)
    r2 = torch.where(bottom, y2, y2 * coef)
    r0, r1, r2 = (torch.where(top, zero, r0), torch.where(top, zero, r1),
                  torch.where(top, zero, r2))
    fp = fric > 0
    r0 = torch.where(fp, r0, torch.clamp(N, max=0.0))
    r1 = torch.where(fp, r1, zero)
    r2 = torch.where(fp, r2, zero)
    slope = slope + torch.sum(D * act * (r0 * v0 + r1 * v1 + r2 * v2), -1)
    yv = (y1 / safe_T) * v1 + (y2 / safe_T) * v2
    vt2 = v1 * v1 + v2 * v2
    c = 1.0 / (1.0 + amu * amu)
    qdP = (c * v0 * v0 + 2.0 * amu * c * v0 * yv + amu * amu * c * yv * yv
           + (amu * w / safe_T) * (vt2 - yv * yv))
    q = torch.where(bottom, v0 * v0 + vt2, v0 * v0 + vt2 - qdP)
    q = torch.where(top, zero, q)
    q = torch.where(fp, q, (N < 0).to(N.dtype) * v0 * v0)
    curv = curv + torch.sum(D * act * q, -1)
    return slope, torch.clamp(curv, min=1e-15)


def alpha_ref(lim, con, sm0, smm, expand_iters: int, ls_iters: int):
    """Exact Newton line search (bracket doubling, then guarded
    Newton/bisection on phi'); per-env step size (B,)."""
    hi = torch.ones_like(sm0)
    for _ in range(expand_iters):
        s, _ = slope_curv(hi, lim, con, sm0, smm)
        hi = torch.where(s < 0, hi * 2.0, hi)
    lo = torch.zeros_like(hi)
    for _ in range(ls_iters):
        mid = 0.5 * (lo + hi)
        s, c = slope_curv(mid, lim, con, sm0, smm)
        cand = mid - s / c
        probe = torch.where((cand > lo) & (cand < hi), cand, mid)
        sp, _ = slope_curv(probe, lim, con, sm0, smm)
        lo = torch.where(sp < 0, probe, lo)
        hi = torch.where(sp < 0, hi, probe)
    alpha = 0.5 * (lo + hi)
    s0, _ = slope_curv(torch.zeros_like(alpha), lim, con, sm0, smm)
    return torch.where(s0 < 0, alpha, torch.zeros_like(alpha))


def line_search_ref(lim, con, sc, expand_iters: int, ls_iters: int):
    """Plain version of row 13 on stacked planes: lim (B, 4, L) [jar0 | jv
    | active | D], con (B, 10, K) [jar0 xyz | jv xyz | mu | frictional |
    active | D], sc (B, 2) [sm0 | smm]; alpha (B,)."""
    return alpha_ref(lim.unbind(1), con.unbind(1), sc[:, 0], sc[:, 1],
                     expand_iters, ls_iters)


def live_rows(lim, expand_iters: int):
    """The limit rows the kernel keeps (csrc/linesearch.cu ls_row_dead),
    (B, L) bool from lim (B, 4, L): all but the rows whose weight active *
    D is zero with every operand finite and |jar0| + 2^expand_iters |jv|
    and |D| times it at most 1e37, which add +-0 to phi' and phi'' at
    every step of the search (alpha <= 2^expand_iters)."""
    jl, vl, al, Dl = (t.float() for t in lim.unbind(1))
    amax = torch.tensor(2.0 ** min(expand_iters, 128), dtype=torch.float32)
    jar = jl.abs() + amax * vl.abs()
    dead = (((al == 0) | (Dl == 0)) & (jar <= 1e37) & (Dl.abs() * jar <= 1e37)
            & (al.abs() <= 1e37))
    return ~dead


def line_search(lim, con, sc, expand_iters: int, ls_iters: int):
    """Row 13 on CUDA tensors, `line_search_ref` on CPU tensors."""
    if lim.device.type == 'cpu':
        return line_search_ref(lim, con, sc, expand_iters, ls_iters)
    global launches
    Bn, L, K = lim.shape[0], lim.shape[2], con.shape[2]
    _cuda.check(lim, (Bn, 4, L), 'lim')
    _cuda.check(con, (Bn, 10, K), 'con')
    _cuda.check(sc, (Bn, 2), 'sc')
    alpha = sc.new_empty((Bn,))
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function('linesearch', 'line_search_f32',
                        [P] * 4 + [I] * 5 + [P])
    rc = fn(lim.data_ptr(), con.data_ptr(), sc.data_ptr(), alpha.data_ptr(),
            Bn, L, K, expand_iters, ls_iters, _cuda.stream())
    _cuda.raise_on(rc, 'line_search_f32')
    launches += 1
    return alpha


def record_phases(fn, batch: int, stride: int, device):
    """Runs fn() (row 13 launches on `batch` envs) with the staged
    kernel's phase clocks on: every stride-th env's cycles in each phase of
    PHASES, an int64 tensor (ceil(batch / stride), len(PHASES)) on the
    CPU."""
    return _cuda.record_phases('linesearch', 'line_search_phase_clock',
                               len(PHASES), fn, batch, stride, device)


def kernel_info(batch: int, L: int, K: int) -> dict:
    """Registers a thread, shared memory a block, blocks an SM and grid
    blocks of the staged kernel at these widths (it takes K <= 64, L <=
    512; the first design takes the rest)."""
    out = (ctypes.c_int * 4)()
    I = ctypes.c_int
    fn = _cuda.function('linesearch', 'line_search_info',
                        [I] * 3 + [ctypes.POINTER(I * 4)])
    _cuda.raise_on(fn(batch, L, K, ctypes.byref(out)), 'line_search_info')
    return _cuda.info_dict(out)
