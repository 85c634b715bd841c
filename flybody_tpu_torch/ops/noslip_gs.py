"""The noslip post-pass: kernels 11 (packed factor) and 12 (dense path).

Counterpart of flybody_tpu/ops/noslip_gs.py. Gauss-Seidel sweeps over the
friction rows of the active frictional contacts with the normal forces
held fixed, each slot's tangent force clamped to its friction circle.

  * `noslip_fused` (kernel 11, csrc/noslip.cu; the TPU's
    `make_noslip_fused_pe`): the M^-1 J_t^T solve by the packed arrow
    factor, the 2x2 block inverses and the sweeps in one launch. Plain
    version `noslip_fused_ref` (the JAX package's `_fused_ref`).
  * `gs` (row 12, csrc/noslip_gs.cu; the TPU's `_noslip_pallas` behind
    `make_gs_pe`): the sweeps alone, given P = M^-1 J_t^T and the
    inverses (the dense path computes them outside). Plain version
    `gs_ref` (the JAX package's `_reference`).

CUDA tensors launch the kernels (float32, contiguous, and for kernel 11
F and Jt 16-byte aligned with 16-byte multiples an env; anything else
raises); CPU tensors run the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from flybody_tpu_torch.ops import _cuda
from flybody_tpu_torch.ops import arrow as _ar
from flybody_tpu_torch.ops import newton_fused as _nf

# Phases of kernel 11's clock instantiation (record_phases), in order.
PHASES = ('stage-in', 'guard', 'solve', 'inverses', 'sweeps', 'write-out')

launches = 0  # noslip_fused (kernel 11) launches
gs_launches = 0  # gs (row 12) launches


def noslip_fused_ref(part, F, Jt, aref_t, lim, use, x0, ft0,
                     iterations: int):
    """P = M^-1 J_t^T by the packed factor F, the 2x2 block inverses, then
    `iterations` sweeps. Shapes: F (B, nl+1, dm+nr, dm); Jt (B, K, 2, nv);
    aref_t (B, K, 2); lim, use (B, K); x0 (B, nv); ft0 (B, K, 2). Returns
    (x (B, nv), ft (B, K, 2))."""
    Bn, K = Jt.shape[:2]
    nv = part.nv
    Pt = _ar.solve_ref(part, F, Jt.reshape(Bn, 2 * K, nv).transpose(1, 2))
    Pt = Pt.reshape(Bn, nv, K, 2).permute(0, 2, 3, 1)  # (B, K, 2, nv)
    return gs_ref(Jt, Pt, block_inverses(Jt, Pt), aref_t, lim, use, x0, ft0,
                  iterations)


def block_inverses(Jt, Pt):
    """Closed-form inverses (B, K, 2, 2) of the 2x2 blocks A_k = J_t,k
    P_k (Jt, Pt (B, K, 2, nv)), the determinant held at least 1e-12 from
    zero with its sign."""
    A = torch.einsum('bkrv,bksv->bkrs', Jt, Pt)
    a, b_, c_, d_ = A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1]
    det = a * d_ - b_ * c_
    det = torch.where(torch.abs(det) > 1e-12, det,
                      torch.where(det >= 0, torch.full_like(det, 1e-12),
                                  torch.full_like(det, -1e-12)))
    return torch.stack([torch.stack([d_, -b_], -1),
                        torch.stack([-c_, a], -1)], -2) / det[..., None, None]


def gs_ref(Jt, Pt, Ainv, aref_t, lim, use, x0, ft0, iterations: int):
    """Plain version of row 12: `iterations` Gauss-Seidel sweeps over the
    K slots. Shapes: Jt, Pt (B, K, 2, nv) (Pt[:, k, r] = M^-1 J_t[k, r]);
    Ainv (B, K, 2, 2); aref_t (B, K, 2); lim, use (B, K); x0 (B, nv); ft0
    (B, K, 2). Returns (x (B, nv), ft (B, K, 2))."""
    K = Jt.shape[1]
    on = use > 0
    x = x0
    ft = ft0.clone()
    for _ in range(iterations):
        for k in range(K):
            res = torch.einsum('brv,bv->br', Jt[:, k], x) - aref_t[:, k]
            new = ft[:, k] - torch.einsum('brs,bs->br', Ainv[:, k], res)
            norm = torch.linalg.norm(new, dim=-1, keepdim=True)
            lk = lim[:, k, None]
            new = torch.where(norm > lk,
                              new * (lk / torch.clamp(norm, min=1e-15)), new)
            new = torch.where(on[:, k, None], new, ft[:, k])
            x = x + torch.einsum('brv,br->bv', Pt[:, k], new - ft[:, k])
            ft[:, k] = new
    return x, ft


def noslip_fused(part, F, Jt, aref_t, lim, use, x0, ft0, iterations: int):
    """Kernel 11 on CUDA tensors, `noslip_fused_ref` on CPU tensors."""
    if F.device.type == 'cpu':
        return noslip_fused_ref(part, F, Jt, aref_t, lim, use, x0, ft0,
                                iterations)
    global launches
    nl, dm, nr, nv = len(part.ds), part.dmax, part.nr, part.nv
    Bn, K = Jt.shape[:2]
    for t, shape, name in ((F, (Bn, nl + 1, dm + nr, dm), 'F'),
                           (Jt, (Bn, K, 2, nv), 'Jt'),
                           (aref_t, (Bn, K, 2), 'aref_t'),
                           (lim, (Bn, K), 'lim'), (use, (Bn, K), 'use'),
                           (x0, (Bn, nv), 'x0'), (ft0, (Bn, K, 2), 'ft0')):
        _cuda.check(t, shape, name)
    # The factor and each slot's two J_t rows come in by bulk copies.
    _nf.check_slabs((F, 'F'), (Jt, 'Jt'))
    if (8 * nv) % 16:
        raise ValueError(f'Jt: a slot\'s two rows ({8 * nv} B) must be a '
                         f'multiple of 16 bytes for the bulk copies')
    x = torch.empty_like(x0)
    ft = torch.empty_like(ft0)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function('noslip', 'noslip_fused_f32', [P] * 9 + [
        I, I, I, ctypes.POINTER(_ar.CPart), P])
    rc = fn(*(t.data_ptr() for t in (F, Jt, aref_t, lim, use, x0, ft0, x,
                                     ft)),
            Bn, K, iterations, ctypes.byref(_ar.c_part(part)),
            _cuda.stream())
    _cuda.raise_on(rc, 'noslip_fused_f32')
    launches += 1
    return x, ft


def record_phases(fn, batch: int, stride: int, device):
    """Runs fn() (noslip_fused launches on `batch` envs) with kernel 11's
    phase clocks on: every stride-th env's cycles in each phase of PHASES,
    an int64 tensor (ceil(batch / stride), len(PHASES)) on the CPU."""
    return _cuda.record_phases('noslip', 'noslip_phase_clock', len(PHASES),
                               fn, batch, stride, device)


def kernel_info(part, batch: int, K: int) -> dict:
    """Registers a thread, shared memory a block, blocks an SM (the
    occupancy calculator) and grid blocks of kernel 11 at K slots."""
    out = (ctypes.c_int * 4)()
    fn = _cuda.function('noslip', 'noslip_info', [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(_ar.CPart),
        ctypes.POINTER(ctypes.c_int * 4)])
    _cuda.raise_on(fn(batch, K, ctypes.byref(_ar.c_part(part)),
                      ctypes.byref(out)), 'noslip_info')
    return _cuda.info_dict(out)


def gs(Jt, Pt, Ainv, aref_t, lim, use, x0, ft0, iterations: int):
    """Row 12 on CUDA tensors, `gs_ref` on CPU tensors (same arguments and
    results)."""
    if Jt.device.type == 'cpu':
        return gs_ref(Jt, Pt, Ainv, aref_t, lim, use, x0, ft0, iterations)
    global gs_launches
    Bn, K, _, nv = Jt.shape
    for t, shape, name in ((Jt, (Bn, K, 2, nv), 'Jt'),
                           (Pt, (Bn, K, 2, nv), 'Pt'),
                           (Ainv, (Bn, K, 2, 2), 'Ainv'),
                           (aref_t, (Bn, K, 2), 'aref_t'),
                           (lim, (Bn, K), 'lim'), (use, (Bn, K), 'use'),
                           (x0, (Bn, nv), 'x0'), (ft0, (Bn, K, 2), 'ft0')):
        _cuda.check(t, shape, name)
    x = torch.empty_like(x0)
    ft = torch.empty_like(ft0)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function('noslip_gs', 'noslip_gs_f32',
                        [P] * 10 + [I] * 4 + [P])
    rc = fn(*(t.data_ptr() for t in (Jt, Pt, Ainv, aref_t, lim, use, x0, ft0,
                                     x, ft)),
            Bn, nv, K, iterations, _cuda.stream())
    _cuda.raise_on(rc, 'noslip_gs_f32')
    gs_launches += 1
    return x, ft
