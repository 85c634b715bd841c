"""Block-arrow (branch-sparse) Cholesky factor/solve for the fly tree.

Counterpart of flybody_tpu/ops/arrow.py. Ordering dofs [root, limb_1 ..
limb_N] makes the mass matrix (and the arrow-compatible part of the Newton
Hessian) block-arrow: limb diagonal blocks D_i, root-limb borders B_i and
the root block R. The packed layout (nl + 1, dm + nr, dm) per env is the
JAX package's:

    Mp[i, :d, :d]       = D_i   (identity on padded diagonal entries)
    Mp[i, dm:dm+nr, :d] = B_i
    Mp[nl, :nr, :nr]    = R

and the packed factor F has the same shape:
    F[i, :dm, :]  = L_i  (lower Cholesky of D_i, identity in padding)
    F[i, dm:, :]  = LB_i = B_i L_i^-T
    F[nl, :nr, :nr] = L_R (lower Cholesky of R - sum_i LB_i LB_i^T).

`factor_solve` is kernel K3 (csrc/arrow.cu) on CUDA tensors and the plain
PyTorch version (`factor_solve_ref`) on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from flybody_tpu_torch.ops import _cuda


class Part(NamedTuple):
    """Static arrow partition of the dof vector (hashable)."""

    los: tuple[int, ...]  # limb dof block starts
    ds: tuple[int, ...]  # limb dof block sizes
    nr: int  # root (border) dof count; root dofs are [0, nr)
    nv: int
    dmax: int
    limb_of_body: tuple[int, ...]  # -1 for world/trunk bodies


@functools.lru_cache(maxsize=8)
def build_partition(meta) -> Part | None:
    """Limb/root partition from the body tree (the JAX package's rule):
    the trunk absorbs bodies while a body has at most one child with
    dofs below it (dof-less side branches join the trunk); the remaining
    subtrees are limbs. None when the layout is not [root, contiguous
    limb blocks] or the partition is unprofitable."""
    nb = meta.nbody
    par = np.array(meta.body_parentid)
    kids: list[list[int]] = [[] for _ in range(nb)]
    for b in range(1, nb):
        kids[par[b]].append(b)
    dof_body = np.array(meta.dof_bodyid)
    sub_dofs = np.zeros(nb, dtype=np.int64)
    for b in dof_body:
        sub_dofs[b] += 1
    for b in range(nb - 1, 0, -1):  # children have higher ids
        sub_dofs[par[b]] += sub_dofs[b]

    trunk = {0}
    limb_roots: list[int] = []
    frontier = [0]
    while frontier:
        b = frontier.pop()
        dofful = [c for c in kids[b] if sub_dofs[c] > 0]
        for c in kids[b]:
            if sub_dofs[c] == 0:
                trunk.add(c)
                frontier.append(c)
        if len(dofful) == 1:
            trunk.add(dofful[0])
            frontier.append(dofful[0])
        else:
            limb_roots.extend(dofful)
    if len(limb_roots) < 2:
        return None

    def subtree(b):
        out = [b]
        for c in kids[b]:
            out.extend(subtree(c))
        return out

    root_dofs = sorted(d for d in range(meta.nv) if dof_body[d] in trunk)
    nr = len(root_dofs)
    if root_dofs != list(range(nr)):
        return None
    limb_of_body = np.full(nb, -1, dtype=np.int64)
    blocks = []
    for li, r in enumerate(sorted(limb_roots)):
        bodies = subtree(r)
        dofs = sorted(d for d in range(meta.nv)
                      if dof_body[d] in set(bodies))
        if not dofs or dofs != list(range(dofs[0], dofs[-1] + 1)):
            return None
        blocks.append((dofs[0], len(dofs)))
        for b in bodies:
            limb_of_body[b] = li
    blocks.sort()
    pos = nr
    for lo, d in blocks:
        if lo != pos:
            return None
        pos += d
    if pos != meta.nv:
        return None
    dmax = max(d for _, d in blocks)
    if dmax > 16 or dmax < nr:
        return None
    return Part(los=tuple(lo for lo, _ in blocks),
                ds=tuple(d for _, d in blocks), nr=nr, nv=meta.nv,
                dmax=dmax, limb_of_body=tuple(int(x) for x in limb_of_body))


@functools.lru_cache(maxsize=8)
def pad_eye_np(part: Part) -> np.ndarray:
    """(nl+1, dm+nr, dm) with 1.0 on padded limb-diagonal positions."""
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    pe = np.zeros((nl + 1, dm + nr, dm))
    for i, d in enumerate(part.ds):
        for j in range(d, dm):
            pe[i, j, j] = 1.0
    return pe


@functools.lru_cache(maxsize=8)
def limb_dof_tables(part: Part):
    """idx (nl, dm) dof index (0 in padding), w (nl, dm) validity mask,
    flat (nv - nr,) positions of the live limb slots in the (nl*dm,)
    flattening, in dof order."""
    nl, dm = len(part.ds), part.dmax
    idx = np.zeros((nl, dm), np.int64)
    w = np.zeros((nl, dm))
    flat = []
    for i, (lo, d) in enumerate(zip(part.los, part.ds)):
        idx[i, :d] = np.arange(lo, lo + d)
        w[i, :d] = 1.0
        flat.extend(i * dm + j for j in range(d))
    return idx, w, np.array(flat, np.int64)


def _tables(part: Part, like: torch.Tensor):
    idx, w, flat = limb_dof_tables(part)
    dev = like.device
    return (torch.as_tensor(idx, device=dev),
            torch.as_tensor(w, dtype=like.dtype, device=dev),
            torch.as_tensor(flat, device=dev))


def pack_sym_ref(part: Part, A, pad_identity: bool = True):
    """Dense symmetric (B, nv, nv) with the tree's arrow sparsity ->
    packed (B, nl+1, dm+nr, dm). Padded limb-diagonal entries are 1 when
    pad_identity, 0 otherwise (so packs add)."""
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    idx, w, _ = _tables(part, A)
    Bn = A.shape[0]
    D = A[:, idx[:, :, None], idx[:, None, :]] * (w[:, :, None]
                                                   * w[:, None, :])
    Bl = (A[:, :nr][:, :, idx] * w).permute(0, 2, 1, 3)  # (B, nl, nr, dm)
    root = A.new_zeros((Bn, 1, dm + nr, dm))
    root[:, 0, :nr, :nr] = A[:, :nr, :nr]
    Mp = torch.cat([torch.cat([D, Bl], dim=2), root], dim=1)
    if pad_identity:
        Mp = Mp + torch.as_tensor(pad_eye_np(part), dtype=A.dtype,
                                  device=A.device)
    return Mp


def add_diag_packed(part: Part, Mp, diag):
    """Packed M plus diag(diag); diag (nv,) or (B, nv). Padding untouched."""
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    idx, w, _ = _tables(part, Mp)
    ext = diag[..., idx] * w  # (..., nl, dm)
    add = torch.zeros_like(Mp)
    add[:, :nl, :dm, :] = torch.diag_embed(ext)
    add[:, nl, :nr, :nr] = torch.diag_embed(diag[..., :nr])
    return Mp + add


def matvec_packed(part: Part, Mp, x):
    """y = M x for packed symmetric M; x (B, nv) or (B, nv, m)."""
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    vec = x.dim() == 2
    xm = x[..., None] if vec else x
    idx, w, flat = _tables(part, Mp)
    xlp = xm[:, idx] * w[None, :, :, None]  # (B, nl, dm, m)
    D = Mp[:, :nl, :dm, :]
    Bl = Mp[:, :nl, dm:dm + nr, :]
    R = Mp[:, nl, :nr, :nr]
    xr = xm[:, :nr]
    ylp = (torch.einsum('bijk,bikm->bijm', D, xlp)
           + torch.einsum('birj,brm->bijm', Bl, xr))
    y_r = (torch.einsum('birk,bikm->brm', Bl, xlp)
           + torch.einsum('brs,bsm->brm', R, xr))
    Bn, m = xm.shape[0], xm.shape[-1]
    out = torch.cat([y_r, ylp.reshape(Bn, nl * dm, m)[:, flat]], dim=1)
    return out[..., 0] if vec else out


def factor_ref_p(part: Part, Mp):
    """Packed symmetric (B, nl+1, dm+nr, dm) -> packed arrow factor."""
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    D = Mp[:, :nl, :dm, :]
    Bl = Mp[:, :nl, dm:dm + nr, :]
    R = Mp[:, nl, :nr, :nr]
    L = torch.linalg.cholesky(D)
    LB = torch.linalg.solve_triangular(
        L, Bl.transpose(-1, -2), upper=False).transpose(-1, -2)
    S = R - torch.einsum('biak,bick->bac', LB, LB)
    LR = torch.linalg.cholesky(S)
    root = Mp.new_zeros((Mp.shape[0], 1, dm + nr, dm))
    root[:, 0, :nr, :nr] = LR
    return torch.cat([torch.cat([L, LB], dim=2), root], dim=1)


def solve_ref(part: Part, F, b):
    """Solve A x = b given the packed factor; b (B, nv) or (B, nv, m)."""
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    vec = b.dim() == 2
    bm = b[..., None] if vec else b
    idx, w, flat = _tables(part, F)
    L = F[:, :nl, :dm, :]
    LB = F[:, :nl, dm:, :]
    LR = F[:, nl, :nr, :nr]
    bl = bm[:, idx] * w[None, :, :, None]  # (B, nl, dm, m)
    y = torch.linalg.solve_triangular(L, bl, upper=False)
    br = bm[:, :nr] - torch.einsum('biak,bikm->bam', LB, y)
    yr = torch.linalg.solve_triangular(LR, br, upper=False)
    xr = torch.linalg.solve_triangular(LR.transpose(-1, -2), yr, upper=True)
    y2 = y - torch.einsum('biak,bam->bikm', LB, xr)
    xl = torch.linalg.solve_triangular(L.transpose(-1, -2), y2, upper=True)
    Bn, m = bm.shape[0], bm.shape[-1]
    out = torch.cat([xr, xl.reshape(Bn, nl * dm, m)[:, flat]], dim=1)
    return out[..., 0] if vec else out


def factor_solve_ref(part: Part, Mp, b):
    """Plain version of K3: (F, x) with F the packed factor of Mp."""
    F = factor_ref_p(part, Mp)
    return F, solve_ref(part, F, b)


# ---------------------------------------------------------------------------
# Kernel K3: fused factor + solve of a packed arrow matrix, one vector rhs.

launches = 0


class _Limbs(ctypes.Structure):
    _fields_ = [('lo', ctypes.c_int * 16), ('d', ctypes.c_int * 16)]


class CPart(ctypes.Structure):
    """The partition as csrc/arrow.cuh's ArrowPart."""

    _fields_ = [('nl', ctypes.c_int), ('dm', ctypes.c_int),
                ('nr', ctypes.c_int), ('nv', ctypes.c_int),
                ('lo', ctypes.c_int * 16), ('d', ctypes.c_int * 16)]


@functools.lru_cache(maxsize=8)
def c_part(part: Part) -> CPart:
    if not 1 <= len(part.ds) <= 16:
        raise ValueError('the arrow kernels take 1 to 16 limb blocks')
    cp = CPart(nl=len(part.ds), dm=part.dmax, nr=part.nr, nv=part.nv)
    for i, (lo, d) in enumerate(zip(part.los, part.ds)):
        cp.lo[i], cp.d[i] = lo, d
    return cp


def factor_solve(part: Part, Mp, b):
    """Packed factor F of Mp (B, nl+1, dm+nr, dm) and x = Mp^-1 b, b (B, nv).

    CUDA tensors (float32) launch K3; CPU tensors take factor_solve_ref."""
    if Mp.device.type == 'cpu' and b.device.type == 'cpu':
        return factor_solve_ref(part, Mp, b)
    global launches
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    Bn = Mp.shape[0]
    _cuda.check(Mp, (Bn, nl + 1, dm + nr, dm), 'Mp')
    _cuda.check(b, (Bn, part.nv), 'b')
    F = torch.empty_like(Mp)
    x = torch.empty_like(b)
    limbs = _Limbs()
    for i, (lo, d) in enumerate(zip(part.los, part.ds)):
        limbs.lo[i], limbs.d[i] = lo, d
    fn = _cuda.function('arrow', 'arrow_factor_solve_f32', [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(_Limbs), ctypes.c_void_p])
    rc = fn(Mp.data_ptr(), b.data_ptr(), F.data_ptr(), x.data_ptr(), Bn,
            nl, dm, nr, part.nv, ctypes.byref(limbs), _cuda.stream())
    _cuda.raise_on(rc, 'arrow_factor_solve_f32')
    launches += 1
    return F, x
