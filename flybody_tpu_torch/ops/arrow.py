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

The matrix comes packed (B, nl+1, dm+nr, dm) or dense (B, nv, nv), as the
JAX package's kernels take it (`_a_spec`); a dense one is read as its
`factor_ref` reads it (`pack_dense`). On CUDA tensors (float32) the
wrappers launch csrc/arrow.cu, on CPU tensors they run the plain PyTorch
versions:
  * `factor_solve` (kernel K3; `factor_solve_ref`): the factor fused with
    the solve of m right-hand sides;
  * `factor` (row 18; `factor_ref` / `factor_ref_p`): the factor alone;
  * `solve` (row 19; `solve_ref`): the substitution with a factor.
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


def matvec(part: Part | None, M, x):
    """y = M x for M dense (B, nv, nv) or packed; x (B, nv)."""
    if M.dim() == 3:
        return torch.einsum('bij,bj->bi', M, x)
    return matvec_packed(part, M, x)


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


def pack_dense(part: Part, A):
    """Dense (B, nv, nv) -> packed (B, nl+1, dm+nr, dm) as the JAX
    package's factor_ref reads it (`_pack` and jnp.linalg.cholesky's
    symmetrized input): limb blocks and the root block (A + A^T) / 2, the
    borders from the root dofs' rows A[:, :nr, limb], identity padding."""
    nl, dm = len(part.ds), part.dmax
    Mp = pack_sym_ref(part, 0.5 * (A + A.transpose(1, 2)))
    Mp[:, :nl, dm:] = pack_sym_ref(part, A)[:, :nl, dm:]
    return Mp


def factor_ref_p(part: Part, Mp):
    """Packed symmetric (B, nl+1, dm+nr, dm) -> packed arrow factor. A
    block that is not positive definite gives an unusable factor (as the
    JAX reference's NaN and the kernels' clamped pivots do) and raises
    nothing."""
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    D = Mp[:, :nl, :dm, :]
    Bl = Mp[:, :nl, dm:dm + nr, :]
    R = Mp[:, nl, :nr, :nr]
    L = torch.linalg.cholesky_ex(D).L
    LB = torch.linalg.solve_triangular(
        L, Bl.transpose(-1, -2), upper=False).transpose(-1, -2)
    S = R - torch.einsum('biak,bick->bac', LB, LB)
    LR = torch.linalg.cholesky_ex(S).L
    root = Mp.new_zeros((Mp.shape[0], 1, dm + nr, dm))
    root[:, 0, :nr, :nr] = LR
    return torch.cat([torch.cat([L, LB], dim=2), root], dim=1)


def factor_ref(part: Part, A):
    """Dense (B, nv, nv) -> packed arrow factor (the JAX factor_ref)."""
    return factor_ref_p(part, pack_dense(part, A))


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


def _factor_any_ref(part: Part, A):
    return factor_ref(part, A) if A.dim() == 3 else factor_ref_p(part, A)


def factor_solve_ref(part: Part, A, b):
    """Plain version of K3: (F, x) with F the packed factor of A (dense or
    packed) and x = A^-1 b."""
    F = _factor_any_ref(part, A)
    return F, solve_ref(part, F, b)


# ---------------------------------------------------------------------------
# Kernels: K3 (factor + solve), row 18 (factor), row 19 (substitution).

# Phases of K3's kernels (record_phases), in order: the packed
# one-right-hand-side kernel's and the dense form's (whose limb factor
# symmetrizes the blocks as they load, and whose root solve at m > 1
# includes the root right-hand sides).
PHASES = ('stage-in', 'limb factor', 'root factor, F out',
          'forward substitution', 'root solve', 'back substitution',
          'write-out')

launches = 0  # K3
factor_launches = 0  # row 18
solve_launches = 0  # row 19


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


_P, _I = ctypes.c_void_p, ctypes.c_int


def _check_matrix(part: Part, A):
    """A dense (B, nv, nv) or packed (B, nl+1, dm+nr, dm) float32 CUDA
    matrix; returns (B, dense)."""
    Bn = A.shape[0]
    dense = A.dim() == 3
    shape = ((Bn, part.nv, part.nv) if dense else
             (Bn, len(part.ds) + 1, part.dmax + part.nr, part.dmax))
    _cuda.check(A, shape, 'A')
    return Bn, dense


def _check_rhs(part: Part, b, Bn):
    """b (B, nv) or (B, nv, m); returns m."""
    m = 1 if b.dim() == 2 else b.shape[-1]
    _cuda.check(b, (Bn, part.nv) if b.dim() == 2 else (Bn, part.nv, m), 'b')
    return m


def _packed_like(part: Part, A):
    return A.new_empty((A.shape[0], len(part.ds) + 1, part.dmax + part.nr,
                        part.dmax))


def factor_solve(part: Part, A, b):
    """Kernel K3: the packed factor F of A (dense (B, nv, nv) or packed
    (B, nl+1, dm+nr, dm)) and x = A^-1 b, b (B, nv) or (B, nv, m).

    CUDA tensors (float32) launch the kernel (a 128-thread block an env
    where the partition fits the register tile's lanes: a packed A with
    one right-hand side arrow_fs1_kernel, a dense A arrow_dense_kernel;
    else, or a packed A with several, arrow_kernel); CPU tensors take
    factor_solve_ref."""
    if A.device.type == 'cpu' and b.device.type == 'cpu':
        return factor_solve_ref(part, A, b)
    global launches
    Bn, dense = _check_matrix(part, A)
    m = _check_rhs(part, b, Bn)
    F = _packed_like(part, A)
    x = torch.empty_like(b)
    if dense:
        fn = _cuda.function('arrow', 'arrow_factor_solve_dense_f32', [
            _P, _P, _P, _P, _I, _I, ctypes.c_uint, ctypes.POINTER(CPart),
            _P])
        rc = fn(A.data_ptr(), b.data_ptr(), F.data_ptr(), x.data_ptr(), Bn,
                m, _cuda.bulk_mask((A, b, F, x)), ctypes.byref(c_part(part)),
                _cuda.stream())
        _cuda.raise_on(rc, 'arrow_factor_solve_dense_f32')
    elif m == 1:
        fn = _cuda.function('arrow', 'arrow_factor_solve1_f32', [
            _P, _P, _P, _P, _I, ctypes.c_uint, ctypes.POINTER(CPart), _P])
        rc = fn(A.data_ptr(), b.data_ptr(), F.data_ptr(), x.data_ptr(), Bn,
                _cuda.bulk_mask((A, b, F, x)), ctypes.byref(c_part(part)),
                _cuda.stream())
        _cuda.raise_on(rc, 'arrow_factor_solve1_f32')
    else:
        fn = _cuda.function('arrow', 'arrow_factor_solve_f32', [
            _P, _P, _P, _P, _I, _I, _I, ctypes.POINTER(CPart), _P])
        rc = fn(A.data_ptr(), b.data_ptr(), F.data_ptr(), x.data_ptr(), Bn,
                int(dense), m, ctypes.byref(c_part(part)), _cuda.stream())
        _cuda.raise_on(rc, 'arrow_factor_solve_f32')
    launches += 1
    return F, x


def record_phases(fn, batch: int, stride: int, device):
    """Runs fn() (K3 launches on `batch` envs: a packed A with one
    right-hand side, or a dense A) with arrow_fs1_kernel's and
    arrow_dense_kernel's phase clocks on: every stride-th env's cycles in
    each phase of PHASES, an int64 tensor (ceil(batch / stride),
    len(PHASES)) on the CPU."""
    return _cuda.record_phases('arrow', 'arrow_phase_clock', len(PHASES),
                               fn, batch, stride, device)


def kernel_info(part: Part, batch: int, m: int | None = None) -> dict:
    """Registers a thread, shared memory a block, blocks an SM and grid
    blocks of K3's kernel for this partition at this batch:
    arrow_fs1_kernel (packed, one right-hand side), or with m the dense
    form's arrow_dense_kernel at m right-hand sides."""
    out = (ctypes.c_int * 4)()
    ptr = [ctypes.POINTER(CPart), _I, ctypes.POINTER(ctypes.c_int * 4)]
    if m is None:
        fn = _cuda.function('arrow', 'arrow_fs1_info', ptr)
        rc = fn(ctypes.byref(c_part(part)), batch, ctypes.byref(out))
    else:
        fn = _cuda.function('arrow', 'arrow_dense_info',
                            ptr[:1] + [_I] + ptr[1:])
        rc = fn(ctypes.byref(c_part(part)), m, batch, ctypes.byref(out))
    _cuda.raise_on(rc, 'arrow_fs1_info' if m is None else 'arrow_dense_info')
    return _cuda.info_dict(out)


def factor(part: Part, A):
    """Row 18: the packed factor of A (dense or packed); CPU tensors take
    factor_ref / factor_ref_p."""
    if A.device.type == 'cpu':
        return _factor_any_ref(part, A)
    global factor_launches
    Bn, dense = _check_matrix(part, A)
    F = _packed_like(part, A)
    fn = _cuda.function('arrow', 'arrow_factor_f32', [
        _P, _P, _I, _I, ctypes.POINTER(CPart), _P])
    rc = fn(A.data_ptr(), F.data_ptr(), Bn, int(dense),
            ctypes.byref(c_part(part)), _cuda.stream())
    _cuda.raise_on(rc, 'arrow_factor_f32')
    factor_launches += 1
    return F


def solve(part: Part, F, b):
    """Row 19: x = A^-1 b from the packed factor F, b (B, nv) or (B, nv,
    m); CPU tensors take solve_ref."""
    if F.device.type == 'cpu' and b.device.type == 'cpu':
        return solve_ref(part, F, b)
    global solve_launches
    Bn = F.shape[0]
    _cuda.check(F, (Bn, len(part.ds) + 1, part.dmax + part.nr, part.dmax),
                'F')
    m = _check_rhs(part, b, Bn)
    x = torch.empty_like(b)
    fn = _cuda.function('arrow', 'arrow_solve_f32', [
        _P, _P, _P, _I, _I, ctypes.POINTER(CPart), _P])
    rc = fn(F.data_ptr(), b.data_ptr(), x.data_ptr(), Bn, m,
            ctypes.byref(c_part(part)), _cuda.stream())
    _cuda.raise_on(rc, 'arrow_solve_f32')
    solve_launches += 1
    return x
