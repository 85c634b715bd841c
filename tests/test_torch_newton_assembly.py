"""The Newton kernels' sparse Hessian assembly schedule, on the CPU.

Kernel 9 (both modes, csrc/newton.cu) assembles the packed Hessian
M + J^T W J + diag(limit) + 1e-12 without a J W buffer: a mask marks the
limbs (and the root) whose columns each contact slot's J rows touch (a
nonzero or NaN entry); each limb's tile (rows: the limb's dofs and the
root's; columns: the limb's) is summed in registers over the slots that
touch the limb and whose W_k is not all zero, with W_k J at the tile's
columns formed per slot; the root's 6 x 6 tile likewise over the slots
that touch the root. `tile_schedule` below is that schedule in plain torch.
Skipped terms are exact zeros (the kernels also keep each entry's sum in
the dense order, so on the card their Hessian is the dense float32
assembly's bit for bit):

  * at float64 it agrees with `newton_fused.assemble_hessian(bf16=False)`
    (the kernels' plain version) and with the Hessian the JAX package's
    `_ref_block_full` hands its block (captured from its `_ref_block`
    call) to 1e-12 of each entry's scale (the same sum over absolute
    values), on the entries the kernels write: the lower triangles of the
    limb and root blocks and the borders; also with a third of the slots
    at hess_active * D = 0;
  * a NaN in one limb column of one hess-active slot's J reaches that
    limb's tile (the column's row and column) and the root border, and no
    other limb's tile;
  * `newton_fused.check_slabs`, the wrappers' check before the kernels'
    bulk copies, refuses an offset view and a slab of a size that is not a
    multiple of 16 bytes.

Inputs: test_torch_solver_kernels.newton_inputs (seeded arrow-SPD M and
arrow-compatible contact rows, as tests/test_ops.py builds them).
"""

import jax
import numpy as np
import pytest
import torch

from flybody_tpu.ops import newton_fused as jnf
from flybody_tpu_torch.ops import newton_fused as tnf
from test_torch_solver_kernels import _t, newton_inputs, parts  # noqa: F401

TOL = 1e-12


def tile_schedule(part, Mp, conJ, lim_dof, hd, Wc):
    """The kernels' assembly in plain torch: per env, per limb l the tile
    rows (limb l, root) x columns (limb l) over the slots touching limb l
    with W_k not all zero, W_k J at the columns formed per slot; the root
    tile over the slots touching the root. Only the entries the kernels
    write (the lower limb and root triangles, the borders) are added to
    Mp; the limit diagonal and 1e-12 on the diagonal."""
    B, K, _, nv = conJ.shape
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    diag = tnf.lim_scatter(nv, lim_dof, hd) + 1e-12
    H = Mp.clone()
    touch = conJ != 0  # NaN counts as touching
    live = (Wc != 0).flatten(2).any(-1)  # (B, K)
    for b in range(B):
        for l, (lo, d) in enumerate(zip(part.los, part.ds)):
            rows = list(range(lo, lo + d)) + list(range(nr))
            tile = conJ.new_zeros((d + nr, d))
            for k in range(K):
                if not (touch[b, k, :, lo:lo + d].any() and live[b, k]):
                    continue
                Jk = conJ[b, k]
                tile += Jk[:, rows].T @ (Wc[b, k] @ Jk[:, lo:lo + d])
            low = torch.tril(tile[:d]) + torch.diag(diag[b, lo:lo + d])
            H[b, l, :d, :d] += low
            H[b, l, dm:dm + nr, :d] += tile[d:]
        root = conJ.new_zeros((nr, nr))
        for k in range(K):
            if touch[b, k, :, :nr].any() and live[b, k]:
                Jr = conJ[b, k, :, :nr]
                root += Jr.T @ (Wc[b, k] @ Jr)
        H[b, nl, :nr, :nr] += torch.tril(root) + torch.diag(diag[b, :nr])
    return H


def written(part, H):
    """The entries the kernels write, flattened per env: the lower
    triangles of the limb blocks (live rows) and of the root block, and
    the borders."""
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    mask = torch.zeros(H.shape[1:], dtype=torch.bool)
    for l, d in enumerate(part.ds):
        mask[l, :d, :d] = torch.tril(torch.ones(d, d, dtype=torch.bool))
        mask[l, dm:dm + nr, :d] = True
    mask[nl, :nr, :nr] = torch.tril(torch.ones(nr, nr, dtype=torch.bool))
    return H[:, mask]


def operands(part, d, zero_every=0):
    """(Mp, conJ, lim_dof, hd, Wc) of newton_inputs at float64; every
    zero_every-th slot gets D = 0 (hess_active * D = 0)."""
    mu, fric, act, D, hact = _t(d['con_params5']).unbind(1)
    if zero_every:
        D = D.clone()
        D[:, ::zero_every] = 0.0
    actl, Dl = _t(d['lim_params']).unbind(1)
    jar_l, jar_c = _t(d['jar_l']), _t(d['jar_c'])
    Wc = tnf.cone_hessian(jar_c, mu, fric, hact) * D[..., None, None]
    return (_t(d['Mp']), _t(d['conJ']), d['lim_dof'],
            Dl * actl * (jar_l < 0), Wc, D)


def jax_hessian(jp, d, D):
    """The packed Hessian the JAX `_ref_block_full` assembles (its
    `_ref_block` argument), per env."""
    cp = np.array(d['con_params5'])
    cp[:, 3] = D.numpy()
    orig = jnf._ref_block
    jnf._ref_block = lambda part, ld, ls, lsi, ni, Hp, *rest: Hp
    try:
        return np.asarray(jax.vmap(lambda *a: jnf._ref_block_full(
            jp, d['lim_dof'], d['lim_sign'], 8, 1, *a))(
                d['Mp'], d['conJ'], d['ohb'], d['x'], d['msm'], d['jar_l'],
                d['jar_c'], d['lim_params'], cp))
    finally:
        jnf._ref_block = orig


def scale(part, Mp, conJ, lim_dof, hd, Wc):
    """Per entry, the same assembly over absolute values."""
    return tnf.assemble_hessian(part, Mp.abs(), conJ.abs(), lim_dof,
                                hd.abs(), Wc.abs(), bf16=False)


@pytest.mark.parametrize('zero_every', [0, 3])
def test_tile_schedule_matches_dense_assembly_and_jax(parts, zero_every):
    jp, tp = parts
    d = newton_inputs(jp, np.float64)
    Mp, conJ, lim_dof, hd, Wc, D = operands(tp, d, zero_every)
    if zero_every:
        assert (Wc[:, ::zero_every] == 0).all()
    got = written(tp, tile_schedule(tp, Mp, conJ, lim_dof, hd, Wc))
    tol = TOL * written(tp, scale(tp, Mp, conJ, lim_dof, hd, Wc))
    dense = written(tp, tnf.assemble_hessian(tp, Mp, conJ, lim_dof, hd, Wc,
                                             bf16=False))
    ref = written(tp, torch.as_tensor(np.array(jax_hessian(jp, d, D))))
    assert torch.isfinite(got).all()
    for what, want in (('assemble_hessian', dense), ('JAX', ref)):
        err = (got - want).abs()
        assert (err <= tol).all(), (what, float((err / tol).max()))


def test_nan_in_one_limb_column_reaches_its_tile_and_the_border(parts):
    jp, tp = parts
    d = newton_inputs(jp, np.float64)
    Mp, conJ, lim_dof, hd, Wc, _ = operands(tp, d)
    dm, nr = tp.dmax, tp.nr
    live = (Wc != 0).flatten(2).any(-1)
    # A hess-active slot and a limb its rows touch.
    b, k, l = next((b, k, l) for b in range(conJ.shape[0])
                   for k in range(conJ.shape[1]) if live[b, k]
                   for l, (lo, dd) in enumerate(zip(tp.los, tp.ds))
                   if (conJ[b, k, :, lo:lo + dd] != 0).any())
    lo, dl, c = tp.los[l], tp.ds[l], 2
    conJ = conJ.clone()
    conJ[b, k, 1, lo + c] = float('nan')
    H = tile_schedule(tp, Mp, conJ, lim_dof, hd, Wc)[b]
    assert torch.isnan(H[l, c, :c + 1]).all()  # the column's row
    assert torch.isnan(H[l, c:dl, c]).all()  # its column
    assert torch.isnan(H[l, dm:dm + nr, c]).all()  # the root border
    others = torch.ones(H.shape[0], dtype=torch.bool)
    others[l] = False
    assert torch.isfinite(H[others]).all()


def test_slab_check_refuses_misaligned_and_ragged_slabs():
    buf = torch.zeros(4 * 108 + 1)
    tnf.check_slabs((buf[:-1].view(4, 108), 'x'))  # aligned: passes
    with pytest.raises(ValueError, match='16-byte aligned'):
        tnf.check_slabs((buf[1:].view(4, 108), 'x'))
    with pytest.raises(ValueError, match='multiple of 16 bytes'):
        tnf.check_slabs((torch.zeros(4, 2, 3), 'jar_c'))
