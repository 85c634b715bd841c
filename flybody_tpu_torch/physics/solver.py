"""Constraint rows and the Newton solver.

Counterpart of flybody_tpu/physics/solver.py: MuJoCo's soft constraints
(joint limits + elliptic-cone contacts), `make_efc`, `solve` and the
`noslip` post-pass. All functions carry a leading env dimension.

`make_efc` takes its contact rows from kernel 7 (`efc_stage.contact_rows`)
when every dof hangs from one kinematic root, and otherwise (several
flies) from the plain multi-tree form with a reference point per dof
(`contact_rows_multi`), as the JAX package does.

`solve` dispatches as the JAX package does, on the arrow partition and on
the rank of qM:
  * partition, qM packed (the engine's walking fly): iterations <= refactor
    period runs the whole solve in one launch of kernel 9
    (`newton_fused.newton_solve`); otherwise each refactor block assembles
    the packed Hessian (bf16-rounded J^T W J operands at float32, as the
    JAX split form) and the Woodbury rows here and launches kernel 8
    (`newton_fused.newton_block`), or, with `block_full` (the preset key
    newton_block_full), launches kernel 9's block-full mode, which
    assembles both in the kernel in float32 (`newton_fused.
    newton_block_full`);
  * partition, qM dense (the walking fly's `smooth.crb`, as
    tools/profile_engine.py prepares it): `solve_arrow_dense`, the arrow
    Newton step on the dense Hessian with cross-limb contact rows carried
    by Woodbury (K3 with 1 + 3 SB right-hand sides, row 14 on the
    capacitance, row 15, row 13), and the reuse iterations of each
    refactor block in one launch of kernel 10 (`newton_fused.reuse`);
  * no partition (several flies): `solve_dense`, each fresh Newton step
    assembles the dense Hessian and factors and solves it (row 17,
    ops/cholesky.py), reuse steps substitute with the last factor (row
    15), every step's exact line search is row 13 (ops/linesearch.py).
`noslip` dispatches on the factor's rank: a packed arrow factor launches
kernel 11 (`noslip_gs.noslip_fused`), a dense one solves P = M^-1 J_t^T by
row 16 and sweeps by row 12 (noslip_gs.gs).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.model.spec import FlyModel
from flybody_tpu_torch.ops import arrow as _ar
from flybody_tpu_torch.ops import cholesky as _chol
from flybody_tpu_torch.ops import efc_stage as _efc
from flybody_tpu_torch.ops import linesearch as _ls
from flybody_tpu_torch.ops import newton_fused as _nf
from flybody_tpu_torch.ops import noslip_gs as _ngs
from flybody_tpu_torch.ops.efc_stage import kbi
from flybody_tpu_torch.ops.newton_fused import cone_hessian, cone_residual
from flybody_tpu_torch.physics import collision as _col
from flybody_tpu_torch.physics import smooth as _sm
from flybody_tpu_torch.physics.math import cross
from flybody_tpu_torch.physics.state import Data


@dataclasses.dataclass
class EfcRows:
    """L limit rows + K contact slots (3 rows each), batched."""

    lim_dof: np.ndarray  # (L,) static
    lim_sign: np.ndarray  # (L,) static
    lim_active: torch.Tensor  # (B, L)
    lim_aref: torch.Tensor
    lim_D: torch.Tensor
    lim_pos: torch.Tensor
    con_J: torch.Tensor  # (B, K, 3, nv)
    con_active: torch.Tensor  # (B, K)
    con_frictional: torch.Tensor
    con_mu: torch.Tensor
    con_aref: torch.Tensor  # (B, K, 3)
    con_D: torch.Tensor
    con_pos: torch.Tensor
    con_sel: torch.Tensor  # (B, K) int64 global slot ids
    con_xpos: torch.Tensor  # (B, K, 3)
    con_normal: torch.Tensor  # (B, K, 3)
    con_body1: torch.Tensor  # (B, K) int64
    con_body2: torch.Tensor
    con_self: torch.Tensor
    con_break: torch.Tensor

    def index(self, idx) -> 'EfcRows':
        """The rows of envs `idx` (the static limit tables stay)."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[idx]
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})

    def to(self, device=None, dtype=None) -> 'EfcRows':
        """On `device`, floating fields in `dtype` (None: as they are)."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if torch.is_tensor(v):
                kw[f.name] = v.to(device=device, dtype=(
                    dtype if dtype is not None and v.is_floating_point()
                    else None))
        return dataclasses.replace(self, **kw)


@functools.lru_cache(maxsize=8)
def limit_tables(meta: _s.Meta):
    """Two rows (lower, upper) per limited slide/hinge joint."""
    dofs, signs, jids = [], [], []
    for j in range(meta.njnt):
        if meta.jnt_limited[j] and meta.jnt_type[j] in (_s.SLIDE, _s.HINGE):
            dofs += [meta.jnt_dofadr[j]] * 2
            signs += [1.0, -1.0]
            jids += [j, j]
    return (np.array(dofs, np.int64), np.array(signs), np.array(jids,
                                                                  np.int64))


TILE = 32  # the dense candidates' prefilter tile (solver.py:271)


def contact_candidates(model: FlyModel, con: _col.Contact,
                       k: int | None = None):
    """The operands of efc_stage.contact_rows: cand_b (B, C, 7) [dist |
    pos | normal], cand_u (B, C, 14) efc_slot_table rows and cand_g (B, C)
    global slot ids. A compact Contact gives the dense slots, then the
    compact blocks. A dense one (no blocks) gives every slot, cut by the
    JAX package's exact two-stage prefilter when there are more than 16
    tiles of TILE slots (solver.py:271-316): the T = min(max(TILE, k), nt)
    tiles with the smallest minimum score (dist - includemargin), in that
    order, padded slots scored 1e10; the k smallest scores lie in them, and
    row 7 sees the JAX package's candidates in its order, so ties break
    the same way. `k`: the selection's size (a dense Contact needs it)."""
    B = con.dist.shape[0]
    table = _col.efc_slot_table(model)
    if not con.blocks:
        if k is None:
            raise ValueError('a dense Contact needs the selection size k')
        S = con.dist.shape[1]
        bcat = torch.cat([con.dist[..., None], con.pos, con.normal], -1)
        gid = model.const('slot_ids_f', lambda: np.arange(S, dtype=float))
        if S <= 16 * TILE:
            return (bcat, table.expand(B, -1, -1).contiguous(),
                    gid.expand(B, -1).contiguous())
        pad = (-S) % TILE
        nt = (S + pad) // TILE
        T = min(max(TILE, k), nt)
        pad_b = bcat.new_tensor([1e10, 0, 0, 0, 0, 0, 1]).expand(B, pad, 7)
        bcat = torch.cat([bcat, pad_b], 1).reshape(B, nt, TILE, 7)
        table = torch.cat([table, table.new_zeros((pad, 14))]).reshape(
            nt, TILE, 14)
        gid = torch.cat([gid, gid.new_zeros(pad)]).reshape(nt, TILE)
        score = bcat[..., 0] - table[..., 0]
        tidx = _col.smallest(score.amin(-1), T)  # (B, T)
        bi = torch.arange(B, device=tidx.device)[:, None]
        return (bcat[bi, tidx].reshape(B, T * TILE, 7),
                table[tidx].reshape(B, T * TILE, 14),
                gid[tidx].reshape(B, T * TILE))
    dsid = _col.dense_slot_ids(model.meta)
    ucat = table[dsid]
    cand_b = torch.cat([torch.cat([con.dist[..., None], con.pos, con.normal],
                                  -1)]
                       + [torch.cat([b.dist[..., None], b.pos, b.normal], -1)
                          for b in con.blocks], 1)
    cand_u = torch.cat([ucat.expand(B, -1, -1)]
                       + [b.params for b in con.blocks], 1)
    gid = model.const('dense_slot_ids_f', lambda: dsid.astype(np.float64))
    cand_g = torch.cat([gid.expand(B, -1)] + [b.idx for b in con.blocks], 1)
    return cand_b, cand_u, cand_g


def tree_count(meta: _s.Meta) -> int:
    """The number of kinematic roots that hold dofs (one per fly)."""
    root = np.array(meta.body_rootid)
    return len(np.unique(root[np.array(meta.dof_bodyid)]))


def contact_rows_multi(model: FlyModel, data: Data, cand_b, cand_u, cand_g,
                       k: int):
    """The plain multi-tree form of efc_stage.contact_rows (the JAX
    package's branch for several kinematic trees): the same selection and
    rows, with each dof's Jacobian taken about the subtree CoM of its own
    tree's root, and no cross-limb flag (there is no arrow partition)."""
    meta = model.meta
    bsel, usel, gsel = _efc.select(cand_b, cand_u, cand_g, k)
    frame = _efc.frame_rows(bsel)
    b1, b2 = _efc.body_ids(usel)
    mask = model.body_dof_mask
    w = mask[b2] - mask[b1]  # (B, k, nv)
    root = np.array(meta.body_rootid)
    ref = data.subtree_com[:, root[np.array(meta.dof_bodyid)]]  # (B, nv, 3)
    arm = bsel[..., None, 1:4] - ref[:, None]  # (B, k, nv, 3)
    contrib = (data.cdof[:, None, :, 3:]
               + cross(data.cdof[:, None, :, :3], arm))
    con_J = torch.einsum('bkrx,bkvx->bkrv', frame,
                         contrib * w[..., None])
    c_break = torch.zeros_like(bsel[..., 0])
    return con_J, _efc.row_scalars(bsel, usel, gsel, con_J, c_break,
                                   data.qvel)


def make_efc(model: FlyModel, data: Data, con: _col.Contact,
             ncon_max: int) -> EfcRows:
    """Joint-limit rows + the ncon_max contact slots with the smallest
    dist - includemargin, from a compact or a dense Contact."""
    meta = model.meta
    dt = data.qpos.dtype
    lim_dof, lim_sign, lim_jid = limit_tables(meta)
    sign = model.const('lim_sign', lambda: lim_sign)
    jrange = model.jnt_range[lim_jid]
    qp = data.qpos[:, np.array(meta.jnt_qposadr)[lim_jid]]
    dist = torch.where(sign > 0, qp - jrange[:, 0], jrange[:, 1] - qp)
    margin = model.jnt_margin[lim_jid]
    lim_active = (dist < margin).to(dt)
    r = dist - margin
    K_, B_, imp = kbi(model.jnt_solref[lim_jid], model.jnt_solimp[lim_jid], r)
    aref = -B_ * data.qvel[:, lim_dof] * sign - K_ * imp * r
    R = torch.clamp((1.0 - imp) / imp * model.dof_invweight0[lim_dof],
                    min=1e-12)

    k = min(ncon_max, con.dist.shape[1]
            + sum(b.dist.shape[1] for b in con.blocks))
    cand_b, cand_u, cand_g = contact_candidates(model, con, k)
    rows = (_efc.contact_rows if tree_count(meta) == 1
            else contact_rows_multi)
    con_J, scal = rows(model, data, cand_b, cand_u, cand_g, k)
    return EfcRows(
        lim_dof=lim_dof, lim_sign=lim_sign, lim_active=lim_active,
        lim_aref=aref, lim_D=1.0 / R, lim_pos=dist, con_J=con_J,
        con_active=scal[1], con_frictional=scal[2], con_mu=scal[3],
        con_aref=torch.stack(scal[5:8], -1), con_D=scal[4], con_pos=scal[0],
        con_sel=torch.round(scal[18]).long(),
        con_xpos=torch.stack(scal[8:11], -1),
        con_normal=torch.stack(scal[11:14], -1),
        con_body1=torch.round(scal[14]).long(),
        con_body2=torch.round(scal[15]).long(),
        con_self=scal[16], con_break=scal[17])


class Operands(NamedTuple):
    """What both Newton forms read besides M, a_free and the warmstart."""

    conJ: torch.Tensor  # (B, K, 3, nv), contiguous
    bsel: torch.Tensor  # (B, SB) Woodbury slots: deepest cross-limb ones
    brk: torch.Tensor  # (B, K) active cross-limb slots
    hess_active: torch.Tensor  # (B, K) active slots of the packed Hessian
    lim_params: torch.Tensor  # (B, 2, L) [active | D]
    con_params: torch.Tensor  # (B, 4, K) [mu | frictional | active | D]


def operands(efc: EfcRows, sb_break: int) -> Operands:
    K = efc.con_J.shape[1]
    brk = efc.con_break * efc.con_active
    score_b = torch.where(brk > 0, efc.con_pos, torch.full_like(brk, 1e10))
    return Operands(
        conJ=efc.con_J.contiguous(),
        bsel=_col.smallest(score_b, min(sb_break, K)), brk=brk,
        hess_active=efc.con_active * (1.0 - efc.con_break),
        lim_params=torch.stack([efc.lim_active, efc.lim_D], 1),
        con_params=torch.stack([efc.con_mu, efc.con_frictional,
                                efc.con_active, efc.con_D], 1))


def con_params5(ops: Operands):
    """(B, 5, K) [mu | frictional | active | D | hess_active]."""
    return torch.cat([ops.con_params, ops.hess_active[:, None]], 1)


def solve_args(part, M, efc: EfcRows, ops: Operands, a_free, ws):
    """The arguments of newton_fused.newton_solve (kernel 9)."""
    return (part, efc.lim_dof, efc.lim_sign, M, ops.conJ,
            ops.bsel.to(torch.int32), a_free, ws, efc.lim_aref.contiguous(),
            efc.con_aref.contiguous(), ops.lim_params, con_params5(ops))


def block_full_args(part, M, efc: EfcRows, ops: Operands, st):
    """The arguments of newton_fused.newton_block_full (kernel 9's
    block-full mode) but for the trip counts."""
    return (part, efc.lim_dof, efc.lim_sign, M, ops.conJ,
            ops.bsel.to(torch.int32), *(t.contiguous() for t in st),
            ops.lim_params, con_params5(ops))


def start_state(part, M, efc: EfcRows, ops: Operands, a_free, ws):
    """(x, M (x - a_free), jar_l, jar_c) at the one of (ws, a_free) with
    the lower primal cost."""
    args = (part, efc.lim_dof, efc.lim_sign, M, ops.conJ, a_free,
            efc.lim_aref, efc.con_aref, ops.lim_params, ops.con_params)
    x = torch.where((_nf.primal_cost(*args, ws)
                     < _nf.primal_cost(*args, a_free))[:, None], ws, a_free)
    sign = x.new_tensor(efc.lim_sign)
    return (x, _ar.matvec_packed(part, M, x - a_free),
            (x[:, efc.lim_dof] * sign - efc.lim_aref).contiguous(),
            _nf.jv(ops.conJ, x) - efc.con_aref)


def block_args(part, M, efc: EfcRows, ops: Operands, st):
    """The arguments of newton_fused.newton_block (kernel 8) but for the
    trip counts: the packed Hessian (bf16-rounded J^T W J operands at
    float32, the JAX split form) and the Woodbury rows at the state."""
    jar_l, jar_c = st[2], st[3]
    Wc = (cone_hessian(jar_c, efc.con_mu, efc.con_frictional,
                       ops.hess_active) * efc.con_D[..., None, None])
    Hp = _nf.assemble_hessian(part, M, ops.conJ, efc.lim_dof,
                              efc.lim_D * efc.lim_active * (jar_l < 0), Wc,
                              bf16=True)
    U = _nf.woodbury_rows(ops.conJ, ops.bsel, jar_c, efc.con_mu,
                          efc.con_frictional, efc.con_D, ops.brk)
    return (part, efc.lim_dof, efc.lim_sign, Hp, M, ops.conJ, U, *st,
            ops.lim_params, ops.con_params)


def solve(model: FlyModel, data: Data, efc: EfcRows, a_free,
          iterations: int, ls_iterations: int, warmstart,
          refactor_period: int, sb_break: int, block_full: bool = False):
    """Newton solve for qacc; returns (qacc, qfrc_constraint, f_l, f_c).

    Each block of `refactor_period` iterations assembles the Hessian,
    factors it (block-arrow) and carries up to `sb_break` cross-limb
    contact slots by a rank-3*SB Woodbury correction; iterations inside a
    block reuse the factor. The starting point is whichever of (warmstart,
    a_free) has the lower primal cost. `block_full`: each block of the
    split form assembles its Hessian in the Newton kernel (packed qM only,
    as in JAX). A model without an arrow partition takes the dense branch
    (`solve_dense`), a dense qM with one `solve_arrow_dense`."""
    M = data.qM
    part = _ar.build_partition(model.meta)
    if part is None:
        return solve_dense(M, efc, a_free, iterations, ls_iterations,
                           warmstart, refactor_period)
    ops = operands(efc, sb_break)
    if M.dim() == 3:
        return solve_arrow_dense(part, M, efc, ops, a_free, iterations,
                                 ls_iterations, warmstart, refactor_period)
    if iterations <= max(1, refactor_period):
        return _nf.newton_solve(*solve_args(part, M, efc, ops, a_free,
                                           warmstart),
                                ls_iterations, iterations)

    st = start_state(part, M, efc, ops, a_free, warmstart)
    for n in _blocks(iterations, refactor_period):
        if block_full:
            st = _nf.newton_block_full(*block_full_args(part, M, efc, ops,
                                                        st),
                                       ls_iterations, n)
        else:
            st = _nf.newton_block(*block_args(part, M, efc, ops, st),
                                  ls_iterations, n)

    x, _, jar_l, jar_c = st
    f_l, f_c = _forces(efc, jar_l, jar_c)
    return x, _jt_forces(efc, f_l, f_c), f_l, f_c


# ------------------------------------------------------------ dense path


def _forces(efc: EfcRows, jar_l, jar_c):
    """Limit-row and contact forces at the constraint residuals."""
    f_l = -efc.lim_D * jar_l * (efc.lim_active * (jar_l < 0))
    f_c = -efc.con_D[..., None] * cone_residual(
        jar_c, efc.con_mu, efc.con_frictional, efc.con_active)
    return f_l, f_c


def _jt_forces(efc: EfcRows, f_l, f_c):
    """J^T f (B, nv): the limit rows scattered to their dofs plus the
    contact rows."""
    nv = efc.con_J.shape[-1]
    return (_nf.lim_scatter(nv, efc.lim_dof, f_l * f_l.new_tensor(
        efc.lim_sign)) + _nf.jtf(efc.con_J, f_c))


def primal_cost_dense(M, efc: EfcRows, a_free, x):
    """0.5 (x - a_free)^T M (x - a_free) + the constraint cost, per env
    (the JAX package's _primal_cost with a dense M)."""
    dx = x - a_free
    jl = x[:, efc.lim_dof] * x.new_tensor(efc.lim_sign) - efc.lim_aref
    res = cone_residual(_nf.jv(efc.con_J, x) - efc.con_aref, efc.con_mu,
                        efc.con_frictional, efc.con_active)
    return (0.5 * torch.sum(dx * _ar.matvec(None, M, dx), -1)
            + 0.5 * torch.sum(efc.lim_D * efc.lim_active * (jl < 0) * jl ** 2,
                              -1)
            + 0.5 * torch.sum(efc.con_D[..., None] * res ** 2, (-2, -1)))


def hessian_dense(M, efc: EfcRows, jar_l, jar_c, active=None):
    """Newton Hessian M + J^T (D H) J + the limit diagonal at the residuals
    (B, nv, nv), over the contact slots `active` (None: efc.con_active; the
    arrow branch leaves the cross-limb slots out). At float32 the J^T (H J)
    operands are rounded to bfloat16 and multiplied in float32, as the JAX
    package's MXU form (solver.py:717-723)."""
    Bn, K, _, nv = efc.con_J.shape
    hd = efc.lim_D * efc.lim_active * (jar_l < 0)
    Hc = cone_hessian(jar_c, efc.con_mu, efc.con_frictional,
                      efc.con_active if active is None else active
                      ) * efc.con_D[..., None, None]
    J2 = efc.con_J.reshape(Bn, 3 * K, nv)
    JH = torch.einsum('bkrs,bksv->bkrv', Hc, efc.con_J).reshape(Bn, 3 * K,
                                                                 nv)
    if J2.dtype == torch.float32:
        # A full-float32 product of the rounded operands:
        # torch.backends.cuda.matmul.allow_tf32 must stay False.
        J2 = J2.to(torch.bfloat16).to(torch.float32)
        JH = JH.to(torch.bfloat16).to(torch.float32)
    return (M + J2.transpose(1, 2) @ JH
            + torch.diag_embed(_nf.lim_scatter(nv, efc.lim_dof, hd)))


def dense_start(M, efc: EfcRows, a_free, warmstart):
    """The carried Newton state (x, M (x - a_free), jar_l, jar_c) on a
    dense M, at the one of (warmstart, a_free) with the lower primal
    cost."""
    x = a_free
    if warmstart is not None:
        x = torch.where((primal_cost_dense(M, efc, a_free, warmstart)
                         < primal_cost_dense(M, efc, a_free, a_free))[:, None],
                        warmstart, a_free)
    return (x, _ar.matvec(None, M, x - a_free),
            x[:, efc.lim_dof] * x.new_tensor(efc.lim_sign) - efc.lim_aref,
            _nf.jv(efc.con_J, x) - efc.con_aref)


def grad_dense(efc: EfcRows, st):
    """The cost's gradient at the carried state."""
    f_l, f_c = _forces(efc, st[2], st[3])
    return st[1] - _jt_forces(efc, f_l, f_c)


def ls_and_update(M, efc: EfcRows, st, dx, ls_iterations: int):
    """The exact line search along dx (row 13) and the carried state's
    linear update, M dense."""
    x, msm, jar_l, jar_c = st
    mdx = _ar.matvec(None, M, dx)
    jv_l = dx[:, efc.lim_dof] * dx.new_tensor(efc.lim_sign)
    jv_c = _nf.jv(efc.con_J, dx)
    lim = torch.stack([jar_l, jv_l, efc.lim_active, efc.lim_D], 1)
    con = torch.cat([jar_c.transpose(1, 2), jv_c.transpose(1, 2),
                     torch.stack([efc.con_mu, efc.con_frictional,
                                  efc.con_active, efc.con_D], 1)], 1)
    sc = torch.stack([torch.sum(msm * dx, -1), torch.sum(dx * mdx, -1)], 1)
    alpha = _ls.line_search(lim.contiguous(), con.contiguous(),
                            sc.contiguous(), 6, ls_iterations)
    a = alpha[:, None]
    return (x + a * dx, msm + a * mdx, jar_l + a * jv_l,
            jar_c + alpha[:, None, None] * jv_c)


def _blocks(iterations: int, refactor_period: int):
    """The iteration count of each refactor block: one fresh step and
    n - 1 reuse steps, the tail block truncated."""
    p = max(1, refactor_period)
    return [min(p, iterations - i) for i in range(0, iterations, p)]


def solve_dense(M, efc: EfcRows, a_free, iterations: int, ls_iterations: int,
                warmstart, refactor_period: int):
    """The dense Newton solve (solver.py's dense branch): the start is the
    one of (warmstart, a_free) with the lower primal cost; blocks of one
    fresh step (Hessian, 1e-12 jitter, factor + solve: row 17) and
    refactor_period - 1 reuse steps (substitution with the block's factor:
    row 15), each followed by the exact line search (row 13) and the
    carried state's linear update. Returns (qacc, qfrc_constraint, f_l,
    f_c)."""
    st = dense_start(M, efc, a_free, warmstart)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    for n in _blocks(iterations, refactor_period):
        H = hessian_dense(M, efc, st[2], st[3]) + 1e-12 * eye
        L, sol = _chol.chol_solve(H.contiguous(),
                                  grad_dense(efc, st).contiguous())
        st = ls_and_update(M, efc, st, -sol, ls_iterations)
        for _ in range(n - 1):
            st = ls_and_update(M, efc, st, -_chol.cho_solve(
                L, grad_dense(efc, st).contiguous()), ls_iterations)

    x, _, jar_l, jar_c = st
    f_l, f_c = _forces(efc, jar_l, jar_c)
    return x, _jt_forces(efc, f_l, f_c), f_l, f_c


def fresh_step_arrow(part, M, efc: EfcRows, ops: Operands, st,
                     ls_iterations: int):
    """The arrow Newton step on a dense M (solver.py:835-860): the dense
    Hessian over the arrow-compatible slots (ops.hess_active) + 1e-12 I
    is factored block-arrow and solved for the gradient and the Woodbury
    rows U of the selected cross-limb slots in one launch (K3, 1 + 3 SB
    right-hand sides): t = A^-1 g, Z = A^-1 U^T; the capacitance C = I +
    U Z is factored (row 14, with 1e-10 I), w = C^-1 U t (row 15), dx =
    -(t - Z w), then the line search (row 13). Returns the new state and
    the block's factor (F, Z, U, LC)."""
    nv, SB3 = M.shape[-1], 3 * ops.bsel.shape[1]
    eye = torch.eye(nv, dtype=M.dtype, device=M.device)
    eye_sb = torch.eye(SB3, dtype=M.dtype, device=M.device)
    H = hessian_dense(M, efc, st[2], st[3], ops.hess_active) + 1e-12 * eye
    U = _nf.woodbury_rows(ops.conJ, ops.bsel, st[3], efc.con_mu,
                          efc.con_frictional, efc.con_D, ops.brk)
    rhs = torch.cat([grad_dense(efc, st)[..., None], U.transpose(1, 2)], -1)
    F, sol = _ar.factor_solve(part, H.contiguous(), rhs.contiguous())
    t, Z = sol[..., 0], sol[..., 1:].contiguous()
    LC = _chol.chol((eye_sb + U @ Z + 1e-10 * eye_sb).contiguous())
    w = _chol.cho_solve(LC, torch.einsum('bsv,bv->bs', U, t).contiguous())
    dx = -(t - torch.einsum('bvs,bs->bv', Z, w))
    return ls_and_update(M, efc, st, dx, ls_iterations), (F, Z, U, LC)


def solve_arrow_dense(part, M, efc: EfcRows, ops: Operands, a_free,
                      iterations: int, ls_iterations: int, warmstart,
                      refactor_period: int):
    """The arrow Newton solve on a dense M (solver.py:933-958): from the
    warmstart choice, blocks of one fresh arrow step (`fresh_step_arrow`)
    and refactor_period - 1 reuse iterations with its factor in one launch
    of kernel 10. Cross-limb slots beyond the Woodbury budget stay in the
    gradient and the cost but leave the Hessian. Returns (qacc,
    qfrc_constraint, f_l, f_c)."""
    st = dense_start(M, efc, a_free, warmstart)
    for n in _blocks(iterations, refactor_period):
        st, (F, Z, U, LC) = fresh_step_arrow(part, M, efc, ops, st,
                                             ls_iterations)
        if n > 1:
            st = _nf.reuse(part, efc.lim_dof, efc.lim_sign, F, M, ops.conJ,
                           Z, U, LC, *(s.contiguous() for s in st),
                           ops.lim_params, ops.con_params, ls_iterations,
                           n - 1)
    x, _, jar_l, jar_c = st
    f_l, f_c = _forces(efc, jar_l, jar_c)
    return x, _jt_forces(efc, f_l, f_c), f_l, f_c


def noslip_dense(model: FlyModel, data: Data, efc: EfcRows, qacc, f_c,
                 iterations: int, max_contacts: int | None):
    """The dense noslip (solver.py's dense branch) on the swept prefix:
    P = M^-1 J_t^T by the dense factor data.qLD (smooth.solve_m: row 16),
    the clamped 2x2 inverses, then the sweeps (row 12). Returns (x, ft
    (B, K, 2)) over the prefix and the prefix's operands Jt, ft0."""
    Bn, Kall, _, nv = efc.con_J.shape
    K = Kall if max_contacts is None else min(max_contacts, Kall)
    Jt = efc.con_J[:, :K, 1:, :].contiguous()  # (B, K, 2, nv)
    P = _sm.solve_m(model, data, Jt.reshape(Bn, 2 * K, nv).transpose(
        1, 2).contiguous())  # (B, nv, 2K)
    Pt = P.reshape(Bn, nv, K, 2).permute(0, 2, 3, 1).contiguous()
    use = (efc.con_active[:, :K] * efc.con_frictional[:, :K] > 0).to(
        qacc.dtype)
    lim = torch.clamp(efc.con_mu[:, :K] * f_c[:, :K, 0], min=0.0)
    ft0 = f_c[:, :K, 1:].contiguous()
    x, ft = _ngs.gs(Jt, Pt, _ngs.block_inverses(Jt, Pt).contiguous(),
                    efc.con_aref[:, :K, 1:].contiguous(), lim.contiguous(),
                    use, qacc.contiguous(), ft0, iterations)
    return x, ft, Jt, ft0


def noslip_operands(qLD, efc: EfcRows, qacc, f_c,
                    max_contacts: int | None):
    """The arguments of noslip_gs.noslip_fused (kernel 11) but for the
    sweep count: the first `max_contacts` slots (make_efc orders slots by
    depth, so the active contacts form a prefix; None: all slots)."""
    K = f_c.shape[1] if max_contacts is None else min(max_contacts,
                                                       f_c.shape[1])
    use = (efc.con_active[:, :K] * efc.con_frictional[:, :K] > 0).to(
        qacc.dtype)
    lim = torch.clamp(efc.con_mu[:, :K] * f_c[:, :K, 0], min=0.0)
    return (qLD, efc.con_J[:, :K, 1:, :].contiguous(),
            efc.con_aref[:, :K, 1:].contiguous(), lim, use,
            qacc.contiguous(), f_c[:, :K, 1:].contiguous())


def noslip(model: FlyModel, data: Data, efc: EfcRows, qacc, f_c,
           iterations: int, max_contacts: int | None):
    """Noslip post-pass: Gauss-Seidel over the friction
    rows of active frictional contacts of the swept prefix
    (`noslip_operands`) with normal forces held fixed, clamped to the
    friction circle. Returns (qacc, f_c, the change of qfrc_constraint).
    A dense factor takes the dense branch (`noslip_dense`)."""
    if data.qLD.dim() == 3:
        x, ft, Jt, ft0 = noslip_dense(model, data, efc, qacc, f_c,
                                      iterations, max_contacts)
    else:
        part = _ar.build_partition(model.meta)
        args = noslip_operands(data.qLD, efc, qacc, f_c, max_contacts)
        x, ft = _ngs.noslip_fused(part, *args, iterations)
        Jt, ft0 = args[1], args[6]
    K = ft.shape[1]
    dqfrc = torch.einsum('bkrv,bkr->bv', Jt, ft - ft0)
    ft = torch.cat([ft, f_c[:, K:, 1:]], 1)
    return x, torch.cat([f_c[..., :1], ft], -1), dqfrc
