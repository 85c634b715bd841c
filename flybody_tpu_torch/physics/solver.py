"""Constraint rows and the Newton solver (plain PyTorch), default preset.

Counterpart of flybody_tpu/physics/solver.py: MuJoCo's soft constraints
(joint limits + elliptic-cone contacts), `make_efc` through its single-tree
row assembly (`_contact_rows_ref`), `solve` through the packed block-arrow
branch with one fresh factor per Newton iteration (the JAX package's
`_ref_block` / `_ref_step` with the exact line search `alpha_ref`), and the
packed `noslip` Gauss-Seidel post-pass (`noslip_gs._fused_ref`). All
functions carry a leading env dimension.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.model.spec import FlyModel
from flybody_tpu_torch.ops import arrow as _ar
from flybody_tpu_torch.physics import collision as _col
from flybody_tpu_torch.physics.math import cross
from flybody_tpu_torch.physics.state import Data

NCON_MAX = 64
SB_BREAK = 8  # Woodbury budget for cross-limb contact rows


def impedance(solimp, r):
    d0, dmax, width, mid, power = solimp.unbind(-1)
    x = torch.clamp(torch.abs(r) / torch.clamp(width, min=1e-15), 0.0, 1.0)
    lo = x ** power / torch.clamp(mid ** (power - 1), min=1e-15)
    hi = 1.0 - (1.0 - x) ** power / torch.clamp((1.0 - mid) ** (power - 1),
                                                min=1e-15)
    imp = d0 + torch.where(x <= mid, lo, hi) * (dmax - d0)
    return torch.clamp(imp, 1e-5, 1.0 - 1e-5)


def kbi(solref, solimp, r):
    """Stiffness K, damping B and impedance of constraint rows."""
    imp = impedance(solimp, r)
    dmax = solimp[..., 1]
    tc, dr = solref[..., 0], solref[..., 1]
    std = tc > 0
    K = torch.where(std, 1.0 / torch.clamp((dmax * tc * dr) ** 2, min=1e-15),
                    -solref[..., 0] / torch.clamp(dmax * dmax, min=1e-15))
    B = torch.where(std, 2.0 / torch.clamp(dmax * tc, min=1e-15),
                    -solref[..., 1] / torch.clamp(dmax, min=1e-15))
    return K, B, imp


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


def make_frame(normal):
    """Tangent basis (t1, t2) for contact normals."""
    helper = torch.zeros_like(normal)
    use_z = torch.abs(normal[..., 0]) > 0.9
    helper[..., 0] = torch.where(use_z, 0.0, 1.0)
    helper[..., 2] = torch.where(use_z, 1.0, 0.0)
    t1 = cross(normal, helper)
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True),
                          min=1e-15)
    return t1, cross(normal, t1)


def make_efc(model: FlyModel, data: Data, con: _col.Contact,
             ncon_max: int = NCON_MAX) -> EfcRows:
    """Joint-limit rows + the ncon_max contact slots with the smallest
    dist - includemargin (single kinematic tree)."""
    meta = model.meta
    dt = data.qpos.dtype
    B = data.qpos.shape[0]
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

    # Candidates: dense slots, then the compact blocks.
    dsid = _col.dense_slot_ids(meta)
    ucat = _col.efc_slot_table(model)[dsid]
    cand_b = torch.cat([torch.cat([con.dist[..., None], con.pos, con.normal],
                                  -1)]
                       + [torch.cat([b.dist[..., None], b.pos, b.normal], -1)
                          for b in con.blocks], 1)
    cand_u = torch.cat([ucat.expand(B, -1, -1)]
                       + [b.params for b in con.blocks], 1)
    gid = model.const('dense_slot_ids_f', lambda: dsid.astype(np.float64))
    cand_g = torch.cat([gid.expand(B, -1)] + [b.idx for b in con.blocks], 1)
    k = min(ncon_max, cand_b.shape[1])
    con_J, scal = contact_rows(model, data, cand_b, cand_u, cand_g, k)
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


def contact_rows(model, data, cand_b, cand_u, cand_g, k):
    """Top-k contact selection and row assembly (the JAX package's
    _contact_rows_ref). Returns con_J (B, k, 3, nv) and 19 (B, k) rows:
    dist, active, frictional, mu, D, aref(3), pos(3), normal(3), body1,
    body2, self, break, slot id."""
    meta = model.meta
    dt = cand_b.dtype
    score = cand_b[..., 0] - cand_u[..., 0]
    sel = _col.smallest(score, k)
    bsel = torch.gather(cand_b, 1, sel[..., None].expand(-1, -1, 7))
    usel = torch.gather(cand_u, 1, sel[..., None].expand(-1, -1, 14))
    gsel = torch.gather(cand_g, 1, sel)
    c_dist, c_pos, c_n = bsel[..., 0], bsel[..., 1:4], bsel[..., 4:7]
    c_incl, c_mu = usel[..., 0], usel[..., 1]
    c_solref, c_solimp = usel[..., 2:4], usel[..., 4:9]
    condim, diag_c = usel[..., 9], usel[..., 10]
    b1f, b2f, c_self = usel[..., 11], usel[..., 12], usel[..., 13]
    c_active = (c_dist < c_incl).to(dt)

    t1, t2 = make_frame(c_n)
    frame = torch.stack([c_n, t1, t2], dim=-2)  # (B, k, 3, 3)
    b1, b2 = torch.round(b1f).long(), torch.round(b2f).long()
    mask = model.body_dof_mask
    w = mask[b2] - mask[b1]  # (B, k, nv)
    root = np.array(meta.body_rootid)
    roots = np.unique(root[np.array(meta.dof_bodyid)])
    if len(roots) != 1:
        raise NotImplementedError('contact rows: single kinematic tree only')
    arm = c_pos - data.subtree_com[:, int(roots[0])][:, None, :]
    gkr = torch.cat([cross(arm[..., None, :], frame), frame], -1)
    con_J = torch.einsum('bkrx,bvx->bkrv', gkr, data.cdof) * w[..., None, :]

    part = _ar.build_partition(meta)
    limb = model.const('limb_of_body',
                       lambda: np.array(part.limb_of_body, np.float64))
    l1, l2 = limb[b1], limb[b2]
    c_break = ((torch.abs(l1 - l2) > 0.5) & (l1 > -0.5)
               & (l2 > -0.5)).to(dt)

    r_c = c_dist - c_incl
    K_c, B_c, imp_c = kbi(c_solref, c_solimp, r_c)
    vel = torch.einsum('bkrv,bv->bkr', con_J, data.qvel)
    aref_n = -B_c * vel[..., 0] - K_c * imp_c * r_c
    aref_t = -B_c[..., None] * vel[..., 1:]
    R_c = torch.clamp((1.0 - imp_c) / imp_c * diag_c, min=1e-12)
    scal = [c_dist, c_active, (condim >= 3).to(dt), c_mu, 1.0 / R_c, aref_n,
            aref_t[..., 0], aref_t[..., 1], c_pos[..., 0], c_pos[..., 1],
            c_pos[..., 2], c_n[..., 0], c_n[..., 1], c_n[..., 2], b1f, b2f,
            c_self, c_break, gsel]
    return con_J, scal


# ------------------------------------------------------ cone machinery


def cone_residual(jar, mu, frictional, active):
    """jar - proj(jar) onto {v_n >= mu ||v_t||}, per contact (..., 3)."""
    N, y = jar[..., 0], jar[..., 1:]
    T = torch.linalg.norm(y, dim=-1)
    a = 1.0 / torch.clamp(mu, min=1e-6)
    w = (N + a * T) / (1.0 + a * a)
    top = N >= mu * T
    bottom = mu * N + T <= 0.0
    safe_T = torch.clamp(T, min=1e-15)
    res = torch.cat([(N - w)[..., None],
                     y * (1.0 - a * w / safe_T)[..., None]], -1)
    res = torch.where(bottom[..., None], jar, res)
    res = torch.where(top[..., None], torch.zeros_like(jar), res)
    res_fl = torch.cat([torch.clamp(N, max=0.0)[..., None],
                        torch.zeros_like(y)], -1)
    res = torch.where(frictional[..., None] > 0, res, res_fl)
    return res * active[..., None]


def cone_hessian(jar, mu, frictional, active):
    """Per-contact 3x3 Hessian of 0.5 ||residual||^2."""
    N, y = jar[..., 0], jar[..., 1:]
    T = torch.linalg.norm(y, dim=-1)
    a = 1.0 / torch.clamp(mu, min=1e-6)
    safe_T = torch.clamp(T, min=1e-15)
    yhat = y / safe_T[..., None]
    w = (N + a * T) / (1.0 + a * a)
    top = N >= mu * T
    bottom = mu * N + T <= 0.0
    c = 1.0 / (1.0 + a * a)
    dP = jar.new_zeros(jar.shape + (3,))
    dP[..., 0, 0] = c
    dP[..., 0, 1:] = (a * c)[..., None] * yhat
    dP[..., 1:, 0] = (a * c)[..., None] * yhat
    outer = yhat[..., :, None] * yhat[..., None, :]
    I2 = torch.eye(2, dtype=jar.dtype, device=jar.device)
    dP[..., 1:, 1:] = ((a * a * c)[..., None, None] * outer
                       + (a * w / safe_T)[..., None, None] * (I2 - outer))
    I3 = torch.eye(3, dtype=jar.dtype, device=jar.device)
    H = torch.where(bottom[..., None, None], I3.expand_as(dP), I3 - dP)
    H = torch.where(top[..., None, None], torch.zeros_like(H), H)
    H_fl = torch.zeros_like(H)
    H_fl[..., 0, 0] = (N < 0).to(jar.dtype)
    H = torch.where((frictional > 0)[..., None, None], H, H_fl)
    return H * active[..., None, None]


def chol3_psd(W):
    """Closed-form lower Cholesky of PSD (..., 3, 3) blocks; zero pivots
    give zero rows."""
    a = torch.sqrt(torch.clamp(W[..., 0, 0], min=0.0))
    ia = torch.where(a > 1e-12, 1.0 / torch.clamp(a, min=1e-30),
                     torch.zeros_like(a))
    b = W[..., 1, 0] * ia
    c = W[..., 2, 0] * ia
    d = torch.sqrt(torch.clamp(W[..., 1, 1] - b * b, min=0.0))
    idd = torch.where(d > 1e-12, 1.0 / torch.clamp(d, min=1e-30),
                      torch.zeros_like(d))
    e = (W[..., 2, 1] - c * b) * idd
    f = torch.sqrt(torch.clamp(W[..., 2, 2] - c * c - e * e, min=0.0))
    z = torch.zeros_like(a)
    return torch.stack([torch.stack([a, z, z], -1),
                        torch.stack([b, d, z], -1),
                        torch.stack([c, e, f], -1)], -2)


def _jv(J, x):
    """(B, K, 3, nv) x (B, nv) -> (B, K, 3)."""
    return torch.einsum('bkrv,bv->bkr', J, x)


def _jtf(J, f):
    """(B, K, 3, nv)^T (B, K, 3) -> (B, nv)."""
    return torch.einsum('bkrv,bkr->bv', J, f)


def _lim_scatter(nv, lim_dof, vals):
    out = vals.new_zeros((vals.shape[0], nv))
    return out.index_add_(1, torch.as_tensor(lim_dof, device=vals.device),
                          vals)


def primal_cost(efc: EfcRows, part, M, a_free, x):
    dx = x - a_free
    sign = x.new_tensor(efc.lim_sign)
    cost = 0.5 * torch.sum(dx * _ar.matvec_packed(part, M, dx), -1)
    jar_l = x[:, efc.lim_dof] * sign - efc.lim_aref
    act_l = efc.lim_active * (jar_l < 0)
    cost = cost + 0.5 * torch.sum(efc.lim_D * act_l * jar_l ** 2, -1)
    jar_c = _jv(efc.con_J, x) - efc.con_aref
    res = cone_residual(jar_c, efc.con_mu, efc.con_frictional,
                        efc.con_active)
    return cost + 0.5 * torch.sum(efc.con_D[..., None] * res ** 2, (-2, -1))


# --------------------------------------------------------- line search


def _slope_curv(a, lim, con, sm0, smm):
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
        s, _ = _slope_curv(hi, lim, con, sm0, smm)
        hi = torch.where(s < 0, hi * 2.0, hi)
    lo = torch.zeros_like(hi)
    for _ in range(ls_iters):
        mid = 0.5 * (lo + hi)
        s, c = _slope_curv(mid, lim, con, sm0, smm)
        cand = mid - s / c
        probe = torch.where((cand > lo) & (cand < hi), cand, mid)
        sp, _ = _slope_curv(probe, lim, con, sm0, smm)
        lo = torch.where(sp < 0, probe, lo)
        hi = torch.where(sp < 0, hi, probe)
    alpha = 0.5 * (lo + hi)
    s0, _ = _slope_curv(torch.zeros_like(alpha), lim, con, sm0, smm)
    return torch.where(s0 < 0, alpha, torch.zeros_like(alpha))


# --------------------------------------------------------------- solve


def _hessian(part, M, efc, jar_l, jar_c, hess_active):
    """Packed Newton Hessian M + J^T D H J + limit diagonal (+1e-12)."""
    nv = part.nv
    act_l = efc.lim_active * (jar_l < 0)
    hd_dof = _lim_scatter(nv, efc.lim_dof, efc.lim_D * act_l)
    Hc = (cone_hessian(jar_c, efc.con_mu, efc.con_frictional, hess_active)
          * efc.con_D[..., None, None])
    JH = torch.einsum('bkrs,bksv->bkrv', Hc, efc.con_J)
    Bn, K = JH.shape[:2]
    J2 = efc.con_J.reshape(Bn, 3 * K, nv)
    JHr = JH.reshape(Bn, 3 * K, nv)
    if J2.dtype == torch.float32:
        # The JAX package rounds these operands to bf16 and accumulates
        # in f32; round-trip through bf16 and multiply in f32 to match
        # (a full-f32 product: torch.backends.cuda.matmul.allow_tf32 must
        # stay False, PyTorch's default).
        J2 = J2.to(torch.bfloat16).to(torch.float32)
        JHr = JHr.to(torch.bfloat16).to(torch.float32)
    JTJH = J2.transpose(1, 2) @ JHr
    Hp = M + _ar.pack_sym_ref(part, JTJH, pad_identity=False)
    return _ar.add_diag_packed(part, Hp, hd_dof + 1e-12)


def _newton_step(part, efc, ls_iters, F, M, Z, U, LC, st):
    """One Newton iteration on a fixed factor (the JAX _ref_step)."""
    x, msm, jar_l, jar_c = st
    sign = x.new_tensor(efc.lim_sign)
    actl, Dl = efc.lim_active, efc.lim_D
    f_l = torch.where(jar_l < 0, -Dl * jar_l * actl, torch.zeros_like(jar_l))
    res = cone_residual(jar_c, efc.con_mu, efc.con_frictional,
                        torch.ones_like(efc.con_mu))
    f_c = -(efc.con_D * efc.con_active)[..., None] * res
    g = msm - _lim_scatter(part.nv, efc.lim_dof, f_l * sign) - _jtf(
        efc.con_J, f_c)
    t = _ar.solve_ref(part, F, g)
    w = torch.cholesky_solve(torch.einsum('bvs,bv->bs', U, t)[..., None],
                             LC)[..., 0]
    dx = -(t - torch.einsum('bvs,bs->bv', Z, w))
    mdx = _ar.matvec_packed(part, M, dx)
    jv_c = _jv(efc.con_J, dx)
    jv_l = dx[:, efc.lim_dof] * sign
    sm0 = torch.sum(msm * dx, -1)
    smm = torch.sum(dx * mdx, -1)
    lim = (jar_l, jv_l, actl, Dl)
    con = (jar_c[..., 0], jar_c[..., 1], jar_c[..., 2], jv_c[..., 0],
           jv_c[..., 1], jv_c[..., 2], efc.con_mu, efc.con_frictional,
           efc.con_active, efc.con_D)
    alpha = alpha_ref(lim, con, sm0, smm, 6, ls_iters)
    a = alpha[:, None]
    return (x + a * dx, msm + a * mdx, jar_l + a * jv_l,
            jar_c + alpha[:, None, None] * jv_c)


def solve(model: FlyModel, data: Data, efc: EfcRows, a_free,
          iterations: int = 10, ls_iterations: int = 8, warmstart=None,
          refactor_period: int = 1):
    """Newton solve for qacc; returns (qacc, qfrc_constraint, f_l, f_c).

    Each block of `refactor_period` iterations assembles the packed
    Hessian, factors it (block-arrow) and carries the cross-limb contact
    rows by a rank-3*SB Woodbury correction; iterations inside a block
    reuse the factor. The starting point is whichever of (warmstart,
    a_free) has the lower primal cost."""
    part = _ar.build_partition(model.meta)
    M = data.qM
    nv = part.nv
    sign = a_free.new_tensor(efc.lim_sign)
    x = a_free
    if warmstart is not None:
        c_ws = primal_cost(efc, part, M, a_free, warmstart)
        c_af = primal_cost(efc, part, M, a_free, a_free)
        x = torch.where((c_ws < c_af)[:, None], warmstart, a_free)

    K = efc.con_J.shape[1]
    SB = min(SB_BREAK, K)
    brk = efc.con_break * efc.con_active
    score_b = torch.where(brk > 0, efc.con_pos, torch.full_like(brk, 1e10))
    bsel = _col.smallest(score_b, SB)  # (B, SB)
    bi = torch.arange(x.shape[0], device=x.device)[:, None]
    Vb = efc.con_J[bi, bsel]  # (B, SB, 3, nv)
    mub, Db = efc.con_mu[bi, bsel], efc.con_D[bi, bsel]
    fricb, actb = efc.con_frictional[bi, bsel], brk[bi, bsel]
    hess_active = efc.con_active * (1.0 - efc.con_break)

    st = (x, _ar.matvec_packed(part, M, x - a_free),
          x[:, efc.lim_dof] * sign - efc.lim_aref,
          _jv(efc.con_J, x) - efc.con_aref)
    p = max(1, refactor_period)
    eye = torch.eye(3 * SB, dtype=x.dtype, device=x.device)
    done = 0
    while done < iterations:
        n = min(p, iterations - done)
        Hp = _hessian(part, M, efc, st[2], st[3], hess_active)
        Wb = (cone_hessian(st[3][bi, bsel], mub, fricb, actb)
              * Db[..., None, None])
        G = chol3_psd(Wb)
        U = torch.einsum('bsrc,bsrv->bvsc', G, Vb).reshape(-1, nv, 3 * SB)
        F = _ar.factor_ref_p(part, Hp)
        Z = _ar.solve_ref(part, F, U)
        C = eye + U.transpose(1, 2) @ Z
        LC = torch.linalg.cholesky(C + 1e-10 * eye)
        for _ in range(n):
            st = _newton_step(part, efc, ls_iterations, F, M, Z, U, LC, st)
        done += n

    x, _, jar_l, jar_c = st
    act_l = efc.lim_active * (jar_l < 0)
    f_l = -efc.lim_D * jar_l * act_l
    f_c = -efc.con_D[..., None] * cone_residual(
        jar_c, efc.con_mu, efc.con_frictional, efc.con_active)
    qfrc = _lim_scatter(nv, efc.lim_dof, f_l * sign) + _jtf(efc.con_J, f_c)
    return x, qfrc, f_l, f_c


def noslip(model: FlyModel, data: Data, efc: EfcRows, qacc, f_c,
           iterations: int = 3):
    """Noslip post-pass (packed factor): Gauss-Seidel over the friction
    rows of active frictional contacts with normal forces held fixed,
    clamped to the friction circle. Returns (qacc, f_c)."""
    part = _ar.build_partition(model.meta)
    Bn, K = f_c.shape[:2]
    nv = part.nv
    Jt = efc.con_J[:, :, 1:, :]  # (B, K, 2, nv)
    aref_t = efc.con_aref[..., 1:]
    use = (efc.con_active * efc.con_frictional) > 0
    lim = torch.clamp(efc.con_mu * f_c[..., 0], min=0.0)
    Pt = _ar.solve_ref(part, data.qLD,
                       Jt.reshape(Bn, 2 * K, nv).transpose(1, 2))
    Pt = Pt.reshape(Bn, nv, K, 2).permute(0, 2, 1, 3)  # (B, K, nv, 2)
    A = torch.einsum('bkrv,bkvs->bkrs', Jt, Pt)
    a, b_, c_, d_ = A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1]
    det = a * d_ - b_ * c_
    det = torch.where(torch.abs(det) > 1e-12, det,
                      torch.where(det >= 0, torch.full_like(det, 1e-12),
                                  torch.full_like(det, -1e-12)))
    Ainv = torch.stack([torch.stack([d_, -b_], -1),
                        torch.stack([-c_, a], -1)], -2) / det[..., None, None]
    x = qacc
    ft = f_c[..., 1:].clone()
    for _ in range(iterations):
        for k in range(K):
            res = torch.einsum('brv,bv->br', Jt[:, k], x) - aref_t[:, k]
            new = ft[:, k] - torch.einsum('brs,bs->br', Ainv[:, k], res)
            norm = torch.linalg.norm(new, dim=-1, keepdim=True)
            lk = lim[:, k, None]
            new = torch.where(norm > lk,
                              new * (lk / torch.clamp(norm, min=1e-15)), new)
            new = torch.where(use[:, k, None], new, ft[:, k])
            x = x + torch.einsum('bvs,bs->bv', Pt[:, k], new - ft[:, k])
            ft[:, k] = new
    return x, torch.cat([f_c[..., :1], ft], -1)
