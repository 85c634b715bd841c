"""Smooth dynamics: velocities, CRB mass matrix, RNE, passive forces,
actuation, and the semi-implicit Euler step.

Counterpart of flybody_tpu/physics/smooth.py, batched over a leading env
dimension. The engine keeps the walking fly's M packed (`crb_packed`):
com_vel .. actuation are then the plain version of kernel K2
(ops/force_stage.py). `fwd_smooth` / `step_smooth` form a dense M (`crb`)
on any model. The factor and solves dispatch as the JAX package's do, on
the arrow partition and on the rank of qM (of qLD for `solve_m`):

  * qM packed: the arrow kernels on the packed layout (ops/arrow.py: K3
    fused factor + solve, row 18 factor, row 19 substitution);
  * qM dense, with an arrow partition (the walking fly's `crb`): the same
    arrow kernels on the dense matrix; the factor qLD is packed;
  * qM dense, no partition (several flies): the dense Cholesky kernels
    (ops/cholesky.py: row 14 factor, 15 and 16 substitutions, 17 fused).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.model.spec import FlyModel
from flybody_tpu_torch.ops import arrow as _ar
from flybody_tpu_torch.ops import cholesky as _chol
from flybody_tpu_torch.physics import fluid as _fl
from flybody_tpu_torch.physics import kinematics as _kin
from flybody_tpu_torch.physics import math as sm
from flybody_tpu_torch.physics.state import Data
from flybody_tpu_torch.utils import quaternions as quat


def com_vel(model: FlyModel, data: Data) -> Data:
    """Body spatial velocities and dof motion-vector derivatives."""
    cvel = torch.einsum('bv,Bv,Bvx->Bbx', model.body_dof_mask, data.qvel,
                        data.cdof)
    prefix = torch.einsum('iv,Bv,Bvx->Bix', model.dof_prefix_mask,
                          data.qvel, data.cdof)
    return data.replace(cvel=cvel,
                        cdof_dot=sm.motion_cross(prefix, data.cdof))


def tendon_vel(model: FlyModel, data: Data) -> Data:
    return data.replace(ten_velocity=data.qvel @ model.ten_J.T)


@functools.lru_cache(maxsize=8)
def anc_low(meta: _s.Meta) -> np.ndarray:
    """anc_low[i, j] = 1 iff dof j is an ancestor-or-self dof of dof i
    with j <= i (the lower triangle of M's tree sparsity)."""
    tb = _kin.tables(meta)
    dof_body = np.array(meta.dof_bodyid)
    body_dof = tb['subtree_mask'][dof_body, :].T  # (nbody, nv)
    return body_dof[dof_body] * np.tril(np.ones((meta.nv, meta.nv)))


def _crb_buf(model: FlyModel, data: Data):
    """buf_i = I^c_{b(i)} cdof_i (B, nv, 6): each dof's body's composite
    inertia (the sum of cinert over its subtree) applied to the dof."""
    tb = _kin.tables(model.meta)
    B, nb = data.qpos.shape[0], model.meta.nbody
    sub = model.const('subtree_mask', lambda: tb['subtree_mask'])
    crb = torch.einsum('bc,Bcx->Bbx', sub,
                       data.cinert.reshape(B, nb, 36)).reshape(B, nb, 6, 6)
    Ic = crb[:, tb['dof_body']]
    return torch.sum(Ic * data.cdof[:, :, None, :], dim=-1)


def crb(model: FlyModel, data: Data) -> Data:
    """Dense mass matrix (B, nv, nv) by composite rigid bodies:
    M[i, j] = cdof_j . buf_i on the tree's sparsity, plus armature."""
    buf = _crb_buf(model, data)
    P = buf @ data.cdof.transpose(1, 2)
    ML = model.const('crb_anc_low', lambda: anc_low(model.meta)) * P
    M = (ML + ML.transpose(1, 2)
         - torch.diag_embed(torch.diagonal(ML, dim1=1, dim2=2))
         + torch.diag(model.dof_armature))
    return data.replace(qM=M)


@functools.lru_cache(maxsize=8)
def crb_tables(meta: _s.Meta) -> dict:
    """The limb blocks and root block of anc_low for the packed CRB."""
    anc = anc_low(meta)
    part = _ar.build_partition(meta)
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    ancp = np.zeros((nl, dm, dm))
    for i, (lo, d) in enumerate(zip(part.los, part.ds)):
        ancp[i, :d, :d] = anc[lo:lo + d, lo:lo + d]
    return dict(part=part, ancp=ancp, anc_root=anc[:nr, :nr])


def crb_packed(model: FlyModel, data: Data) -> Data:
    """Mass matrix in packed block-arrow form (ops/arrow.py layout) by
    composite rigid bodies; the dense (nv, nv) M is never formed."""
    pt = crb_tables(model.meta)
    part = pt['part']
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    B = data.qpos.shape[0]
    buf = _crb_buf(model, data)  # (B, nv, 6)
    idx, w, _ = _ar._tables(part, buf)
    arm = model.dof_armature
    bufp = buf[:, idx] * w[..., None]
    cdofp = data.cdof[:, idx] * w[..., None]
    P = torch.einsum('blix,bljx->blij', bufp, cdofp)
    ML = model.const('crb_ancp', lambda: pt['ancp']) * P
    eye = torch.eye(dm, dtype=ML.dtype, device=ML.device)
    D = (ML + ML.transpose(-1, -2)
         - torch.diag_embed(torch.diagonal(ML, dim1=-2, dim2=-1))
         + eye * (arm[idx] * w)[:, None, :])
    Bl = torch.einsum('blix,brx->blri', bufp, data.cdof[:, :nr])
    Pr = torch.einsum('bax,bcx->bac', buf[:, :nr], data.cdof[:, :nr])
    MLr = model.const('crb_anc_root', lambda: pt['anc_root']) * Pr
    R = (MLr + MLr.transpose(-1, -2)
         - torch.diag_embed(torch.diagonal(MLr, dim1=-2, dim2=-1))
         + torch.diag(arm[:nr]))
    root = R.new_zeros((B, 1, dm + nr, dm))
    root[:, 0, :nr, :nr] = R
    Mp = torch.cat([torch.cat([D, Bl], dim=2), root], dim=1)
    Mp = Mp + model.const('pad_eye', lambda: _ar.pad_eye_np(part))
    return data.replace(qM=Mp)


def _with_diag(model: FlyModel, M, diag):
    """M + diag(diag) for M packed or dense."""
    if M.dim() == 4:
        return _ar.add_diag_packed(_ar.build_partition(model.meta), M, diag)
    return M + torch.diag_embed(diag.expand(M.shape[:2]))


def factor_m(model: FlyModel, data: Data, extra_diag=None) -> Data:
    """qLD: the factor of qM + diag(extra_diag) (extra_diag (nv,) or (B,
    nv)): the packed arrow factor (row 18) when the model has an arrow
    partition, qM packed or dense; the dense lower factor (row 14)
    otherwise."""
    M = data.qM if extra_diag is None else _with_diag(model, data.qM,
                                                      extra_diag)
    part = _ar.build_partition(model.meta)
    if part is None:
        return data.replace(qLD=_chol.chol(M.contiguous()))
    return data.replace(qLD=_ar.factor(part, M.contiguous()))


def factor_solve_m(model: FlyModel, data: Data, rhs):
    """Factor of qM fused with the solve qM x = rhs: the arrow kernel K3
    (qM packed or dense) with an arrow partition, row 17 without."""
    part = _ar.build_partition(model.meta)
    if part is None:
        qLD, x = _chol.chol_solve(data.qM, rhs)
    else:
        qLD, x = _ar.factor_solve(part, data.qM, rhs)
    return data.replace(qLD=qLD), x


def solve_m(model: FlyModel, data: Data, rhs):
    """qM x = rhs by the factor qLD; rhs (B, nv) or (B, nv, m). A packed
    arrow factor takes row 19; a dense one row 15 (one right-hand side) or
    row 16 (several: the dense noslip's M^-1 J_t^T)."""
    if data.qLD.dim() == 4:
        return _ar.solve(_ar.build_partition(model.meta), data.qLD, rhs)
    if rhs.dim() == 2:
        return _chol.cho_solve(data.qLD, rhs)
    return _chol.cho_solve_multi(data.qLD, rhs)


def fwd_smooth(model: FlyModel, data: Data) -> Data:
    """Everything up to (but excluding) constraints, in the JAX package's
    order with a dense M (`crb`) on any model: fills qfrc_smooth."""
    data, _, _ = _kin.fwd_position_smooth(model, data)
    data = com_vel(model, data)
    data = tendon_vel(model, data)
    data = crb(model, data)
    data = rne(model, data)
    data = passive(model, data)
    data = _fl.fluid(model, data)
    data = actuation(model, data)
    qfrc_smooth = (data.qfrc_passive + data.qfrc_fluid + data.qfrc_actuator
                   + xfrc_accumulate(model, data) - data.qfrc_bias)
    if data.qfrc_applied is not None:
        qfrc_smooth = qfrc_smooth + data.qfrc_applied
    return data.replace(qfrc_smooth=qfrc_smooth)


def rne(model: FlyModel, data: Data) -> Data:
    """qfrc_bias = C(qpos, qvel) qvel + gravity (mj_rne, flg_acc=0)."""
    mask = model.body_dof_mask
    cacc = torch.einsum('bv,Bv,Bvx->Bbx', mask, data.qvel, data.cdof_dot)
    grav = torch.cat([torch.zeros_like(model.gravity), -model.gravity])
    cacc = cacc + grav
    Iv = torch.sum(data.cinert * data.cvel[:, :, None, :], dim=-1)
    f = (torch.sum(data.cinert * cacc[:, :, None, :], dim=-1)
         + sm.force_cross(data.cvel, Iv))
    qfrc_bias = torch.sum(data.cdof * torch.einsum('bv,Bbx->Bvx', mask, f),
                          dim=-1)
    return data.replace(qfrc_bias=qfrc_bias)


@functools.lru_cache(maxsize=8)
def spring_tables(meta: _s.Meta):
    """qpos/dof addresses of slide/hinge joints (those carry springs)."""
    jids = [j for j in range(meta.njnt)
            if meta.jnt_type[j] in (_s.SLIDE, _s.HINGE)]
    return (np.array([meta.jnt_qposadr[j] for j in jids], np.int64),
            np.array([meta.jnt_dofadr[j] for j in jids], np.int64),
            np.array(jids, np.int64))


def passive(model: FlyModel, data: Data) -> Data:
    """Joint/tendon springs and dampers (mj_passive without fluid)."""
    qadr, dadr, jids = spring_tables(model.meta)
    qfrc = -model.dof_damping * data.qvel
    if len(jids):
        disp = data.qpos[:, qadr] - model.qpos_spring[qadr]
        qfrc[:, dadr] += -model.jnt_stiffness[jids] * disp
    if model.meta.ntendon:
        ls = model.ten_lengthspring
        length = data.ten_length
        zero = torch.zeros_like(length)
        disp = torch.where(length > ls[:, 1], length - ls[:, 1],
                           torch.where(length < ls[:, 0], length - ls[:, 0],
                                       zero))
        frc = (-model.ten_stiffness * disp
               - model.ten_damping * data.ten_velocity)
        qfrc = qfrc + frc @ model.ten_J
    return data.replace(qfrc_passive=qfrc)


@functools.lru_cache(maxsize=8)
def act_tables(meta: _s.Meta) -> dict:
    """Actuator transmission maps and activation index maps."""
    nu = meta.nu
    trn_qadr = np.zeros(nu, np.int64)
    trn_dadr = np.zeros(nu, np.int64)
    is_joint = np.zeros(nu)
    is_tendon = np.zeros(nu)
    ten_id = np.zeros(nu, np.int64)
    for u in range(nu):
        t, tid = meta.actuator_trntype[u], meta.actuator_trnid[u]
        if t == _s.TRN_JOINT:
            is_joint[u] = 1.0
            trn_qadr[u] = meta.jnt_qposadr[tid]
            trn_dadr[u] = meta.jnt_dofadr[tid]
        elif t == _s.TRN_TENDON:
            is_tendon[u] = 1.0
            ten_id[u] = tid
    adr = np.array(meta.actuator_actadr)
    has_act = adr >= 0
    act_first = np.where(has_act, adr, 0).astype(np.int64)
    act_to_u = np.zeros(meta.na, np.int64)
    for u in range(nu):
        if adr[u] >= 0:
            act_to_u[adr[u]] = u
    return dict(trn_qadr=trn_qadr, trn_dadr=trn_dadr, is_joint=is_joint,
                is_tendon=is_tendon, ten_id=ten_id,
                has_act=has_act.astype(np.float64), act_first=act_first,
                act_to_u=act_to_u,
                is_affine=(np.array(meta.actuator_biastype)
                           == _s.BIAS_AFFINE).astype(np.float64),
                exact=(np.array(meta.actuator_dyntype)[act_to_u]
                       == _s.DYN_FILTEREXACT).astype(np.float64))


def actuation(model: FlyModel, data: Data) -> Data:
    """Actuator forces and activation derivatives (mj_fwdActuation)."""
    meta = model.meta
    tb = act_tables(meta)
    c = lambda k: model.const('act_' + k, lambda: tb[k])
    cr = model.actuator_ctrlrange
    ctrl = torch.clamp(data.ctrl, cr[:, 0], cr[:, 1])
    if meta.na:
        act_for_u = data.act[:, tb['act_first']]
        tau = torch.clamp(model.actuator_dynprm[:, 0], min=1e-10)
        act_dot = ((ctrl - act_for_u) / tau)[:, tb['act_to_u']]
        has_act = c('has_act')
        inp = has_act * act_for_u + (1.0 - has_act) * ctrl
    else:
        act_dot = ctrl[:, :0]
        inp = ctrl
    gear = model.actuator_gear0
    length = (c('is_joint') * data.qpos[:, tb['trn_qadr']]
              + c('is_tendon') * data.ten_length[:, tb['ten_id']]) * gear
    velocity = (c('is_joint') * data.qvel[:, tb['trn_dadr']]
                + c('is_tendon') * data.ten_velocity[:, tb['ten_id']]) * gear
    bp = model.actuator_biasprm
    bias = bp[:, 0] + bp[:, 1] * length + bp[:, 2] * velocity
    force = model.actuator_gainprm[:, 0] * inp + c('is_affine') * bias
    fr = model.actuator_forcerange
    lim = model.actuator_forcelimited
    force = lim * torch.clamp(force, fr[:, 0], fr[:, 1]) + (1.0 - lim) * force
    return data.replace(actuator_force=force, act_dot=act_dot,
                        qfrc_actuator=force @ model.actuator_moment)


def xfrc_accumulate(model: FlyModel, data: Data):
    """Cartesian per-body applied wrenches (force; torque) in joint space."""
    if data.xfrc_applied is None:
        return torch.zeros_like(data.qvel)
    ref = data.subtree_com[:, np.array(model.meta.body_rootid)]
    force = data.xfrc_applied[..., :3]
    torque = data.xfrc_applied[..., 3:] + sm.cross(data.xpos - ref, force)
    f = torch.cat([torque, force], dim=-1)
    return torch.sum(data.cdof * torch.einsum('bv,Bbx->Bvx',
                                              model.body_dof_mask, f), dim=-1)


@functools.lru_cache(maxsize=8)
def integrate_tables(meta: _s.Meta):
    lin_q, lin_d, quat_q, quat_d = [], [], [], []
    for j in range(meta.njnt):
        t, qadr, dadr = (meta.jnt_type[j], meta.jnt_qposadr[j],
                         meta.jnt_dofadr[j])
        if t in (_s.SLIDE, _s.HINGE):
            lin_q.append(qadr)
            lin_d.append(dadr)
        elif t == _s.BALL:
            quat_q.append(qadr)
            quat_d.append(dadr)
        elif t == _s.FREE:
            lin_q += [qadr, qadr + 1, qadr + 2]
            lin_d += [dadr, dadr + 1, dadr + 2]
            quat_q.append(qadr + 3)
            quat_d.append(dadr + 3)
    return tuple(np.array(x, np.int64) for x in (lin_q, lin_d, quat_q,
                                                 quat_d))


def integrate_pos(model: FlyModel, qpos, qvel, dt):
    """mj_integratePos: qpos advanced by qvel*dt, quaternions on S3."""
    lin_q, lin_d, quat_q, quat_d = integrate_tables(model.meta)
    out = qpos.clone()
    if len(lin_q):
        out[:, lin_q] += dt * qvel[:, lin_d]
    if len(quat_q):
        gq = quat_q[:, None] + np.arange(4)[None, :]
        gd = quat_d[:, None] + np.arange(3)[None, :]
        out[:, gq] = quat.integrate_quat(qpos[:, gq], qvel[:, gd], dt)
    return out


def advance_act(model: FlyModel, data: Data, dt):
    """Activations: Euler for `filter`, exact for `filterexact`."""
    if not model.meta.na:
        return data.act
    tb = act_tables(model.meta)
    tau = torch.clamp(model.actuator_dynprm[tb['act_to_u'], 0], min=1e-10)
    euler_new = data.act + dt * data.act_dot
    exact_new = data.act + data.act_dot * tau * (1.0 - torch.exp(-dt / tau))
    ex = model.const('act_exact', lambda: tb['exact'])
    return ex * exact_new + (1.0 - ex) * euler_new


def euler(model: FlyModel, data: Data) -> Data:
    """Semi-implicit Euler with implicit joint damping (mj_Euler): qacc =
    (qM + dt diag(damping))^-1 qfrc by factor_solve_m's dispatch."""
    dt = model.timestep
    qfrc = data.qfrc_smooth
    if data.qfrc_constraint is not None:
        qfrc = qfrc + data.qfrc_constraint
    Md = _with_diag(model, data.qM, dt * model.dof_damping)
    damped, qacc = factor_solve_m(model, data.replace(qM=Md), qfrc)
    data = data.replace(qLD=damped.qLD)
    act = advance_act(model, data, dt)
    qvel = data.qvel + dt * qacc
    qpos = integrate_pos(model, data.qpos, qvel, dt)
    return data.replace(qpos=qpos, qvel=qvel, act=act, qacc=qacc,
                        time=data.time + dt)


def step_smooth(model: FlyModel, data: Data) -> Data:
    """One contact-free physics step: fwd_smooth, then euler."""
    data = fwd_smooth(model, data)
    data = data.replace(qfrc_constraint=torch.zeros_like(data.qfrc_smooth))
    return euler(model, data)
