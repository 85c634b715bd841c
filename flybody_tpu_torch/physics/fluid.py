"""Fluid forces: inertia-box model and ellipsoid model.

Counterpart of flybody_tpu/physics/fluid.py (MuJoCo's passive fluid
forces), batched over envs. Part of the plain version of kernel K2.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from flybody_tpu_torch.model.spec import FlyModel
from flybody_tpu_torch.physics import math as sm
from flybody_tpu_torch.physics.state import Data

_MJMINVAL = 1e-15


@functools.lru_cache(maxsize=8)
def fluid_tables(meta):
    geom_active = np.array(meta.geom_fluid_active, dtype=bool)
    body_uses_ellipsoid = np.zeros(meta.nbody, dtype=bool)
    for g in range(meta.ngeom):
        if geom_active[g]:
            body_uses_ellipsoid[meta.geom_bodyid[g]] = True
    return dict(
        geom_active=geom_active,
        body_uses_ellipsoid=body_uses_ellipsoid,
        geom_bodyid=np.array(meta.geom_bodyid),
        geom_rootid=np.array(meta.body_rootid)[np.array(meta.geom_bodyid)],
        body_rootid=np.array(meta.body_rootid),
    )


def _local_velocity(data, rootid, pos, mat, bodyid):
    """mj_objectVelocity(flg_local=1): (angular, linear) in the object
    frame."""
    cvel = data.cvel[:, bodyid]
    w, v = cvel[..., :3], cvel[..., 3:]
    v_at = v + sm.cross(w, pos - data.subtree_com[:, rootid])
    matT = mat.transpose(-1, -2)
    return (torch.sum(matT * w[..., None, :], dim=-1),
            torch.sum(matT * v_at[..., None, :], dim=-1))


def _project(model, data, f_body):
    """qfrc = cdof . (sum over each dof's subtree of body wrenches)."""
    return torch.sum(data.cdof * torch.einsum(
        'bv,Bbx->Bvx', model.body_dof_mask, f_body), dim=-1)


def inertia_box_dims(mass: np.ndarray, inertia: np.ndarray) -> np.ndarray:
    """Equivalent inertia-box semi-dimensions (nbody, 3), host-side."""
    i0, i1, i2 = inertia[:, 0], inertia[:, 1], inertia[:, 2]
    m = np.maximum(mass, _MJMINVAL)
    return np.stack([np.sqrt(np.maximum(_MJMINVAL, i1 + i2 - i0) / m * 6.0),
                     np.sqrt(np.maximum(_MJMINVAL, i0 + i2 - i1) / m * 6.0),
                     np.sqrt(np.maximum(_MJMINVAL, i0 + i1 - i2) / m * 6.0)],
                    -1)


def inertia_box_mask(model) -> np.ndarray:
    """Bodies that take inertia-box forces: not world, not using the
    ellipsoid model, with mass."""
    tb = fluid_tables(model.meta)
    nb = model.meta.nbody
    return ((~tb['body_uses_ellipsoid']) & (np.arange(nb) > 0)
            & (model.np_arrays['body_mass'] > _MJMINVAL)).astype(np.float64)


def _inertia_box_forces(model: FlyModel, data: Data, tb):
    visc, dens = model.viscosity, model.density
    box = model.const('fluid_box', lambda: inertia_box_dims(
        model.np_arrays['body_mass'], model.np_arrays['body_inertia']))
    lw, lv = _local_velocity(data, tb['body_rootid'], data.xipos,
                             data.ximat, np.arange(model.meta.nbody))
    lv = lv - torch.sum(data.ximat * model.wind[:, None], dim=-2)
    diam = torch.mean(box, dim=-1)
    ltrq = -math.pi * diam[:, None] ** 3 * visc * lw
    lfrc = -3.0 * math.pi * diam[:, None] * visc * lv
    b0, b1, b2 = box[:, 0], box[:, 1], box[:, 2]
    lfrc = lfrc - 0.5 * dens * torch.stack([
        b1 * b2 * torch.abs(lv[..., 0]) * lv[..., 0],
        b0 * b2 * torch.abs(lv[..., 1]) * lv[..., 1],
        b0 * b1 * torch.abs(lv[..., 2]) * lv[..., 2]], dim=-1)
    ltrq = ltrq - dens / 64.0 * torch.stack([
        b0 * (b1 ** 4 + b2 ** 4) * torch.abs(lw[..., 0]) * lw[..., 0],
        b1 * (b0 ** 4 + b2 ** 4) * torch.abs(lw[..., 1]) * lw[..., 1],
        b2 * (b0 ** 4 + b1 ** 4) * torch.abs(lw[..., 2]) * lw[..., 2]],
        dim=-1)
    world_t = torch.sum(data.ximat * ltrq[..., None, :], dim=-1)
    world_f = torch.sum(data.ximat * lfrc[..., None, :], dim=-1)
    mask = model.const('fluid_box_mask', lambda: inertia_box_mask(model))
    ref = data.subtree_com[:, tb['body_rootid']]
    t_ref = world_t + sm.cross(data.xipos - ref, world_f)
    f = torch.cat([t_ref, world_f], dim=-1) * mask[:, None]
    return _project(model, data, f)


def _ellipsoid_forces(model: FlyModel, data: Data, tb):
    dens, visc = model.density, model.viscosity
    gf = model.geom_fluid
    interaction, blunt, slender, ang_drag, kutta, magnus = (
        gf[:, 0], gf[:, 1], gf[:, 2], gf[:, 3], gf[:, 4], gf[:, 5])
    vmass, vinert = gf[:, 6:9], gf[:, 9:12]
    size = model.geom_size
    s0, s1, s2 = size[:, 0], size[:, 1], size[:, 2]
    lw, lv = _local_velocity(data, tb['geom_rootid'], data.geom_xpos,
                             data.geom_xmat, tb['geom_bodyid'])
    lv = lv - torch.sum(data.geom_xmat * model.wind[:, None], dim=-2)

    v_lin = dens * vmass * lv
    v_ang = dens * vinert * lw
    fA = sm.cross(v_lin, lw)
    gA = sm.cross(v_lin, lv) + sm.cross(v_ang, lw)
    volume = 4.0 / 3.0 * math.pi * s0 * s1 * s2
    fM = (magnus * dens * volume)[:, None] * sm.cross(lw, lv)

    d_max = torch.max(size, dim=-1).values
    d_min = torch.min(size, dim=-1).values
    d_mid = s0 + s1 + s2 - d_max - d_min
    A_max = math.pi * d_max * d_mid
    proj_denom = ((s1 * s2) ** 4 * lv[..., 0] ** 2
                  + (s2 * s0) ** 4 * lv[..., 1] ** 2
                  + (s0 * s1) ** 4 * lv[..., 2] ** 2)
    proj_num = ((s1 * s2 * lv[..., 0]) ** 2 + (s2 * s0 * lv[..., 1]) ** 2
                + (s0 * s1 * lv[..., 2]) ** 2)
    A_proj = math.pi * torch.sqrt(proj_denom
                                  / torch.clamp(proj_num, min=_MJMINVAL))
    norm = torch.stack([(s1 * s2) ** 2 * lv[..., 0],
                        (s2 * s0) ** 2 * lv[..., 1],
                        (s0 * s1) ** 2 * lv[..., 2]], dim=-1)
    speed = torch.linalg.norm(lv, dim=-1)
    cos_alpha = proj_num / torch.clamp(speed * proj_denom, min=_MJMINVAL)
    kutta_circ = (kutta * dens * cos_alpha * A_proj)[..., None] * sm.cross(
        norm, lv)
    fK = sm.cross(kutta_circ, lv)

    eq_d = 2.0 / 3.0 * (s0 + s1 + s2)
    lin_f_coef = 3.0 * math.pi * eq_d
    lin_t_coef = math.pi * eq_d ** 3

    def max_moment(d0, da, db):
        return 8.0 / 15.0 * math.pi * d0 * torch.maximum(da, db) ** 4

    II = torch.stack([max_moment(s0, s1, s2), max_moment(s1, s2, s0),
                      max_moment(s2, s0, s1)], dim=-1)
    I_max = (8.0 / 15.0 * math.pi * d_mid * d_max ** 4)[:, None]
    mom_visc = lw * (ang_drag[:, None] * II + slender[:, None] * (I_max - II))
    drag_lin = (visc * lin_f_coef
                + dens * speed * (A_proj * blunt + slender * (A_max - A_proj)))
    drag_ang = visc * lin_t_coef + dens * torch.linalg.norm(mom_visc, dim=-1)
    ltrq = (gA - drag_ang[..., None] * lw) * interaction[:, None]
    lfrc = (fA + fM + fK - drag_lin[..., None] * lv) * interaction[:, None]

    world_t = torch.sum(data.geom_xmat * ltrq[..., None, :], dim=-1)
    world_f = torch.sum(data.geom_xmat * lfrc[..., None, :], dim=-1)
    active = model.const('fluid_geom_active',
                         lambda: tb['geom_active'].astype(np.float64))
    ref = data.subtree_com[:, tb['geom_rootid']]
    t_ref = world_t + sm.cross(data.geom_xpos - ref, world_f)
    f_spatial = torch.cat([t_ref, world_f], dim=-1) * active[:, None]
    f_body = f_spatial.new_zeros((f_spatial.shape[0], model.meta.nbody, 6))
    f_body.index_add_(1, torch.as_tensor(tb['geom_bodyid'],
                                         device=f_body.device), f_spatial)
    return _project(model, data, f_body)


def fluid(model: FlyModel, data: Data) -> Data:
    """Total fluid generalized forces (qfrc_fluid)."""
    tb = fluid_tables(model.meta)
    qfrc = _inertia_box_forces(model, data, tb)
    if tb['geom_active'].any():
        qfrc = qfrc + _ellipsoid_forces(model, data, tb)
    return data.replace(qfrc_fluid=qfrc)
