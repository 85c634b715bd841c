"""Sensors: gyro, velocimeter, accelerometer, force, touch (plain PyTorch).

Counterpart of flybody_tpu/physics/sensors.py, batched over envs: the
post-constraint body accelerations and internal forces of
mj_rnePostConstraint, then every sensor in sensordata order with cutoff
clipping. The plain version of kernel K4 (ops/sens_stage.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.model.spec import FlyModel
from flybody_tpu_torch.physics import kinematics as _kin
from flybody_tpu_torch.physics import math as sm
from flybody_tpu_torch.ops.efc_stage import make_frame


@functools.lru_cache(maxsize=8)
def sensor_rows(meta: _s.Meta):
    """Sensors in sensordata order (they tile it contiguously)."""
    rows = sorted(({'type': meta.sensor_type[i], 'objid': meta.sensor_objid[i],
                    'adr': meta.sensor_adr[i], 'dim': meta.sensor_dim[i],
                    'idx': i} for i in range(meta.nsensor)),
                  key=lambda r: r['adr'])
    off = 0
    for r in rows:
        assert r['adr'] == off, (r, off)
        off += r['dim']
    assert off == meta.nsensordata
    return tuple(rows)


def body_cacc(model: FlyModel, qacc, qvel, cdof, cdof_dot):
    """Post-constraint body spatial accelerations (B, nbody, 6)."""
    mask = model.body_dof_mask
    grav = torch.cat([torch.zeros_like(model.gravity), -model.gravity])
    return (torch.einsum('bv,Bv,Bvx->Bbx', mask, qacc, cdof)
            + torch.einsum('bv,Bv,Bvx->Bbx', mask, qvel, cdof_dot) + grav)


def contact_body_wrenches(model: FlyModel, subtree_com, con_xpos,
                          con_normal, body1, body2, con_active, f_c):
    """External contact wrenches per body (B, nbody, 6), (torque; force)
    about each body's root subtree CoM."""
    t1, t2 = make_frame(con_normal)
    frame = torch.stack([con_normal, t1, t2], dim=-2)
    f_world = torch.einsum('bkr,bkri->bki', f_c, frame)
    root = model.const('body_rootid', lambda: np.array(model.meta.body_rootid))
    out = f_world.new_zeros((f_world.shape[0], model.meta.nbody, 6))
    bi = torch.arange(f_world.shape[0], device=f_world.device)[:, None]
    for body, sgn in ((body2, 1.0), (body1, -1.0)):
        ref = subtree_com[bi, root[body]]
        f = sgn * f_world
        w = torch.cat([sm.cross(con_xpos - ref, f), f], -1)
        w = w * con_active[..., None]
        out.scatter_add_(1, body[..., None].expand(-1, -1, 6), w)
    return out


def sensordata(model: FlyModel, qacc, qvel, cvel, cdof, cdof_dot, cinert,
               site_xpos, site_xmat, subtree_com, con_xpos, con_normal,
               body1, body2, con_active, f_c, xpos=None, xfrc_applied=None):
    """The full sensordata vector (B, nsensordata)."""
    meta = model.meta
    tb = _kin.tables(meta)
    cacc = body_cacc(model, qacc, qvel, cdof, cdof_dot)
    Iv = torch.sum(cinert * cvel[..., None, :], dim=-1)
    h = torch.sum(cinert * cacc[..., None, :], dim=-1) + sm.force_cross(
        cvel, Iv)
    ext = contact_body_wrenches(model, subtree_com, con_xpos, con_normal,
                                body1, body2, con_active, f_c)
    if xfrc_applied is not None:
        ref = subtree_com[:, tb['root_of_body']]
        force = xfrc_applied[..., :3]
        ext = ext + torch.cat([xfrc_applied[..., 3:]
                               + sm.cross(xpos - ref, force), force], -1)
    sub = model.const('subtree_mask', lambda: tb['subtree_mask'])
    fint = torch.einsum('bc,Bcx->Bbx', sub, h - ext)
    normal_force = torch.clamp(f_c[..., 0], min=0.0) * con_active

    segs = []
    for r in sensor_rows(meta):
        t, sid = r['type'], r['objid']
        b = meta.site_bodyid[sid]
        R = site_xmat[:, sid]
        rT = lambda v: torch.einsum('bij,bi->bj', R, v)
        w, v = cvel[:, b, :3], cvel[:, b, 3:]
        arm = site_xpos[:, sid] - subtree_com[:, meta.body_rootid[b]]
        if t == _s.SENS_GYRO:
            segs.append(rT(w))
        elif t == _s.SENS_VELOCIMETER:
            segs.append(rT(v + sm.cross(w, arm)))
        elif t == _s.SENS_ACCELEROMETER:
            wa, va = cacc[:, b, :3], cacc[:, b, 3:]
            v_at = v + sm.cross(w, arm)
            segs.append(rT(va + sm.cross(wa, arm) + sm.cross(w, v_at)))
        elif t == _s.SENS_FORCE:
            segs.append(rT(fint[:, b, 3:]))
        elif t == _s.SENS_TOUCH:
            involve = ((body1 == b) | (body2 == b)).to(qacc.dtype)
            segs.append(torch.sum(involve * normal_force, -1, keepdim=True))
        else:
            raise NotImplementedError(f'sensor type {t}')
    out = torch.cat(segs, -1)
    cut = model.const('sensor_cutoff_vec', lambda: np.concatenate(
        [np.full(r['dim'], model.np_arrays['sensor_cutoff'][r['idx']])
         for r in sensor_rows(meta)]))
    return torch.where(cut > 0, torch.clamp(out, -cut, cut), out)
