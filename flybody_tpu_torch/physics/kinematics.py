"""Forward kinematics and CoM-based quantities (the position stage).

Counterpart of flybody_tpu/physics/kinematics.py: joint local transforms,
per-body composition (tracking each joint's anchor and axis for MuJoCo's
sequential-joint semantics), world poses by pointer-doubling prefix
products, inertial/geom/site frames, subtree CoM, cinert, cdof and fixed
tendon lengths. These functions are the plain version of kernel K1
(ops/pos_stage.py); `fwd_position_smooth` is the stage's entry point.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.model.spec import FlyModel
from flybody_tpu_torch.physics import math as sm
from flybody_tpu_torch.physics.state import Data
from flybody_tpu_torch.utils import quaternions as quat


@functools.lru_cache(maxsize=8)
def tables(meta: _s.Meta) -> dict:
    """Constant index tables derived from static metadata (host-side)."""
    njnt, nv, nbody = meta.njnt, meta.nv, meta.nbody
    jnt_type = np.array(meta.jnt_type)
    slots = np.full((nbody, meta.max_jnt_per_body), -1, dtype=np.int64)
    for b in range(nbody):
        for s in range(meta.body_jntnum[b]):
            slots[b, s] = meta.body_jntadr[b] + s
    parent = np.array(meta.body_parentid)
    sub = np.eye(nbody)
    for c in range(nbody - 1, 0, -1):
        sub[parent[c]] += sub[c]
    sub = (sub > 0).astype(np.float64)

    dof_rot = np.zeros(nv)
    dof_local_axis = np.zeros((nv, 3))
    for j in range(njnt):
        adr = meta.jnt_dofadr[j]
        t = jnt_type[j]
        if t == _s.HINGE:
            dof_rot[adr] = 1.0
        elif t == _s.BALL:
            for k in range(3):
                dof_rot[adr + k] = 1.0
                dof_local_axis[adr + k, k] = 1.0
        elif t == _s.FREE:
            for k in range(3):
                dof_local_axis[adr + k, k] = 1.0
                dof_rot[adr + 3 + k] = 1.0
                dof_local_axis[adr + 3 + k, k] = 1.0
    dof_jnt_type = jnt_type[np.array(meta.dof_jntid)]
    free_ids = np.where(jnt_type == _s.FREE)[0]
    return dict(
        hinge_ids=np.where(jnt_type == _s.HINGE)[0],
        slide_ids=np.where(jnt_type == _s.SLIDE)[0],
        ball_ids=np.where(jnt_type == _s.BALL)[0],
        free_ids=free_ids,
        free_body=np.array(meta.jnt_bodyid)[free_ids],
        jnt_qposadr=np.array(meta.jnt_qposadr),
        jnt_bodyid=np.array(meta.jnt_bodyid),
        slots=slots, subtree_mask=sub, parent=parent,
        dof_jnt=np.array(meta.dof_jntid), dof_body=np.array(meta.dof_bodyid),
        dof_rot=dof_rot, dof_local_axis=dof_local_axis,
        is_free_trans=(dof_jnt_type == _s.FREE) & (dof_rot == 0),
        is_body_frame_unit=((dof_jnt_type == _s.BALL)
                            | ((dof_jnt_type == _s.FREE) & (dof_rot == 1))),
        root_of_body=np.array(meta.body_rootid),
        body_anc=np.array(meta.body_anc),
        geom_bodyid=np.array(meta.geom_bodyid),
        site_bodyid=np.array(meta.site_bodyid),
    )


def _joint_local_transforms(model: FlyModel, qpos):
    """(B, njnt+1, 3/4) local joint transforms; row njnt is identity."""
    meta = model.meta
    tb = tables(meta)
    B, njnt = qpos.shape[0], meta.njnt
    jquat = qpos.new_zeros((B, njnt + 1, 4))
    jquat[..., 0] = 1.0
    jpos = qpos.new_zeros((B, njnt + 1, 3))
    if len(tb['hinge_ids']):
        ids = tb['hinge_ids']
        qadr = tb['jnt_qposadr'][ids]
        angles = qpos[:, qadr] - model.qpos0[qadr]
        q = quat.axis_angle_to_quat(model.jnt_axis[ids], angles)
        anchor = model.jnt_pos[ids]
        jquat[:, ids] = q
        jpos[:, ids] = anchor - quat.rotate_vec_with_quat(anchor, q)
    if len(tb['slide_ids']):
        ids = tb['slide_ids']
        qadr = tb['jnt_qposadr'][ids]
        disp = (qpos[:, qadr] - model.qpos0[qadr])[..., None]
        jpos[:, ids] = model.jnt_axis[ids] * disp
    if len(tb['ball_ids']):
        ids = tb['ball_ids']
        qadr = tb['jnt_qposadr'][ids]
        q = quat.norm_quat(qpos[:, qadr[:, None] + np.arange(4)[None, :]])
        anchor = model.jnt_pos[ids]
        jquat[:, ids] = q
        jpos[:, ids] = anchor - quat.rotate_vec_with_quat(anchor, q)
    return jpos, jquat


def _object_poses(xpos, xquat, xipos, xmat, ximat, obj_pos, obj_quat,
                  bodyid, sameframe):
    """World frames of geoms/sites with mjtSameFrame shortcuts."""
    sf = np.asarray(sameframe)
    pos = xpos[:, bodyid] + quat.rotate_vec_with_quat(obj_pos,
                                                      xquat[:, bodyid])
    mat = quat.quat_to_mat(quat.mult_quat(xquat[:, bodyid], obj_quat))
    dev = xpos.device
    use_body = torch.as_tensor(sf == 1, device=dev)[:, None]
    use_inertia = torch.as_tensor(sf == 2, device=dev)[:, None]
    pos = torch.where(use_body, xpos[:, bodyid],
                      torch.where(use_inertia, xipos[:, bodyid], pos))
    rot_b = torch.as_tensor((sf == 1) | (sf == 3), device=dev)[:, None, None]
    rot_i = torch.as_tensor((sf == 2) | (sf == 4), device=dev)[:, None, None]
    mat = torch.where(rot_b, xmat[:, bodyid],
                      torch.where(rot_i, ximat[:, bodyid], mat))
    return pos, mat


def kinematics(model: FlyModel, data: Data):
    """Body/geom/site world poses; returns (data, jnt_xanchor, jnt_xaxis)."""
    meta = model.meta
    tb = tables(meta)
    qpos = data.qpos
    B, nbody, njnt = qpos.shape[0], meta.nbody, meta.njnt
    jpos, jquat = _joint_local_transforms(model, qpos)

    lpos = model.body_pos.expand(B, nbody, 3).clone()
    lquat = model.body_quat.expand(B, nbody, 4).clone()
    anchor_loc = qpos.new_zeros((B, njnt, 3))
    axis_loc = qpos.new_zeros((B, njnt, 3))
    slots = tb['slots']
    for s in range(meta.max_jnt_per_body):
        vb = np.where(slots[:, s] >= 0)[0]  # bodies with an s-th joint
        j = slots[vb, s]
        lp, lq = lpos[:, vb], lquat[:, vb]
        anchor_loc[:, j] = lp + quat.rotate_vec_with_quat(model.jnt_pos[j],
                                                          lq)
        axis_loc[:, j] = quat.rotate_vec_with_quat(model.jnt_axis[j], lq)
        new_pos, new_quat = sm.compose_frame(lp, lq, jpos[:, j], jquat[:, j])
        lpos[:, vb] = new_pos
        lquat[:, vb] = new_quat

    for j, b in zip(tb['free_ids'], tb['free_body']):
        adr = int(tb['jnt_qposadr'][j])
        lpos[:, b] = qpos[:, adr:adr + 3]
        lquat[:, b] = quat.norm_quat(qpos[:, adr + 3:adr + 7])
        anchor_loc[:, j] = 0.0

    xpos, xquat = lpos, lquat
    for anc in tb['body_anc']:
        xpos = xpos[:, anc] + quat.rotate_vec_with_quat(xpos, xquat[:, anc])
        xquat = quat.mult_quat(xquat[:, anc], xquat)
    xquat = quat.norm_quat(xquat)
    xmat = quat.quat_to_mat(xquat)
    xipos = xpos + quat.rotate_vec_with_quat(model.body_ipos, xquat)
    ximat = quat.quat_to_mat(quat.mult_quat(xquat, model.body_iquat))

    geom_xpos, geom_xmat = _object_poses(
        xpos, xquat, xipos, xmat, ximat, model.geom_pos, model.geom_quat,
        tb['geom_bodyid'], meta.geom_sameframe)
    site_xpos, site_xmat = _object_poses(
        xpos, xquat, xipos, xmat, ximat, model.site_pos, model.site_quat,
        tb['site_bodyid'], meta.site_sameframe)

    pb = tb['parent'][tb['jnt_bodyid']]
    jnt_xanchor = xpos[:, pb] + quat.rotate_vec_with_quat(anchor_loc,
                                                          xquat[:, pb])
    jnt_xaxis = quat.rotate_vec_with_quat(axis_loc, xquat[:, pb])
    for j, b in zip(tb['free_ids'], tb['free_body']):
        jnt_xanchor[:, j] = xpos[:, b]
        jnt_xaxis[:, j] = torch.tensor([0.0, 0.0, 1.0], dtype=xpos.dtype,
                                       device=xpos.device)
    data = data.replace(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos,
                        ximat=ximat, geom_xpos=geom_xpos,
                        geom_xmat=geom_xmat, site_xpos=site_xpos,
                        site_xmat=site_xmat)
    return data, jnt_xanchor, jnt_xaxis


def com_pos(model: FlyModel, data: Data, jnt_xanchor, jnt_xaxis) -> Data:
    """Subtree CoM, cdof and cinert (mj_comPos)."""
    tb = tables(model.meta)
    dt = data.qpos.dtype
    mass = model.body_mass
    sub = model.const('subtree_mask', lambda: tb['subtree_mask'])
    subtreemass = torch.clamp(model.body_subtreemass, min=1e-30)
    subtree_com = (torch.einsum('bc,Bcx->Bbx', sub,
                                mass[:, None] * data.xipos)
                   / subtreemass[:, None])
    ref = subtree_com[:, tb['root_of_body']]
    cinert = sm.spatial_inertia(mass, model.body_inertia, data.ximat,
                                data.xipos - ref)

    dof_body, dof_jnt = tb['dof_body'], tb['dof_jnt']
    dev = data.qpos.device
    R = data.xmat[:, dof_body]
    local_axis = model.const('dof_local_axis', lambda: tb['dof_local_axis'])
    body_frame_axis = torch.sum(R * local_axis[:, None, :], dim=-1)
    world_axis = torch.where(
        torch.as_tensor(tb['is_free_trans'], device=dev)[:, None],
        local_axis.expand_as(body_frame_axis),
        torch.where(torch.as_tensor(tb['is_body_frame_unit'],
                                    device=dev)[:, None],
                    body_frame_axis, jnt_xaxis[:, dof_jnt]))
    anchor = jnt_xanchor[:, dof_jnt]
    is_rot = model.const('dof_rot', lambda: tb['dof_rot'])[:, None]
    cdof_ang = world_axis * is_rot
    cdof_lin = torch.where(is_rot > 0,
                           sm.cross(world_axis, ref[:, dof_body] - anchor),
                           world_axis)
    cdof = torch.cat([cdof_ang, cdof_lin], dim=-1).to(dt)
    return data.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def tendon(model: FlyModel, data: Data) -> Data:
    """Fixed-tendon lengths."""
    return data.replace(ten_length=data.qpos @ model.ten_Lq.T)


def fwd_position_smooth(model: FlyModel, data: Data):
    """Position stage: kinematics -> com_pos -> tendon, as kernel K1 on
    CUDA (ops/pos_stage.py). Returns (data, jnt_xanchor, jnt_xaxis)."""
    from flybody_tpu_torch.ops import pos_stage
    (xpos, xquat, xmat, xipos, ximat, geom_xpos, geom_xmat, site_xpos,
     site_xmat, subtree_com, cinert, cdof, jnt_xanchor, jnt_xaxis,
     ten_length) = pos_stage.pos_stage(model, data.qpos)
    data = data.replace(
        xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
        geom_xpos=geom_xpos, geom_xmat=geom_xmat, site_xpos=site_xpos,
        site_xmat=site_xmat, subtree_com=subtree_com, cinert=cinert,
        cdof=cdof, ten_length=ten_length)
    return data, jnt_xanchor, jnt_xaxis
