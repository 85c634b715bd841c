"""Kernel K2: the fused velocity + force stage (csrc/force_stage.cu).

Counterpart of flybody_tpu/ops/force_stage.py.
`force_stage(model, qpos, qvel, act, ctrl, cdof, cinert, xipos, ximat,
subtree_com, geom_xpos, geom_xmat, ten_length)` returns

    cvel, cdof_dot, ten_velocity, qfrc_bias, qfrc_passive, qfrc_fluid,
    qfrc_actuator, actuator_force, act_dot, qM (packed block-arrow)

in the JAX package's order and layout (B leading). CUDA tensors launch the
kernel; CPU tensors run the plain version `force_stage_ref`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.ops import _cuda
from flybody_tpu_torch.ops import arrow as _ar
from flybody_tpu_torch.ops._pack import Pack

NAMES = ('cvel', 'cdof_dot', 'ten_velocity', 'qfrc_bias', 'qfrc_passive',
         'qfrc_fluid', 'qfrc_actuator', 'actuator_force', 'act_dot', 'qM')

launches = 0


def force_stage_ref(model, qpos, qvel, act, ctrl, cdof, cinert, xipos,
                    ximat, subtree_com, geom_xpos, geom_xmat, ten_length):
    """Plain version: com_vel -> tendon_vel -> crb_packed -> rne ->
    passive -> fluid -> actuation."""
    from flybody_tpu_torch.physics import fluid as _fl
    from flybody_tpu_torch.physics import smooth as _sm
    from flybody_tpu_torch.physics.state import make_data
    d = make_data(model, qpos.shape[0]).replace(
        qpos=qpos, qvel=qvel, act=act, ctrl=ctrl, cdof=cdof, cinert=cinert,
        xipos=xipos, ximat=ximat, subtree_com=subtree_com,
        geom_xpos=geom_xpos, geom_xmat=geom_xmat, ten_length=ten_length)
    d = _sm.com_vel(model, d)
    d = _sm.tendon_vel(model, d)
    d = _sm.crb_packed(model, d)
    d = _sm.rne(model, d)
    d = _sm.passive(model, d)
    d = _fl.fluid(model, d)
    d = _sm.actuation(model, d)
    return (d.cvel, d.cdof_dot, d.ten_velocity, d.qfrc_bias, d.qfrc_passive,
            d.qfrc_fluid, d.qfrc_actuator, d.actuator_force, d.act_dot, d.qM)


# Geoms whose ellipsoid fluid model ellipsoid_variant switches on.
ELLIPSOID_GEOMS = ('wing_left_fluid', 'wing_right_fluid',
                   'coxa_T1_left_collision')


def ellipsoid_variant(arrays: dict, meta: dict, geoms=ELLIPSOID_GEOMS):
    """The model's npz arrays and meta with the ellipsoid fluid model on
    for `geoms` (flight's fluidcoef, seeded added-mass coefficients).

    The walking model activates no ellipsoid fluid geom; this variant is
    how the kernel's ellipsoid branch is held against its plain version.
    """
    ids = [meta['geom_names'].index(n) for n in geoms]
    gf = np.array(arrays['geom_fluid'], np.float64)
    rng = np.random.RandomState(7)
    active = list(meta['geom_fluid_active'])
    for g in ids:
        gf[g, :6] = (1.0, 1.0, 0.5, 1.5, 1.7, 1.0)
        gf[g, 6:] = 1e-4 * rng.rand(6)
        active[g] = True
    return dict(arrays, geom_fluid=gf), dict(meta, geom_fluid_active=active)


def _dof_parents(meta) -> np.ndarray:
    """MuJoCo's dof_parentid: the nearest ancestor dof, -1 at the root."""
    nv = meta.nv
    par = np.full(nv, -1, np.int64)
    dof_body = np.array(meta.dof_bodyid)
    bparent = np.array(meta.body_parentid)
    last = {}  # body -> its last dof
    for i in range(nv):
        last[dof_body[i]] = i
    for i in range(nv):
        b = dof_body[i]
        if i > 0 and dof_body[i - 1] == b:
            par[i] = i - 1
            continue
        p = bparent[b]
        while p > 0 and p not in last:
            p = bparent[p]
        par[i] = last.get(p, -1) if p > 0 else -1
    return par


def pack(model) -> Pack:
    """The kernel's constant tables for this model (built once)."""
    p = model._cache.get('force_stage_pack')
    if p is not None:
        return p
    from flybody_tpu_torch.physics import fluid as _fl
    from flybody_tpu_torch.physics import smooth as _sm
    meta = model.meta
    a = model.np_arrays
    jtype = np.array(meta.jnt_type)
    if not set(jtype.tolist()) <= {_s.FREE, _s.HINGE}:
        raise NotImplementedError('force_stage kernel: free and hinge '
                                  'joints only')
    part = _ar.build_partition(meta)
    nv, nb, nu = meta.nv, meta.nbody, meta.nu
    nl, dm, nr = len(part.ds), part.dmax, part.nr

    kind = np.full(nv, 2, np.int64)
    stiff = np.zeros(nv)
    sref = np.zeros(nv)
    dqadr = np.full(nv, -1, np.int64)
    for j in range(meta.njnt):
        adr = meta.jnt_dofadr[j]
        if jtype[j] == _s.FREE:
            kind[adr:adr + 3] = 0
            kind[adr + 3:adr + 6] = 1
        else:
            stiff[adr] = a['jnt_stiffness'][j]
            sref[adr] = a['qpos_spring'][meta.jnt_qposadr[j]]
            dqadr[adr] = meta.jnt_qposadr[j]
    limb = np.full(nv, -1, np.int64)
    pos = np.arange(nv, dtype=np.int64)
    for li, (lo, d) in enumerate(zip(part.los, part.ds)):
        limb[lo:lo + d] = li
        pos[lo:lo + d] = np.arange(d)

    tb = _sm.act_tables(meta)
    act_rows = np.stack([
        a['actuator_ctrlrange'][:, 0], a['actuator_ctrlrange'][:, 1],
        np.maximum(a['actuator_dynprm'][:, 0], 1e-10),
        a['actuator_gainprm'][:, 0], a['actuator_biasprm'][:, 0],
        a['actuator_biasprm'][:, 1], a['actuator_biasprm'][:, 2],
        tb['is_affine'], a['actuator_forcelimited'],
        a['actuator_forcerange'][:, 0], a['actuator_forcerange'][:, 1],
        a['actuator_gear0'], tb['has_act'], tb['is_joint'], tb['is_tendon']],
        axis=1)
    act_q = np.where(tb['is_joint'] > 0, tb['trn_qadr'], tb['ten_id'])
    mom = a['actuator_moment']
    mu, md = np.nonzero(mom)
    ell = np.nonzero(np.array(meta.geom_fluid_active))[0]
    ell_f = np.concatenate([a['geom_fluid'][ell], a['geom_size'][ell]], 1)
    ell_i = np.stack([ell, np.array(meta.geom_bodyid)[ell]], 1)
    dims = [meta.nq, nv, nb, meta.ntendon, nu, meta.na, nl, dm, nr, len(mu),
            len(ell), meta.ngeom]
    p = Pack(
        floats=[('gravity', a['gravity']), ('wind', a['wind']),
                ('fluid', [a['density'], a['viscosity']]),
                ('armature', a['dof_armature']), ('damping', a['dof_damping']),
                ('stiff', stiff), ('springref', sref), ('ten_J', a['ten_J']),
                ('ten_stiff', a['ten_stiffness']),
                ('ten_damp', a['ten_damping']),
                ('ten_ls', a['ten_lengthspring']),
                ('box', _fl.inertia_box_dims(a['body_mass'],
                                             a['body_inertia'])),
                ('box_mask', _fl.inertia_box_mask(model)),
                ('act', act_rows), ('mom_coef', mom[mu, md]),
                ('ellipsoid', ell_f)],
        ints=[('dims', dims), ('parent', meta.body_parentid),
              ('root', meta.body_rootid), ('dofadr', meta.body_dofadr),
              ('dofnum', meta.body_dofnum), ('dof_body', meta.dof_bodyid),
              ('dof_kind', kind), ('dof_parent', _dof_parents(meta)),
              ('dof_limb', limb), ('dof_pos', pos), ('dof_qadr', dqadr),
              ('act_q', act_q), ('act_d', tb['trn_dadr']),
              ('act_adr', meta.actuator_actadr), ('mom_u', mu),
              ('mom_dof', md), ('ellipsoid', ell_i)])
    model._cache['force_stage_pack'] = p
    return p


def force_stage(model, qpos, qvel, act, ctrl, cdof, cinert, xipos, ximat,
                subtree_com, geom_xpos, geom_xmat, ten_length):
    if qpos.device.type == 'cpu':
        return force_stage_ref(model, qpos, qvel, act, ctrl, cdof, cinert,
                               xipos, ximat, subtree_com, geom_xpos,
                               geom_xmat, ten_length)
    global launches
    meta = model.meta
    part = _ar.build_partition(meta)
    B = qpos.shape[0]
    nb, nv, nt, nu, na, ng = (meta.nbody, meta.nv, meta.ntendon, meta.nu,
                              meta.na, meta.ngeom)
    ins = [(qpos, (B, meta.nq)), (qvel, (B, nv)), (act, (B, na)),
           (ctrl, (B, nu)), (cdof, (B, nv, 6)), (cinert, (B, nb, 6, 6)),
           (xipos, (B, nb, 3)), (ximat, (B, nb, 3, 3)),
           (subtree_com, (B, nb, 3)), (geom_xpos, (B, ng, 3)),
           (geom_xmat, (B, ng, 3, 3)), (ten_length, (B, nt))]
    for i, (t, shape) in enumerate(ins):
        _cuda.check(t, shape, f'force_stage input {i}')
    p = pack(model)
    fp, ip = p.on(qpos.device)
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    shapes = [(nb, 6), (nv, 6), (nt,), (nv,), (nv,), (nv,), (nv,), (nu,),
              (na,), (nl + 1, dm + nr, dm), (54 * nb + 6 * nv,)]
    outs = [torch.empty((B,) + s, dtype=torch.float32, device=qpos.device)
            for s in shapes]
    iptr = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t, _ in ins])
    optr = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    fn = _cuda.function('force_stage', 'force_stage_f32', [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    rc = fn(iptr, optr, fp.data_ptr(), fp.numel(), ip.data_ptr(),
            ip.numel(), p.nf, p.ni, B, _cuda.stream())
    _cuda.raise_on(rc, 'force_stage_f32')
    launches += 1
    return tuple(outs[:10])  # the last is the kernel's scratch
