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

# Phases of the kernel's clock instantiation (record_phases), in order.
PHASES = ('stage-in', 'velocities', 'body wrenches', 'subtree sums',
          'dof forces', 'mass matrix', 'passive', 'actuation', 'write-out')

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


def body_levels(meta) -> tuple[np.ndarray, np.ndarray]:
    """Bodies 1..nb-1 by tree depth, each depth in body order, and where
    each depth starts: the kernel's root-to-leaves schedule (a body reads
    only its parent's velocity, which an earlier level wrote)."""
    par = np.array(meta.body_parentid)
    depth = np.zeros(len(par), np.int64)
    for b in range(1, len(par)):
        depth[b] = depth[par[b]] + 1
    order = np.argsort(depth[1:], kind='stable') + 1
    off = np.searchsorted(depth[order], np.arange(1, depth.max() + 2))
    return order, off


def mass_codes(meta, part) -> np.ndarray:
    """Per entry of the packed mass matrix (nl + 1, dm + nr, dm), what the
    kernel writes there: -1 zero, -2 the identity padding of a limb
    block, else (i << 16) | (j << 1) | a for buf_i . cdof_j (+
    dof_armature[i] when a is 1), j on dof i's ancestor chain: the walk of
    each dof's ancestor chain, dof by dof, whose last write to an entry is
    the one kept."""
    nv, nl, dm, nr = meta.nv, len(part.ds), part.dmax, part.nr
    assert nv < 1 << 15, 'mass_codes: dof indices take 15 bits'
    limb = np.full(nv, -1, np.int64)
    pos = np.arange(nv, dtype=np.int64)
    for li, (lo, d) in enumerate(zip(part.los, part.ds)):
        limb[lo:lo + d] = li
        pos[lo:lo + d] = np.arange(d)
    dpar = _dof_parents(meta)
    rowlen = (dm + nr) * dm
    code = np.full((nl + 1) * rowlen, -1, np.int64)
    for li in range(nl):
        code[li * rowlen + np.arange(dm) * (dm + 1)] = -2
    for i in range(nv):
        li, ai = limb[i], pos[i]
        j = i
        while j >= 0:
            lj, aj = limb[j], pos[j]
            c = (i << 16) | (j << 1)
            if li >= 0 and lj >= 0:
                code[li * rowlen + ai * dm + aj] = c + (i == j)
                code[li * rowlen + aj * dm + ai] = c + (i == j)
            elif li >= 0:
                code[li * rowlen + (dm + aj) * dm + ai] = c
            else:
                code[nl * rowlen + ai * dm + aj] = c + (i == j)
                code[nl * rowlen + aj * dm + ai] = c + (i == j)
            j = dpar[j]
    return code


def moment_lists(mom_dof: np.ndarray, nv: int):
    """CSR lists (ptr (nv + 1), k) of the nonzero moments of each dof, in
    the order of the moment list (k ascending): qfrc_actuator[i] sums
    mom_coef[k] * actuator_force[mom_u[k]] over them in that order."""
    k = np.argsort(mom_dof, kind='stable')
    ptr = np.searchsorted(mom_dof[k], np.arange(nv + 1))
    return ptr, k


def pack(model) -> Pack:
    """The kernel's constant tables for this model (built once); `dims`
    holds their sizes (csrc/force_stage.cu `Dim`)."""
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
    mptr, mk = moment_lists(md, nv)
    ell = np.nonzero(np.array(meta.geom_fluid_active))[0]
    ell_f = np.concatenate([a['geom_fluid'][ell], a['geom_size'][ell]], 1)
    ell_i = np.stack([ell, np.array(meta.geom_bodyid)[ell]], 1)
    lbody, loff = body_levels(meta)
    dims = [meta.nq, nv, nb, meta.ntendon, nu, meta.na, nl, dm, nr, len(mu),
            len(ell), meta.ngeom, len(loff) - 1]
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
              ('dof_kind', kind), ('level_body', lbody), ('level_off', loff),
              ('mass_code', mass_codes(meta, part)), ('dof_qadr', dqadr),
              ('act_q', act_q), ('act_d', tb['trn_dadr']),
              ('act_adr', meta.actuator_actadr), ('mom_u', mu),
              ('mom_ptr', mptr), ('mom_k', mk), ('ellipsoid', ell_i)])
    p.dims = np.array(dims, np.int32)
    # The ints before the mass codes (header, dims, tree and dof tables),
    # which the kernel stages in shared memory.
    p.ntopo = int(p.ints[p.nf + p.inames.index('mass_code')])
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
              (na,), (nl + 1, dm + nr, dm)]
    outs = [torch.empty((B,) + s, dtype=torch.float32, device=qpos.device)
            for s in shapes]
    iptr = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t, _ in ins])
    optr = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    dims = p.dims.ctypes.data_as(ctypes.c_void_p)
    fn = _cuda.function('force_stage', 'force_stage_f32', [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p])
    rc = fn(iptr, optr, fp.data_ptr(), ip.data_ptr(), p.nf, p.ni, p.ntopo,
            dims, len(p.dims),
            _cuda.bulk_mask([t for t, _ in ins[:9]] + [ten_length]), B,
            _cuda.stream())
    _cuda.raise_on(rc, 'force_stage_f32')
    launches += 1
    return tuple(outs)


def record_phases(fn, batch: int, stride: int, device):
    """Runs fn() (force_stage launches on `batch` envs) with the kernel's
    phase clocks on: every stride-th env's cycles in each phase of PHASES,
    an int64 tensor (ceil(batch / stride), len(PHASES)) on the CPU."""
    return _cuda.record_phases('force_stage', 'force_stage_phase_clock',
                               len(PHASES), fn, batch, stride, device)


def kernel_info(model, batch: int) -> dict:
    """Registers a thread, shared memory a block, blocks an SM (the
    occupancy calculator) and grid blocks of the kernel for this model at
    this batch."""
    p = pack(model)
    out = (ctypes.c_int * 4)()
    fn = _cuda.function('force_stage', 'force_stage_info', [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int * 4)])
    _cuda.raise_on(fn(p.ntopo, p.dims.ctypes.data_as(ctypes.c_void_p),
                      len(p.dims), batch, ctypes.byref(out)),
                   'force_stage_info')
    return _cuda.info_dict(out)
