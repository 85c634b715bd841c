"""Kernel K4: rnePostConstraint + sensordata (csrc/sens_stage.cu).

Counterpart of flybody_tpu/ops/sens_stage.py. `sens_stage(model, qacc,
qvel, cvel, cdof, cdof_dot, cinert, site_xpos, site_xmat, subtree_com,
con_xpos, con_normal, con_b12, con_active, f_c)` returns sensordata
(B, nsensordata); con_b12 (B, 2, K) holds the contact bodies as floats, as
in the JAX package. CUDA tensors launch the kernel; CPU tensors run the
plain version `sens_stage_ref` (physics/sensors.py).

The kernel runs an env in a 128-thread block and forms only what the
sensors read, each value by the one-thread loop's operations in its order;
its schedule comes from the host tables of `pack` (`plan`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.ops import _cuda
from flybody_tpu_torch.ops._pack import Pack

# Phases of the kernel's clock instantiation (record_phases), in order.
PHASES = ('stage-in', 'accelerations', 'contact wrenches', 'body forces',
          'subtree sums', 'sensors')

launches = 0


def sens_stage_ref(model, qacc, qvel, cvel, cdof, cdof_dot, cinert,
                   site_xpos, site_xmat, subtree_com, con_xpos, con_normal,
                   con_b12, con_active, f_c):
    from flybody_tpu_torch.physics import sensors as _sens
    b12 = torch.round(con_b12).long()
    return _sens.sensordata(model, qacc, qvel, cvel, cdof, cdof_dot, cinert,
                            site_xpos, site_xmat, subtree_com, con_xpos,
                            con_normal, b12[:, 0], b12[:, 1], con_active, f_c)


def plan(meta, rows):
    """What the kernel computes for these sensors, in the one-thread loop's
    order: `need`, the bodies in the subtrees of the force sensors' bodies
    (their body forces and subtree sums; ascending); `tops`, the force
    sensors' bodies with no force sensor's body above them, with `sub`
    (`sub_off`) each top's descendants in descending id (the loop's order
    of the subtree sums); `acc`, the bodies whose acceleration the kernel
    forms (`need` and the accelerometers' bodies; ascending), with `dofs`
    (`dof_off`) the dofs of each one's chain of bodies from the world's
    child down to itself (a parent's before its child's, each body's in
    order: the terms of the loop's sums)."""
    par = list(meta.body_parentid)
    nb = len(par)
    kids = [[] for _ in range(nb)]
    for b in range(1, nb):
        kids[par[b]].append(b)

    def subtree(b):
        out = [b]
        for c in kids[b]:
            out += subtree(c)
        return out

    def above(b):
        out = []
        while b != 0:
            b = par[b]
            out.append(b)
        return out

    site_body = meta.site_bodyid
    force = {site_body[r['objid']] for r in rows
             if r['type'] == _s.SENS_FORCE}
    tops = sorted(b for b in force if not set(above(b)) & force)
    need = sorted({x for b in tops for x in subtree(b)})
    acc = sorted(set(need) | {site_body[r['objid']] for r in rows
                              if r['type'] == _s.SENS_ACCELEROMETER})
    sub = [sorted(subtree(b)[1:], reverse=True) for b in tops]
    dofs = [[i for x in [y for y in reversed(above(b)) if y != 0] + [b]
             for i in range(meta.body_dofadr[x],
                            meta.body_dofadr[x] + meta.body_dofnum[x])]
            for b in acc]

    def flat(lists):
        off = np.cumsum([0] + [len(x) for x in lists])
        return (np.array([v for x in lists for v in x], np.int64),
                off.astype(np.int64))
    sub_f, sub_off = flat(sub)
    dofs_f, dof_off = flat(dofs)
    return dict(need=np.array(need, np.int64), tops=np.array(tops, np.int64),
                sub=sub_f, sub_off=sub_off, acc=np.array(acc, np.int64),
                dofs=dofs_f, dof_off=dof_off)


def pack(model) -> Pack:
    """The kernel's constant tables for this model (built once), with two
    host attributes: `dims`, the sizes the launch passes (csrc/sens_stage.cu
    `Dim`), and `plan`, the tables' source (`plan`)."""
    p = model._cache.get('sens_stage_pack')
    if p is not None:
        return p
    from flybody_tpu_torch.physics import sensors as _sens
    meta = model.meta
    rows = _sens.sensor_rows(meta)
    supported = {_s.SENS_TOUCH, _s.SENS_ACCELEROMETER, _s.SENS_VELOCIMETER,
                 _s.SENS_GYRO, _s.SENS_FORCE}
    if not {r['type'] for r in rows} <= supported:
        raise NotImplementedError('sens_stage kernel: unsupported sensor')
    cut = np.concatenate([np.full(r['dim'],
                                  model.np_arrays['sensor_cutoff'][r['idx']])
                          for r in rows])
    sens = [[r['type'], r['objid'], r['adr'], r['dim'],
             meta.site_bodyid[r['objid']]] for r in rows]
    pl = plan(meta, rows)
    dims = [meta.nv, meta.nbody, meta.nsite, meta.nsensordata, len(rows),
            len(pl['acc']), len(pl['need']), len(pl['tops'])]
    p = Pack(floats=[('gravity', model.np_arrays['gravity']),
                     ('cutoff', cut)],
             ints=[('parent', meta.body_parentid),
                   ('root', meta.body_rootid),
                   ('sens', np.array(sens, np.int64)),
                   ('need', pl['need']),
                   ('sub', pl['sub']), ('sub_off', pl['sub_off']),
                   ('acc', pl['acc']), ('dofs', pl['dofs']),
                   ('dof_off', pl['dof_off'])])
    p.dims = np.array(dims, np.int32)
    p.plan = pl
    model._cache['sens_stage_pack'] = p
    return p


def operands(data, efc, f_c) -> tuple:
    """sens_stage's operands (after the model) from a forward pass's data,
    contact rows and contact forces, contiguous (con_b12 from the rows'
    body ids)."""
    cb12 = torch.stack([efc.con_body1, efc.con_body2], 1).to(data.qacc.dtype)
    return tuple(t.contiguous() for t in (
        data.qacc, data.qvel, data.cvel, data.cdof, data.cdof_dot,
        data.cinert, data.site_xpos, data.site_xmat, data.subtree_com,
        efc.con_xpos, efc.con_normal, cb12, efc.con_active, f_c))


def sens_stage(model, qacc, qvel, cvel, cdof, cdof_dot, cinert, site_xpos,
               site_xmat, subtree_com, con_xpos, con_normal, con_b12,
               con_active, f_c):
    args = (qacc, qvel, cvel, cdof, cdof_dot, cinert, site_xpos, site_xmat,
            subtree_com, con_xpos, con_normal, con_b12, con_active, f_c)
    if qacc.device.type == 'cpu':
        return sens_stage_ref(model, *args)
    global launches
    meta = model.meta
    B, K = con_active.shape
    nv, nb, ns = meta.nv, meta.nbody, meta.nsite
    shapes = [(B, nv), (B, nv), (B, nb, 6), (B, nv, 6), (B, nv, 6),
              (B, nb, 6, 6), (B, ns, 3), (B, ns, 3, 3), (B, nb, 3),
              (B, K, 3), (B, K, 3), (B, 2, K), (B, K), (B, K, 3)]
    for i, (t, shape) in enumerate(zip(args, shapes)):
        _cuda.check(t, shape, f'sens_stage input {i}')
    p = pack(model)
    fp, ip = p.on(qacc.device)
    out = torch.empty((B, meta.nsensordata), dtype=torch.float32,
                      device=qacc.device)
    iptr = (ctypes.c_void_p * len(args))(*[t.data_ptr() for t in args])
    fn = _cuda.function('sens_stage', 'sens_stage_f32', [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rc = fn(iptr, out.data_ptr(), fp.data_ptr(), ip.data_ptr(), p.nf, p.ni,
            p.dims.ctypes.data_as(ctypes.c_void_p), len(p.dims),
            _cuda.bulk_mask(args), K, B, _cuda.stream())
    _cuda.raise_on(rc, 'sens_stage_f32')
    launches += 1
    return out


def record_phases(fn, batch: int, stride: int, device):
    """Runs fn() (sens_stage launches on `batch` envs) with the kernel's
    phase clocks on: every stride-th env's cycles in each phase of PHASES,
    an int64 tensor (ceil(batch / stride), len(PHASES)) on the CPU."""
    return _cuda.record_phases('sens_stage', 'sens_stage_phase_clock',
                               len(PHASES), fn, batch, stride, device)


def kernel_info(model, K: int, batch: int) -> dict:
    """Registers a thread, shared memory a block, blocks an SM (the
    occupancy calculator) and grid blocks of the kernel for this model and
    K contact slots at this batch."""
    p = pack(model)
    out = (ctypes.c_int * 4)()
    fn = _cuda.function('sens_stage', 'sens_stage_info', [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int * 4)])
    _cuda.raise_on(fn(p.dims.ctypes.data_as(ctypes.c_void_p), len(p.dims),
                      K, batch, ctypes.byref(out)), 'sens_stage_info')
    return _cuda.info_dict(out)
