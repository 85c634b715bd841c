"""Kernel K4: rnePostConstraint + sensordata (csrc/sens_stage.cu).

Counterpart of flybody_tpu/ops/sens_stage.py. `sens_stage(model, qacc,
qvel, cvel, cdof, cdof_dot, cinert, site_xpos, site_xmat, subtree_com,
con_xpos, con_normal, con_b12, con_active, f_c)` returns sensordata
(B, nsensordata); con_b12 (B, 2, K) holds the contact bodies as floats, as
in the JAX package. CUDA tensors launch the kernel; CPU tensors run the
plain version `sens_stage_ref` (physics/sensors.py).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.ops import _cuda
from flybody_tpu_torch.ops._pack import Pack

launches = 0


def sens_stage_ref(model, qacc, qvel, cvel, cdof, cdof_dot, cinert,
                   site_xpos, site_xmat, subtree_com, con_xpos, con_normal,
                   con_b12, con_active, f_c):
    from flybody_tpu_torch.physics import sensors as _sens
    b12 = torch.round(con_b12).long()
    return _sens.sensordata(model, qacc, qvel, cvel, cdof, cdof_dot, cinert,
                            site_xpos, site_xmat, subtree_com, con_xpos,
                            con_normal, b12[:, 0], b12[:, 1], con_active, f_c)


def pack(model) -> Pack:
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
    p = Pack(floats=[('gravity', model.np_arrays['gravity']),
                     ('cutoff', cut)],
             ints=[('dims', [meta.nv, meta.nbody, meta.nsite,
                             meta.nsensordata, len(rows)]),
                   ('parent', meta.body_parentid), ('root', meta.body_rootid),
                   ('dofadr', meta.body_dofadr), ('dofnum', meta.body_dofnum),
                   ('sens', np.array(sens, np.int64))])
    model._cache['sens_stage_pack'] = p
    return p


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
    scratch = torch.empty((B, 12 * nb), dtype=torch.float32,
                          device=qacc.device)
    iptr = (ctypes.c_void_p * len(args))(*[t.data_ptr() for t in args])
    fn = _cuda.function('sens_stage', 'sens_stage_f32', [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rc = fn(iptr, out.data_ptr(), scratch.data_ptr(), fp.data_ptr(),
            fp.numel(), ip.data_ptr(), ip.numel(), p.nf, p.ni, K, B,
            _cuda.stream())
    _cuda.raise_on(rc, 'sens_stage_f32')
    launches += 1
    return out
