"""Kernel K1: the fused position stage (csrc/pos_stage.cu).

Counterpart of flybody_tpu/ops/pos_stage.py. `pos_stage(model, qpos)`
returns the 15 position-stage outputs in the JAX package's order and
layout (B leading):

    xpos, xquat, xmat, xipos, ximat, geom_xpos, geom_xmat, site_xpos,
    site_xmat, subtree_com, cinert, cdof, jnt_xanchor, jnt_xaxis,
    ten_length

On a CUDA tensor it launches the kernel; on a CPU tensor it runs the plain
version `pos_stage_ref` (physics/kinematics.py).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.ops import _cuda
from flybody_tpu_torch.ops._pack import Pack
from flybody_tpu_torch.ops.force_stage import body_levels

NAMES = ('xpos', 'xquat', 'xmat', 'xipos', 'ximat', 'geom_xpos', 'geom_xmat',
         'site_xpos', 'site_xmat', 'subtree_com', 'cinert', 'cdof',
         'jnt_xanchor', 'jnt_xaxis', 'ten_length')

# Phases of the kernel's clock instantiation (record_phases), in order.
PHASES = ('stage-in', 'body frames', 'objects', 'subtree com',
          'cinert and cdof', 'write-out')

launches = 0


def pos_stage_ref(model, qpos):
    """Plain version: kinematics -> com_pos -> tendon."""
    from flybody_tpu_torch.physics import kinematics as kin
    from flybody_tpu_torch.physics.state import make_data
    d = make_data(model, qpos.shape[0]).replace(qpos=qpos)
    d, ja, jx = kin.kinematics(model, d)
    d = kin.com_pos(model, d, ja, jx)
    d = kin.tendon(model, d)
    return (d.xpos, d.xquat, d.xmat, d.xipos, d.ximat, d.geom_xpos,
            d.geom_xmat, d.site_xpos, d.site_xmat, d.subtree_com, d.cinert,
            d.cdof, ja, jx, d.ten_length)


def out_shapes(meta) -> list[tuple]:
    nb, ng, ns, nv, nj = (meta.nbody, meta.ngeom, meta.nsite, meta.nv,
                          meta.njnt)
    return [(nb, 3), (nb, 4), (nb, 3, 3), (nb, 3), (nb, 3, 3), (ng, 3),
            (ng, 3, 3), (ns, 3), (ns, 3, 3), (nb, 3), (nb, 6, 6), (nv, 6),
            (nj, 3), (nj, 3), (meta.ntendon,)]


def pack(model) -> Pack:
    """The kernel's constant tables for this model (built once). The tables
    the tree walk reads come first in each pack: the kernel copies the
    first `nfs` floats and `nis` ints (multiples of 4) into shared memory.
    `dims` holds their sizes (csrc/pos_stage.cu `Dim`)."""
    p = model._cache.get('pos_stage_pack')
    if p is not None:
        return p
    meta = model.meta
    a = model.np_arrays
    jtype = np.array(meta.jnt_type)
    if not set(jtype.tolist()) <= {_s.FREE, _s.HINGE}:
        raise NotImplementedError('pos_stage kernel: free and hinge joints '
                                  'only')
    nv = meta.nv
    mode = np.zeros(nv, np.int64)
    kk = np.zeros(nv, np.int64)
    for j in range(meta.njnt):
        adr = meta.jnt_dofadr[j]
        if jtype[j] == _s.FREE:
            mode[adr:adr + 3] = 0
            mode[adr + 3:adr + 6] = 1
            kk[adr:adr + 6] = [0, 1, 2, 0, 1, 2]
        else:
            mode[adr] = 2
    lbody, loff = body_levels(meta)
    dims = [meta.nq, nv, meta.nbody, meta.njnt, meta.ngeom, meta.nsite,
            meta.ntendon, len(loff) - 1]
    p = Pack(
        floats=[('qpos0', a['qpos0']), ('body_pos', a['body_pos']),
                ('body_quat', a['body_quat']), ('jnt_pos', a['jnt_pos']),
                ('jnt_axis', a['jnt_axis']), ('body_ipos', a['body_ipos']),
                ('body_iquat', a['body_iquat']), ('mass', a['body_mass']),
                ('subtreemass', np.maximum(a['body_subtreemass'], 1e-30)),
                ('inertia', a['body_inertia']), ('geom_pos', a['geom_pos']),
                ('geom_quat', a['geom_quat']), ('site_pos', a['site_pos']),
                ('site_quat', a['site_quat']), ('ten_Lq', a['ten_Lq']),
                ('pad', np.zeros(4))],
        ints=[('dims', dims), ('parent', meta.body_parentid),
              ('jntadr', meta.body_jntadr), ('jntnum', meta.body_jntnum),
              ('jnt_type', meta.jnt_type),
              ('jnt_qposadr', meta.jnt_qposadr), ('level_body', lbody),
              ('level_off', loff), ('root', meta.body_rootid),
              ('geom_body', meta.geom_bodyid),
              ('geom_sf', meta.geom_sameframe),
              ('site_body', meta.site_bodyid),
              ('site_sf', meta.site_sameframe),
              ('dof_body', meta.dof_bodyid), ('dof_jnt', meta.dof_jntid),
              ('dof_mode', mode), ('dof_k', kk), ('pad', np.zeros(4))])
    p.dims = np.array(dims, np.int32)
    # The staged prefixes, rounded up to 16 bytes (the pad tables keep
    # them inside the packs).
    p.nfs = _up4(int(p.ints[p.fnames.index('body_ipos')]))
    p.nis = _up4(int(p.ints[p.nf + p.inames.index('root')]))
    model._cache['pos_stage_pack'] = p
    return p


def _up4(n: int) -> int:
    return (n + 3) & ~3


def pos_stage(model, qpos):
    """The 15 position-stage outputs for qpos (B, nq)."""
    if qpos.device.type == 'cpu':
        return pos_stage_ref(model, qpos)
    global launches
    meta = model.meta
    B = qpos.shape[0]
    _cuda.check(qpos, (B, meta.nq), 'qpos')
    p = pack(model)
    fp, ip = p.on(qpos.device)
    outs = [torch.empty((B,) + s, dtype=torch.float32, device=qpos.device)
            for s in out_shapes(meta)]
    ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    fn = _cuda.function('pos_stage', 'pos_stage_f32', [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
        ctypes.c_void_p])
    rc = fn(qpos.data_ptr(), ptrs, fp.data_ptr(), ip.data_ptr(), p.nf, p.ni,
            p.nfs, p.nis, p.dims.ctypes.data_as(ctypes.c_void_p), len(p.dims),
            _cuda.bulk_mask(outs), B, _cuda.stream())
    _cuda.raise_on(rc, 'pos_stage_f32')
    launches += 1
    return tuple(outs)


def record_phases(fn, batch: int, stride: int, device):
    """Runs fn() (pos_stage launches on `batch` envs) with the kernel's
    phase clocks on: every stride-th env's cycles in each phase of PHASES,
    an int64 tensor (ceil(batch / stride), len(PHASES)) on the CPU."""
    return _cuda.record_phases('pos_stage', 'pos_stage_phase_clock',
                               len(PHASES), fn, batch, stride, device)


def kernel_info(model, batch: int) -> dict:
    """Registers a thread, shared memory a block, blocks an SM (the
    occupancy calculator) and grid blocks of the kernel for this model at
    this batch."""
    p = pack(model)
    out = (ctypes.c_int * 4)()
    fn = _cuda.function('pos_stage', 'pos_stage_info', [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int * 4)])
    _cuda.raise_on(fn(p.nfs, p.nis, p.dims.ctypes.data_as(ctypes.c_void_p),
                      len(p.dims), batch, ctypes.byref(out)),
                   'pos_stage_info')
    return _cuda.info_dict(out)
