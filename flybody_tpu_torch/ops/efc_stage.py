"""Contact constraint rows: kernel 7.

Counterpart of flybody_tpu/ops/efc_stage.py (`make_efc_contacts_pe`,
`_efc_pallas`, row 7 of PERF.md's kernel table): of the C candidate
contacts (dense analytic slots, then the compact capsule-capsule and MPR
blocks), the k with the smallest dist - includemargin, the lower index
first among ties and NaN scores last (a stable sort, as
collision.smallest); then their Jacobian rows in the contact frame,
velocity, impedance, aref and D (MuJoCo's mj_makeConstraint for a single
kinematic tree).

Operands: cand_b (B, C, 7) [dist | pos | normal], cand_u (B, C, 14)
efc_slot_table rows, cand_g (B, C) global slot ids as floats, and the
forward pass's qvel, cdof and subtree_com. Returns con_J (B, k, 3, nv) and
19 (B, k) rows: dist, active, frictional, mu, D, aref (3), pos (3),
normal (3), body1, body2, self, break, slot id. `contact_rows` launches
csrc/efc_stage.cu on CUDA tensors (float32, contiguous, a body_dof_mask of
zeros and ones; anything else raises) and runs the plain version
`contact_rows_ref` on CPU tensors. PHASES, `record_phases` and
`kernel_info` read the kernel's phase clocks and resources.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flybody_tpu_torch.ops import _cuda
from flybody_tpu_torch.ops import arrow as _ar
from flybody_tpu_torch.physics import collision as _col
from flybody_tpu_torch.physics.math import cross

launches = 0
NROWS = 19
PHASES = ('stage-in and keys', 'selection', 'features and frames',
          'con_J and velocities', 'row scalars')


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


def select(cand_b, cand_u, cand_g, k):
    """The k candidates with the smallest dist - includemargin (a stable
    sort: the lower index first among ties): their rows of cand_b (B, k,
    7), cand_u (B, k, 14) and cand_g (B, k)."""
    sel = _col.smallest(cand_b[..., 0] - cand_u[..., 0], k)
    return (torch.gather(cand_b, 1, sel[..., None].expand(-1, -1, 7)),
            torch.gather(cand_u, 1, sel[..., None].expand(-1, -1, 14)),
            torch.gather(cand_g, 1, sel))


def frame_rows(bsel):
    """The contact frames (B, k, 3, 3): rows normal, t1, t2."""
    c_n = bsel[..., 4:7]
    t1, t2 = make_frame(c_n)
    return torch.stack([c_n, t1, t2], dim=-2)


def body_ids(usel):
    return torch.round(usel[..., 11]).long(), torch.round(usel[..., 12]).long()


def row_scalars(bsel, usel, gsel, con_J, c_break, qvel):
    """The 19 (B, k) rows of the selected slots from their Jacobian rows:
    dist, active, frictional, mu, D, aref(3), pos(3), normal(3), body1,
    body2, self, break, slot id."""
    dt = bsel.dtype
    c_dist, c_pos, c_n = bsel[..., 0], bsel[..., 1:4], bsel[..., 4:7]
    c_incl, c_mu = usel[..., 0], usel[..., 1]
    c_solref, c_solimp = usel[..., 2:4], usel[..., 4:9]
    condim, diag_c = usel[..., 9], usel[..., 10]
    r_c = c_dist - c_incl
    K_c, B_c, imp_c = kbi(c_solref, c_solimp, r_c)
    vel = torch.einsum('bkrv,bv->bkr', con_J, qvel)
    aref_n = -B_c * vel[..., 0] - K_c * imp_c * r_c
    aref_t = -B_c[..., None] * vel[..., 1:]
    R_c = torch.clamp((1.0 - imp_c) / imp_c * diag_c, min=1e-12)
    return [c_dist, (c_dist < c_incl).to(dt), (condim >= 3).to(dt), c_mu,
            1.0 / R_c, aref_n, aref_t[..., 0], aref_t[..., 1], c_pos[..., 0],
            c_pos[..., 1], c_pos[..., 2], c_n[..., 0], c_n[..., 1],
            c_n[..., 2], usel[..., 11], usel[..., 12], usel[..., 13],
            c_break, gsel]


def contact_rows_ref(model, data, cand_b, cand_u, cand_g, k):
    """Top-k contact selection and row assembly (the JAX package's
    _contact_rows_ref, flybody_tpu/physics/solver.py). Returns con_J
    (B, k, 3, nv) and 19 (B, k) rows: dist, active, frictional, mu, D,
    aref(3), pos(3), normal(3), body1, body2, self, break, slot id."""
    bsel, usel, gsel = select(cand_b, cand_u, cand_g, k)
    frame = frame_rows(bsel)
    b1, b2 = body_ids(usel)
    mask = model.body_dof_mask
    w = mask[b2] - mask[b1]  # (B, k, nv)
    arm = bsel[..., 1:4] - data.subtree_com[:, tree_root(model.meta)][
        :, None, :]
    gkr = torch.cat([cross(arm[..., None, :], frame), frame], -1)
    con_J = torch.einsum('bkrx,bvx->bkrv', gkr, data.cdof) * w[..., None, :]

    limb = limb_of_body(model)
    l1, l2 = limb[b1], limb[b2]
    c_break = ((torch.abs(l1 - l2) > 0.5) & (l1 > -0.5)
               & (l2 > -0.5)).to(bsel.dtype)
    return con_J, row_scalars(bsel, usel, gsel, con_J, c_break, data.qvel)


def tree_root(meta) -> int:
    """The root body of the one kinematic tree that holds every dof."""
    root = np.array(meta.body_rootid)
    roots = np.unique(root[np.array(meta.dof_bodyid)])
    if len(roots) != 1:
        raise NotImplementedError('contact rows: single kinematic tree only')
    return int(roots[0])


def limb_of_body(model):
    """Each body's arrow limb, as a float (-1 outside the limbs)."""
    part = _ar.build_partition(model.meta)
    return model.const('limb_of_body',
                       lambda: np.array(part.limb_of_body, np.float64))


def mask_bits(model):
    """body_dof_mask as the kernel takes it: (nbody, ceil(nv / 64)) int64
    words, bit v % 64 of word v // 64 set where dof v moves the body. The
    mask holds only 0 and 1 (a dof is in a body's chain or not); the
    kernel refuses any other mask."""
    def build():
        m = np.asarray(model.np_arrays['body_dof_mask'])
        if not np.isin(m, (0.0, 1.0)).all():
            raise ValueError('contact_rows: the kernel takes a body_dof_mask '
                             'of zeros and ones')
        nb, nv = m.shape
        bits = np.zeros((nb, (nv + 63) // 64), np.uint64)
        for v in range(nv):
            bits[:, v // 64] |= (m[:, v] == 1.0).astype(np.uint64) << \
                np.uint64(v % 64)
        return bits.view(np.int64)
    return model.const('body_dof_mask_bits', build)


def contact_rows(model, data, cand_b, cand_u, cand_g, k):
    """Kernel 7 on CUDA tensors, `contact_rows_ref` on CPU tensors."""
    if cand_b.device.type == 'cpu':
        return contact_rows_ref(model, data, cand_b, cand_u, cand_g, k)
    global launches
    meta = model.meta
    B, C = cand_b.shape[:2]
    nv, nb = meta.nv, meta.nbody
    com = data.subtree_com[:, tree_root(meta)].contiguous()
    mask, limb = mask_bits(model), limb_of_body(model)
    for t, shape, name in ((cand_b, (B, C, 7), 'cand_b'),
                           (cand_u, (B, C, 14), 'cand_u'),
                           (cand_g, (B, C), 'cand_g'),
                           (data.qvel, (B, nv), 'qvel'),
                           (data.cdof, (B, nv, 6), 'cdof'),
                           (com, (B, 3), 'subtree_com[root]'),
                           (limb, (nb,), 'limb_of_body')):
        _cuda.check(t, shape, name)
    _cuda.check(mask, (nb, (nv + 63) // 64), 'body_dof_mask bits',
                torch.int64)
    if not 0 < k <= C:
        raise ValueError(f'contact_rows: k = {k} of {C} candidates')
    con_J = torch.empty((B, k, 3, nv), dtype=torch.float32,
                        device=cand_b.device)
    scal = torch.empty((NROWS, B, k), dtype=torch.float32,
                       device=cand_b.device)
    V, I = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function('efc_stage', 'efc_contacts_f32',
                        [V] * 10 + [I] * 5 + [V])
    rc = fn(cand_b.data_ptr(), cand_u.data_ptr(), cand_g.data_ptr(),
            data.qvel.data_ptr(), data.cdof.data_ptr(), com.data_ptr(),
            mask.data_ptr(), limb.data_ptr(), con_J.data_ptr(),
            scal.data_ptr(), B, C, k, nv, nb, _cuda.stream())
    _cuda.raise_on(rc, 'efc_contacts_f32')
    launches += 1
    return con_J, list(scal.unbind(0))


def record_phases(fn, batch: int, stride: int, device):
    """Runs fn() (contact_rows launches on `batch` envs) with the kernel's
    phase clocks on: every stride-th env's cycles in each phase of PHASES,
    an int64 tensor (ceil(batch / stride), len(PHASES)) on the CPU."""
    return _cuda.record_phases('efc_stage', 'efc_contacts_phase_clock',
                               len(PHASES), fn, batch, stride, device)


def kernel_info(batch: int, C: int, k: int, meta) -> dict:
    """Registers a thread, shared memory a block, blocks an SM (the
    occupancy calculator) and grid blocks of the kernel for C candidates,
    k slots and the model's dofs and bodies at this batch."""
    out = (ctypes.c_int * 4)()
    I = ctypes.c_int
    fn = _cuda.function('efc_stage', 'efc_contacts_info',
                        [I] * 5 + [ctypes.POINTER(ctypes.c_int * 4)])
    _cuda.raise_on(fn(batch, C, k, meta.nv, meta.nbody, ctypes.byref(out)),
                   'efc_contacts_info')
    return _cuda.info_dict(out)
