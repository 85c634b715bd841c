"""Spatial algebra, (angular; linear) ordering, batched over leading dims.

Counterpart of flybody_tpu/physics/math.py.
"""

from __future__ import annotations

import torch

from flybody_tpu_torch.utils.quaternions import mult_quat, rotate_vec_with_quat


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def compose_frame(pos1, quat1, pos2, quat2):
    """(p1, q1) o (p2, q2)."""
    return pos1 + rotate_vec_with_quat(pos2, quat1), mult_quat(quat1, quat2)


def skew(v):
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def motion_cross(v, m):
    w, u = v[..., :3], v[..., 3:]
    wm, um = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, wm), cross(w, um) + cross(u, wm)], dim=-1)


def force_cross(v, f):
    w, u = v[..., :3], v[..., 3:]
    fa, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, fa) + cross(u, fl), cross(w, fl)], dim=-1)


def spatial_inertia(mass, inertia_diag, imat, com_offset):
    """6x6 spatial inertia about a reference point (see the JAX docstring:
    r = body CoM - reference point, imat principal frame -> world)."""
    I_com = torch.sum(imat[..., :, None, :] * imat[..., None, :, :]
                      * inertia_diag[..., None, None, :], dim=-1)
    S = skew(com_offset)
    m = mass[..., None, None]
    rr = com_offset[..., :, None] * com_offset[..., None, :]
    r2 = torch.sum(com_offset * com_offset, dim=-1)[..., None, None]
    eye3 = torch.eye(3, dtype=I_com.dtype, device=I_com.device)
    top = torch.cat([I_com + m * (r2 * eye3 - rr), m * S], dim=-1)
    bottom = torch.cat([-m * S, m * eye3.expand_as(I_com)], dim=-1)
    return torch.cat([top, bottom], dim=-2)
