"""Batched quaternion library (PyTorch), scalar-first (w, x, y, z).

Counterpart of flybody_tpu/utils/quaternions.py; every function takes
arbitrary leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def mult_quat(a, b):
    """Hamilton product a*b, broadcasting over leading dims."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def conj_quat(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def reciprocal_quat(q):
    return conj_quat(q) / torch.clamp(
        torch.sum(q * q, dim=-1, keepdim=True), min=_EPS)


def norm_quat(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def rotate_vec_with_quat(vec, quat):
    """R(quat) @ vec, expanded Rodrigues form (scale-invariant in quat)."""
    w = quat[..., :1]
    u = quat[..., 1:]
    s = torch.sum(quat * quat, dim=-1, keepdim=True)
    u, vec = torch.broadcast_tensors(u, vec)
    uv = torch.linalg.cross(u, vec)
    return (vec * (s - 2.0 * torch.sum(u * u, dim=-1, keepdim=True))
            + 2.0 * u * torch.sum(u * vec, dim=-1, keepdim=True)
            + 2.0 * w * uv) / torch.clamp(s, min=_EPS)


def rotate_vec_inv_quat(vec, quat):
    return rotate_vec_with_quat(vec, conj_quat(quat))


def quat_to_mat(q):
    """Unit quaternion -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis, angle):
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None],
                      torch.sin(half)[..., None] * axis], dim=-1)


def quat_dist_short_arc(a, b):
    """Short-arc geodesic angle between unit quaternions, in [0, pi]."""
    dot = torch.sum(a * b, dim=-1)
    prod = torch.sqrt(torch.clamp(
        torch.sum(a * a, dim=-1) * torch.sum(b * b, dim=-1), min=_EPS))
    return 2.0 * torch.arccos(torch.clamp(torch.abs(dot) / prod, -1.0, 1.0))


def get_dquat_local(quat_from, quat_to):
    """Rotation from quat_from to quat_to in quat_from's local frame."""
    return mult_quat(conj_quat(quat_from), quat_to)


def get_egocentric_vec(root_pos, vec_world, root_quat):
    return rotate_vec_inv_quat(vec_world - root_pos, root_quat)


def integrate_quat(q, angvel_local, dt):
    """q' = q * exp(omega_local * dt / 2), renormalized (mj_integratePos)."""
    norm = torch.sqrt(torch.sum(angvel_local * angvel_local, dim=-1,
                                keepdim=True) + _EPS * _EPS)
    angle = norm * dt
    axis = angvel_local / norm
    dq = torch.cat([torch.cos(0.5 * angle), axis * torch.sin(0.5 * angle)],
                   dim=-1)
    return norm_quat(mult_quat(q, dq))


def joint_orientation_quat(xaxis, qpos):
    return axis_angle_to_quat(xaxis, qpos)
