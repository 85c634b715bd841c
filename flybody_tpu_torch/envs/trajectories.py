"""Reference-trajectory stores: synthetic walking trajectories.

Counterpart of the parts of flybody_tpu/envs/trajectories.py that the
inference-mode walking task needs: the padded store shared by all envs and
the synthetic constant-speed trajectory.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flybody_tpu_torch.utils import device as _device


def _np_quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def constant_speed_trajectory(n_steps: int, speed: float,
                              yaw_speed: float = 0.0,
                              init_pos=(0, 0, 0.1278),
                              init_heading: float = 0.0,
                              body_rot_angle_y: float = 0.0,
                              body_rot_angle_x: float = 0.0,
                              control_timestep: float = 0.002):
    """Synthetic straight/turning root trajectory: (qpos (T, 7),
    qvel (T, 6))."""
    qpos = np.zeros((n_steps, 7))
    qvel = np.zeros((n_steps, 6))
    qpos[0, :3] = init_pos
    qpos[:, 2] = init_pos[2]
    ya = np.deg2rad(body_rot_angle_y)
    xa = np.deg2rad(body_rot_angle_x)
    q = np.array([np.cos(ya / 2), 0.0, np.sin(ya / 2), 0.0])
    q = _np_quat_mul(np.array([np.cos(xa / 2), np.sin(xa / 2), 0.0, 0.0]), q)
    dq_h = np.array([np.cos(init_heading / 2), 0, 0,
                     np.sin(init_heading / 2)])
    qpos[0, 3:] = _np_quat_mul(dq_h, q)
    qvel[0, :2] = speed * np.array([np.cos(init_heading),
                                    np.sin(init_heading)])
    dtheta = yaw_speed * control_timestep
    dquat = np.array([np.cos(dtheta / 2), 0, 0, np.sin(dtheta / 2)])
    sin_half = np.linalg.norm(dquat[1:])
    angle = 2 * np.arctan2(sin_half, dquat[0])
    axis = (dquat[1:] / sin_half) if sin_half > 1e-12 else np.zeros(3)
    qvel[:, 3:] = axis * angle
    M = np.array([[np.cos(dtheta), -np.sin(dtheta)],
                  [np.sin(dtheta), np.cos(dtheta)]])
    for i in range(1, n_steps):
        qvel[i, :2] = M @ qvel[i - 1, :2]
        qpos[i, :2] = qpos[i - 1, :2] + qvel[i, :2] * control_timestep
        qpos[i, 3:] = _np_quat_mul(dquat, qpos[i - 1, 3:])
    return qpos, qvel


@dataclasses.dataclass
class TrajectoryStore:
    """Padded trajectory bank on the device."""

    qpos: torch.Tensor  # (N, T, 7+)
    qvel: torch.Tensor  # (N, T, 6+)
    lengths: torch.Tensor  # (N,) int64
    root2site: torch.Tensor | None = None  # (N, T, S, 3)
    joint_quat: torch.Tensor | None = None  # (N, T, J, 4)

    @property
    def num_trajectories(self) -> int:
        return self.qpos.shape[0]


def store_from_arrays(qpos_list, qvel_list, extras=None, device=None,
                      dtype=torch.float64) -> TrajectoryStore:
    """Pads trajectories with their final frame into one store, on CUDA
    unless `device` says otherwise."""
    device = _device.resolve(device)
    n = len(qpos_list)
    tmax = max(q.shape[0] for q in qpos_list)
    qpos = np.zeros((n, tmax, qpos_list[0].shape[1]))
    qvel = np.zeros((n, tmax, qvel_list[0].shape[1]))
    lengths = np.zeros(n, np.int64)
    for i, (qp, qv) in enumerate(zip(qpos_list, qvel_list)):
        L = qp.shape[0]
        qpos[i, :L] = qp
        qpos[i, L:] = qp[-1]
        qvel[i, :L] = qv
        lengths[i] = L
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    kw = {}
    for key, arrs in (extras or {}).items():
        buf = np.zeros((n, tmax) + arrs[0].shape[1:])
        for i, a in enumerate(arrs):
            buf[i, :a.shape[0]] = a
            buf[i, a.shape[0]:] = a[-1]
        kw[key] = t(buf)
    return TrajectoryStore(qpos=t(qpos), qvel=t(qvel),
                           lengths=torch.as_tensor(lengths, device=device),
                           **kw)


def inference_walking_store(device=None,
                            dtype=torch.float64) -> TrajectoryStore:
    """Synthetic straight walk at 2 cm/s, 300 control steps, on CUDA
    unless `device` says otherwise."""
    qpos, qvel = constant_speed_trajectory(
        n_steps=300, speed=2, init_pos=(0, 0, 0.1278), control_timestep=2e-3)
    return store_from_arrays([qpos], [qvel], device=device, dtype=dtype)
