"""Reward machinery: dm_control-style tolerance and DeepMimic factors.

Counterpart of flybody_tpu/envs/rewards.py, batched over a leading env
dimension.
"""

from __future__ import annotations

import torch

from flybody_tpu_torch.utils import quaternions as quat

DEEP_MIMIC_STD = {
    'com': 0.078487,
    'qvel': 53.7801,
    'root2site': 0.0735,
    'joint_quat': 1.2247,
}


def tolerance_linear(x, margin, value_at_margin=0.0):
    """rewards.tolerance with bounds=(0, 0), sigmoid='linear'."""
    d = torch.abs(x) / margin
    value = 1.0 - (1.0 - value_at_margin) * d
    return torch.where(d < 1.0, value, torch.zeros_like(value))


def walker_features(qpos, qvel, site_xpos, joint_xaxis, joint_qpos):
    """Pose features (B, ...): root + mocap joint qpos/qvel, mocap site
    positions (B, S, 3), mocap joint world axes (B, J, 3) and angles."""
    root_pos, root_quat = qpos[:, :3], qpos[:, 3:7]
    root2site = quat.get_egocentric_vec(root_pos[:, None], site_xpos,
                                        root_quat[:, None])
    xaxis1 = quat.rotate_vec_with_quat(
        joint_xaxis, quat.reciprocal_quat(root_quat)[:, None])
    joint_quat = quat.joint_orientation_quat(xaxis1, joint_qpos)
    return {'com': root_pos, 'qvel': qvel, 'root2site': root2site,
            'joint_quat': torch.cat([root_quat[:, None], joint_quat], 1)}


def reference_features(ref_qpos, ref_qvel, ref_root2site, ref_joint_quat):
    return {'com': ref_qpos[:, :3], 'qvel': ref_qvel,
            'root2site': ref_root2site,
            'joint_quat': torch.cat([ref_qpos[:, None, 3:7], ref_joint_quat],
                                    1)}


def reward_factors_deep_mimic(walker_f, reference_f, std=None,
                              weights=(1.0, 1.0, 1.0, 1.0)):
    """The four DeepMimic factors, (B, 4)."""
    std = std or DEEP_MIMIC_STD
    factors = []
    for k, w in zip(('com', 'qvel', 'root2site', 'joint_quat'), weights):
        if 'quat' in k:
            diff = torch.sum(quat.quat_dist_short_arc(walker_f[k],
                                                      reference_f[k]) ** 2,
                             -1)
        else:
            diff = torch.sum(
                (torch.abs(walker_f[k] - reference_f[k]) ** 2).flatten(1), -1)
        factors.append(w * torch.exp(-0.5 / std[k] ** 2 * diff))
    return torch.stack(factors, -1)
