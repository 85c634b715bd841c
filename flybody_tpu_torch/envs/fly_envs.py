"""Environment factories (counterpart of flybody_tpu/envs/fly_envs.py).

This slice ports the inference-mode walking task: `walk_imitation(
functional=True)` with the shipped walking model
(model/assets/walk_imitation.npz, the JAX package's
`fly_envs._walking_model()` at its defaults) and the synthetic reference
trajectory. The dm_env adapter, the dataset-driven mode and the other
tasks are not ported yet.
"""

from __future__ import annotations

import torch

from flybody_tpu_torch.envs import trajectories as traj_lib
from flybody_tpu_torch.envs.walk_imitation import WalkImitationEnv
from flybody_tpu_torch.model import spec

WALK_OBS = ['walker/' + s for s in
            ('accelerometer', 'actuator_activation', 'appendages_pos',
             'force', 'gyro', 'joints_pos', 'joints_vel', 'touch',
             'velocimeter', 'world_zaxis')]
WALK_IMITATION_OBS = WALK_OBS + ['walker/ref_displacement',
                                 'walker/ref_root_quat']


def walk_imitation(functional: bool = True, preset: str = 'default',
                   device=None, dtype: torch.dtype = torch.float32,
                   terminal_com_dist: float = 0.3, future_steps: int = 64,
                   **env_kwargs) -> WalkImitationEnv:
    """Batched walking imitation on the synthetic trajectory. Runs on CUDA
    unless `device` says otherwise; float32 by default. `preset` names the
    solver setting (physics/engine.py PRESETS: 'default' or 'bench')."""
    if not functional:
        raise NotImplementedError('the dm_env adapter is not ported yet; '
                                  'use functional=True')
    model = spec.load(spec.WALK_IMITATION_NPZ, device=device, dtype=dtype)
    store = traj_lib.inference_walking_store(device=model.device,
                                             dtype=dtype)
    return WalkImitationEnv(model, store, terminal_com_dist=terminal_com_dist,
                            future_steps=future_steps, inference_mode=True,
                            time_limit=10.0, preset=preset, **env_kwargs)
