"""Batched environment core (counterpart of flybody_tpu/envs/base.py).

`reset(batch, generator) -> (EnvState, TimeStep)` and
`step(state, action) -> (EnvState, TimeStep)` act on B envs at once (the
batch is a leading dimension; the JAX package's vmap and custom_vmap
substep core have no counterpart here). A control step runs n_sub physics
substeps and averages the sensors over them, with the fly self-contact
force sum riding as one extra trailing sensor channel; observables are
evaluated on a fresh position-stage pass of the post-step state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from flybody_tpu_torch.envs import walker as walker_lib
from flybody_tpu_torch.model.spec import FlyModel
from flybody_tpu_torch.physics import engine
from flybody_tpu_torch.physics import kinematics as kin
from flybody_tpu_torch.physics.state import Data, make_data
from flybody_tpu_torch.utils import quaternions as quat

FIRST, MID, LAST = 0, 1, 2

PRESETS = engine.PRESETS  # the named solver settings

TERMINAL_QACC = 1e14
TERMINAL_LINVEL = 50.0
TERMINAL_ANGVEL = 200.0


def exceeds(x, thresh):
    """NaN-safe x > thresh: also True when x is not finite."""
    return ~(x <= thresh)


def below(x, thresh):
    """NaN-safe x < thresh: also True when x is not finite."""
    return ~(x >= thresh)


@dataclasses.dataclass
class TimeStep:
    step_type: torch.Tensor  # (B,) int64
    reward: torch.Tensor  # (B,)
    discount: torch.Tensor  # (B,)
    observation: dict


@dataclasses.dataclass
class EnvState:
    data: Data
    step_idx: torch.Tensor  # (B,) int64, control steps this episode
    prev_action: torch.Tensor  # (B, num_actions)
    task: Any = None

    def replace(self, **kw) -> 'EnvState':
        return dataclasses.replace(self, **kw)


class FruitFlyEnv:
    """Base class; tasks override the hooks."""

    def __init__(self, model: FlyModel, num_user_actions: int = 0,
                 control_timestep: float = 2e-3,
                 physics_timestep: float = 1e-4,
                 time_limit: float = 1.0,
                 preset: str = 'default',
                 extra_observables=()):
        self.model = model
        self.tables = walker_lib.build_tables(model.meta, num_user_actions)
        self.action_min, self.action_max = walker_lib.action_bounds(
            model, self.tables)
        self.n_sub = int(round(control_timestep / physics_timestep))
        self.control_timestep = control_timestep
        self.physics_timestep = physics_timestep
        self.time_limit = time_limit
        self.max_steps = int(round(time_limit / control_timestep))
        if preset not in PRESETS:
            raise KeyError(f'unknown solver preset {preset!r}; one of '
                           f'{sorted(PRESETS)}')
        self.preset = PRESETS[preset]
        self.extra_observables = tuple(extra_observables)

    # ---------------------------------------------------------------- hooks

    def _init_task(self, batch: int, generator) -> Any:
        return None

    def _init_qpos_qvel_act(self, task, batch: int):
        d = make_data(self.model, batch)
        return d.qpos, d.qvel, d.act

    def _before_step(self, state: EnvState, action):
        return state.task, action

    def _reward_factors(self, state: EnvState, fkd: Data):
        return fkd.qpos.new_ones((fkd.qpos.shape[0], 1))

    def _check_termination(self, state: EnvState, fkd: Data, obs):
        qacc_huge = exceeds(torch.linalg.norm(state.data.qacc, dim=-1),
                            TERMINAL_QACC)
        return qacc_huge, torch.zeros_like(qacc_huge)

    def _observations(self, state: EnvState, fkd: Data, sensors_mean):
        return {}

    # ------------------------------------------------------------- plumbing

    def action_to_ctrl(self, action):
        S = self.model.const('walker_scatter', lambda: self.tables.scatter)
        return action @ S.T

    def _substeps(self, data: Data, ctrl):
        """n_sub physics substeps; returns (data, substep-mean sensors)."""
        data = data.replace(ctrl=ctrl)
        total = None
        for _ in range(self.n_sub):
            out = engine.step(self.model, data, self.preset)
            sens = torch.cat([out.sensordata,
                              out.self_contact_force[:, None]], -1)
            total = sens if total is None else total + sens
            data = out.strip()
        return data, total / self.n_sub

    def _fk(self, data: Data) -> Data:
        fkd, ja, jx = kin.fwd_position_smooth(self.model, data)
        return fkd.replace(jnt_xanchor=ja, jnt_xaxis=jx)

    # -------------------------------------------------------------- obs lib

    def _obs_vestibular(self, fkd: Data, sensors_mean):
        tb = self.tables
        obs = {}
        for name in ('accelerometer', 'gyro', 'velocimeter'):
            adr, dim = tb.vest_adr[name]
            obs[f'walker/{name}'] = sensors_mean[:, adr:adr + dim]
        obs['walker/world_zaxis'] = fkd.xmat[:, tb.thorax_body, 2, :]
        return obs

    def _obs_proprioception(self, state: EnvState, fkd: Data):
        tb = self.tables
        return {
            'walker/joints_pos': fkd.qpos[:, tb.joints_qpos_idx],
            'walker/joints_vel': state.data.qvel[:, tb.joints_dof_idx],
            'walker/actuator_activation': state.data.act,
        }

    def _obs_appendages(self, fkd: Data):
        tb = self.tables
        sites = fkd.site_xpos[:, tb.appendage_sites]
        torso_pos = fkd.xpos[:, tb.thorax_body]
        torso_mat = fkd.xmat[:, tb.thorax_body]
        rel = torch.einsum('bsi,bij->bsj', sites - torso_pos[:, None],
                           torso_mat)
        return {'walker/appendages_pos': rel.flatten(1)}

    def _obs_force_touch(self, sensors_mean):
        tb = self.tables
        return {'walker/force': sensors_mean[:, tb.force_adr],
                'walker/touch': sensors_mean[:, tb.touch_adr]}

    def _extra_observables(self, state: EnvState, fkd: Data, sensors_mean,
                           names):
        tb = self.tables
        obs = {}
        for name in names:
            key = f'walker/{name}'
            if name == 'thorax_height':
                obs[key] = fkd.xpos[:, tb.thorax_body, 2]
            elif name == 'abdomen_height':
                obs[key] = fkd.xpos[:, tb.abdomen_body, 2]
            elif name == 'world_zaxis_abdomen':
                obs[key] = fkd.xmat[:, tb.abdomen_body, 2, :]
            elif name == 'world_zaxis_head':
                obs[key] = fkd.xmat[:, tb.head_body, 2, :]
            elif name == 'prev_action':
                obs[key] = state.prev_action
            elif name == 'self_contact':
                obs[key] = sensors_mean[:, -1]
            else:
                raise KeyError(f'unknown extra observable {name}')
        return obs

    def _obs_ref(self, fkd: Data, ref_qpos_window):
        """ref_displacement / ref_root_quat with future preview."""
        fly_pos = fkd.qpos[:, None, :3]
        fly_quat = fkd.qpos[:, None, 3:7]
        disp = quat.rotate_vec_inv_quat(ref_qpos_window[..., :3] - fly_pos,
                                        fly_quat)
        dquat = quat.get_dquat_local(fly_quat, ref_qpos_window[..., 3:7])
        return {'walker/ref_displacement': disp,
                'walker/ref_root_quat': dquat}

    # ----------------------------------------------------------- public API

    def reset(self, batch: int, generator: torch.Generator | None = None
              ) -> tuple[EnvState, TimeStep]:
        """B fresh episodes; `generator` (CPU) draws the task samples."""
        model = self.model
        dt, dev = model.dtype, model.device
        task = self._init_task(batch, generator)
        qpos, qvel, act = self._init_qpos_qvel_act(task, batch)
        data = make_data(model, batch).replace(
            qpos=qpos, qvel=qvel, act=act,
            qacc=torch.zeros((batch, model.meta.nv), dtype=dt, device=dev))
        state = EnvState(
            data=data,
            step_idx=torch.zeros((batch,), dtype=torch.int64, device=dev),
            prev_action=torch.zeros((batch, self.tables.num_actions),
                                    dtype=dt, device=dev),
            task=task)
        fkd = self._fk(data)
        zeros = torch.zeros((batch, model.meta.nsensordata + 1), dtype=dt,
                            device=dev)
        obs = self._observations(state, fkd, zeros)
        ts = TimeStep(
            step_type=torch.full((batch,), FIRST, dtype=torch.int64,
                                 device=dev),
            reward=torch.zeros((batch,), dtype=dt, device=dev),
            discount=torch.ones((batch,), dtype=dt, device=dev),
            observation=obs)
        return state, ts

    def step(self, state: EnvState, action) -> tuple[EnvState, TimeStep]:
        action = torch.as_tensor(action, dtype=self.model.dtype,
                                 device=self.model.device)
        task, mj_action = self._before_step(state, action)
        state = state.replace(task=task, prev_action=action)
        data, sensors_mean = self._substeps(state.data,
                                            self.action_to_ctrl(mj_action))
        state = state.replace(data=data, step_idx=state.step_idx + 1)
        fkd = self._fk(data)
        obs = self._observations(state, fkd, sensors_mean)
        reward = torch.prod(self._reward_factors(state, fkd), -1)
        terminate, good_end = self._check_termination(state, fkd, obs)
        last = terminate | (state.step_idx >= self.max_steps)
        fatal = terminate & ~good_end
        ts = TimeStep(
            step_type=torch.where(last, LAST, MID),
            reward=reward,
            discount=torch.where(fatal, 0.0, 1.0).to(reward.dtype),
            observation=obs)
        return state, ts
