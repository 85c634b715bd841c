"""Walking imitation task (DeepMimic-style tracking of a reference).

Counterpart of flybody_tpu/envs/walk_imitation.py, batched: episodes reset
the fly to the reference's root pose, track it, scrub NaN actions, reward
Gaussian factors on (com, qvel, root2site, joint_quat) with a wing
retraction factor (constant 1 in inference mode), and terminate on speed
limits, CoM divergence, trajectory end or qacc explosion.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flybody_tpu_torch.envs import base as envbase
from flybody_tpu_torch.envs import rewards as rewards_lib
from flybody_tpu_torch.envs import trajectories as traj_lib
from flybody_tpu_torch.model.spec import FlyModel


@dataclasses.dataclass
class WalkTask:
    traj_idx: torch.Tensor  # (B,) int64
    episode_steps: torch.Tensor  # (B,) int64


class WalkImitationEnv(envbase.FruitFlyEnv):

    def __init__(self, model: FlyModel, store: traj_lib.TrajectoryStore,
                 mocap_joint_names=(), mocap_site_names=(),
                 terminal_com_dist: float = 0.3,
                 future_steps: int = 64,
                 inference_mode: bool = False,
                 initialize_qvel: bool = False,
                 time_limit: float = 10.0,
                 **kwargs):
        super().__init__(model, num_user_actions=0,
                         control_timestep=2e-3, physics_timestep=2e-4,
                         time_limit=time_limit, **kwargs)
        self.store = store
        self.terminal_com_dist = terminal_com_dist
        self.future_steps = future_steps
        self.inference_mode = inference_mode
        self.initialize_qvel = initialize_qvel
        meta = model.meta
        jid = [meta.jnt_names.index(n) for n in mocap_joint_names]
        self._mocap_jnt = np.array(jid, np.int64)
        self._mocap_qpos = np.array([meta.jnt_qposadr[j] for j in jid],
                                    np.int64)
        self._mocap_dof = np.array([meta.jnt_dofadr[j] for j in jid],
                                   np.int64)
        self._mocap_sites = np.array(
            [meta.site_names.index(n) for n in mocap_site_names], np.int64)

    def _init_task(self, batch, generator) -> WalkTask:
        n = self.store.num_trajectories
        idx = torch.randint(0, n, (batch,), generator=generator).to(
            self.model.device)
        snippet = self.store.lengths[idx] - self.future_steps - 1
        return WalkTask(traj_idx=idx,
                        episode_steps=torch.clamp(snippet,
                                                  max=self.max_steps + 1))

    def _ref(self, table, task: WalkTask, step, count: int):
        """table[traj, start:start+count] with the start clamped so the
        window fits (lax.dynamic_slice semantics)."""
        T = table.shape[1]
        start = torch.clamp(step, 0, T - count)
        t = start[:, None] + torch.arange(count, device=start.device)
        return table[task.traj_idx[:, None], t]

    def _init_qpos_qvel_act(self, task: WalkTask, batch):
        model = self.model
        ref0 = self.store.qpos[task.traj_idx, 0]
        qpos = model.qpos0.expand(batch, -1).clone()
        qpos[:, :7] = ref0[:, :7]
        if len(self._mocap_qpos):
            qpos[:, self._mocap_qpos] = ref0[:, 7:]
        qvel = qpos.new_zeros((batch, model.meta.nv))
        if self.initialize_qvel:
            refv = self.store.qvel[task.traj_idx, 0]
            qvel[:, :6] = refv[:, :6]
            if len(self._mocap_dof):
                qvel[:, self._mocap_dof] = refv[:, 6:]
        wing = self.tables.wing_qpos_idx
        if len(wing):
            qpos[:, wing] = model.qpos_spring[wing]
        return qpos, qvel, qpos.new_zeros((batch, model.meta.na))

    def _before_step(self, state, action):
        return state.task, torch.nan_to_num(action, nan=0.0)

    def _observations(self, state, fkd, sensors_mean):
        obs = {}
        obs.update(self._obs_vestibular(fkd, sensors_mean))
        obs.update(self._obs_proprioception(state, fkd))
        obs.update(self._obs_appendages(fkd))
        obs.update(self._obs_force_touch(sensors_mean))
        window = self._ref(self.store.qpos, state.task, state.step_idx,
                           self.future_steps + 1)[..., :7]
        obs.update(self._obs_ref(fkd, window))
        obs.update(self._extra_observables(state, fkd, sensors_mean,
                                           self.extra_observables))
        return obs

    def _reward_factors(self, state, fkd):
        B = fkd.qpos.shape[0]
        if self.inference_mode:
            return fkd.qpos.new_ones((B, 1))
        task, step = state.task, state.step_idx
        ref_qpos = self._ref(self.store.qpos, task, step, 1)[:, 0]
        ref_qvel = self._ref(self.store.qvel, task, step, 1)[:, 0]
        ref_r2s = self.store.root2site[task.traj_idx, step]
        ref_jq = self.store.joint_quat[task.traj_idx, step]
        qpos = torch.cat([fkd.qpos[:, :7], fkd.qpos[:, self._mocap_qpos]], 1)
        qvel = torch.cat([state.data.qvel[:, :6],
                          state.data.qvel[:, self._mocap_dof]], 1)
        wf = rewards_lib.walker_features(
            qpos, qvel, fkd.site_xpos[:, self._mocap_sites],
            fkd.jnt_xaxis[:, self._mocap_jnt], fkd.qpos[:, self._mocap_qpos])
        rf = rewards_lib.reference_features(ref_qpos, ref_qvel, ref_r2s,
                                            ref_jq)
        factors = rewards_lib.reward_factors_deep_mimic(
            wf, rf, weights=(20.0, 1.0, 1.0, 1.0))
        wing = self.tables.wing_qpos_idx
        if len(wing):
            qdiff = fkd.qpos[:, wing] - self.model.qpos_spring[wing]
            retract = torch.prod(rewards_lib.tolerance_linear(qdiff, 3.0), -1)
            factors = torch.cat([factors, retract[:, None]], -1)
        return factors

    def _check_termination(self, state, fkd, obs):
        linvel = torch.linalg.norm(obs['walker/velocimeter'], dim=-1)
        angvel = torch.linalg.norm(obs['walker/gyro'], dim=-1)
        com_dist = torch.linalg.norm(obs['walker/ref_displacement'][:, 0],
                                     dim=-1)
        reached_end = state.step_idx >= state.task.episode_steps
        qacc_huge = envbase.exceeds(
            torch.linalg.norm(state.data.qacc, dim=-1), envbase.TERMINAL_QACC)
        terminate = (envbase.exceeds(linvel, envbase.TERMINAL_LINVEL)
                     | envbase.exceeds(angvel, envbase.TERMINAL_ANGVEL)
                     | reached_end
                     | envbase.exceeds(com_dist, self.terminal_com_dist)
                     | qacc_huge)
        return terminate, reached_end
