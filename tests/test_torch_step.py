"""The slice end to end: one batched walk_imitation control step of
flybody_tpu_torch against the JAX package, from a carried-across state.

A JAX `vmap(env.reset)` state at batch 2 is carried into the port with
`data_from_numpy`; both sides then take one control step (10 physics
substeps at the default preset: 10 Newton iterations, 8 line-search steps,
64 contact slots, refactor 1, noslip on all slots) with the same seeded
actions, at float64 on the CPU. Tolerance: max |port - jax| <= 1e-6 *
max |jax| per state field and observation (measured agreement is ~1e-13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.envs import trajectories as jtraj
from flybody_tpu.envs.walk_imitation import WalkImitationEnv as JaxWalk
from flybody_tpu.model import spec as jspec
from flybody_tpu_torch.envs import fly_envs as tfe
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.physics.state import data_from_numpy

B = 2
TOL = 1e-6
FIELDS = ('qpos', 'qvel', 'act', 'qacc', 'time')
EXTRA = ('thorax_height', 'abdomen_height', 'world_zaxis_abdomen',
         'world_zaxis_head', 'prev_action', 'self_contact')


@pytest.fixture(scope='module')
def run():
    # The JAX factory's env, on the same compiled model the port ships
    # (tests/test_torch_model.py holds the asset equal to
    # fly_envs._walking_model()).
    jenv = JaxWalk(jspec.load(tspec.WALK_IMITATION_NPZ),
                   jtraj.inference_walking_store(), inference_mode=True,
                   time_limit=10.0, extra_observables=EXTRA)
    tenv = tfe.walk_imitation(device='cpu', dtype=torch.float64,
                              extra_observables=EXTRA)
    js, jts = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(0), B))
    rng = np.random.RandomState(1)
    lo, hi = tenv.action_min, tenv.action_max
    act = lo + (hi - lo) * rng.rand(B, len(lo))
    js2, jts2 = jax.jit(jax.vmap(jenv.step))(js, jnp.asarray(act))

    ts, tts = tenv.reset(B)
    d = js.data
    ts = ts.replace(data=data_from_numpy(
        tenv.model, **{f: np.asarray(getattr(d, f)) for f in
                       FIELDS + ('ctrl',)}))
    ts2, tts2 = tenv.step(ts, torch.as_tensor(act))
    return dict(jts=jts, tts=tts, js2=js2, jts2=jts2, ts2=ts2, tts2=tts2,
                tenv=tenv)


def _close(out, ref, what):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(out - ref).max())
    assert err <= TOL * scale, f'{what}: max err {err:.3e}, scale {scale:.3e}'


OBS = tfe.WALK_IMITATION_OBS + ['walker/' + n for n in EXTRA]


@pytest.mark.parametrize('key', OBS)
def test_reset_observation(run, key):
    _close(run['tts'].observation[key], run['jts'].observation[key], key)


@pytest.mark.parametrize('field', FIELDS)
def test_step_state(run, field):
    _close(getattr(run['ts2'].data, field), getattr(run['js2'].data, field),
           field)


@pytest.mark.parametrize('key', OBS)
def test_step_observation(run, key):
    _close(run['tts2'].observation[key], run['jts2'].observation[key], key)


def test_step_reward_discount_type(run):
    for f in ('reward', 'discount', 'step_type'):
        np.testing.assert_array_equal(
            np.asarray(getattr(run['tts2'], f)),
            np.asarray(getattr(run['jts2'], f)), err_msg=f)
    assert set(run['tts2'].observation) == set(OBS)
    np.testing.assert_array_equal(run['ts2'].step_idx.numpy(),
                                  np.asarray(run['js2'].step_idx))


def test_deep_mimic_reward_factors_match_jax():
    """The dataset-driven reward path (unused in inference mode) on
    seeded features: walker features, the four DeepMimic factors and the
    linear tolerance."""
    from flybody_tpu.envs import rewards as jr
    from flybody_tpu_torch.envs import rewards as tr
    rng = np.random.RandomState(3)
    J, S = 5, 4
    qpos = rng.randn(B, 7 + J)
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    qvel = rng.randn(B, 6 + J)
    sites, axes = rng.randn(B, S, 3), rng.randn(B, J, 3)
    ref_q = rng.randn(B, 7 + J)
    ref_q[:, 3:7] /= np.linalg.norm(ref_q[:, 3:7], axis=1, keepdims=True)
    ref_v, ref_r2s = rng.randn(B, 6 + J), rng.randn(B, S, 3)
    ref_jq = rng.randn(B, J, 4)
    jf = [jr.reward_factors_deep_mimic(
        jr.walker_features(qpos[b], qvel[b], sites[b], axes[b],
                           qpos[b, 7:]),
        jr.reference_features(ref_q[b], ref_v[b], ref_r2s[b], ref_jq[b]),
        weights=(20.0, 1.0, 1.0, 1.0)) for b in range(B)]
    t = torch.as_tensor
    tf = tr.reward_factors_deep_mimic(
        tr.walker_features(t(qpos), t(qvel), t(sites), t(axes),
                           t(qpos[:, 7:])),
        tr.reference_features(t(ref_q), t(ref_v), t(ref_r2s), t(ref_jq)),
        weights=(20.0, 1.0, 1.0, 1.0))
    _close(tf, np.stack([np.asarray(f) for f in jf]), 'factors')
    x = rng.randn(B, 9) * 4.0
    _close(tr.tolerance_linear(t(x), 3.0),
           np.asarray(jr.tolerance_linear(jnp.asarray(x), margin=3.0)),
           'tolerance')
