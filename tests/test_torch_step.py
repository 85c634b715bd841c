"""The slice end to end: one batched walk_imitation control step of
flybody_tpu_torch against the JAX package, from a carried-across state,
at both solver presets.

A JAX `vmap(env.reset)` state at batch 2 is carried into the port with
`data_from_numpy`; both sides then take one control step (10 physics
substeps) with the same seeded actions, at float64 on the CPU.
  * default preset: 10 Newton iterations, 8 line-search steps, 64 contact
    slots, refactor 1, noslip on all slots (the split Newton form);
  * bench preset: 8/6/24/refactor 8, noslip on 16 slots, broadphase
    top-P 32/16, Woodbury budget 4 (the whole-solve form). The JAX env
    takes train/run.py:165-180's settings, with the top-P widths and
    FLYBODY_SB_BREAK set in a MonkeyPatch context before the first trace,
    as run.py sets them at run time.
Tolerance: max |port - jax| <= 1e-6 * max |jax| per state field and
observation (measured agreement is ~1e-13 at the default preset).

At the bench preset the reference is not reproducible to that bound: its
exact line search returns the midpoint of the final bracket, and once the
guarded Newton probe lands on the root of phi' (phi is piecewise
quadratic, so it does within one step), the rounding sign of phi' there
decides which end of the bracket moves; a 1e-15 relative change of a_free
moves the JAX whole solve's qacc by ~1% at the reset state. So the bench
case runs both sides with the line search replaced by plain bisection
(`bisect_alpha_*`, 60 halvings after the same bracket doubling), whose
result is continuous in its inputs: the test then holds the rest of the
bench path (top-P 32/16 broadphase, 24 slots, the whole-solve assembly
with Woodbury budget 4, noslip on 16 slots) to 1e-6.
tests/test_torch_solver_kernels.py holds the line search itself against
the JAX one.
"""

import os

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


# train/run.py:165-180 (--bench-solver): the JAX env's solver settings.
BENCH_SOLVER = dict(solver_iterations=8, ls_iterations=6, ncon_max=24,
                    refactor_period=8, noslip_contacts=16)


HALVINGS = 60


def bisect_alpha_jax(lim, con, sc, expand_iters, ls_iters):
    """Plain bisection on phi' (the JAX line search's signature)."""
    from flybody_tpu.ops import linesearch as jls
    sm0, smm = sc[0, 0], sc[1, 0]

    def slope_at(a):
        return jls._slope_curv_ref(a, lim, con, sm0, smm)[0]

    def expand(_, hi):
        return jnp.where(slope_at(hi) < 0, hi * 2.0, hi)

    def halve(_, b):
        mid = 0.5 * (b[0] + b[1])
        neg = slope_at(mid) < 0
        return jnp.where(neg, mid, b[0]), jnp.where(neg, b[1], mid)

    hi = jax.lax.fori_loop(0, expand_iters, expand, jnp.ones_like(sm0))
    lo, hi = jax.lax.fori_loop(0, HALVINGS, halve, (0.0 * hi, hi))
    return jnp.where(slope_at(0.0 * hi) < 0, 0.5 * (lo + hi), 0.0 * hi)


def bisect_alpha_torch(lim, con, sm0, smm, expand_iters, ls_iters):
    """Plain bisection on phi' (the port's line search's signature)."""
    from flybody_tpu_torch.ops import linesearch as tls

    def slope_at(a):
        return tls.slope_curv(a, lim, con, sm0, smm)[0]

    hi = torch.ones_like(sm0)
    for _ in range(expand_iters):
        hi = torch.where(slope_at(hi) < 0, hi * 2.0, hi)
    lo = torch.zeros_like(hi)
    for _ in range(HALVINGS):
        mid = 0.5 * (lo + hi)
        neg = slope_at(mid) < 0
        lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
    return torch.where(slope_at(0.0 * hi) < 0, 0.5 * (lo + hi), 0.0 * hi)


def _run(preset):
    # The JAX factory's env, on the same compiled model the port ships
    # (tests/test_torch_model.py holds the asset equal to
    # fly_envs._walking_model()).
    from flybody_tpu.physics import collision as jcol
    jkw = BENCH_SOLVER if preset == 'bench' else {}
    jenv = JaxWalk(jspec.load(tspec.WALK_IMITATION_NPZ),
                   jtraj.inference_walking_store(), inference_mode=True,
                   time_limit=10.0, extra_observables=EXTRA, **jkw)
    tenv = tfe.walk_imitation(preset=preset, device='cpu',
                              dtype=torch.float64, extra_observables=EXTRA)
    rng = np.random.RandomState(1)
    lo, hi = tenv.action_min, tenv.action_max
    act = lo + (hi - lo) * rng.rand(B, len(lo))
    with pytest.MonkeyPatch.context() as mp:
        if preset == 'bench':
            mp.setattr(jcol, 'MPR_MERGED_TOP_P', 32)
            mp.setattr(jcol, 'CC_TOP_P', 16)
            mp.setenv('FLYBODY_SB_BREAK', '4')
        js, jts = jax.jit(jax.vmap(jenv.reset))(
            jax.random.split(jax.random.PRNGKey(0), B))
        if preset == 'bench':
            from flybody_tpu.ops import linesearch as jls
            mp.setattr(jls, 'alpha_ref', bisect_alpha_jax)
        js2, jts2 = jax.jit(jax.vmap(jenv.step))(js, jnp.asarray(act))

    ts, tts = tenv.reset(B)
    d = js.data
    ts = ts.replace(data=data_from_numpy(
        tenv.model, **{f: np.asarray(getattr(d, f)) for f in
                       FIELDS + ('ctrl',)}))
    with pytest.MonkeyPatch.context() as mp:
        if preset == 'bench':
            from flybody_tpu_torch.ops import linesearch as tls
            mp.setattr(tls, 'alpha_ref', bisect_alpha_torch)
        ts2, tts2 = tenv.step(ts, torch.as_tensor(act))
    return dict(jts=jts, tts=tts, js2=js2, jts2=jts2, ts2=ts2, tts2=tts2,
                tenv=tenv)


@pytest.fixture(scope='module')
def run():
    return _run('default')


@pytest.fixture(scope='module')
def run_bench():
    return _run('bench')


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


@pytest.mark.parametrize('field', FIELDS)
def test_bench_step_state(run_bench, field):
    r = run_bench
    _close(getattr(r['ts2'].data, field), getattr(r['js2'].data, field),
           field)


@pytest.mark.parametrize('key', OBS)
def test_bench_step_observation(run_bench, key):
    r = run_bench
    _close(r['tts2'].observation[key], r['jts2'].observation[key], key)


def test_bench_step_reward_discount_type(run_bench):
    test_step_reward_discount_type(run_bench)


def test_preset_table_pins_the_reference_settings():
    """The presets are the settings of envs/base.py:92-96 (with the
    broadphase and Woodbury defaults of physics/collision.py:620/683 and
    solver.py:778) and of bench.py:39-67 / train/run.py:165-180, both with
    the split Newton form (FLYBODY_NEWTON_BLOCK_FULL unset, solver.py:
    884-886); default_full is default with the block-full form."""
    from flybody_tpu_torch.physics.engine import PRESETS
    assert PRESETS['default'] == dict(
        solver_iterations=10, ls_iterations=8, ncon_max=64,
        refactor_period=1, noslip_contacts=None, mpr_top_p=128,
        cc_top_p=128, sb_break=8, newton_block_full=False)
    assert PRESETS['bench'] == dict(BENCH_SOLVER, mpr_top_p=32, cc_top_p=16,
                                    sb_break=4, newton_block_full=False)
    assert PRESETS['default_full'] == dict(PRESETS['default'],
                                           newton_block_full=True)
    assert sorted(PRESETS) == ['bench', 'default', 'default_full']
    import inspect
    from flybody_tpu.envs import base as jbase
    from flybody_tpu.physics import collision as jcol
    sig = inspect.signature(jbase.FruitFlyEnv.__init__).parameters
    for k in ('solver_iterations', 'ls_iterations', 'ncon_max',
              'refactor_period', 'noslip_contacts'):
        assert PRESETS['default'][k] == sig[k].default, k
    # The module constants as the JAX package reads them with no knob set.
    assert (jcol.MPR_MERGED_TOP_P, jcol.CC_TOP_P) == (128, 128)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, 'bench.py')) as f:
        bench = f.read()
    for setting in ("'FLYBODY_MPR_TOP_P', '32'", "'FLYBODY_CC_TOP_P', '16'",
                    "'FLYBODY_SB_BREAK', '4'", "'BENCH_NCON', 24",
                    "'BENCH_REFACTOR', 8", "'BENCH_NOSLIP_CON', 16",
                    "'BENCH_SOLVER_ITERS', 8", "'BENCH_LS_ITERS', 6"):
        assert setting in bench, setting
    with open(os.path.join(repo, 'flybody_tpu', 'train', 'run.py')) as f:
        run_py = ' '.join(f.read().split())
    assert ('env_kwargs.update(solver_iterations=8, ls_iterations=6, '
            'ncon_max=24, refactor_period=8, noslip_contacts=16)') in run_py
    for setting in ('_col.MPR_MERGED_TOP_P = 32', '_col.CC_TOP_P = 16',
                    "os.environ.setdefault('FLYBODY_SB_BREAK', '4')"):
        assert setting in run_py, setting


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
