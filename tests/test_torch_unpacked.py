"""The unpacked-mass-matrix path against the JAX package at float64: the
factor and solves of smooth.py and the contact-free step.

On a dense qM the JAX package dispatches on the arrow partition and on
qM's rank (smooth.py:186-237, 528-549): the walking fly (a partition)
gets the packed arrow factor from the dense matrix (rows 18, 19 and K3's
dense form), a model without one (two flies) the dense Cholesky factor
(row 14). The same inputs go through the JAX functions as the JAX package
runs them on the CPU (the XLA references: arrow.factor_ref / solve_ref,
jnp.linalg.cholesky) and through the port's plain versions on CPU tensors:

  * factor_m / solve_m / factor_solve_m on the walking model's dense M
    (packed factor, 1 and 25 right-hand sides) and on the two-fly scene's
    (dense factor): max |port - jax| <= 1e-12 * max |jax| per output;
  * step_smooth (fwd_smooth with the dense crb, then euler through K3's
    dense form) over 50 substeps of 4 envs from a perturbed state with
    random controls: qpos, qvel, qacc within 1e-9 of max |jax|.

The Newton solve and the noslip on the dense M are in
tests/test_torch_unpacked_solve.py (a second file, so that each stays
within seconds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.model import spec as jspec
from flybody_tpu.physics import kinematics as jkin
from flybody_tpu.physics import smooth as jsm
from flybody_tpu.physics.state import make_data as jmake_data
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.ops import arrow as tarrow
from flybody_tpu_torch.physics import kinematics as tkin
from flybody_tpu_torch.physics import smooth as tsm
from flybody_tpu_torch.physics.state import data_from_numpy
from walk_states import flail, models

B = 4
OPS_TOL = 1e-12
STEP_TOL = 1e-9
SUBSTEPS = 50


def _close(out, ref, tol, what):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert np.isfinite(ref).all(), f'{what}: reference not finite'
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f'{what}: max err {err:.3e}, scale {scale:.3e}'


def _dense_m(jm, tm, qpos):
    """The dense M (smooth.crb) of both packages at qpos, and the JAX
    state it came from."""
    def one(q):
        d = jmake_data(jm).replace(qpos=q)
        d, _, _ = jkin.fwd_position_smooth(jm, d)
        return jsm.crb(jm, jsm.com_vel(jm, d))
    jd = jax.jit(jax.vmap(one))(jnp.asarray(qpos))
    td = data_from_numpy(tm, time=np.zeros(len(qpos)), qpos=qpos,
                         qvel=np.zeros((len(qpos), tm.meta.nv)),
                         act=np.zeros((len(qpos), tm.meta.na)),
                         ctrl=np.zeros((len(qpos), tm.meta.nu)))
    td, _, _ = tkin.fwd_position_smooth(tm, td)
    return jd, tsm.crb(tm, tsm.com_vel(tm, td))


@pytest.fixture(scope='module')
def walk():
    jm, tm = models()
    qpos, _ = flail(B, 1)
    jd, td = _dense_m(jm, tm, qpos)
    rng = np.random.RandomState(2)
    rhs = {1: rng.randn(B, tm.meta.nv), 25: rng.randn(B, tm.meta.nv, 25)}
    return jm, tm, jd, td, rhs


def test_walking_dense_m_takes_the_arrow_factor(walk):
    jm, tm, jd, td, _ = walk
    _close(td.qM, jd.qM, OPS_TOL, 'qM')
    assert td.qM.dim() == 3 and tarrow.build_partition(tm.meta) is not None
    jF = jax.jit(jax.vmap(lambda d: jsm.factor_m(jm, d).qLD))(jd)
    tF = tsm.factor_m(tm, td).qLD
    assert tuple(tF.shape) == (B, 13, 20, 14)
    _close(tF, jF, OPS_TOL, 'qLD')


@pytest.mark.parametrize('m', [1, 25])
def test_walking_solve_m(walk, m):
    """solve_m with the packed factor (row 19's plain version)."""
    jm, tm, jd, td, rhs = walk
    b = rhs[m]
    jx = jax.jit(jax.vmap(lambda d, r: jsm.solve_m(
        jm, jsm.factor_m(jm, d), r)))(jd, jnp.asarray(b))
    tx = tsm.solve_m(tm, tsm.factor_m(tm, td), torch.as_tensor(b))
    _close(tx, jx, OPS_TOL, f'x (m {m})')


@pytest.mark.parametrize('m', [1, 25])
def test_walking_factor_solve_m(walk, m):
    """factor_solve_m on the dense M (K3's dense form, plain version)."""
    jm, tm, jd, td, rhs = walk
    b = rhs[m]
    jF, jx = jax.jit(jax.vmap(lambda d, r: (
        lambda o: (o[0].qLD, o[1]))(jsm.factor_solve_m(jm, d, r))))(
            jd, jnp.asarray(b))
    td2, tx = tsm.factor_solve_m(tm, td, torch.as_tensor(b))
    _close(td2.qLD, jF, OPS_TOL, 'qLD')
    _close(tx, jx, OPS_TOL, f'x (m {m})')


def test_factor_m_extra_diag(walk):
    jm, tm, jd, td, _ = walk
    diag = np.random.RandomState(3).rand(tm.meta.nv)
    jF = jax.jit(jax.vmap(lambda d: jsm.factor_m(
        jm, d, jnp.asarray(diag)).qLD))(jd)
    _close(tsm.factor_m(tm, td, torch.as_tensor(diag)).qLD, jF, OPS_TOL,
           'qLD')


def test_two_fly_dense_m_takes_the_dense_factor():
    """No arrow partition: factor_m gives the dense lower factor (row 14's
    plain version), solve_m substitutes with it (rows 15, 16)."""
    jm = jspec.load(tspec.TWO_FLY_NPZ)
    tm = tspec.load(tspec.TWO_FLY_NPZ, device='cpu', dtype=torch.float64)
    rng = np.random.RandomState(4)
    qpos = np.tile(np.asarray(jm.qpos0)[None], (2, 1))
    qpos[:, 7:] += 0.1 * rng.randn(2, qpos.shape[1] - 7)
    jd, td = _dense_m(jm, tm, qpos)
    b = rng.randn(2, tm.meta.nv)
    jL, jx = jax.jit(jax.vmap(lambda d, r: (
        lambda f: (f.qLD, jsm.solve_m(jm, f, r)))(jsm.factor_m(jm, d))))(
            jd, jnp.asarray(b))
    tf = tsm.factor_m(tm, td)
    assert tuple(tf.qLD.shape) == (2, tm.meta.nv, tm.meta.nv)
    _close(tf.qLD, jL, OPS_TOL, 'qLD')
    _close(tsm.solve_m(tm, tf, torch.as_tensor(b)), jx, OPS_TOL, 'x')


@pytest.fixture(scope='module')
def smooth_steps():
    """50 step_smooth substeps in both packages from a perturbed state
    (qpos0 + 0.01 N(0, 1), qvel 0.1 N(0, 1), ctrl U(-1, 1); numpy seed 5)."""
    jm, tm = models()
    rng = np.random.RandomState(5)
    meta = tm.meta
    state = dict(time=np.zeros(B),
                 qpos=np.tile(np.asarray(jm.qpos0)[None], (B, 1))
                 + 0.01 * rng.randn(B, meta.nq),
                 qvel=0.1 * rng.randn(B, meta.nv), act=np.zeros((B, meta.na)),
                 ctrl=rng.uniform(-1.0, 1.0, (B, meta.nu)))
    step = jax.jit(jax.vmap(lambda d: jsm.step_smooth(jm, d)))
    jd = jax.vmap(lambda s: jmake_data(jm).replace(**s))(
        {k: jnp.asarray(v) for k, v in state.items()})
    td = data_from_numpy(tm, **state)
    for _ in range(SUBSTEPS):
        jd = step(jd)
        td = tsm.step_smooth(tm, td)
    return jd, td


@pytest.mark.parametrize('field', ['qpos', 'qvel', 'qacc'])
def test_step_smooth_matches_jax(smooth_steps, field):
    jd, td = smooth_steps
    _close(getattr(td, field), getattr(jd, field), STEP_TOL, field)
