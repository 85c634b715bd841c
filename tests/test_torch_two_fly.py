"""The dense-path slice end to end: the two-fly scene against the JAX
package at float64 on the CPU.

The scene is the JAX package's surgery.multi_fly_xml(2) compiled by
compile.build_fly_model (tests/test_surgery.py:91-121), shipped as
model/assets/two_fly.npz. It has no arrow partition, so both packages run
their dense path: the plain force chain with a dense mass matrix, the
multi-tree contact rows, the dense Newton solve (fused factor + solve,
substitution with a kept factor, the standalone line search) and the
dense noslip (multi-RHS substitution, Gauss-Seidel sweeps).

The flailing state: reset (with a zero warmstart qacc), then qvel ~ N(0,
1) and ctrl ~ U(-1, 1) from numpy seed 0 at batch 4, stepped 9 substeps by the JAX package at the
default preset (vmapped engine.step), so the flies have self- and
inter-fly contacts. From there both packages take one substep:
  * default preset (10 Newton iterations, 8 line-search steps, 64 slots,
    refactor 1, noslip on all slots), with the preset's line search;
  * bench preset (8/6/24/refactor 8, noslip on 16 slots, broadphase top-P
    32/16), with the line search swapped for the plain bisection of
    tests/test_torch_step.py on both sides: the exact search returns the
    midpoint of its final bracket and is chaotic at rounding level once
    its Newton probe lands on the root of phi' (ROADMAP section 3).
Tolerance: max |port - jax| <= 1e-6 * max |jax| per field (measured
~2e-11 on qacc at the default preset). The constraint rows and the dense
mass matrix of a forward pass at the flailing state are held to 1e-9 per
field, with the slot and body ids exactly equal.

The scene holds pairs whose distance does not depend on the state, one in
each fly (for example slots 1627 and 4123, 5.5434849697885e-3 in every
env): their float64 distances differ in the last bits by the rounding of
each fly's world pose, so which of the two the top-K selection lists first
follows rounding, in the JAX package as in the port (6 to 22 of each env's
64 positions at this state). The row test therefore
matches slots by id: each env selects the same set of slots, a slot sits
at another position only among slots whose distances agree to 1e-12 of
the largest, and every field agrees slot by slot.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.model import compile as jcompile
from flybody_tpu.model import spec as jspec
from flybody_tpu.model import surgery
from flybody_tpu.ops import arrow as jarrow
from flybody_tpu.physics import collision as jcol
from flybody_tpu.physics import engine as jeng
from flybody_tpu.physics import kinematics as jkin
from flybody_tpu.physics import smooth as jsm
from flybody_tpu.physics import solver as jsol
from flybody_tpu.physics.state import make_data as jmake_data
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.ops import arrow as tarrow
from flybody_tpu_torch.physics import collision as tcol
from flybody_tpu_torch.physics import engine as teng
from flybody_tpu_torch.physics import kinematics as tkin
from flybody_tpu_torch.physics import smooth as tsm
from flybody_tpu_torch.physics import solver as tsol
from flybody_tpu_torch.physics.state import data_from_numpy
from test_torch_step import bisect_alpha_jax, bisect_alpha_torch

B = 4
SUBSTEPS = 9
STEP_TOL = 1e-6
ROW_TOL = 1e-9
STATE = ('time', 'qpos', 'qvel', 'act', 'ctrl', 'qacc')
OUT = ('qpos', 'qvel', 'act', 'qacc', 'time', 'sensordata',
       'qfrc_constraint', 'self_contact_force')
# The JAX env arguments of each preset (physics/engine.PRESETS); the
# bench preset's broadphase widths are module constants there.
JAX_KW = {'default': dict(solver_iterations=10, ls_iterations=8,
                          ncon_max=64, refactor_period=1),
          'bench': dict(solver_iterations=8, ls_iterations=6, ncon_max=24,
                        refactor_period=8, noslip_contacts=16)}


def _close(out, ref, tol, what):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    if out.size == 0:
        return
    assert np.isfinite(ref).all(), f'{what}: reference not finite'
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f'{what}: max err {err:.3e}, scale {scale:.3e}'


@pytest.fixture(scope='module')
def models():
    return (jspec.load(tspec.TWO_FLY_NPZ),
            tspec.load(tspec.TWO_FLY_NPZ, device='cpu', dtype=torch.float64))


def _jax_data(jm, state):
    return jmake_data(jm).replace(**{k: jnp.asarray(v)
                                     for k, v in state.items()})


def _jax_step(jm, preset):
    kw = JAX_KW[preset]
    return jax.jit(jax.vmap(lambda d: jeng.step(jm, d, **kw)))


@pytest.fixture(scope='module')
def flail(models):
    """The flailing state (numpy, batch 4) after 9 JAX default substeps,
    and the JAX default-preset step function."""
    jm, tm = models
    rng = np.random.RandomState(0)
    meta = tm.meta
    state = dict(time=np.zeros(B), qpos=np.tile(tm.np_arrays['qpos0'],
                                                (B, 1)),
                 qvel=rng.randn(B, meta.nv), act=np.zeros((B, meta.na)),
                 ctrl=rng.uniform(-1.0, 1.0, (B, meta.nu)),
                 qacc=np.zeros((B, meta.nv)))
    step = _jax_step(jm, 'default')
    d = _jax_data(jm, state)
    for _ in range(SUBSTEPS):
        d = step(d).strip()  # the carry's structure: one compile
    return {k: np.asarray(getattr(d, k)) for k in STATE}, step


def test_asset_matches_fresh_two_fly_scene(tmp_path):
    """The committed asset is spec.save of build_fly_model(
    *multi_fly_xml(2))[0]."""
    path = str(tmp_path / 'two_fly.npz')
    jspec.save(path, jcompile.build_fly_model(*surgery.multi_fly_xml(2))[0])
    a_arr, a_meta = tspec.read_npz(tspec.TWO_FLY_NPZ)
    f_arr, f_meta = tspec.read_npz(path)
    assert a_meta == f_meta
    for k in tspec.ARRAY_FIELDS:
        np.testing.assert_array_equal(a_arr[k], f_arr[k], err_msg=k)


def test_no_arrow_partition_in_either_package(models):
    jm, tm = models
    assert jarrow.build_partition(jm.meta) is None
    assert tarrow.build_partition(tm.meta) is None
    assert tsol.tree_count(tm.meta) == 2
    assert (tm.meta.nq, tm.meta.nv, tm.meta.nu, tm.meta.na,
            tm.meta.nbody) == (218, 216, 156, 0, 135)


EFC_FIELDS = ('lim_active', 'lim_aref', 'lim_D', 'lim_pos', 'con_J',
              'con_active', 'con_frictional', 'con_mu', 'con_aref', 'con_D',
              'con_pos', 'con_xpos', 'con_normal', 'con_self', 'con_break')
EFC_IDS = ('con_sel', 'con_body1', 'con_body2')


@pytest.fixture(scope='module')
def rows(models, flail):
    """The dense M and the constraint rows of a forward pass at the
    flailing state, in both packages."""
    jm, tm = models
    state = flail[0]

    def jax_rows(d):
        d, _, _ = jkin.fwd_position_smooth(jm, d)
        con = jcol.collide(jm, d, compact=True)
        d = jsm.com_vel(jm, d)
        efc = jsol.make_efc(jm, d, con, ncon_max=64)
        return jsm.crb(jm, d).qM, {k: getattr(efc, k)
                                   for k in EFC_FIELDS + EFC_IDS}

    jM, jefc = jax.jit(jax.vmap(jax_rows))(_jax_data(jm, state))
    d = data_from_numpy(tm, **state)
    d, _, _ = tkin.fwd_position_smooth(tm, d)
    con = tcol.collide(tm, d, 128, 128)
    d = tsm.com_vel(tm, d)
    efc = tsol.make_efc(tm, d, con, 64)
    return (jM, jefc), (tsm.crb(tm, d).qM, efc)


def _by_slot(jefc, tefc):
    """The port's slot order mapped onto the JAX one: perm (B, K) with
    port slot perm[b, k] = JAX slot k."""
    jsel, tsel = np.asarray(jefc['con_sel']), tefc.con_sel.numpy()
    perm = np.stack([np.argsort(t)[np.searchsorted(np.sort(t), j)]
                     for j, t in zip(jsel, tsel)])
    assert (np.take_along_axis(tsel, perm, 1) == jsel).all()
    return perm


def test_dense_crb_matches_jax(rows):
    (jM, _), (tM, _) = rows
    _close(tM, jM, ROW_TOL, 'qM')


@pytest.mark.parametrize('field', EFC_FIELDS)
def test_multi_tree_rows_match_jax(rows, field):
    (_, jefc), (_, tefc) = rows
    out = getattr(tefc, field).numpy()
    if field.startswith('con_'):
        perm = _by_slot(jefc, tefc)
        out = np.take_along_axis(
            out, perm.reshape(perm.shape + (1,) * (out.ndim - 2)), 1)
    _close(out, jefc[field], ROW_TOL, field)


def test_multi_tree_row_ids_match_jax(rows):
    """The same slots in each env; a slot elsewhere in the list only
    among near-ties of its distance; the contact bodies by slot."""
    (_, jefc), (_, tefc) = rows
    jsel, tsel = np.asarray(jefc['con_sel']), tefc.con_sel.numpy()
    for j, t in zip(jsel, tsel):
        assert sorted(j) == sorted(t)
    jpos, tpos = np.asarray(jefc['con_pos']), tefc.con_pos.numpy()
    moved = jsel != tsel
    assert (np.abs(jpos - tpos)[moved]
            <= 1e-12 * np.abs(jpos).max()).all()
    perm = _by_slot(jefc, tefc)
    for k in ('con_body1', 'con_body2'):
        np.testing.assert_array_equal(
            np.take_along_axis(getattr(tefc, k).numpy(), perm, 1),
            np.asarray(jefc[k]), err_msg=k)
    assert tefc.con_active.sum(1).min() >= 1  # the flies are in contact


@pytest.fixture(scope='module')
def step_default(models, flail):
    jm, tm = models
    state, step = flail
    return (step(_jax_data(jm, state)),
            teng.step(tm, data_from_numpy(tm, **state),
                      teng.PRESETS['default']))


@pytest.fixture(scope='module')
def step_bench(models, flail):
    jm, tm = models
    state = flail[0]
    from flybody_tpu.ops import linesearch as jls
    from flybody_tpu_torch.ops import linesearch as tls
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcol, 'MPR_MERGED_TOP_P', 32)
        mp.setattr(jcol, 'CC_TOP_P', 16)
        mp.setattr(jls, 'alpha_ref', bisect_alpha_jax)
        mp.setattr(tls, 'alpha_ref', bisect_alpha_torch)
        jout = _jax_step(jm, 'bench')(_jax_data(jm, state))
        tout = teng.step(tm, data_from_numpy(tm, **state),
                         teng.PRESETS['bench'])
    return jout, tout


@pytest.mark.parametrize('field', OUT)
def test_step_matches_jax(step_default, field):
    jout, tout = step_default
    _close(getattr(tout, field), getattr(jout, field), STEP_TOL, field)


@pytest.mark.parametrize('field', OUT)
def test_bench_step_matches_jax(step_bench, field):
    jout, tout = step_bench
    _close(getattr(tout, field), getattr(jout, field), STEP_TOL, field)
