"""The dense collide, its contact rows and the collision tools against the
JAX package.

`collision.collide(compact=False)` is the JAX package's default collide
(collision.py:891-972), the one its tools time: every slot in slot order,
row 5 (the analytic narrowphase) on every analytic group, capsule-capsule
included, and the merged MPR (row 6) on its 128 closest pairs scattered
back. Contact-rich walking states (tests/test_torch_collision.py's, 4 of
them, numpy seed 0) go through the JAX package's position stage, dense
collide and make_efc under jax.vmap at float64 on the CPU; the port gets
the same position-stage arrays. Tolerance: max |port - jax| <= 1e-9 *
max |jax| per field.

  * Row 5's plain version on the dense collide's 1,154 analytic pairs
    (1,213 slots) against the JAX collide's analytic slots, every slot.
  * The dense collide against the JAX one: every slot's dist; pos and
    normal where dist < 1e-3 (a separated pair's MPR normal is arbitrary).
    The MPR slots follow tests/test_torch_collision.py's rule: the JAX
    result's own change under a translation of both geoms (rounding only)
    bounds the port's difference on touching pairs, since the reference's
    MPR flips discrete choices at rounding level at a few pairs.
  * make_efc on the JAX package's dense Contact (the exact two-stage tile
    prefilter, then row 7's plain version): every row field, slots matched
    by id as tests/test_torch_two_fly.py matches them, ids exactly.
  * The per-group narrowphase of the JAX tools: `mpr_topp` (broadphase top
    64, the group's narrowphase, scatter back) on the capsule-capsule group
    (exact analytic rows) and on the capsule-ellipsoid group (the
    per-type-pair MPR's plain version), and `handler(gather_group)` on the
    ellipsoid-ellipsoid group, against `_mpr_topp`, `_handler` and
    `_gather_group`.
  * tools/profile_collide.py and tools/profile_micro.py run to their end on
    the CPU at batch 2, one iteration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.model import spec as jspec
from flybody_tpu.physics import collision as jcol
from flybody_tpu.physics import kinematics as jkin
from flybody_tpu.physics import solver as jsol
from flybody_tpu.physics import state as jstate
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.ops import narrowphase as tnp
from flybody_tpu_torch.physics import collision as tcol
from flybody_tpu_torch.physics import solver as tsol
from flybody_tpu_torch.physics.state import data_from_numpy
from flybody_tpu_torch.tools import profile_collide, profile_micro
from test_torch_collision import (EFC_FIELDS, EXACT, F64_TOL, POSE, _close,
                                  contact_rich_states, mpr_translation_control,
                                  to_torch)

B = 4
K = 64
CC = (tspec.GEOM_CAPSULE, tspec.GEOM_CAPSULE)
CAPSULE_ELLIPSOID = (tspec.GEOM_CAPSULE, tspec.GEOM_ELLIPSOID)
ELLIPSOIDS = (tspec.GEOM_ELLIPSOID, tspec.GEOM_ELLIPSOID)


@pytest.fixture(scope='module')
def run():
    jm = jspec.load(tspec.WALK_IMITATION_NPZ)
    tm = tspec.load(device='cpu', dtype=torch.float64)
    qpos, qvel = contact_rich_states(jm.meta.nq, jm.meta.nv, jm.qpos0,
                                     np.float64, batch=B)
    tb = jcol.pair_tables(jm.meta)

    def f(qp, qv):
        d = jstate.make_data(jm).replace(qpos=qp, qvel=qv)
        d, _, _ = jkin.fwd_position_smooth(jm, d)
        con = jcol.collide(jm, d)
        efc = jsol.make_efc(jm, d, con, ncon_max=K)
        gcat = jcol._geom_cat(d)
        topp = tuple(jcol._mpr_topp(jm, d, key, *tb['groups'][key][:2],
                                    gcat=gcat)
                     for key in (CC, CAPSULE_ELLIPSOID))
        groups = topp + (jcol._handler(ELLIPSOIDS)(jcol._gather_group(
            jm, gcat, *tb['groups'][ELLIPSOIDS][:2])),)
        return [getattr(d, n) for n in POSE], con, efc, groups

    pose, jcon, jefc, jgroups = jax.jit(jax.vmap(f))(jnp.asarray(qpos),
                                                    jnp.asarray(qvel))
    data = data_from_numpy(tm, qpos=qpos, qvel=qvel, time=np.zeros(B),
                           act=np.zeros((B, jm.meta.na)),
                           ctrl=np.zeros((B, jm.meta.nu)),
                           **{n: np.asarray(x) for n, x in zip(POSE, pose)})
    return dict(tm=tm, data=data, jcon=jcon, jefc=jefc, jgroups=jgroups,
                tcon=tcol.collide(tm, data, compact=False),
                mpr_control=mpr_translation_control(
                    tm, data, tcol.MPR_MERGED_TOP_P))


def _analytic_ids(tm):
    return tcol.analytic_slot_ids(tm.meta, False)


def test_analytic_rows_match_jax(run):
    """Row 5's plain version with the capsule-capsule segment."""
    tm, data = run['tm'], run['data']
    segs = tcol.analytic_segments(tm.meta, False)
    assert sum(len(g1) for _, g1, _, _ in segs) == 1154
    assert [k for k, _, _, _ in segs].count(CC) == 1
    out = tnp.narrowphase(segs, data.geom_xpos, data.geom_xmat,
                          tm.geom_size)
    ids = _analytic_ids(tm)
    assert out[0].shape[1] == len(ids) == 1213
    for name, o in zip(('dist', 'pos', 'normal'), out):
        _close(o, np.asarray(getattr(run['jcon'], name))[:, ids], name)


def test_dense_collide_matches_jax(run):
    jc, tc = run['jcon'], run['tcon']
    tm = run['tm']
    assert tc.blocks == () and tc.dist.shape == (B, 2223)
    jd = np.asarray(jc.dist)
    ana = np.zeros(jd.shape[1], bool)
    ana[_analytic_ids(tm)] = True
    near = jd < 1e-3
    for name in ('dist', 'pos', 'normal'):
        o, r = getattr(tc, name).numpy(), np.asarray(getattr(jc, name))
        keep = ana[None] & (True if name == 'dist' else near)
        keep = np.broadcast_to(keep, near.shape)
        _close(o[keep], r[keep], f'analytic {name}')
    # The MPR slots: uncovered ones (dist 1e10, normal (0, 0, 1)) and
    # separated ones exactly as in JAX, touching ones within the JAX
    # result's own change under translation.
    mpr = ~ana[None] & np.ones_like(near)
    td = tc.dist.numpy()
    for v in (1e10, 1.0):
        np.testing.assert_array_equal(td[mpr] == v, jd[mpr] == v)
    unc = mpr & (jd == 1e10)
    assert unc.sum() > 0
    assert (tc.normal.numpy()[unc] == [0.0, 0.0, 1.0]).all()
    touch = mpr & (jd < 1.0)
    assert touch.sum() > 0
    worst, moved = run['mpr_control']
    off = np.zeros_like(touch)
    for name, w in zip(('dist', 'normal', 'pos'), worst):
        o, r = getattr(tc, name).numpy(), np.asarray(getattr(jc, name))
        err = np.abs(o - r)
        err = np.where(touch, err.max(-1) if err.ndim == 3 else err, 0.0)
        scale = np.abs(r[touch]).max()
        assert err.max() <= w + F64_TOL * scale, (name, err.max(), w)
        off |= err > F64_TOL * scale
    assert off.sum() <= moved, (int(off.sum()), moved)


def test_dense_make_efc_matches_jax(run):
    """The prefilter and the contact rows on the JAX package's Contact."""
    tm, data, je = run['tm'], run['data'], run['jefc']
    te = tsol.make_efc(tm, data, to_torch(run['jcon']), K)
    assert te.con_J.shape[1] == K
    assert float(np.asarray(je.con_active).sum()) >= 8  # contact-rich
    jsel, tsel = np.asarray(je.con_sel), te.con_sel.numpy()
    perm = np.stack([np.argsort(t)[np.searchsorted(np.sort(t), j)]
                     for j, t in zip(jsel, tsel)])
    assert (np.take_along_axis(tsel, perm, 1) == jsel).all()
    for f in EFC_FIELDS:
        o, r = getattr(te, f).numpy(), np.asarray(getattr(je, f))
        o = np.take_along_axis(o, perm.reshape(perm.shape + (1,) * (
            o.ndim - 2)), 1)
        if f in EXACT:
            np.testing.assert_array_equal(o, r.astype(o.dtype), err_msg=f)
        else:
            _close(o, r, f)


def test_group_narrowphase_matches_jax(run):
    tm, data = run['tm'], run['data']
    tb = tcol.pair_tables(tm.meta)
    gcat = tcol._geom_cat(data)
    outs = tuple(tcol.mpr_topp(tm, data, key, *tb['groups'][key][:2],
                               gcat=gcat)
                 for key in (CC, CAPSULE_ELLIPSOID)) + (
        tcol.handler(ELLIPSOIDS)(tcol.gather_group(
            tm, gcat, *tb['groups'][ELLIPSOIDS][:2])),)
    for what, out, ref in zip(('capsule-capsule top-P',
                               'capsule-ellipsoid top-P',
                               'ellipsoid-ellipsoid'), outs,
                              run['jgroups']):
        assert np.asarray(ref[0]).shape == tuple(out[0].shape)
        # Every pair of the analytic group; the MPR groups' touching ones.
        keep = (np.ones(out[0].shape, bool) if what.startswith('capsule-c')
                else np.asarray(ref[0]) < 1e-3)
        _close(out[0], ref[0], f'{what} dist')
        for i, name in ((1, 'pos'), (2, 'normal')):
            _close(out[i].numpy()[keep], np.asarray(ref[i])[keep],
                   f'{what} {name}')
    assert (np.asarray(run['jgroups'][1][0]) < 1e-3).sum() > 0


def test_profile_collide_runs_on_the_cpu(capsys):
    r = profile_collide.main(['--cpu', '--batch', '2', '--iters', '1'])
    out = capsys.readouterr().out
    assert 'platform=cpu' in out and 'FULL collide' in out
    assert len(r) == 14 and all(v > 0 for v in r.values())


def test_profile_micro_runs_on_the_cpu(capsys):
    r = profile_micro.main(['--cpu', '--batch', '2', '--iters', '1'])
    out = capsys.readouterr().out
    for line in ('efc top_k(64)', 'efc full', 'factor_m', 'solve_m (vec)',
                 'newton grad+hess', 'newton chol(H)', 'newton cho_solve',
                 'solve 8x6', 'noslip 3', 'done: batch=2 platform=cpu'):
        assert line in out, line
    assert sum(k.startswith('collide ') for k in r) == 13
