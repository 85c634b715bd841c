"""The collision slice against the JAX package: the compact collide
(analytic narrowphase, capsule-capsule block, merged MPR) and the contact
rows of make_efc.

Contact-rich walking states (qpos[:, 2] = 0.1, joint noise 0.1, as
tests/test_ops.py:556-564 builds them) are made from a numpy seed; the JAX
package computes their position stage, `collision.collide(compact=True)`
and `solver.make_efc` under jax.vmap (the XLA reference on the CPU), with
the preset's broadphase widths set on its module in a MonkeyPatch context
before the trace. The port gets the same position-stage arrays and runs
`collide` on CPU tensors, and `make_efc` on the JAX package's candidates:
the plain versions of kernels 5, 6 and 7 (ops/narrowphase.py,
ops/mpr_kernel.py, ops/efc_stage.py).

Both presets: top-P 128 / 128 and 64 slots (default), 32 / 16 and 24
(bench). Tolerance: float64, max |port - jax| <= 1e-9 * max |jax| per
field; the selected slot ids and body ids exactly.

The MPR block cannot meet 1e-9 on every pair, because the reference does
not: at a few touching pairs its discrete choices (which portal face of a
flat cylinder end, whether the polish step is accepted) flip with the
rounding of its inputs, and translating both geoms by an offset (which
changes no geometry, only rounding) moves the JAX result there by ~1e-8
in dist and ~1e-5 in the normal. So the block is held against that
control: the separated / touching classification exactly; each touching
pair either within 1e-9 of its field's scale, or within the largest
change the translations make in the JAX result at any touching pair (plus
1e-9 of scale), and no more such pairs than the translations move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.model import spec as jspec
from flybody_tpu.physics import collision as jcol
from flybody_tpu.physics import kinematics as jkin
from flybody_tpu.physics import mpr as jmpr
from flybody_tpu.physics import solver as jsol
from flybody_tpu.physics import state as jstate
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.physics import collision as tcol
from flybody_tpu_torch.physics import engine as tengine
from flybody_tpu_torch.physics import solver as tsol
from flybody_tpu_torch.physics.state import data_from_numpy

B = 6
F64_TOL = 1e-9
POSE = ('geom_xpos', 'geom_xmat', 'cdof', 'subtree_com')
EXACT = ('con_sel', 'con_body1', 'con_body2')
EFC_FIELDS = ('con_J', 'con_active', 'con_frictional', 'con_mu', 'con_aref',
              'con_D', 'con_pos', 'con_xpos', 'con_normal', 'con_self',
              'con_break') + EXACT


def contact_rich_states(nq, nv, qpos0, dtype, seed=0, batch=B):
    """Walking poses pressed into the floor with noisy joints."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(qpos0, np.float64)[None], (batch, 1))
    qpos[:, 2] = 0.1
    qpos[:, 7:] += 0.1 * rng.randn(batch, nq - 7)
    qvel = 0.3 * rng.randn(batch, nv)
    return qpos.astype(dtype), qvel.astype(dtype)


def jax_collision(jm, qpos, qvel, preset):
    """Position stage, compact collide and make_efc of the JAX package at
    the preset's broadphase widths and slot count."""
    p = tengine.PRESETS[preset]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcol, 'MPR_MERGED_TOP_P', p['mpr_top_p'])
        mp.setattr(jcol, 'CC_TOP_P', p['cc_top_p'])

        def f(qp, qv):
            d = jstate.make_data(jm).replace(qpos=qp, qvel=qv)
            d, _, _ = jkin.fwd_position_smooth(jm, d)
            con = jcol.collide(jm, d, compact=True)
            efc = jsol.make_efc(jm, d, con, ncon_max=p['ncon_max'])
            return [getattr(d, n) for n in POSE], con, efc

        pose, con, efc = jax.jit(jax.vmap(f))(jnp.asarray(qpos),
                                             jnp.asarray(qvel))
    return [np.asarray(x) for x in pose], con, efc


@pytest.fixture(scope='module', params=['default', 'bench'])
def run(request):
    preset = request.param
    jm = jspec.load(tspec.WALK_IMITATION_NPZ)
    tm = tspec.load(device='cpu', dtype=torch.float64)
    qpos, qvel = contact_rich_states(jm.meta.nq, jm.meta.nv, jm.qpos0,
                                     np.float64)
    pose, jcon, jefc = jax_collision(jm, qpos, qvel, preset)
    p = tengine.PRESETS[preset]
    data = data_from_numpy(tm, qpos=qpos, qvel=qvel, time=np.zeros(B),
                           act=np.zeros((B, jm.meta.na)),
                           ctrl=np.zeros((B, jm.meta.nu)),
                           **dict(zip(POSE, pose)))
    tcon = tcol.collide(tm, data, p['mpr_top_p'], p['cc_top_p'])
    tefc = tsol.make_efc(tm, data, to_torch(jcon), p['ncon_max'])
    return dict(jcon=jcon, jefc=jefc, tcon=tcon, tefc=tefc, preset=preset,
                mpr_control=mpr_translation_control(tm, data,
                                                    p['mpr_top_p']))


def to_torch(jcon):
    """The JAX package's Contact as the port's, at float64."""
    def t(x):
        return torch.as_tensor(np.array(x), dtype=torch.float64)
    return tcol.Contact(
        dist=t(jcon.dist), pos=t(jcon.pos), normal=t(jcon.normal),
        blocks=tuple(tcol.CompactBlock(idx=t(b.idx), dist=t(b.dist),
                                       pos=t(b.pos), normal=t(b.normal),
                                       params=t(b.params))
                     for b in jcon.blocks))


OFFSETS = ((0.5, 0.25, 0.125), (1.25e-4, 0.0, 0.0))


def mpr_translation_control(tm, data, top_p):
    """The JAX MPR on the merged broadphase candidates, and again with both
    geoms translated by each of OFFSETS: per field (dist, normal, pos), the
    largest change over touching pairs, and the count of touching pairs
    that any translation moves by more than 1e-9 of the field's scale."""
    ft = tcol._pair_family_tables(tm.meta, True)
    idx, c1, c2 = tcol._broadphase(tm, data, tcol._geom_cat(data), ft, top_p)
    prm = tm._cache['mpr_table'][idx][..., :11].numpy()
    c1, c2 = c1.numpy(), c2.numpy()
    mat = c1.shape[:2] + (3, 3)

    def mpr(*a):
        return jmpr.mpr_penetration(*a[:8], margin1=a[8], margin2=a[9],
                                    polish_iters=8, smooth_mask=a[10] > 0.5)

    f = jax.jit(jax.vmap(mpr))

    def run(off):
        off = np.asarray(off)
        d, n, p = f(*[jnp.asarray(a) for a in (
            prm[..., 8], prm[..., 9], c1[..., :3] + off,
            c1[..., 3:].reshape(mat), prm[..., 0:3], c2[..., :3] + off,
            c2[..., 3:].reshape(mat), prm[..., 4:7], prm[..., 3],
            prm[..., 7], prm[..., 10])])
        return np.asarray(d), np.asarray(n), np.asarray(p) - off

    base = run((0.0, 0.0, 0.0))
    touching = base[0] != 1.0
    worst, moved = [0.0, 0.0, 0.0], np.zeros_like(touching)
    for off in OFFSETS:
        for i, (a, b) in enumerate(zip(base, run(off))):
            err = np.abs(a - b)
            err = err.max(-1) if err.ndim == 3 else err
            err = np.where(touching, err, 0.0)
            worst[i] = max(worst[i], float(err.max()))
            moved |= err > F64_TOL * np.abs(a).max()
    return worst, int(moved.sum())


def _close(out, ref, what):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(out - ref).max())
    assert err <= F64_TOL * scale, f'{what}: {err:.3e} of scale {scale:.3e}'


def test_dense_narrowphase_matches_jax(run):
    """Kernel 5's plain version: the dense analytic slots."""
    jc, tc = run['jcon'], run['tcon']
    assert tc.dist.shape[1] == 174
    for f in ('dist', 'pos', 'normal'):
        _close(getattr(tc, f), getattr(jc, f), f)


@pytest.mark.parametrize('block', ['capsule-capsule', 'mpr'])
def test_compact_blocks_match_jax(run, block):
    """The broadphase selections and narrowphases of the compact blocks
    (kernel 6's plain version for the MPR block)."""
    i = ('capsule-capsule', 'mpr').index(block)
    jb, tb = run['jcon'].blocks[i], run['tcon'].blocks[i]
    np.testing.assert_array_equal(tb.idx.numpy(), np.asarray(jb.idx))
    _close(tb.params, jb.params, f'{block}.params')
    if block == 'capsule-capsule':
        for f in ('dist', 'pos', 'normal'):
            _close(getattr(tb, f), getattr(jb, f), f'{block}.{f}')
        return
    sep = np.asarray(jb.dist) == 1.0
    np.testing.assert_array_equal(tb.dist.numpy() == 1.0, sep)
    assert (~sep).sum() > 0  # touching pairs, too
    assert (tb.pos.numpy()[sep] == 0.0).all()
    worst, moved = run['mpr_control']
    off = np.zeros_like(sep)
    for f, w in zip(('dist', 'normal', 'pos'), worst):
        o, r = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        err = np.abs(o - r)
        err = np.where(sep, 0.0, err.max(-1) if err.ndim == 3 else err)
        scale = np.abs(r).max()
        assert err.max() <= w + F64_TOL * scale, (f, err.max(), w)
        off |= err > F64_TOL * scale
    assert off.sum() <= moved, (int(off.sum()), moved)


def test_contact_rows_match_jax(run):
    """Kernel 7's plain version: top-K selection and row assembly, on the
    JAX package's candidates (the MPR block's rounding flips above would
    otherwise reach the rows of the slots they select)."""
    je, te = run['jefc'], run['tefc']
    assert float(np.asarray(je.con_active).sum()) >= 8  # contact-rich
    for f in EFC_FIELDS:
        o, r = getattr(te, f).numpy(), np.asarray(getattr(je, f))
        if f in EXACT:
            np.testing.assert_array_equal(o, r.astype(o.dtype), err_msg=f)
        else:
            _close(o, r, f)
