"""The collision slice's plain versions against the JAX package's Pallas
kernels in interpret mode, at float32 on the CPU.

Inputs come from contact-rich walking states (test_torch_collision's,
made from a numpy seed) through the port at float32: the position stage's
geom poses, the merged MPR broadphase's candidates and make_efc's
candidate set. The same arrays go to
  * kernel 5, `narrowphase._np_pallas(..., interpret=True)` (as
    tests/test_ops.py:103-160 runs it) against `narrowphase_ref`;
  * kernel 6, `make_mpr_merged_pe(8, interpret=True)` (as
    tests/test_ops.py:317) against `mpr_merged_ref`, on the merged
    broadphase's 32 candidates (the bench preset's width);
  * kernel 7, `make_efc_contacts_pe(K, nv, nbody, interpret=True)` against
    `contact_rows_ref`, at the bench preset's widths and 24 slots (the
    interpreted kernel unrolls its slots, so the default preset's 64 take
    three times as long; tests/test_torch_collision.py holds the plain
    version against the JAX reference at both presets).
Bounds are the JAX tests' own: narrowphase 1e-4 of each output's scale;
MPR on pairs nearer than 1e-3, dist within 1e-4 and normals with dot
product above 0.999; contact rows 3e-6 of each field's scale, the slot and
body ids exactly.

MPR at float32 cannot resolve every pair: on a capsule-cylinder pair of
these states the Pallas kernel lands on another portal than the float64
answer (dist -0.0226 against -0.0062), where the port's plain version and
the JAX package's own XLA reference at float32 both agree with float64 to
1e-6. So the port is held to the kernel on the near pairs where the kernel
agrees with the float64 answer (the JAX reference at float64) within the
bounds, to the float64 answer on the others, and those others are at most
a tenth of the near pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.ops import efc_stage as jefc
from flybody_tpu.ops import mpr_kernel as jmprk
from flybody_tpu.ops import narrowphase as jnp_
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.ops import efc_stage as tefc
from flybody_tpu_torch.ops import mpr_kernel as tmprk
from flybody_tpu_torch.ops import narrowphase as tnp
from flybody_tpu_torch.physics import collision as tcol
from flybody_tpu_torch.physics import engine as tengine
from flybody_tpu_torch.physics import kinematics as tkin
from flybody_tpu_torch.physics import solver as tsol
from flybody_tpu_torch.physics.state import data_from_numpy
from test_torch_collision import contact_rich_states

B = 8
NP_TOL = 1e-4
MPR_NEAR, MPR_ATOL, MPR_DOT = 1e-3, 1e-4, 0.999
EFC_TOL = 3e-6


@pytest.fixture(scope='module')
def state():
    tm = tspec.load(device='cpu', dtype=torch.float32)
    meta = tm.meta
    qpos, qvel = contact_rich_states(meta.nq, meta.nv,
                                     tm.np_arrays['qpos0'], np.float32,
                                     batch=B)
    data = data_from_numpy(tm, qpos=qpos, qvel=qvel, time=np.zeros(B),
                           act=np.zeros((B, meta.na)),
                           ctrl=np.zeros((B, meta.nu)))
    data, _, _ = tkin.fwd_position_smooth(tm, data)
    return tm, data


def _lanes(v):
    """(B, P, C) -> the Pallas kernels' (C, P, 128) layout, zero-padded."""
    v = np.moveaxis(np.asarray(v), 0, -1).swapaxes(0, 1)
    pad = np.zeros(v.shape[:-1] + ((-v.shape[-1]) % 128,), v.dtype)
    return jnp.asarray(np.concatenate([v, pad], -1))


def test_narrowphase_matches_pallas_interpret(state):
    tm, data = state
    segs = tcol.dense_segments(tm.meta)
    out = tnp.narrowphase(segs, data.geom_xpos, data.geom_xmat, tm.geom_size)
    jsegs, plo, slo = [], 0, 0
    for key, g1, _, k in segs:
        jsegs.append((key, plo, plo + len(g1), slo, k))
        plo, slo = plo + len(g1), slo + len(g1) * k
    g1 = np.concatenate([s[1] for s in segs])
    g2 = np.concatenate([s[2] for s in segs])
    gcat = tcol._geom_cat(data).numpy()
    size = tm.geom_size.numpy()
    sz = np.broadcast_to(np.concatenate([size[g1], size[g2]], -1),
                         (B, plo, 6))
    d, p, n = jnp_._np_pallas(tuple(jsegs), slo, _lanes(gcat[:, g1]),
                              _lanes(gcat[:, g2]), _lanes(sz),
                              interpret=True)
    perm = jnp_.rowmajor_to_canonical_perm(tuple(jsegs), slo)
    ref = [np.moveaxis(np.asarray(x)[:, :, :B], -1, 0).swapaxes(1, 2)[
        :, perm] for x in (d, p, n)]
    for name, o, r in zip(('dist', 'pos', 'normal'), out, ref):
        r = r[..., 0] if name == 'dist' else r
        scale = float(np.abs(r).max())
        err = float(np.abs(o.numpy() - r).max())
        assert err <= NP_TOL * scale, (name, err, scale)


def test_mpr_merged_matches_pallas_interpret(state):
    tm, data = state
    ft = tcol._pair_family_tables(tm.meta, True)
    P = tengine.PRESETS['bench']['mpr_top_p']
    idx, c1, c2 = tcol._broadphase(tm, data, tcol._geom_cat(data), ft, P)
    tcol._mpr_merged(tm, data, tcol._geom_cat(data), P)  # builds the table
    prm = tm._cache['mpr_table'][idx][..., :11].contiguous()
    d, n, _ = tmprk.mpr_merged(c1, c2, prm, 8)
    a1, a2, pr = c1.numpy(), c2.numpy(), prm.numpy()
    mat = a1.shape[:2] + (3, 3)
    f = jmprk.make_mpr_merged_pe(8, interpret=True)
    jd, jn, _ = jax.vmap(f)(*[jnp.asarray(x) for x in (
        a1[..., :3], a1[..., 3:].reshape(mat), pr[..., 0:3], pr[..., 3],
        a2[..., :3], a2[..., 3:].reshape(mat), pr[..., 4:7], pr[..., 7],
        pr[..., 8], pr[..., 9], pr[..., 10])])
    fd, fn, _ = jax.vmap(jmprk.make_mpr_merged_pe(8))(*[
        jnp.asarray(x, jnp.float64) for x in (
            a1[..., :3], a1[..., 3:].reshape(mat), pr[..., 0:3], pr[..., 3],
            a2[..., :3], a2[..., 3:].reshape(mat), pr[..., 4:7], pr[..., 7],
            pr[..., 8], pr[..., 9], pr[..., 10])])
    jd, jn, fd, fn = map(np.asarray, (jd, jn, fd, fn))

    def agree(d_, n_, rd, rn):
        return (np.abs(d_ - rd) <= MPR_ATOL) & (np.sum(n_ * rn, -1) > MPR_DOT)

    near = jd < MPR_NEAR
    assert near.sum() > 5
    resolved = agree(jd, jn, fd, fn)
    assert (near & ~resolved).sum() <= 0.1 * near.sum()
    ok = np.where(resolved, agree(d.numpy(), n.numpy(), jd, jn),
                  agree(d.numpy(), n.numpy(), fd, fn))
    assert ok[near].all(), np.argwhere(near & ~ok)


def test_contact_rows_match_pallas_interpret(state):
    tm, data = state
    meta = tm.meta
    p = tengine.PRESETS['bench']
    con = tcol.collide(tm, data, p['mpr_top_p'], p['cc_top_p'])
    cand = tsol.contact_candidates(tm, con)
    K = p['ncon_max']
    con_J, scal = tefc.contact_rows(tm, data, *cand, K)
    root = tefc.tree_root(meta)
    f = jefc.make_efc_contacts_pe(K, meta.nv, meta.nbody, interpret=True)
    jJ, js = jax.vmap(f, in_axes=(0, 0, 0, 0, 0, 0, None, None))(
        *[jnp.asarray(x.numpy()) for x in cand],
        jnp.asarray(data.qvel.numpy()), jnp.asarray(data.cdof.numpy()),
        jnp.asarray(data.subtree_com[:, root].numpy()),
        jnp.asarray(tm.body_dof_mask.numpy().T),
        jnp.asarray(tefc.limb_of_body(tm).numpy()[None]))
    assert float(scal[1].sum()) >= 8  # contact-rich
    outs = [con_J] + scal
    refs = [np.asarray(jJ)] + list(np.moveaxis(np.asarray(js), 1, 0))
    for i, (o, r) in enumerate(zip(outs, refs)):
        o = o.numpy()
        if i - 1 in (14, 15, 18):  # body1, body2, slot id
            np.testing.assert_array_equal(o, r, err_msg=f'row {i - 1}')
            continue
        scale = max(1e-6, float(np.abs(r).max()))
        err = float(np.abs(o - r).max())
        assert err <= EFC_TOL * scale, (i - 1, err, scale)
