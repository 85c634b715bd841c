"""The schedules of the position-stage kernel (K1) and the merged MPR
(row 6) in plain torch, on the CPU.

csrc/pos_stage.cu runs an env in one block: the world body, then the body
frames root to leaves a body a thread, level by level (the pack's
`level_body` / `level_off`, from `force_stage.body_levels`), each body's
hinge chain in order in its thread; the tendon lengths a tendon a thread
over qpos in order; geom and site frames an object a thread; the subtree
CoM's sums a component a thread over the bodies in descending order;
cinert a body a thread; cdof a dof a thread. `k1(..., level_order=True)`
below is that schedule, built from the kernel's host tables
(`pos_stage.pack`); `level_order=False` is the loop of the
one-thread-per-env kernel it replaced, the bodies in id order. Every frame
starts as NaN, so a body run before its parent shows.

  (a) at float32 the schedule is the one-thread loop bit for bit
      (torch.equal) on the walking and the two-fly models; at float64 it
      agrees with the JAX package's `make_pos_stage_pe` to 1e-12 of each
      entry's scale (the largest |value| of its body, object, dof, joint or
      tendon in the JAX output, floored at 1e-6 of the output's largest);
  (b) the level tables visit parents before children and cover every body
      once, and the staged prefixes of the packs hold every table the walk
      reads (multiples of 4, inside the packs).

csrc/mpr.cu's merged kernel runs its candidates in the stable order of
their type-pair key within windows of WINDOW candidates
(`mpr_kernel.type_order`) and skips polish on pairs that are not smooth.

  (c) `mpr_merged_ref` on candidates permuted by that order, scattered
      back, is the unpermuted call bit for bit at float32, at the kernel's
      window and at one of 64 (several windows here); the order is stable
      (keys ascend within a window, equal keys in index order) and its
      inverse restores the candidates' order;
  (d) polish only on smooth pairs leaves `mpr_merged_ref`'s dist, normal
      and pos unchanged (torch.equal) on the walk candidates and on a
      batch of cylinder pairs only, while on the smooth pairs polish moves
      some result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.model import spec as jspec
from flybody_tpu.ops import pos_stage as jps
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.ops import force_stage as tfs
from flybody_tpu_torch.ops import mpr_kernel as tmk
from flybody_tpu_torch.ops import pos_stage as tps
from flybody_tpu_torch.physics import collision, kinematics
from flybody_tpu_torch.physics.state import make_data

B = 3
TOL = 1e-12
MODELS = {'walk': tspec.WALK_IMITATION_NPZ, 'two_fly': tspec.TWO_FLY_NPZ}


# ------------------------------------------------- quaternion algebra
# Each expression in csrc/common.cuh's order, a rounding per operation.


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _qmul(a, b):
    a0, a1, a2, a3 = (a[..., k] for k in range(4))
    b0, b1, b2, b3 = (b[..., k] for k in range(4))
    return torch.stack([a0 * b0 - a1 * b1 - a2 * b2 - a3 * b3,
                        a0 * b1 + a1 * b0 + a2 * b3 - a3 * b2,
                        a0 * b2 - a1 * b3 + a2 * b0 + a3 * b1,
                        a0 * b3 + a1 * b2 - a2 * b1 + a3 * b0], -1)


def _qrot(q, v):
    u = q[..., 1:]
    s = q[..., 0] * q[..., 0] + _dot3(u, u)
    uv = _cross3(u, v)
    a = s - 2.0 * _dot3(u, u)
    b = 2.0 * _dot3(u, v)
    inv = 1.0 / torch.clamp(s, min=1e-12)
    return torch.stack([(v[..., k] * a + u[..., k] * b
                         + 2.0 * q[..., 0] * uv[..., k]) * inv
                        for k in range(3)], -1)


def _qnormalize(q):
    n = torch.sqrt(q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]
                   + q[..., 2] * q[..., 2] + q[..., 3] * q[..., 3])
    return q * (1.0 / torch.clamp(n, min=1e-12))[..., None]


def _qmat(q):
    w, x, y, z = (q[..., k] for k in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)


# ------------------------------------------------------------------ K1


def _tables(model, dtype):
    """The kernel's tables by name: float tables as torch tensors of
    `dtype` (at float64 before their rounding to float32), int tables as
    numpy."""
    p = tps.pack(model)
    out = {n: torch.as_tensor(p.table(n, dtype == torch.float64)).to(dtype)
           for n in p.fnames}
    out.update({n: p.table(n).astype(np.int64) for n in p.inames})
    return out


def _body_frame(b, T, qpos, X):
    """Body b's frame from its parent's (the kernel's body_frame)."""
    lp = T['body_pos'][3 * b:3 * b + 3].expand(qpos.shape[0], 3)
    lq = T['body_quat'][4 * b:4 * b + 4].expand(qpos.shape[0], 4)
    p = int(T['parent'][b])
    pq, pp = X['xquat'][:, p], X['xpos'][:, p]
    free_j = -1
    for s in range(int(T['jntnum'][b])):
        j = int(T['jntadr'][b]) + s
        a = int(T['jnt_qposadr'][j])
        if T['jnt_type'][j] == 0:
            lp, lq = qpos[:, a:a + 3], _qnormalize(qpos[:, a + 3:a + 7])
            free_j = j
            continue
        ja, jx = T['jnt_pos'][3 * j:3 * j + 3], T['jnt_axis'][3 * j:3 * j + 3]
        X['janc'][:, j] = pp + _qrot(pq, _qrot(lq, ja) + lp)
        X['jaxis'][:, j] = _qrot(pq, _qrot(lq, jx))
        ang = qpos[:, a] - T['qpos0'][a]
        sh, chh = torch.sin(0.5 * ang), torch.cos(0.5 * ang)
        hq = torch.stack([chh, sh * jx[0], sh * jx[1], sh * jx[2]], -1)
        lp = lp + _qrot(lq, ja - _qrot(hq, ja))
        lq = _qmul(lq, hq)
    if b == 0:
        wp, wq = lp, lq
    else:
        wp, wq = _qrot(pq, lp) + pp, _qmul(pq, lq)
    wq = _qnormalize(wq)
    X['xpos'][:, b], X['xquat'][:, b], X['xmat'][:, b] = wp, wq, _qmat(wq)
    X['xipos'][:, b] = wp + _qrot(wq, T['body_ipos'][3 * b:3 * b + 3])
    X['ximat'][:, b] = _qmat(_qmul(wq, T['body_iquat'][4 * b:4 * b + 4]))
    if free_j >= 0:
        X['janc'][:, free_j] = wp
        X['jaxis'][:, free_j] = torch.tensor([0.0, 0.0, 1.0],
                                             dtype=qpos.dtype)


def _object_frame(g, body, sf, lp, lq, X):
    b, s = int(body[g]), int(sf[g])
    if s == 1:
        p = X['xpos'][:, b]
    elif s == 2:
        p = X['xipos'][:, b]
    else:
        p = _qrot(X['xquat'][:, b], lp[3 * g:3 * g + 3]) + X['xpos'][:, b]
    if s in (1, 3):
        m = X['xmat'][:, b]
    elif s in (2, 4):
        m = X['ximat'][:, b]
    else:
        m = _qmat(_qmul(X['xquat'][:, b], lq[4 * g:4 * g + 4]))
    return p, m


def _cinert(b, T, X):
    R = X['ximat'][:, b]
    r = X['xipos'][:, b] - X['scom'][:, int(T['root'][b])]
    m, inert = T['mass'][b], T['inertia'][3 * b:3 * b + 3]
    r2 = _dot3(r, r)
    zero = torch.zeros_like(r2)
    sk = [zero, -r[:, 2], r[:, 1], r[:, 2], zero, -r[:, 0], -r[:, 1],
          r[:, 0], zero]
    ci = torch.full((r.shape[0], 6, 6), float('nan'), dtype=r.dtype)
    for i in range(3):
        for j in range(3):
            ic = (R[:, 3 * i] * R[:, 3 * j] * inert[0]
                  + R[:, 3 * i + 1] * R[:, 3 * j + 1] * inert[1]
                  + R[:, 3 * i + 2] * R[:, 3 * j + 2] * inert[2])
            ci[:, i, j] = ic + m * ((r2 if i == j else zero) - r[:, i]
                                    * r[:, j])
            ci[:, i, 3 + j] = m * sk[3 * i + j]
            ci[:, 3 + i, j] = -m * sk[3 * i + j]
            ci[:, 3 + i, 3 + j] = m if i == j else 0.0
    return ci


def _cdof(i, T, X):
    b, j = int(T['dof_body'][i]), int(T['dof_jnt'][i])
    mode, k = int(T['dof_mode'][i]), int(T['dof_k'][i])
    n = X['xpos'].shape[0]
    if mode == 0:
        out = torch.zeros((n, 6), dtype=X['xpos'].dtype)
        out[:, 3 + k] = 1.0
        return out
    ax = X['xmat'][:, b][:, [k, 3 + k, 6 + k]] if mode == 1 \
        else X['jaxis'][:, j]
    arm = X['scom'][:, int(T['root'][b])] - X['janc'][:, j]
    return torch.cat([ax, _cross3(ax, arm)], -1)


def k1(model, qpos, level_order: bool) -> dict:
    """The position stage in the kernel's schedule (level_order) or the
    one-thread loop's (bodies in id order)."""
    meta = model.meta
    T = _tables(model, qpos.dtype)
    n = qpos.shape[0]
    nb, nj, ng, ns = meta.nbody, meta.njnt, meta.ngeom, meta.nsite

    def nan(*shape):
        return torch.full((n,) + shape, float('nan'), dtype=qpos.dtype)
    X = dict(xpos=nan(nb, 3), xquat=nan(nb, 4), xmat=nan(nb, 9),
             xipos=nan(nb, 3), ximat=nan(nb, 9), janc=nan(nj, 3),
             jaxis=nan(nj, 3))
    Lq = T['ten_Lq'].reshape(meta.ntendon, meta.nq)
    ten = []
    for u in range(meta.ntendon):
        s = torch.zeros_like(qpos[:, 0])
        for q in range(meta.nq):
            s = s + Lq[u, q] * qpos[:, q]
        ten.append(s)
    X['ten'] = torch.stack(ten, 1)
    order = ([0] + T['level_body'].tolist()) if level_order else range(nb)
    for b in order:
        _body_frame(int(b), T, qpos, X)
    for name, cnt in (('geom', ng), ('site', ns)):
        frames = [_object_frame(g, T[f'{name}_body'], T[f'{name}_sf'],
                                T[f'{name}_pos'], T[f'{name}_quat'], X)
                  for g in range(cnt)]
        X[f'{name}_xpos'] = torch.stack([f[0] for f in frames], 1)
        X[f'{name}_xmat'] = torch.stack([f[1] for f in frames], 1)
    scom = T['mass'].reshape(nb, 1) * X['xipos']
    for b in range(nb - 1, 0, -1):
        p = int(T['parent'][b])
        scom[:, p] = scom[:, p] + scom[:, b]
    X['scom'] = scom * (1.0 / T['subtreemass'])[:, None]
    X['cinert'] = torch.stack([_cinert(b, T, X) for b in range(nb)], 1)
    X['cdof'] = torch.stack([_cdof(i, T, X) for i in range(meta.nv)], 1)
    return X


# The JAX package's outputs (tps.NAMES order) under this test's names.
KEYS = ('xpos', 'xquat', 'xmat', 'xipos', 'ximat', 'geom_xpos', 'geom_xmat',
        'site_xpos', 'site_xmat', 'scom', 'cinert', 'cdof', 'janc', 'jaxis',
        'ten')


def _qpos(meta, qpos0, n, seed):
    rng = np.random.RandomState(seed)
    q = np.tile(np.asarray(qpos0)[None], (n, 1))
    for j in range(meta.njnt):
        a = meta.jnt_qposadr[j]
        if meta.jnt_type[j] == 0:
            q[:, a:a + 3] += 0.05 * rng.randn(n, 3)
            q[:, a + 3:a + 7] += 0.2 * rng.randn(n, 4)
        else:
            q[:, a] += 0.3 * rng.randn(n)
    return q


@pytest.mark.parametrize('name', MODELS)
def test_k1_schedule_is_the_one_thread_loop_bit_for_bit(name):
    tm = tspec.load(MODELS[name], device='cpu', dtype=torch.float32)
    qpos = torch.as_tensor(_qpos(tm.meta, tm.np_arrays['qpos0'], B, 1),
                           dtype=torch.float32)
    new, old = k1(tm, qpos, True), k1(tm, qpos, False)
    for key in KEYS:
        assert not bool(torch.isnan(new[key]).any()), key
        assert torch.equal(new[key], old[key]), key


def test_k1_schedule_matches_jax_at_float64():
    jm = jspec.load(tspec.WALK_IMITATION_NPZ, dtype=np.float64)
    tm = tspec.load(device='cpu', dtype=torch.float64)
    qpos = _qpos(tm.meta, tm.np_arrays['qpos0'], B, 2)
    ref = jax.jit(jax.vmap(jps.make_pos_stage_pe(jm)))(jnp.asarray(qpos))
    out = k1(tm, torch.as_tensor(qpos), True)
    for key, want in zip(KEYS, ref):
        want = torch.as_tensor(np.array(want))
        got = out[key].reshape(want.shape)
        rows = want.abs().reshape(B, want.shape[1], -1).amax(-1)
        scale = rows.clamp(min=1e-6 * float(want.abs().max()))
        scale = scale.reshape(rows.shape + (1,) * (want.dim() - 2))
        err = (got - want).abs()
        bad = err > TOL * scale
        assert not bool(bad.any()), (
            f'{key}: {int(bad.sum())} entries off, worst '
            f'{float((err / scale).max()):.3e}')


@pytest.mark.parametrize('name', MODELS)
def test_k1_tables_walk_parents_first_and_stage_the_walk(name):
    tm = tspec.load(MODELS[name], device='cpu', dtype=torch.float32)
    meta = tm.meta
    p = tps.pack(tm)
    lbody, loff = p.table('level_body'), p.table('level_off')
    assert (lbody.tolist(), loff.tolist()) == tuple(
        a.tolist() for a in tfs.body_levels(meta))
    seen = {0}
    for lev in range(len(loff) - 1):
        level = lbody[loff[lev]:loff[lev + 1]].tolist()
        assert all(meta.body_parentid[b] in seen for b in level)
        assert not seen & set(level)
        seen |= set(level)
    assert seen == set(range(meta.nbody)) and len(lbody) == meta.nbody - 1
    assert p.nfs % 4 == 0 and p.nis % 4 == 0
    assert p.nfs <= len(p.floats) and p.nis <= len(p.ints)
    for t in ('qpos0', 'body_pos', 'body_quat', 'jnt_pos', 'jnt_axis'):
        i = p.fnames.index(t)
        assert p.ints[i] + len(p.table(t)) <= p.nfs, t
    for t in ('dims', 'parent', 'jntadr', 'jntnum', 'jnt_type',
              'jnt_qposadr', 'level_body', 'level_off'):
        i = p.nf + p.inames.index(t)
        assert p.ints[i] + len(p.table(t)) <= p.nis, t


# ------------------------------------------------------------- row 6


@pytest.fixture(scope='module')
def candidates():
    """The walk state's merged candidates at P 128 and P 32, float32."""
    tm = tspec.load(device='cpu', dtype=torch.float32)
    qpos = torch.as_tensor(_qpos(tm.meta, tm.np_arrays['qpos0'], 8, 3),
                           dtype=torch.float32)
    d, _, _ = kinematics.fwd_position_smooth(
        tm, make_data(tm, 8).replace(qpos=qpos))
    return {P: collision.merged_candidates(tm, d, P)[:3] for P in (128, 32)}


def _flat(t):
    return t.reshape(-1, t.shape[-1])


@pytest.mark.parametrize('P', (128, 32))
@pytest.mark.parametrize('window', (64, tmk.WINDOW))
def test_mpr_in_type_order_is_the_same_call_bit_for_bit(candidates, P,
                                                        window):
    c1, c2, prm = (_flat(t) for t in candidates[P])
    order = tmk.type_order(prm, window)
    n = len(order)
    inv = torch.argsort(order)
    assert torch.equal(order[inv], torch.arange(n))
    keys = tmk.pair_keys(prm)[order]
    win = order // window
    assert torch.equal(win, torch.arange(n) // window)  # stays in its window
    rank = win * 64 + keys
    assert bool((rank[1:] >= rank[:-1]).all())
    same = rank[1:] == rank[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())  # stable
    ref = tmk.mpr_merged_ref(c1, c2, prm, 8)
    got = tmk.mpr_merged_ref(c1[order], c2[order], prm[order], 8)
    for r, g in zip(ref, got):
        back = torch.empty_like(g)
        back[order] = g
        assert torch.equal(back, r)
    assert len(torch.unique(keys)) > 1


def _polish_where_smooth(c1, c2, prm, polish):
    """The kernel's polish rule: `polish` steps on smooth pairs, none on
    the others."""
    smooth = prm[:, 10] > 0.5
    out = None
    for mask, it in ((smooth, polish), (~smooth, 0)):
        if not bool(mask.any()):
            continue
        part = tmk.mpr_merged_ref(c1[mask], c2[mask], prm[mask], it)
        if out is None:
            out = [torch.empty((len(prm),) + t.shape[1:], dtype=t.dtype)
                   for t in part]
        for o, r in zip(out, part):
            o[mask] = r
    return out


@pytest.mark.parametrize('cylinders_only', (False, True),
                         ids=('walk', 'cylinder pairs'))
def test_mpr_polish_on_smooth_pairs_only_changes_nothing(candidates,
                                                         cylinders_only):
    c1, c2, prm = (_flat(t).clone() for t in candidates[128])
    if cylinders_only:
        prm[:, 8:10] = float(tspec.GEOM_CYLINDER)
        prm[:, 10] = 0.0
    smooth = prm[:, 10] > 0.5
    assert bool((~smooth).any())
    ref = tmk.mpr_merged_ref(c1, c2, prm, 8)
    got = _polish_where_smooth(c1, c2, prm, 8)
    for r, g in zip(ref, got):
        assert torch.equal(g, r)
    if not cylinders_only:  # polish does move some smooth pair's result
        off = tmk.mpr_merged_ref(c1, c2, prm, 0)
        assert not torch.equal(off[1][smooth], ref[1][smooth])
