"""The schedules of the sensor stage (K4) and the arrow factor+solve (K3)
in plain torch, on the CPU.

csrc/sens_stage.cu runs an env in one block and forms only what the
sensors read (`sens_stage.plan`): the accelerations a (body, component) a
thread over the dofs of each body's chain of ancestors from the world
(`acc`, `dofs`, `dof_off`), for the bodies of the force sensors' subtrees (`need`) and
the accelerometers'; the contact wrenches a contact a thread (both
sides); the body forces of `need` a body a thread, each subtracting the
wrenches on its body in contact order, side 0 before side 1, times the
contact's active flag; the subtree sums a (top force-sensor body,
component) a thread over its descendants in descending id (`tops`, `sub`,
`sub_off`); the sensors a sensor a thread. `k4(..., schedule=True)` below
is that schedule, built from the kernel's host tables (`sens_stage.pack`);
`schedule=False` is the loop of the one-thread-per-env kernel it replaced,
which formed every body's acceleration and internal force. Accelerations
and internal forces start as NaN, so a value read before it is written, or
never written, shows.

  (a) at float32 the schedule is the one-thread loop bit for bit
      (torch.equal, NaN in the same places) on the walking and the two-fly
      models, on clean operands and on edge envs (an inactive contact with
      a NaN force, contacts on the world body on either side, both sides of
      a contact on one body); at float64 it agrees with the JAX package's
      `make_sens_stage_pe` to 1e-12 of each sensor's scale (its largest
      |value| in the JAX output, floored at 1e-6 of the largest overall);
  (b) each body's acceleration terms are the dofs of its chain from the
      world's child down to it (a parent's before its child's); each top's
      list is its descendants in
      descending id, so each parent's children are summed into it in
      descending id after their own children; `need` is the union of the
      tops' subtrees and holds every force sensor's body, and `acc` adds
      the accelerometers' bodies.

csrc/arrow.cu's packed one-right-hand-side kernel (K3) spreads a limb's
forward substitution over its rows: at step i the owner of row i divides
its running sum by D[i, i], and every row k > i subtracts D[k, i] y[i].

  (c) at float32 that spread is the one-lane row form (y[k] = (b[k] -
      sum_{i<k} D[k, i] y[i]) / D[k, k], terms in order) bit for bit
      (torch.equal) on the kernel's factor of the walking model's packed
      mass matrix (with a damped diagonal, as Euler's operand) and of a
      random block-arrow matrix; at float64 the whole factor+solve in the
      kernel's schedule agrees with the JAX package's arrow `factor_ref_p`
      and `solve_ref` to 1e-12 of each entry's scale (the largest |value|
      of its limb block, root block or x).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.model import spec as jspec
from flybody_tpu.ops import arrow as jarrow
from flybody_tpu.ops import sens_stage as jss
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.ops import arrow as tarrow
from flybody_tpu_torch.ops import sens_stage as tss
from flybody_tpu_torch.physics import sensors as tsens

B = 3
K = 12
TOL = 1e-12
MODELS = {'walk': tspec.WALK_IMITATION_NPZ, 'two_fly': tspec.TWO_FLY_NPZ}


def same(a, b) -> bool:
    """torch.equal with NaN in the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, torch.zeros_like(a), a),
        torch.where(nb, torch.zeros_like(b), b)))


# ------------------------------------------------------------------ K4
# Each expression in csrc/common.cuh's order, a rounding per operation.


def _cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _matTvec(m, v):
    return torch.stack([m[..., 0] * v[..., 0] + m[..., 3] * v[..., 1]
                        + m[..., 6] * v[..., 2],
                        m[..., 1] * v[..., 0] + m[..., 4] * v[..., 1]
                        + m[..., 7] * v[..., 2],
                        m[..., 2] * v[..., 0] + m[..., 5] * v[..., 1]
                        + m[..., 8] * v[..., 2]], -1)


def _mat6vec(inert, v):
    cols = []
    for r in range(6):
        s = torch.zeros_like(v[..., 0])
        for c in range(6):
            s = s + inert[..., r, c] * v[..., c]
        cols.append(s)
    return torch.stack(cols, -1)


def _force_cross(v, f):
    a, b, c = _cross3(v[..., :3], f[..., :3]), _cross3(
        v[..., 3:], f[..., 3:]), _cross3(v[..., :3], f[..., 3:])
    return torch.cat([a + b, c], -1)


def _tables(model, dtype):
    p = tss.pack(model)
    out = {n: torch.as_tensor(p.table(n, dtype == torch.float64)).to(dtype)
           for n in p.fnames}
    out.update({n: p.table(n).astype(np.int64) for n in p.inames})
    return out


def _wrench(c, T, cpos, cn, cb12, fc, scom):
    """Contact c's (torque; force) and body for each side, (n,) envs."""
    n = cn[:, c]
    helper = torch.zeros_like(n)
    flip = n[:, 0].abs() > 0.9
    helper[:, 0] = torch.where(flip, 0.0, 1.0)
    helper[:, 2] = torch.where(flip, 1.0, 0.0)
    t1 = _cross3(n, helper)
    dot = t1[:, 0] * t1[:, 0] + t1[:, 1] * t1[:, 1] + t1[:, 2] * t1[:, 2]
    inv = 1.0 / torch.clamp(torch.sqrt(dot), min=1e-15)
    t1 = t1 * inv[:, None]
    t2 = _cross3(n, t1)
    f = fc[:, c]
    fw = f[:, :1] * n + f[:, 1:2] * t1 + f[:, 2:3] * t2
    env = torch.arange(cn.shape[0])
    out = []
    for side in (0, 1):
        b = torch.round(cb12[:, 1 - side, c]).long()
        fs = fw if side == 0 else -fw
        ref = scom[env, torch.as_tensor(T['root'])[b]]
        tq = _cross3(cpos[:, c] - ref, fs)
        out.append((b, tq, fs))
    return out


def k4(model, args, schedule: bool) -> torch.Tensor:
    """sensordata in the kernel's schedule (schedule) or the one-thread
    loop's."""
    (qacc, qvel, cvel, cdof, cdd, cinert, spos, smat, scom, cpos, cn, cb12,
     cact, fc) = args
    meta = model.meta
    T = _tables(model, qacc.dtype)
    n, nb, Kc = qacc.shape[0], meta.nbody, cact.shape[1]
    env = torch.arange(n)
    parent = T['parent']
    cacc = torch.full((n, nb, 6), float('nan'), dtype=qacc.dtype)
    world = torch.cat([torch.zeros(3, dtype=qacc.dtype), -T['gravity']])

    def dof_terms(a, b):
        adr = meta.body_dofadr[b]
        for i in range(adr, adr + meta.body_dofnum[b]):
            a = a + (cdof[:, i] * qacc[:, i:i + 1]
                     + cdd[:, i] * qvel[:, i:i + 1])
        return a
    if schedule:  # each body over the dofs of its chain of ancestors
        off = T['dof_off']
        for j, b in enumerate(T['acc']):
            a = world.expand(n, 6)
            for i in T['dofs'][off[j]:off[j + 1]]:
                a = a + (cdof[:, i] * qacc[:, i:i + 1]
                         + cdd[:, i] * qvel[:, i:i + 1])
            cacc[:, b] = a
    else:  # every body, in id order, from its parent's
        cacc[:, 0] = world
        for b in range(1, nb):
            cacc[:, b] = dof_terms(cacc[:, parent[b]].clone(), b)
    bodies = T['need'] if schedule else np.arange(nb)
    fint = torch.full((n, nb, 6), float('nan'), dtype=qacc.dtype)
    Iv = _mat6vec(cinert[:, bodies], cvel[:, bodies])
    fint[:, bodies] = (_mat6vec(cinert[:, bodies], cacc[:, bodies])
                       + _force_cross(cvel[:, bodies], Iv))
    wr = [_wrench(c, T, cpos, cn, cb12, fc, scom) for c in range(Kc)]
    if schedule:  # a body a thread, over the wrenches in order
        ids = torch.as_tensor(bodies)
        for c in range(Kc):
            for b, tq, fs in wr[c]:
                on = (b[:, None] == ids)[..., None]
                act = cact[:, c, None, None]
                w = torch.cat([tq, fs], -1)[:, None]
                fint[:, ids] = torch.where(on, fint[:, ids] - w * act,
                                           fint[:, ids])
    else:  # a contact at a time, side 0 then side 1
        for c in range(Kc):
            for b, tq, fs in wr[c]:
                act = cact[:, c, None]
                fint[env, b] = fint[env, b] - torch.cat([tq, fs], -1) * act
    if schedule:  # a top at a time, its descendants in descending id
        soff = T['sub_off']
        for j in range(len(soff) - 1):
            for b in T['sub'][soff[j]:soff[j + 1]]:
                fint[:, parent[b]] = fint[:, parent[b]] + fint[:, b]
    else:
        for b in range(nb - 1, 0, -1):
            fint[:, parent[b]] = fint[:, parent[b]] + fint[:, b]
    segs = []
    sens = T['sens'].reshape(-1, 5)
    for typ, site, adr, dim, b in sens.tolist():
        R = smat[:, site].reshape(n, 9)
        w, v = cvel[:, b, :3], cvel[:, b, 3:]
        arm = spos[:, site] - scom[:, int(T['root'][b])]
        vat = _cross3(w, arm) + v
        if typ == 3:  # gyro
            val = _matTvec(R, w)
        elif typ == 2:  # velocimeter
            val = _matTvec(R, vat)
        elif typ == 1:  # accelerometer
            wa = cacc[:, b]
            acc = wa[:, 3:] + _cross3(wa[:, :3], arm) + _cross3(w, vat)
            val = _matTvec(R, acc)
        elif typ == 4:  # force
            val = _matTvec(R, fint[:, b, 3:])
        else:  # touch
            tot = torch.zeros_like(qacc[:, 0])
            for c in range(Kc):
                inv = (((cb12[:, 0, c] - b).abs() < 0.5)
                       | ((cb12[:, 1, c] - b).abs() < 0.5))
                tot = torch.where(inv, tot + torch.clamp(fc[:, c, 0], min=0.0)
                                  * cact[:, c], tot)
            val = tot[:, None]
        segs.append(val[:, :dim])
    out = torch.cat(segs, -1)
    cut = T['cutoff']
    return torch.where(cut > 0, torch.minimum(torch.maximum(out, -cut), cut),
                       out)


def _sens_args(meta, seed, dtype, edge=False):
    """Seeded numpy operands of the sensor stage, (B envs, K slots); edge:
    env 0 has an inactive contact with a NaN force, env 1 contacts on the
    world body on either side, env 2 both sides of a contact on one body."""
    rng = np.random.RandomState(seed)
    nv, nb, ns = meta.nv, meta.nbody, meta.nsite
    cn = rng.randn(B, K, 3)
    cn /= np.linalg.norm(cn, axis=-1, keepdims=True)
    cn[:, 0] = [0.95, 0.3, 0.1]  # the helper axis flips
    cb12 = rng.randint(1, nb, (B, 2, K)).astype(np.float64)
    cb12[:, :, -1] = 0.0  # a contact with the world on both sides
    act = (rng.rand(B, K) < 0.7).astype(np.float64)
    fc = rng.randn(B, K, 3)
    if edge:
        act[0, 1], fc[0, 1] = 0.0, np.nan
        cb12[1, 0, 0:2] = 0.0
        cb12[1, 1, 2] = 0.0
        act[1, 0:3] = 1.0
        cb12[2, 0, 3] = cb12[2, 1, 3]
        act[2, 3] = 1.0
    arrays = (rng.randn(B, nv), rng.randn(B, nv), rng.randn(B, nb, 6),
              rng.randn(B, nv, 6), rng.randn(B, nv, 6),
              rng.randn(B, nb, 6, 6), rng.randn(B, ns, 3),
              rng.randn(B, ns, 3, 3), rng.randn(B, nb, 3),
              rng.randn(B, K, 3), cn, cb12, act, 10.0 * fc)
    return tuple(torch.as_tensor(a, dtype=dtype) for a in arrays)


@pytest.mark.parametrize('edge', (False, True), ids=('clean', 'edge envs'))
@pytest.mark.parametrize('name', MODELS)
def test_k4_schedule_is_the_one_thread_loop_bit_for_bit(name, edge):
    tm = tspec.load(MODELS[name], device='cpu', dtype=torch.float32)
    args = _sens_args(tm.meta, 4, torch.float32, edge)
    new, old = k4(tm, args, True), k4(tm, args, False)
    assert same(new, old)
    nan = torch.isnan(new)
    if edge:  # the NaN force reaches the force sensors of env 0 only
        assert bool(nan[0].any()) and not bool(nan[1:].any())
    else:
        assert not bool(nan.any())


def test_k4_schedule_matches_jax_at_float64():
    jm = jspec.load(tspec.WALK_IMITATION_NPZ, dtype=np.float64)
    tm = tspec.load(device='cpu', dtype=torch.float64)
    args = _sens_args(tm.meta, 5, torch.float64)
    ref = jax.jit(jax.vmap(jss.make_sens_stage_pe(jm)))(
        *(jnp.asarray(a.numpy()) for a in args))
    want = torch.as_tensor(np.array(ref))
    got = k4(tm, args, True)
    cols = want.abs().amax(0)
    scale = cols.clamp(min=1e-6 * float(want.abs().max()))
    err = (got - want).abs() / scale
    assert float(err.max()) <= TOL, float(err.max())


@pytest.mark.parametrize('name', MODELS)
def test_k4_tables_walk_parents_first_and_sum_children_in_order(name):
    tm = tspec.load(MODELS[name], device='cpu', dtype=torch.float32)
    meta = tm.meta
    par = list(meta.body_parentid)
    p = tss.pack(tm)
    T = {n: p.table(n).tolist() for n in p.inames}
    pl = {k: v.tolist() for k, v in tss.plan(
        meta, tsens.sensor_rows(meta)).items()}
    assert pl == {k: v.tolist() for k, v in p.plan.items()}
    assert {k: pl[k] for k in ('need', 'sub', 'sub_off', 'acc', 'dofs',
                               'dof_off')} == {
        k: T[k] for k in ('need', 'sub', 'sub_off', 'acc', 'dofs',
                          'dof_off')}
    T['tops'] = pl['tops']  # host only: it sizes the launch
    sens = np.array(T['sens']).reshape(-1, 5)
    force = {int(s[4]) for s in sens if s[0] == 4}
    accel = {int(s[4]) for s in sens if s[0] == 1}

    def desc(b):
        return {c for c in range(1, meta.nbody)
                if b in _ancestors(par, c)}
    for j, b in enumerate(T['acc']):  # the world's child down to b
        path = list(reversed([b] + _ancestors(par, b)[:-1]))
        want = [i for x in path for i in range(
            meta.body_dofadr[x], meta.body_dofadr[x] + meta.body_dofnum[x])]
        assert T['dofs'][T['dof_off'][j]:T['dof_off'][j + 1]] == want
    assert set(T['tops']) <= force
    assert all(not set(_ancestors(par, b)) & force for b in T['tops'])
    for j, top in enumerate(T['tops']):
        sub = T['sub'][T['sub_off'][j]:T['sub_off'][j + 1]]
        assert sub == sorted(desc(top), reverse=True)
        for pos, b in enumerate(sub):  # b's children were summed before
            assert all(sub.index(c) < pos for c in range(meta.nbody)
                       if c and par[c] == b)
    need = {x for b in T['tops'] for x in desc(b) | {b}}
    assert T['need'] == sorted(need) and force <= need
    assert T['acc'] == sorted(need | accel)
    assert p.dims.tolist()[-3:] == [len(T['acc']), len(T['need']),
                                    len(T['tops'])]


def _ancestors(par, b):
    out = []
    while b != 0:
        b = par[b]
        out.append(b)
    return out


# ------------------------------------------------------------------ K3


def _factor(part, Mp):
    """The kernel's factor (k3_limb_factor, k3_root_factor) in place on a
    copy: the column loop of each limb block and its border, the Schur
    complement, the root block's loop."""
    F = Mp.clone()
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    for li, d in enumerate(part.ds):
        D = F[:, li]  # (n, dm + nr, dm), rows [0, d) and the border
        rows = list(range(d)) + list(range(dm, dm + nr))
        for k in range(d):
            inv = torch.rsqrt(torch.clamp(D[:, k, k], min=1e-30))
            low = [i for i in rows if i >= k]
            D[:, low, k] = D[:, low, k] * inv[:, None]
            for j in range(k + 1, d):
                tgt = [i for i in rows if i >= j]
                D[:, tgt, j] = D[:, tgt, j] - D[:, tgt, k] * D[:, j, k, None]
        for i in range(d):
            D[:, i, i + 1:] = 0.0
    R = F[:, nl]
    S = R[:, :nr, :nr].clone()
    for li, d in enumerate(part.ds):
        LB = F[:, li, dm:dm + nr, :d]
        for k in range(d):
            S = S - LB[:, :, None, k] * LB[:, None, :, k]
    R[:, :nr, :nr] = S
    for k in range(nr):
        inv = torch.rsqrt(torch.clamp(R[:, k, k], min=1e-30))
        R[:, k:nr, k] = R[:, k:nr, k] * inv[:, None]
        for j in range(k + 1, nr):
            R[:, j:nr, j] = R[:, j:nr, j] - R[:, j:nr, k] * R[:, j, k, None]
    for r in range(nr):
        R[:, r, r + 1:nr] = 0.0
    return F


def _forward_rows(D, y, d):
    """The one-lane chain: row k from its terms i = 0..k-1 in order."""
    y = y.clone()
    for k in range(d):
        s = y[:, k]
        for i in range(k):
            s = s - D[:, k, i] * y[:, i]
        y[:, k] = s / D[:, k, k]
    return y


def _forward_spread(D, y, d):
    """The kernel's spread: at step i, y[i] divided, then every row k > i
    subtracts D[k, i] y[i]."""
    s = y.clone()
    for i in range(d):
        s[:, i] = s[:, i] / D[:, i, i]
        s[:, i + 1:d] = s[:, i + 1:d] - D[:, i + 1:d, i] * s[:, i, None]
    return s


def k3(part, Mp, b, spread=True):
    """(F, x) in the kernel's schedule."""
    F = _factor(part, Mp)
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    x = b.clone()
    fwd = _forward_spread if spread else _forward_rows
    for li, (lo, d) in enumerate(zip(part.los, part.ds)):
        x[:, lo:lo + d] = fwd(F[:, li], x[:, lo:lo + d], d)
    for r in range(nr):  # the root right-hand side, limbs and dofs in order
        s = x[:, r]
        for li, (lo, d) in enumerate(zip(part.los, part.ds)):
            for k in range(d):
                s = s - F[:, li, dm + r, k] * x[:, lo + k]
        x[:, r] = s
    LR = F[:, nl]
    for k in range(nr):
        s = x[:, k]
        for i in range(k):
            s = s - LR[:, k, i] * x[:, i]
        x[:, k] = s / LR[:, k, k]
    for k in range(nr - 1, -1, -1):
        s = x[:, k]
        for i in range(k + 1, nr):
            s = s - LR[:, i, k] * x[:, i]
        x[:, k] = s / LR[:, k, k]
    for li, (lo, d) in enumerate(zip(part.los, part.ds)):
        D = F[:, li]
        for a in range(d):  # the border terms, a row a lane
            s = x[:, lo + a]
            for r in range(nr):
                s = s - D[:, dm + r, a] * x[:, r]
            x[:, lo + a] = s
        for k in range(d - 1, -1, -1):
            s = x[:, lo + k]
            for i in range(k + 1, d):
                s = s - D[:, i, k] * x[:, lo + i]
            x[:, lo + k] = s / D[:, k, k]
    return F, x


def _operands(part, kind, dtype):
    """A packed SPD matrix and a right-hand side: the walking model's
    mass matrix at a perturbed pose with a damped diagonal (Euler's
    operand), or a random block-arrow matrix."""
    rng = np.random.RandomState(7)
    nv = part.nv
    if kind == 'walk mass matrix':
        from flybody_tpu_torch.physics import kinematics, smooth
        from flybody_tpu_torch.physics.state import make_data
        tm = tspec.load(device='cpu', dtype=torch.float64)
        q = np.tile(tm.np_arrays['qpos0'], (B, 1))
        q[:, 7:] += 0.2 * rng.randn(B, tm.meta.nq - 7)
        d = kinematics.fwd_position_smooth(
            tm, make_data(tm, B).replace(qpos=torch.as_tensor(q)))[0]
        Mp = smooth.crb_packed(tm, d).qM
        Mp = tarrow.add_diag_packed(part, Mp, tm.timestep * tm.dof_damping)
    else:
        A = np.zeros((B, nv, nv))
        nr = part.nr
        for lo, dd in zip(part.los, part.ds):
            G = rng.randn(B, dd, dd)
            A[:, lo:lo + dd, lo:lo + dd] = G @ G.transpose(0, 2, 1) + dd * \
                np.eye(dd)
            A[:, :nr, lo:lo + dd] = 0.3 * rng.randn(B, nr, dd)
            A[:, lo:lo + dd, :nr] = A[:, :nr, lo:lo + dd].transpose(0, 2, 1)
        G = rng.randn(B, nr, nr)
        A[:, :nr, :nr] = G @ G.transpose(0, 2, 1) + 50.0 * np.eye(nr)
        Mp = tarrow.pack_sym_ref(part, torch.as_tensor(A))
    b = torch.as_tensor(100.0 * rng.randn(B, nv))
    return Mp.to(dtype), b.to(dtype)


KINDS = ('walk mass matrix', 'random block-arrow')


@pytest.fixture(scope='module')
def part():
    return tarrow.build_partition(tspec.load(device='cpu').meta)


@pytest.mark.parametrize('kind', KINDS)
def test_k3_spread_substitution_is_the_row_form_bit_for_bit(part, kind):
    Mp, b = _operands(part, kind, torch.float32)
    F, x = k3(part, Mp, b, spread=True)
    Fr, xr = k3(part, Mp, b, spread=False)
    assert torch.equal(F, Fr)
    assert torch.equal(x, xr)
    assert bool(torch.isfinite(x).all())
    for li, (lo, d) in enumerate(zip(part.los, part.ds)):  # and per limb
        y = b[:, lo:lo + d] + 1.0
        assert torch.equal(_forward_spread(F[:, li], y, d),
                           _forward_rows(F[:, li], y, d)), li


@pytest.mark.parametrize('kind', KINDS)
def test_k3_schedule_matches_jax_at_float64(part, kind):
    Mp, b = _operands(part, kind, torch.float64)
    F, x = k3(part, Mp, b)
    jp = jarrow.build_partition(jspec.load(tspec.WALK_IMITATION_NPZ,
                                           dtype=np.float64).meta)
    Fj = jax.vmap(lambda m: jarrow.factor_ref_p(jp, m))(jnp.asarray(
        Mp.numpy()))
    xj = jax.vmap(lambda f, r: jarrow.solve_ref(jp, f, r))(
        Fj, jnp.asarray(b.numpy()))
    Fj, xj = torch.as_tensor(np.array(Fj)), torch.as_tensor(np.array(xj))
    blocks = Fj.abs().amax((2, 3), keepdim=True)  # per limb / root block
    assert float(((F - Fj).abs() / blocks).max()) <= TOL
    scale = xj.abs().amax(1, keepdim=True)
    assert float(((x - xj).abs() / scale).max()) <= TOL
