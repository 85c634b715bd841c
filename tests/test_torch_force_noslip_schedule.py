"""The schedules of the force-stage kernel (K2) and the fused noslip (row 11)
in plain torch, on the CPU.

csrc/force_stage.cu runs an env in one block: velocities root to leaves a
body a thread, level by level (`force_stage.body_levels`); the leaf-to-root
sums a thread a component over the bodies in descending order; the packed
mass matrix a thread an entry, from `force_stage.mass_codes` (each entry's
(dof, ancestor dof) pair, armature or identity padding); passive forces a
dof a thread over the tendons in order; qfrc_actuator a dof a thread over
its nonzero moments (`force_stage.moment_lists`). `k2_schedule` below is
that schedule, built from the kernel's host tables; `k2_one_thread` is the
loop of the one-thread-per-env kernel it replaced, in its order.

  (a) at float64 the schedule's mass matrix and qfrc_actuator agree with
      the JAX package's `make_force_stage_pe` to 1e-12 of each entry's
      scale (the same sum over absolute values), on the walking model
      from a seeded state;
  (b) at float32 every quantity of the schedule is the one-thread loop's
      bit for bit (torch.equal): the reordering keeps every sum in its
      order.

csrc/noslip.cu sweeps only the slots with use > 0 (ascending), unless the
env's operands hold a non-finite value or the bound of its unlisted
columns of P = M^-1 J_t^T reaches 1e30; `noslip_listed` below is that
schedule, `arrow_bound` its bound.

  (c) perturbing every use = 0 slot's J_t, aref and lim by finite seeded
      values leaves `noslip_fused_ref`'s x and ft unchanged at float32
      (torch.equal), and the listed schedule agrees with it and with the
      JAX package's `_fused_ref` to 1e-12 at float64; the bound holds
      every unlisted column of P; an env with a NaN in its factor gives
      NaN x in the plain version, the listed schedule and the JAX
      reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.ops import force_stage as jfs
from flybody_tpu.ops import noslip_gs as jngs
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.ops import arrow as tarrow
from flybody_tpu_torch.ops import force_stage as tfs
from flybody_tpu_torch.ops import noslip_gs as tngs
from test_torch_solver_kernels import noslip_inputs, parts  # noqa: F401
from test_torch_stages import _inputs

TOL = 1e-12


# ------------------------------------------------------------ spatial algebra
# Each sum in the kernels' order (csrc/common.cuh), a rounding per operation.


def _dot6(a, b):
    s = torch.zeros_like(a[..., 0])
    for k in range(6):
        s = s + a[..., k] * b[..., k]
    return s


def _mat6vec(I, v):
    return torch.stack([_dot6(I[..., r, :], v) for r in range(6)], -1)


def _cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _motion_cross(v, m):
    return torch.cat([_cross3(v[..., :3], m[..., :3]),
                      _cross3(v[..., :3], m[..., 3:])
                      + _cross3(v[..., 3:], m[..., :3])], -1)


def _force_cross(v, f):
    return torch.cat([_cross3(v[..., :3], f[..., :3])
                      + _cross3(v[..., 3:], f[..., 3:]),
                      _cross3(v[..., :3], f[..., 3:])], -1)


# ------------------------------------------------------------------ K2


def _body_velocity(b, tab, cdof, qvel, cvel, cacc, cdd):
    """Body b's velocity, bias acceleration and cdof_dot from its
    parent's (the kernel's body_velocity)."""
    par = int(tab['parent'][b])
    v, a = cvel[:, par].clone(), cacc[:, par].clone()
    pend = torch.zeros_like(v)
    lo = int(tab['dofadr'][b])
    for i in range(lo, lo + int(tab['dofnum'][b])):
        c, q, kind = cdof[:, i], qvel[:, i, None], int(tab['dof_kind'][i])
        if kind != 1:
            v = v + pend
            pend = torch.zeros_like(v)
        if kind == 0:
            cd = torch.zeros_like(v)
            v = v + c * q
        else:
            cd = _motion_cross(v, c)
            if kind == 1:
                pend = pend + c * q
            else:
                v = v + c * q
        a = a + cd * q
        cdd[:, i] = cd
    cvel[:, b] = v + pend
    cacc[:, b] = a


def _actuator_forces(tab, qpos, qvel, act, ctrl, tlen, tvel):
    """actuator_force and act_dot, an actuator at a time."""
    A, nu = tab['act'].reshape(-1, 15), len(tab['act_adr'])
    afrc, adot = [], torch.zeros_like(act)
    for u in range(nu):
        r = A[u]
        c = torch.clamp(torch.clamp(ctrl[:, u], min=float(r[0])),
                        max=float(r[1]))
        ia = int(tab['act_adr'][u])
        a_u = act[:, ia] if ia >= 0 else torch.zeros_like(c)
        if ia >= 0:
            adot[:, ia] = (c - a_u) / float(r[2])
        inp = float(r[12]) * a_u + (1.0 - float(r[12])) * c
        if r[13] > 0:
            ln, vel = qpos[:, tab['act_q'][u]], qvel[:, tab['act_d'][u]]
        elif r[14] > 0:
            ln, vel = tlen[:, tab['act_q'][u]], tvel[:, tab['act_q'][u]]
        else:
            ln = vel = torch.zeros_like(c)
        ln, vel = ln * float(r[11]), vel * float(r[11])
        f = float(r[3]) * inp + float(r[7]) * (
            float(r[4]) + float(r[5]) * ln + float(r[6]) * vel)
        if r[8] > 0:
            f = torch.clamp(torch.clamp(f, min=float(r[9])), max=float(r[10]))
        afrc.append(f)
    return torch.stack(afrc, 1), adot


def _tables(model, dtype):
    """The kernel's tables by name: float tables as torch tensors of
    `dtype` (at float64 before their rounding to float32), int tables as
    numpy."""
    p = tfs.pack(model)
    out = {n: torch.as_tensor(p.table(n, dtype == torch.float64)).to(dtype)
           for n in p.fnames}
    out.update({n: p.table(n).astype(np.int64) for n in p.inames})
    return out


def k2_common(model, tab, qpos, qvel, act, ctrl, cdof, cinert, tlen, ff0,
              level_order: bool):
    """Velocities (level by level or in body order), RNE wrenches, the
    leaf-to-root sums, bias / fluid / buf, tendons, passive forces and
    actuator forces. ff0: per-body fluid wrenches (an input here: both
    schedules compute them a body at a time)."""
    B, nb, nv = qpos.shape[0], model.meta.nbody, model.meta.nv
    nan = torch.full((B, nb, 6), float('nan'), dtype=qpos.dtype)
    cvel, cacc = nan.clone(), nan.clone()
    cvel[:, 0] = 0.0
    cacc[:, 0, :3] = 0.0
    cacc[:, 0, 3:] = -tab['gravity']
    cdd = torch.full((B, nv, 6), float('nan'), dtype=qpos.dtype)
    order = (tab['level_body'] if level_order else range(1, nb))
    for b in order:
        _body_velocity(int(b), tab, cdof, qvel, cvel, cacc, cdd)
    fb = _mat6vec(cinert, cacc) + _force_cross(cvel, _mat6vec(cinert, cvel))
    ff, crb = ff0.clone(), cinert.clone()
    for b in range(nb - 1, 0, -1):  # a component at a time, same order
        par = int(tab['parent'][b])
        fb[:, par] = fb[:, par] + fb[:, b]
        ff[:, par] = ff[:, par] + ff[:, b]
        crb[:, par] = crb[:, par] + crb[:, b]
    db = tab['dof_body']
    bias, fluid = _dot6(cdof, fb[:, db]), _dot6(cdof, ff[:, db])
    buf = _mat6vec(crb[:, db], cdof)
    nt = tlen.shape[1]
    tJ = tab['ten_J'].reshape(nt, nv)
    tvel = []
    for t in range(nt):
        v = torch.zeros_like(qvel[:, 0])
        for i in range(nv):
            v = v + tJ[t, i] * qvel[:, i]
        tvel.append(v)
    tvel = torch.stack(tvel, 1)
    ls = tab['ten_ls'].reshape(nt, 2)
    disp = torch.where(tlen > ls[:, 1], tlen - ls[:, 1],
                       torch.where(tlen < ls[:, 0], tlen - ls[:, 0],
                                   torch.zeros_like(tlen)))
    frc = -tab['ten_stiff'] * disp - tab['ten_damp'] * tvel
    afrc, adot = _actuator_forces(tab, qpos, qvel, act, ctrl, tlen, tvel)
    return dict(cvel=cvel, cacc=cacc, cdd=cdd, fb=fb, ff=ff, crb=crb,
                bias=bias, fluid=fluid, buf=buf, tvel=tvel, frc=frc,
                afrc=afrc, adot=adot)


def _passive_first(tab, qpos, qvel):
    f = -tab['damping'] * qvel
    q = tab['dof_qadr']
    hinge = q >= 0
    spring = torch.zeros_like(f)
    spring[:, hinge] = tab['stiff'][hinge] * (
        qpos[:, q[hinge]] - tab['springref'][hinge])
    return torch.where(torch.as_tensor(hinge), f - spring, f)


def k2_schedule(model, *args, ff0):
    """The kernel's schedule: common part, then the mass matrix a packed
    entry at a time from the mass codes, passive forces a dof at a time
    over the tendons, qfrc_actuator a dof at a time over its moment list.
    Also each mass-matrix entry's and qfrc_actuator's |.|-sum scale."""
    qpos, qvel, act, ctrl, cdof, cinert, tlen = args
    tab = _tables(model, qpos.dtype)
    o = k2_common(model, tab, *args, ff0, level_order=True)
    code = torch.as_tensor(tab['mass_code'])
    live = code >= 0
    i, j, arm_on = code[live] >> 16, (code[live] >> 1) & 0x7fff, code[live] & 1
    B, nv = qpos.shape[0], model.meta.nv
    M = torch.where(code == -2, 1.0, 0.0).to(qpos.dtype).expand(B, -1).clone()
    val = _dot6(o['buf'][:, i], cdof[:, j])
    M[:, live] = val + torch.where(arm_on > 0, tab['armature'][i], 0.0)
    Ms = torch.zeros_like(M)
    Ms[:, live] = _dot6(o['buf'][:, i].abs(), cdof[:, j].abs()) + torch.where(
        arm_on > 0, tab['armature'][i].abs(), 0.0)
    nt = tlen.shape[1]
    tJ = tab['ten_J'].reshape(nt, nv)
    f = _passive_first(tab, qpos, qvel)
    for t in range(nt):
        f = f + tJ[t] * o['frc'][:, t, None]
    ptr, ks = tab['mom_ptr'], tab['mom_k']
    mc, mu = tab['mom_coef'], tab['mom_u']
    qact, qscale = [], []
    for d in range(nv):
        s, a = torch.zeros_like(qpos[:, 0]), torch.zeros_like(qpos[:, 0])
        for k in ks[ptr[d]:ptr[d + 1]]:
            s = s + mc[k] * o['afrc'][:, mu[k]]
            a = a + (mc[k] * o['afrc'][:, mu[k]]).abs()
        qact.append(s)
        qscale.append(a)
    nl, dm, nr = (int(tab['dims'][6]), int(tab['dims'][7]),
                  int(tab['dims'][8]))
    shape = (B, nl + 1, dm + nr, dm)
    return dict(o, M=M.reshape(shape), M_scale=Ms.reshape(shape),
                passive=f, qact=torch.stack(qact, 1),
                qact_scale=torch.stack(qscale, 1))


def k2_one_thread(model, *args, ff0):
    """The one-thread-per-env kernel's loops, in its order: the mass
    matrix by walking each dof's ancestor chain over the identity padding,
    passive forces a tendon at a time, qfrc_actuator over the moment list
    in its order."""
    qpos, qvel, act, ctrl, cdof, cinert, tlen = args
    meta = model.meta
    tab = _tables(model, qpos.dtype)
    o = k2_common(model, tab, *args, ff0, level_order=False)
    part = tarrow.build_partition(meta)
    nv, nl, dm, nr = meta.nv, len(part.ds), part.dmax, part.nr
    limb = np.full(nv, -1)
    pos = np.arange(nv)
    for li, (lo, d) in enumerate(zip(part.los, part.ds)):
        limb[lo:lo + d] = li
        pos[lo:lo + d] = np.arange(d)
    dpar = tfs._dof_parents(meta)
    B = qpos.shape[0]
    M = torch.zeros((B, nl + 1, dm + nr, dm), dtype=qpos.dtype)
    for li in range(nl):
        M[:, li, range(dm), range(dm)] = 1.0
    for i in range(nv):
        j = i
        while j >= 0:
            val = _dot6(o['buf'][:, i], cdof[:, j])
            li, ai, lj, aj = limb[i], pos[i], limb[j], pos[j]
            if li >= 0 and lj >= 0:
                if i == j:
                    val = val + tab['armature'][i]
                M[:, li, ai, aj] = val
                M[:, li, aj, ai] = val
            elif li >= 0:
                M[:, li, dm + aj, ai] = val
            else:
                if i == j:
                    val = val + tab['armature'][i]
                M[:, nl, ai, aj] = val
                M[:, nl, aj, ai] = val
            j = dpar[j]
    nt = tlen.shape[1]
    tJ = tab['ten_J'].reshape(nt, nv)
    pas = _passive_first(tab, qpos, qvel)
    for t in range(nt):
        pas = pas + tJ[t] * o['frc'][:, t, None]
    mom = model.np_arrays['actuator_moment']
    mu, md = np.nonzero(mom)
    mc = torch.as_tensor(mom[mu, md]).to(qpos.dtype)
    qact = torch.zeros_like(qvel)
    for k in range(len(mu)):
        qact[:, md[k]] = qact[:, md[k]] + mc[k] * o['afrc'][:, mu[k]]
    return dict(o, M=M, passive=pas, qact=qact)


K2_ARGS = (0, 1, 2, 3, 4, 5, 11)  # qpos qvel act ctrl cdof cinert ten_length


@pytest.fixture(scope='module')
def walk():
    d = _inputs(np.float64)
    fargs = [np.asarray(a) for a in d['fargs']]
    rng = np.random.RandomState(3)
    ff0 = 1e-3 * rng.randn(fargs[0].shape[0], d['jm'].meta.nbody, 6)
    return d, fargs, ff0


def _k2_args(fargs, dtype):
    a = [torch.as_tensor(np.array(fargs[i])).to(dtype) for i in K2_ARGS]
    B = a[0].shape[0]
    a[4] = a[4].reshape(B, -1, 6)
    a[5] = a[5].reshape(B, -1, 6, 6)
    return a


def test_k2_schedule_matches_jax_at_float64(walk):
    d, fargs, ff0 = walk
    tm = tspec.load(device='cpu', dtype=torch.float64)
    ref = jax.jit(jax.vmap(jfs.make_force_stage_pe(d['jm'])))(
        *map(jnp.asarray, fargs))
    out = k2_schedule(tm, *_k2_args(fargs, torch.float64),
                      ff0=torch.as_tensor(ff0))
    for name, got, want, scale in (
            ('qM', out['M'], ref[9], out['M_scale']),
            ('qfrc_actuator', out['qact'], ref[6], out['qact_scale'])):
        want = torch.as_tensor(np.asarray(want))
        assert got.shape == want.shape, name
        err = (got - want).abs()
        bad = err > TOL * scale.clamp(min=1e-300)
        assert not bool(bad.any()), (
            f'{name}: {int(bad.sum())} entries off, worst '
            f'{float((err / scale.clamp(min=1e-300)).max()):.3e}')
    # Both outputs are the JAX package's, and neither is trivial.
    assert float(out['qact'].abs().max()) > 0
    assert float((out['M'] - torch.as_tensor(np.asarray(ref[9]))).abs().max()
                 ) <= 1e-9 * float(out['M'].abs().max())


def test_k2_schedule_is_the_one_thread_loop_bit_for_bit(walk):
    d, fargs, ff0 = walk
    tm = tspec.load(device='cpu', dtype=torch.float32)
    args = _k2_args(fargs, torch.float32)
    ff = torch.as_tensor(ff0).float()
    new = k2_schedule(tm, *args, ff0=ff)
    old = k2_one_thread(tm, *args, ff0=ff)
    for name in ('cvel', 'cacc', 'cdd', 'fb', 'ff', 'crb', 'bias', 'fluid',
                 'buf', 'tvel', 'frc', 'afrc', 'adot', 'M', 'passive',
                 'qact'):
        assert not bool(torch.isnan(new[name]).any()), name
        assert torch.equal(new[name], old[name]), name


def test_k2_tables_walk_parents_first_and_cover_the_matrix():
    """The levels put every body after its parent; the mass codes name
    each live entry once per (i, j) orientation and pad the limb
    diagonals; the moment lists hold every nonzero moment once, in
    order."""
    tm = tspec.load(device='cpu', dtype=torch.float32)
    meta = tm.meta
    lbody, loff = tfs.body_levels(meta)
    seen = {0}
    for lev in range(len(loff) - 1):
        level = lbody[loff[lev]:loff[lev + 1]]
        assert all(meta.body_parentid[b] in seen for b in level)
        seen |= set(int(b) for b in level)
    assert seen == set(range(meta.nbody))
    code = tfs.mass_codes(meta, tarrow.build_partition(meta))
    live = code[code >= 0]
    i, j = live >> 16, (live >> 1) & 0x7fff
    assert (j <= i).all()
    assert ((live & 1) == (i == j)).all()
    mom = tm.np_arrays['actuator_moment']
    mu, md = np.nonzero(mom)
    ptr, ks = tfs.moment_lists(md, meta.nv)
    assert sorted(ks.tolist()) == list(range(len(mu)))
    for dof in range(meta.nv):
        kk = ks[ptr[dof]:ptr[dof + 1]]
        assert (md[kk] == dof).all() and (np.diff(kk) > 0).all()


# ------------------------------------------------------------------ row 11


def arrow_bound(part, F, b):
    """The kernel's guard bound for one env: the substitution with |F| and
    sums of absolute values on b >= 0 (dof layout)."""
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    F, y = F.abs(), b.clone()
    for l, (lo, d) in enumerate(zip(part.los, part.ds)):
        for k in range(d):
            y[lo + k] = (y[lo + k] + (F[l, k, :k] * y[lo:lo + k]).sum()
                         ) / F[l, k, k]
    for r in range(nr):
        y[r] = y[r] + sum((F[l, dm + r, :d] * y[lo:lo + d]).sum()
                          for l, (lo, d) in enumerate(zip(part.los, part.ds)))
    LR = F[nl, :nr, :nr]
    for k in range(nr):
        y[k] = (y[k] + (LR[k, :k] * y[:k]).sum()) / LR[k, k]
    for k in reversed(range(nr)):
        y[k] = (y[k] + (LR[k + 1:, k] * y[k + 1:nr]).sum()) / LR[k, k]
    for l, (lo, d) in enumerate(zip(part.los, part.ds)):
        y[lo:lo + d] = y[lo:lo + d] + (F[l, dm:, :d] * y[:nr, None]).sum(0)
        for k in reversed(range(d)):
            y[lo + k] = (y[lo + k] + (F[l, k + 1:d, k] * y[lo + k + 1:lo + d]
                                      ).sum()) / F[l, k, k]
    return y


def noslip_listed(part, F, Jt, aref_t, lim, use, x0, ft0, iterations):
    """Row 11's schedule: per env the slots with use > 0 in ascending
    order (their columns of P, their inverses, their sweeps), or every
    slot when an operand is not finite or the bound of the unlisted
    columns reaches 1e30."""
    B, K = use.shape
    xs, fts = [], []
    for e in range(B):
        listed = torch.nonzero(use[e] > 0).flatten()
        ops = (F[e], Jt[e], x0[e], ft0[e])
        full = not all(bool(torch.isfinite(t).all()) for t in ops)
        if not full and len(listed) < K:
            off = ~(use[e] > 0)
            bnd = Jt[e, off].abs().amax((0, 1))
            full = not bool((arrow_bound(part, F[e], bnd) < 1e30).all())
        slots = torch.arange(K) if full else listed
        n = len(slots)
        J = Jt[e:e + 1, slots]
        P = tarrow.solve_ref(part, F[e:e + 1],
                             J.reshape(1, 2 * n, -1).transpose(1, 2))
        P = P.reshape(1, -1, n, 2).permute(0, 2, 3, 1)
        x, ft = tngs.gs_ref(J, P, tngs.block_inverses(J, P),
                            aref_t[e:e + 1, slots], lim[e:e + 1, slots],
                            use[e:e + 1, slots], x0[e:e + 1],
                            ft0[e:e + 1, slots], iterations)
        ft_all = ft0[e].clone()
        ft_all[slots] = ft[0]
        xs.append(x[0])
        fts.append(ft_all)
    return torch.stack(xs), torch.stack(fts)


K_NS = 64


@pytest.fixture(scope='module')
def noslip64():
    args = [torch.as_tensor(a) for a in noslip_inputs(np.float64, K_ns=K_NS)]
    use = args[4]
    assert bool((use == 0).any()) and bool((use > 0).any())
    rng = np.random.RandomState(11)
    pert = [a.clone() for a in args]
    off = use == 0
    for i, scale in ((1, 10.0), (2, 5.0), (3, 3.0)):
        noise = torch.as_tensor(scale * rng.randn(*args[i].shape))
        mask = off.reshape(off.shape + (1,) * (args[i].dim() - 2))
        pert[i] = torch.where(mask, args[i] + noise, args[i])
    return args, pert


def test_noslip_unlisted_slots_change_nothing_at_float32(parts, noslip64):
    _, tp = parts
    args, pert = noslip64
    a32 = [t.float() for t in args]
    p32 = [t.float() for t in pert]
    assert not torch.equal(a32[1], p32[1])
    x, ft = tngs.noslip_fused_ref(tp, *a32, 3)
    xp, ftp = tngs.noslip_fused_ref(tp, *p32, 3)
    assert torch.equal(x, xp) and torch.equal(ft, ftp)
    assert not torch.equal(ft, a32[6])  # the sweeps moved the forces


def test_noslip_listed_schedule_matches_plain_and_jax(parts, noslip64):
    jp, tp = parts
    _, pert = noslip64
    ref = jax.jit(jax.vmap(lambda *a: jngs._fused_ref(jp, 3, *a)))(
        *(jnp.asarray(t.numpy()) for t in pert))
    plain = tngs.noslip_fused_ref(tp, *pert, 3)
    got = noslip_listed(tp, *pert, 3)
    for name, o, p, r in zip(('x', 'ft'), got, plain, ref):
        r = torch.as_tensor(np.asarray(r))
        scale = float(r.abs().max())
        assert float((o - r).abs().max()) <= TOL * scale, name
        assert float((o - p).abs().max()) <= TOL * scale, name


def test_noslip_bound_holds_the_unlisted_columns(parts, noslip64):
    _, tp = parts
    args, _ = noslip64
    F, Jt, use = args[0], args[1], args[4]
    B, K = use.shape
    P = tarrow.solve_ref(tp, F, Jt.reshape(B, 2 * K, -1).transpose(1, 2))
    P = P.reshape(B, -1, K, 2).permute(0, 2, 3, 1)  # (B, K, 2, nv)
    for e in range(B):
        off = use[e] == 0
        bnd = arrow_bound(tp, F[e], Jt[e, off].abs().amax((0, 1)))
        assert bool((P[e, off].abs() <= bnd * (1 + 1e-12)).all())
        assert float(bnd.max()) < 1e30


def test_noslip_nan_factor_gives_nan_x_in_every_version(parts, noslip64):
    jp, tp = parts
    args, _ = noslip64
    bad = [t.clone() for t in args]
    bad[0][0, 0, 3, 1] = float('nan')
    ref = jax.jit(jax.vmap(lambda *a: jngs._fused_ref(jp, 3, *a)))(
        *(jnp.asarray(t.numpy()) for t in bad))
    for x, _ in (tngs.noslip_fused_ref(tp, *bad, 3),
                 noslip_listed(tp, *bad, 3),
                 tuple(torch.as_tensor(np.asarray(r)) for r in ref)):
        assert bool(torch.isnan(x[0]).all())
        assert bool(torch.isfinite(x[1:]).all())
