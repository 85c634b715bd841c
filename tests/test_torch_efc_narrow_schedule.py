"""The schedules of the contact rows (row 7) and the analytic narrowphase
(row 5) in plain torch, on the CPU.

csrc/efc_stage.cu selects an env's K candidates with the smallest score
(dist - includemargin) by a radix select: each score's 32-bit key
(`sort_key`'s high word: order-preserving bits, -0 as +0, NaN largest),
8-bit digit histograms over the keys (at most 4 passes: an env stops once
its K-th smallest key is the last of its digit's keys) for the K-th
smallest key, then, where that key's tie is split, over the tied
candidates' indices (1-2 passes); the keys at or below it are ranked
among themselves by their 64-bit (key, index) value. `radix_select` below
is that schedule.

  (a) it selects what `collision.smallest` (a stable sort) selects, in
      its order, exactly: on the candidates of a walk_imitation state at
      each preset's widths (C 430 and 222) and of the dense make_efc (C
      2,048), and on edge scores (ties, -0 / +0, +-inf, NaN, 1e10), for K
      1, 24, 64 and C; on the finite candidates also what the JAX
      package's `jax.lax.top_k(-score, k)` (solver.py:367) selects.

csrc/narrowphase.cu gives each (env, pair) of its table
(`narrowphase.pair_table`: type, geom1, geom2, first slot) one thread,
which gathers its two geoms' poses and writes the pair's rows at slots
first .. first + k - 1.

  (b) on the compact and dense segment tables of the walking model and
      the compact one of the two-fly scene, the pair table names the
      segments' pairs and writes every slot exactly once; the pair rows
      by the table are the plain version's bit for bit.

csrc/efc_stage.cu gives a half-warp a slot's three con_J rows (the
rank-count kernel gave it one row) and sends a warp's two slots' six
contiguous rows from a shared staging buffer by bulk.cuh `store_floats`
(the 16-byte aligned middle by one bulk store, the floats around it by
plain stores), by tiles of 64 slots; each row is computed as the
rank-count kernel computed it: lane j of the half-warp over the dofs v = j
mod 16, ascending, each entry the 6-term sum g . cdof[v] times the mask
difference, the row's velocity summed in that order and reduced by the
xor tree 8, 4, 2, 1.

  (c) `store_floats` writes every float of a slab exactly once from its
      staged place at every alignment; at float32 the staged schedule's
      con_J and velocities are the rank-count kernel's direct-store
      schedule's bit for bit (every entry written once, in its place), for
      several widths, slot counts (one and two tiles) and output offsets;
      the kernel's mask bits (`efc_stage.mask_bits`) give every body
      pair's mask difference bit for bit, and a mask other than zeros and
      ones is refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.ops import efc_stage as tef
from flybody_tpu_torch.ops import narrowphase as tnp
from flybody_tpu_torch.physics import collision, engine, kinematics, solver
from flybody_tpu_torch.physics.state import make_data

B = 4
KS = (1, 24, 64)


# ------------------------------------------------------------- row 7


def key_hi(score: torch.Tensor) -> torch.Tensor:
    """sort_key's high word of float32 scores, as int64 in [0, 2^32)."""
    s = torch.where(score == 0, torch.zeros_like(score), score)
    b = s.view(torch.int32).to(torch.int64) & 0xffffffff
    b = torch.where(b >= 0x80000000, (~b) & 0xffffffff, b | 0x80000000)
    return torch.where(torch.isnan(score), torch.full_like(b, 0xffffffff), b)


def radix_pass(v, part, shift, pre, msk, need):
    """One pass: the histogram of digit (v >> shift) & 255 over the
    values agreeing with pre on msk (and `part`), the digit holding the
    need-th smallest; returns pre, msk, need (its rank within that
    digit's values) and cnt (their count)."""
    part = part & ((v & msk[:, None]) == pre[:, None])
    dig = (v >> shift) & 255
    hist = torch.zeros(v.shape[0], 256, dtype=torch.int64).scatter_add_(
        1, dig, part.to(torch.int64))
    cum = hist.cumsum(1)
    d = (cum >= need[:, None]).to(torch.int64).argmax(1)
    before = cum.gather(1, d[:, None])[:, 0] - hist.gather(1, d[:, None])[:, 0]
    cnt = hist.gather(1, d[:, None])[:, 0]
    return pre | (d << shift), msk | (255 << shift), need - before, cnt


def radix_select(score: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) candidate indices in the kernel's schedule."""
    nb, C = score.shape
    hk = key_hi(score)
    idx = torch.arange(C, dtype=torch.int64).expand(nb, C)
    zero = torch.zeros(nb, dtype=torch.int64)
    pre, msk, need = zero, zero, torch.full((nb,), k, dtype=torch.int64)
    everyone = torch.ones_like(hk, dtype=torch.bool)
    done = torch.zeros(nb, dtype=torch.bool)
    hstar, split = zero, torch.zeros(nb, dtype=torch.bool)
    for shift in (24, 16, 8, 0):
        pre, msk, need, cnt = radix_pass(hk, everyone, shift, pre, msk,
                                         need)
        # an env stops once the K-th key is the last of its digit's keys
        stop = ~done & (need == cnt)
        hstar = torch.where(stop, pre | (~msk & 0xffffffff), hstar)
        done = done | stop
    hstar = torch.where(done, hstar, pre)
    split = ~done & (need < cnt)
    ipre, imsk = zero, zero
    bits = (C - 1).bit_length()
    tie = hk == hstar[:, None]
    for shift in range(max(bits - 1, 0) // 8 * 8, -1, -8):
        ipre, imsk, need, _ = radix_pass(idx, tie & split[:, None], shift,
                                         ipre, imsk, need)
    cstar = torch.where(split, ipre, torch.full_like(ipre, 2 ** 32 - 1))
    take = (hk < hstar[:, None]) | (tie & (idx <= cstar[:, None]))
    assert bool((take.sum(1) == k).all())
    # The kernel's 64-bit (key, index) values, in the order of unsigned
    # comparison (int64 holds them for C <= 2^16).
    assert C <= 2 ** 16
    key = (hk << 16) | idx
    out = torch.empty(nb, k, dtype=torch.int64)
    for b in range(nb):
        sel = key[b][take[b]]
        rank = (sel[None, :] < sel[:, None]).sum(1)  # keys below each
        out[b, rank] = sel & 0xffff
    return out


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


@pytest.fixture(scope='module')
def walk():
    """(model, d): a walk state's position stage, float32."""
    tm = tspec.load(device='cpu', dtype=torch.float32)
    qpos = torch.as_tensor(_qpos(tm.meta, tm.np_arrays['qpos0'], B, 5),
                           dtype=torch.float32)
    d, _, _ = kinematics.fwd_position_smooth(
        tm, make_data(tm, B).replace(qpos=qpos))
    return tm, d


@pytest.fixture(scope='module')
def scores(walk):
    """{C: the candidates' scores}: each preset's compact collide and the
    dense make_efc's prefiltered candidates."""
    tm, d = walk
    out = {}
    for preset in ('default', 'bench'):
        cfg = engine.PRESETS[preset]
        con = collision.collide(tm, d, cfg['mpr_top_p'], cfg['cc_top_p'])
        cb, cu, _ = solver.contact_candidates(tm, con)
        out[cb.shape[1]] = cb[..., 0] - cu[..., 0]
    con = collision.collide(tm, d, compact=False)
    cb, cu, _ = solver.contact_candidates(tm, con, 64)
    out[cb.shape[1]] = cb[..., 0] - cu[..., 0]
    return out


def edge_scores(C, seed):
    g = torch.Generator(device='cpu').manual_seed(seed)
    choice = torch.tensor([0.0, -0.0, 1e-3, -1e-3, float('inf'),
                           float('-inf'), float('nan'), 1e10])
    return choice[torch.randint(0, len(choice), (B, C), generator=g)]


def test_candidate_widths(scores):
    assert sorted(scores) == [222, 430, 2048]


@pytest.mark.parametrize('C', (222, 430, 2048))
def test_radix_select_is_the_stable_sort_on_walk_candidates(scores, C):
    s = scores[C]
    for k in KS + (C,):
        got = radix_select(s, k)
        assert torch.equal(got, collision.smallest(s, k)), k
        want = jax.lax.top_k(-jnp.asarray(s.numpy()), k)[1]
        assert np.array_equal(got.numpy(), np.asarray(want)), k


@pytest.mark.parametrize('C', (1, 7, 222, 300, 430, 2048))
def test_radix_select_is_the_stable_sort_on_edge_scores(C):
    s = edge_scores(C, C)
    for k in sorted({min(k, C) for k in KS + (C,)}):
        assert torch.equal(radix_select(s, k), collision.smallest(s, k)), k


def test_key_orders_as_the_stable_sort():
    """Equal keys exactly for -0 / +0; NaN above +inf; order kept."""
    s = torch.tensor([float('-inf'), -1e10, -1.0, -1e-30, -0.0, 0.0, 1e-30,
                      1.0, 1e10, float('inf'), float('nan')])
    k = key_hi(s)
    assert int(k[4]) == int(k[5])
    assert bool((k[1:] >= k[:-1]).all())
    assert int(k[-1]) == 2 ** 32 - 1 and int(k[-2]) < int(k[-1])


# ------------------------------------------------------------- row 5


TABLES = {'walk compact': (tspec.WALK_IMITATION_NPZ, True),
          'walk dense': (tspec.WALK_IMITATION_NPZ, False),
          'two_fly compact': (tspec.TWO_FLY_NPZ, True)}


@pytest.mark.parametrize('name', TABLES)
def test_narrowphase_table_covers_every_slot_once(name):
    """The pair table names each segment's pairs, in order, and writes
    every slot exactly once."""
    path, cc = TABLES[name]
    tm = tspec.load(path, device='cpu', dtype=torch.float32)
    segs = collision.analytic_segments(tm.meta, cc)
    pairs = tnp.pair_table(segs)
    S = tnp.n_slots(segs)
    count = np.zeros(S, np.int64)
    p = 0
    for key, g1, g2, k in segs:
        for a, b in zip(g1, g2):
            code, ga, gb, first = pairs[p]
            assert tnp.KERNEL_KEYS[code] == key and (ga, gb) == (a, b)
            count[first:first + k] += 1
            p += 1
    assert p == len(pairs) and bool((count == 1).all())


@pytest.mark.parametrize('name', TABLES)
def test_pair_rows_by_the_pair_table_are_the_plain_rows(name):
    """The kernel's schedule: each pair's rows from its geoms' position
    and frame, written at first + r, against narrowphase_ref's slabs, bit
    for bit at float32."""
    path, cc = TABLES[name]
    tm = tspec.load(path, device='cpu', dtype=torch.float32)
    qpos = torch.as_tensor(_qpos(tm.meta, tm.np_arrays['qpos0'], B, 6),
                           dtype=torch.float32)
    d, _, _ = kinematics.fwd_position_smooth(
        tm, make_data(tm, B).replace(qpos=qpos))
    segs = collision.analytic_segments(tm.meta, cc)
    pairs = tnp.pair_table(segs)
    pos_in, mat_in = d.geom_xpos, d.geom_xmat.reshape(B, -1, 9)
    S = tnp.n_slots(segs)
    dist = torch.full((B, S), float('nan'))
    pos = torch.full((B, S, 3), float('nan'))
    nrm = torch.full((B, S, 3), float('nan'))
    for code in np.unique(pairs[:, 0]):
        key = tnp.KERNEL_KEYS[code]
        sel = pairs[pairs[:, 0] == code]
        g1 = torch.as_tensor(sel[:, 1], dtype=torch.int64)
        g2 = torch.as_tensor(sel[:, 2], dtype=torch.int64)
        rows = tnp._rows(key, torch.cat([pos_in[:, g1], mat_in[:, g1]], -1),
                         torch.cat([pos_in[:, g2], mat_in[:, g2]], -1),
                         tm.geom_size[g1], tm.geom_size[g2])
        for r, (dd, pp, nn) in enumerate(rows):
            at = torch.as_tensor(sel[:, 3] + r, dtype=torch.int64)
            dist[:, at], pos[:, at], nrm[:, at] = dd, pp, nn
    want = tnp.narrowphase_ref(segs, d.geom_xpos, d.geom_xmat, tm.geom_size)
    for got, ref in zip((dist, pos, nrm), want):
        assert torch.equal(got, ref)


# ------------------------------------------------------------- con_J


def store_floats(addr: int, n: int):
    """bulk.cuh store_floats for a slab of n floats at byte address addr:
    [(first, count)] of the bulk store (16-byte aligned on both sides, a
    multiple of 16 bytes) and the plain stores, in float offsets."""
    shift = (addr >> 2) & 3
    head = min((4 - shift) & 3, n)
    body = (n - head) & ~3
    pieces = [(i, 1) for i in range(head)]
    if body:
        assert (addr + 4 * head) % 16 == 0 and body % 4 == 0
        pieces.append((head, body))
    pieces += [(i, 1) for i in range(head + body, n)]
    return shift, pieces


def _written_once(addr, n):
    shift, pieces = store_floats(addr, n)
    count = np.zeros(n, np.int64)
    for first, m in pieces:
        count[first:first + m] += 1
        # the staged source (stage + shift + first) agrees mod 16 bytes
        assert (4 * (shift + first) - (addr + 4 * first)) % 16 == 0
    return bool((count == 1).all())


@pytest.mark.parametrize('n', (1, 2, 3, 4, 5, 174, 522, 1213, 3639, 216))
def test_store_floats_writes_each_float_once(n):
    for addr in range(0, 64, 4):
        assert _written_once(addr, n), (addr, n)


def _lane_entries(g, cdof, m, nv, j):
    """Lane j's entries of a row, in its order: v = j, j + 16, ..."""
    vs = list(range(j, nv, 16))
    out = []
    for v in vs:
        s = torch.zeros((), dtype=torch.float32)
        for i in range(6):
            s = s + g[i] * cdof[v, i]
        out.append(s * m[v])
    return vs, out


def _row(g, cdof, m, qvel, nv):
    """A half-warp's row: its entries and J qvel (lane sums, xor tree)."""
    entries, acc = {}, []
    for j in range(16):
        vs, js = _lane_entries(g, cdof, m, nv, j)
        a = torch.zeros((), dtype=torch.float32)
        for v, x in zip(vs, js):
            entries[v] = x
            a = a + x * qvel[v]
        acc.append(a)
    for o in (8, 4, 2, 1):
        acc = [acc[j] + acc[j ^ o] for j in range(16)]
    return entries, acc[0]


def con_j_schedule(gkr, cdof, mdiff, qvel, staged: bool, addr: int):
    """con_J (3K, nv) and vel (3K) of one env by the kernel's warps.
    staged: the kernel's schedule, by tiles of 64 slots: warp w takes the
    slots k = kb + 2 w + 8 i + h, half-warp h a slot's three rows, and its
    two slots' six rows go out through its staging buffer by store_floats
    (at byte address `addr` of the env's slab); else the rank-count
    kernel's: half-warp h of warp w takes row q = 2 w + 8 i + h, stored
    where computed."""
    R, nv = gkr.shape[0], cdof.shape[0]
    K = R // 3
    J = torch.full((R * nv,), float('nan'))
    written = np.zeros(R * nv, np.int64)
    vel = torch.full((R,), float('nan'))
    if not staged:
        for w in range(4):
            for q0 in range(2 * w, R, 8):
                for q in range(q0, min(q0 + 2, R)):
                    entries, vel[q] = _row(gkr[q], cdof, mdiff[q // 3],
                                           qvel, nv)
                    for v, x in entries.items():
                        J[q * nv + v] = x
                        written[q * nv + v] += 1
    for kb in range(0, K if staged else 0, 64):
        kn = min(64, K - kb)
        for w in range(4):
            for k0 in range(2 * w, kn, 8):
                nslot = min(2, kn - k0)
                at0 = (kb + k0) * 3 * nv
                shift = ((addr + 4 * at0) >> 2) & 3
                buf = torch.full((6 * nv + 3,), float('nan'))
                for h in range(nslot):
                    k = kb + k0 + h
                    for r in range(3):
                        q = 3 * k + r
                        entries, vel[q] = _row(gkr[q], cdof, mdiff[k], qvel,
                                               nv)
                        for v, x in entries.items():
                            buf[shift + (3 * h + r) * nv + v] = x
                _, pieces = store_floats(addr + 4 * at0, nslot * 3 * nv)
                for first, m in pieces:
                    J[at0 + first:at0 + first + m] = buf[shift + first:
                                                         shift + first + m]
                    written[at0 + first:at0 + first + m] += 1
    assert bool((written == 1).all())
    return J.reshape(R, nv), vel


@pytest.mark.parametrize('nv,K,addr', [(108, 2, 0), (108, 3, 432),
                                       (7, 3, 4), (10, 1, 8), (13, 5, 12),
                                       (9, 70, 4)])
def test_con_j_staged_stores_keep_the_entries_and_velocity_order(nv, K,
                                                                 addr):
    rng = np.random.RandomState(nv * 10 + K)
    R = 3 * K
    gkr = torch.as_tensor(rng.randn(R, 6), dtype=torch.float32)
    cdof = torch.as_tensor(rng.randn(nv, 6), dtype=torch.float32)
    mdiff = torch.as_tensor(rng.randint(-1, 2, (K, nv)), dtype=torch.float32)
    qvel = torch.as_tensor(rng.randn(nv) * 10, dtype=torch.float32)
    Js, vs = con_j_schedule(gkr, cdof, mdiff, qvel, True, addr)
    Jd, vd = con_j_schedule(gkr, cdof, mdiff, qvel, False, addr)
    assert torch.equal(Js, Jd) and torch.equal(vs, vd)
    # and the velocity is J qvel, to float32's rounding of its terms
    terms = Jd.double() * qvel.double()
    err = (vd.double() - terms.sum(1)).abs()
    assert bool((err <= 1e-6 * terms.abs().sum(1)).all())


@pytest.mark.parametrize('name', ('walk', 'two_fly'))
def test_mask_bits_give_the_mask_differences(name):
    path = {'walk': tspec.WALK_IMITATION_NPZ, 'two_fly': tspec.TWO_FLY_NPZ}
    tm = tspec.load(path[name], device='cpu', dtype=torch.float32)
    mask = tm.body_dof_mask
    bits = tef.mask_bits(tm)
    nb, nv = mask.shape
    assert bits.shape == (nb, (nv + 63) // 64) and bits.dtype == torch.int64
    v = torch.arange(nv)
    on = ((bits[:, v // 64] >> (v % 64)) & 1).to(torch.float32)  # (nb, nv)
    for b2 in range(nb):  # as the kernel forms it: float(bit2) - float(bit1)
        got = on[b2][None] - on
        want = mask[b2][None] - mask
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    arrays = dict(tm.np_arrays)
    arrays['body_dof_mask'] = arrays['body_dof_mask'] * 0.5
    half = dataclasses.replace(tm, np_arrays=arrays, _cache={})
    with pytest.raises(ValueError, match='zeros and ones'):
        tef.mask_bits(half)
