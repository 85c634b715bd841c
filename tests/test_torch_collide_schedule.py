"""The schedules of the analytic narrowphase (row 5) and the per-type-pair
MPR (row 20) in plain torch, on the CPU.

csrc/narrowphase.cu gives each (env, pair) of the pair table
(`narrowphase.pair_table`) a thread: when the table fits one block of
THREADS threads, block (1, e) takes env e's pairs on threads 0 .. P - 1
(and env e + 65535, ... past the grid's y range); otherwise item t = e P +
p goes to thread t of a 1-D grid. Each thread
gathers only the pose and size entries its pair type's formulas read
(`GATHERED`, csrc/narrowphase.cu; the others stay zero), forms its rows
and stores them at slots first .. first + k - 1 of its env.

  (a) on the compact and dense segment tables of the walking model and
      the compact one of the two-fly scene, in the grid each table gets
      and in the other one, the threads take every (env, pair) once and
      store every (env, slot) exactly once;
  (b) the rows formed from the gathered entries alone (every other entry
      zero) and stored by that schedule are narrowphase_ref's bit for bit
      at float32, on walk states and on kernel_ab's edge envs (a NaN
      position, lying cylinders, coincident capsule axes, a sphere resting
      on its plane).

csrc/mpr.cu's kernel 20 (`mpr_pair_kernel`) gives each of the B P
candidates of one type pair a thread (lane g of block b takes candidate b
THREADS + g; the lanes past the count return).

  (c) on the seven groups' candidates of a walk state
      (tools/profile_collide.mpr_groups) and on a ragged count (the first
      envs' candidates and 37 more), the blocks cover every candidate
      exactly once, and the plain version run block by block on the
      candidates the lanes take is the plain call bit for bit at float32.
"""

import numpy as np
import pytest
import torch

from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.ops import mpr_kernel as tmk
from flybody_tpu_torch.ops import narrowphase as tnp
from flybody_tpu_torch.physics import collision, kinematics
from flybody_tpu_torch.physics.state import make_data
from flybody_tpu_torch.tools import kernel_ab, profile_collide

B = 4
THREADS = 128  # csrc/narrowphase.cu and csrc/mpr.cu kThreads
PLANE, SPHERE, CAPSULE = (tspec.GEOM_PLANE, tspec.GEOM_SPHERE,
                          tspec.GEOM_CAPSULE)
ELLIPSOID, CYLINDER = tspec.GEOM_ELLIPSOID, tspec.GEOM_CYLINDER

# What csrc/narrowphase.cu's `gather` reads of a pair of each type: of the
# pose rows c (12 floats: pos | row-major mat) of geom 1 and geom 2 and of
# their size rows (3 floats). Every type reads both positions and geom 2's
# size[0]; column j of the rotation is c[3 + j], c[6 + j], c[9 + j].
POS = (0, 1, 2)
COL0, COL2 = (3, 6, 9), (5, 8, 11)
GATHERED = {  # key: (c1 entries, c2 entries, size1 entries, size2 entries)
    (PLANE, SPHERE): (POS + COL2, POS, (), (0,)),
    (PLANE, CAPSULE): (POS + COL2, POS + COL2, (), (0, 1)),
    (PLANE, ELLIPSOID): (POS + COL2, tuple(range(12)), (), (0, 1, 2)),
    (PLANE, CYLINDER): (POS + COL2, POS + COL2 + COL0, (), (0, 1)),
    (SPHERE, SPHERE): (POS, POS, (0,), (0,)),
    (SPHERE, CAPSULE): (POS, POS + COL2, (0,), (0, 1)),
    (CAPSULE, CAPSULE): (POS + COL2, POS + COL2, (0, 1), (0, 1)),
}
TABLES = {'walk compact': (tspec.WALK_IMITATION_NPZ, True),
          'walk dense': (tspec.WALK_IMITATION_NPZ, False),
          'two_fly compact': (tspec.TWO_FLY_NPZ, True)}


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


def _state(path, seed):
    tm = tspec.load(path, device='cpu', dtype=torch.float32)
    qpos = torch.as_tensor(_qpos(tm.meta, tm.np_arrays['qpos0'], B, seed),
                           dtype=torch.float32)
    d, _, _ = kinematics.fwd_position_smooth(
        tm, make_data(tm, B).replace(qpos=qpos))
    return tm, d


def items(nb: int, P: int, env_blocks: bool) -> np.ndarray:
    """(env, pair) of each live thread of the kernel's grid, in thread
    order (csrc/narrowphase.cu narrowphase_kernel)."""
    if env_blocks:  # block (1, e), threads 0 .. THREADS - 1
        e, p = np.meshgrid(np.arange(nb), np.arange(THREADS), indexing='ij')
        live = p < P
        return np.stack([e[live], p[live]], 1)
    t = np.arange(-(-nb * P // THREADS) * THREADS)
    t = t[t < nb * P]
    return np.stack([t // P, t % P], 1)


def _masked(c, keep):
    m = torch.zeros(c.shape[-1], dtype=torch.bool)
    m[list(keep)] = True
    return torch.where(m, c, torch.zeros_like(c))


def scheduled(segs, xpos, xmat, size, env_blocks):
    """narrowphase's outputs by the kernel's schedule: each thread's
    gathered entries, its rows and its stores; also the count of stores
    of each (env, slot) and of threads of each (env, pair)."""
    pairs = tnp.pair_table(segs)
    P, S = len(pairs), tnp.n_slots(segs)
    nb = xpos.shape[0]
    gcat = torch.cat([xpos, xmat.reshape(nb, -1, 9)], -1)
    dist = torch.full((nb, S), float('nan'))
    pos = torch.full((nb, S, 3), float('nan'))
    nrm = torch.full((nb, S, 3), float('nan'))
    stores = np.zeros((nb, S), np.int64)
    taken = np.zeros((nb, P), np.int64)
    it = items(nb, P, env_blocks)
    np.add.at(taken, (it[:, 0], it[:, 1]), 1)
    for code in np.unique(pairs[:, 0]):
        key = tnp.KERNEL_KEYS[code]
        mine = it[pairs[it[:, 1], 0] == code]  # the threads of this type
        e = torch.as_tensor(mine[:, 0])
        sel = pairs[mine[:, 1]]
        g1 = torch.as_tensor(sel[:, 1], dtype=torch.int64)
        g2 = torch.as_tensor(sel[:, 2], dtype=torch.int64)
        k1, k2, ks1, ks2 = GATHERED[key]
        rows = tnp._rows(key, _masked(gcat[e, g1], k1),
                         _masked(gcat[e, g2], k2),
                         _masked(size[g1], ks1), _masked(size[g2], ks2))
        for r, (dd, pp, nn) in enumerate(rows):
            at = torch.as_tensor(sel[:, 3] + r, dtype=torch.int64)
            dist[e, at], pos[e, at], nrm[e, at] = dd, pp, nn
            np.add.at(stores, (mine[:, 0], sel[:, 3] + r), 1)
    return (dist, pos, nrm), stores, taken


@pytest.fixture(scope='module')
def states():
    return {name: _state(path, 6) for name, (path, _) in TABLES.items()}


# Each table in the grid it gets (only the walk's compact table, 115 pairs,
# fits one block) and in the dealt one.
GRIDS = (('walk compact', True), ('walk compact', False),
         ('walk dense', False), ('two_fly compact', False))


@pytest.mark.parametrize('name, env_blocks', GRIDS)
def test_narrowphase_threads_store_every_slot_once(name, env_blocks, states):
    tm, d = states[name]
    segs = collision.analytic_segments(tm.meta, TABLES[name][1])
    P = len(tnp.pair_table(segs))
    assert (P <= THREADS) == (name == 'walk compact'), P
    _, stores, taken = scheduled(segs, d.geom_xpos, d.geom_xmat,
                                 tm.geom_size, env_blocks)
    assert bool((taken == 1).all()) and bool((stores == 1).all())


@pytest.mark.parametrize('edge', (False, True), ids=('state', 'edge envs'))
@pytest.mark.parametrize('name', TABLES)
def test_narrowphase_schedule_is_the_plain_call(name, edge, states):
    tm, d = states[name]
    segs = collision.analytic_segments(tm.meta, TABLES[name][1])
    args = (segs, d.geom_xpos, d.geom_xmat, tm.geom_size)
    if edge:
        args = kernel_ab.narrow_edge_envs(args)
    env_blocks = len(tnp.pair_table(segs)) <= THREADS  # the kernel's grid
    got, _, _ = scheduled(*args, env_blocks)
    for g, w in zip(got, tnp.narrowphase_ref(*args)):
        assert kernel_ab.same(g, w)


# ------------------------------------------------------------- row 20


def lanes(count: int):
    """Candidate of each (block, lane) of kernel 20's grid, -1 past the
    count."""
    blocks = (count + THREADS - 1) // THREADS
    g = np.arange(blocks * THREADS).reshape(blocks, THREADS)
    return np.where(g < count, g, -1)


@pytest.fixture(scope='module')
def groups():
    args = profile_collide.parser().parse_args(['--cpu', '--batch', '2'])
    model, d = profile_collide.setup(args)
    return profile_collide.mpr_groups(model, d)


@pytest.mark.parametrize('ragged', (False, True), ids=('walk', 'ragged'))
def test_mpr_pair_lanes_are_the_plain_call(groups, ragged):
    for key, pol, (c1, c2, prm) in groups:
        flat = [t.reshape(-1, t.shape[-1]) for t in (c1, c2, prm)]
        if ragged:
            flat = [torch.cat([t, t[:37]]) for t in flat]
        n = flat[0].shape[0]
        ln = lanes(n)
        taken = np.bincount(ln[ln >= 0], minlength=n)
        assert bool((taken == 1).all()), key
        want = tmk.mpr_pair_ref(*key, pol, *(t[None] for t in flat))
        got = [torch.full_like(w, float('nan')) for w in want]
        for block in ln:
            idx = torch.as_tensor(block[block >= 0])
            out = tmk.mpr_pair_ref(*key, pol, *(t[idx][None] for t in flat))
            for g, o in zip(got, out):
                g[:, idx] = o
        for g, w in zip(got, want):
            assert kernel_ab.same(g, w), key
