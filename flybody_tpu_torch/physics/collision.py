"""Collision detection, compact path.

Counterpart of flybody_tpu/physics/collision.py `collide(compact=True)`:
static pair tables with MuJoCo's filters, the analytic narrowphase for
the plane/sphere groups on all their pairs (kernel 5,
ops/narrowphase.py), a bounding-sphere broadphase + exact segment-segment
narrowphase on the closest capsule-capsule pairs (plain, as in JAX), and
one merged broadphase + type-dispatching MPR on the closest mixed-type
pairs (kernel 6, ops/mpr_kernel.py). Every selection is a stable sort, so
ties keep the lower index first as jax.lax.top_k does.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.model.spec import FlyModel
from flybody_tpu_torch.ops import mpr_kernel as _mprk
from flybody_tpu_torch.ops import narrowphase as _np
from flybody_tpu_torch.ops.narrowphase import _rows
from flybody_tpu_torch.physics.state import Data

_PAIR_NCON = {
    (_s.GEOM_PLANE, _s.GEOM_SPHERE): 1,
    (_s.GEOM_PLANE, _s.GEOM_CAPSULE): 2,
    (_s.GEOM_PLANE, _s.GEOM_ELLIPSOID): 1,
    (_s.GEOM_PLANE, _s.GEOM_CYLINDER): 3,
    (_s.GEOM_SPHERE, _s.GEOM_SPHERE): 1,
    (_s.GEOM_SPHERE, _s.GEOM_CAPSULE): 1,
    (_s.GEOM_SPHERE, _s.GEOM_ELLIPSOID): 1,
    (_s.GEOM_SPHERE, _s.GEOM_CYLINDER): 1,
    (_s.GEOM_CAPSULE, _s.GEOM_CAPSULE): 1,
    (_s.GEOM_CAPSULE, _s.GEOM_ELLIPSOID): 1,
    (_s.GEOM_CAPSULE, _s.GEOM_CYLINDER): 3,
    (_s.GEOM_ELLIPSOID, _s.GEOM_ELLIPSOID): 1,
    (_s.GEOM_ELLIPSOID, _s.GEOM_CYLINDER): 1,
    (_s.GEOM_CYLINDER, _s.GEOM_CYLINDER): 1,
}
_MPR_PAIRS = {
    (_s.GEOM_SPHERE, _s.GEOM_ELLIPSOID),
    (_s.GEOM_SPHERE, _s.GEOM_CYLINDER),
    (_s.GEOM_CAPSULE, _s.GEOM_ELLIPSOID),
    (_s.GEOM_CAPSULE, _s.GEOM_CYLINDER),
    (_s.GEOM_ELLIPSOID, _s.GEOM_ELLIPSOID),
    (_s.GEOM_ELLIPSOID, _s.GEOM_CYLINDER),
    (_s.GEOM_CYLINDER, _s.GEOM_CYLINDER),
}
_CC_KEY = (_s.GEOM_CAPSULE, _s.GEOM_CAPSULE)


def _pair_rows(key) -> int:
    """Slots per pair: MPR manifolds collapse to one nrep-weighted slot."""
    return 1 if key in _MPR_PAIRS else _PAIR_NCON[key]


def _pair_nrep(key) -> int:
    return _PAIR_NCON[key] if key in _MPR_PAIRS else 1


def smallest(x, k: int):
    """Indices of the k smallest entries along the last dim, ties in index
    order (the order of jax.lax.top_k on -x)."""
    return torch.sort(x, dim=-1, stable=True).indices[..., :k]


@functools.lru_cache(maxsize=8)
def pair_tables(meta: _s.Meta) -> dict:
    """Candidate pairs grouped by canonical type pair, and per-slot
    geom/body/condim/nrep tables in slot order."""
    ngeom = meta.ngeom
    parent = np.array(meta.body_parentid)
    weld = np.array(meta.body_weldid)
    gtype = np.array(meta.geom_type)
    gbody = np.array(meta.geom_bodyid)
    contype = np.array(meta.geom_contype)
    conaff = np.array(meta.geom_conaffinity)
    excl = set(meta.exclude_pairs)
    groups: dict = {}
    for g1 in range(ngeom):
        for g2 in range(g1 + 1, ngeom):
            b1, b2 = gbody[g1], gbody[g2]
            if b1 == b2 or weld[b1] == weld[b2]:
                continue
            w1, w2 = weld[b1], weld[b2]
            pw1, pw2 = weld[parent[w1]], weld[parent[w2]]
            if (w1 == pw2 and w2 != 0) or (w2 == pw1 and w1 != 0):
                continue
            if (int(b1), int(b2)) in excl or (int(b2), int(b1)) in excl:
                continue
            if not ((contype[g1] & conaff[g2]) or (contype[g2] & conaff[g1])):
                continue
            a, b = (g1, g2) if gtype[g1] <= gtype[g2] else (g2, g1)
            key = (int(gtype[a]), int(gtype[b]))
            if key not in _PAIR_NCON:
                raise NotImplementedError(f'collision pair type {key}')
            groups.setdefault(key, []).append((a, b))
    out = {}
    sg1, sg2, scd, snrep = [], [], [], []
    condim = np.array(meta.geom_condim)
    prio = np.array(meta.geom_priority)
    for key in sorted(groups):
        g1 = np.array([p[0] for p in groups[key]])
        g2 = np.array([p[1] for p in groups[key]])
        k = _pair_rows(key)
        out[key] = (g1, g2, k)
        for p1, p2 in groups[key]:
            if prio[p1] != prio[p2]:
                cd = condim[p1] if prio[p1] > prio[p2] else condim[p2]
            else:
                cd = max(condim[p1], condim[p2])
            sg1 += [p1] * k
            sg2 += [p2] * k
            scd += [int(cd)] * k
            snrep += [float(_pair_nrep(key))] * k
    sg1 = np.array(sg1, np.int64)
    sg2 = np.array(sg2, np.int64)
    return dict(groups=out, slot_geom1=sg1, slot_geom2=sg2,
                slot_condim=np.array(scd, np.int64),
                slot_body1=gbody[sg1], slot_body2=gbody[sg2],
                slot_nrep=np.array(snrep), nslot=len(sg1))


def self_pair_mask(meta: _s.Meta) -> np.ndarray:
    """Slots whose geoms share a non-world kinematic root (fly-self)."""
    tb = pair_tables(meta)
    root = np.array(meta.body_rootid)
    r1, r2 = root[tb['slot_body1']], root[tb['slot_body2']]
    return (r1 == r2) & (r1 != 0)


def _combine_params(a: dict, meta, g1, g2):
    """MuJoCo contact-parameter mixing (host-side, float64)."""
    prio = np.array(meta.geom_priority)
    f1, f2 = a['geom_friction'][g1], a['geom_friction'][g2]
    p1 = (prio[g1] > prio[g2]).astype(np.float64)[:, None]
    p2 = (prio[g2] > prio[g1]).astype(np.float64)[:, None]
    peq = 1.0 - p1 - p2
    f3 = peq * np.maximum(f1, f2) + p1 * f1 + p2 * f2
    m1, m2 = a['geom_solmix'][g1], a['geom_solmix'][g2]
    both = (m1 >= 1e-15) & (m2 >= 1e-15)
    w1 = np.where(both, m1 / np.maximum(m1 + m2, 1e-15),
                  np.where(m1 >= 1e-15, 1.0, np.where(m2 >= 1e-15, 0.0, 0.5)))
    w2 = 1.0 - w1
    sr1, sr2 = a['geom_solref'][g1], a['geom_solref'][g2]
    standard = (sr1[:, 0] > 0) & (sr2[:, 0] > 0)
    solref = np.where(standard[:, None], w1[:, None] * sr1 + w2[:, None] * sr2,
                      np.minimum(sr1, sr2))
    si1, si2 = a['geom_solimp'][g1], a['geom_solimp'][g2]
    solimp = w1[:, None] * si1 + w2[:, None] * si2
    solref = peq * solref + p1 * sr1 + p2 * sr2
    solimp = peq * solimp + p1 * si1 + p2 * si2
    margin = a['geom_margin'][g1] + a['geom_margin'][g2]
    return f3[:, 0], solref, solimp, margin


def efc_slot_table_np(model: FlyModel) -> np.ndarray:
    """Per-slot constraint parameters (S, 14): [includemargin, mu,
    solref(2), solimp(5), condim, diag/nrep, body1, body2, selfmask]."""
    meta = model.meta
    a = model.np_arrays
    tb = pair_tables(meta)
    rows = []
    for key, (g1, g2, k) in tb['groups'].items():
        mu, sr, si, mg = _combine_params(a, meta, g1, g2)
        rows.append(np.repeat(np.concatenate(
            [mg[:, None], mu[:, None], sr, si], -1), k, axis=0))
    base = np.concatenate(rows)
    inv1 = a['body_invweight0'][:, 0]
    b1, b2 = tb['slot_body1'], tb['slot_body2']
    diag = (inv1[b1] + inv1[b2]) / tb['slot_nrep']
    return np.concatenate([
        base, tb['slot_condim'][:, None].astype(np.float64), diag[:, None],
        b1[:, None].astype(np.float64), b2[:, None].astype(np.float64),
        self_pair_mask(meta)[:, None].astype(np.float64)], -1)


def efc_slot_table(model: FlyModel):
    return model.const('efc_slot_table', lambda: efc_slot_table_np(model))


def _dense(key) -> bool:
    """Analytic groups that the compact collide evaluates on all pairs."""
    return key in _np.ANALYTIC_KEYS and key != _CC_KEY


@functools.lru_cache(maxsize=8)
def dense_segments(meta: _s.Meta) -> tuple:
    """The narrowphase's segment table: (key, geom1 ids, geom2 ids, rows
    per pair) of each dense analytic group, in slot order."""
    tb = pair_tables(meta)
    return tuple((key, tuple(int(g) for g in g1), tuple(int(g) for g in g2),
                  k) for key, (g1, g2, k) in tb['groups'].items()
                 if _dense(key))


@functools.lru_cache(maxsize=8)
def dense_slot_ids(meta: _s.Meta) -> np.ndarray:
    """Global slot ids of the dense analytic slots, in slot order."""
    tb = pair_tables(meta)
    ids, slot_lo = [], 0
    for key, (g1, g2, k) in tb['groups'].items():
        n = len(g1) * k
        if _dense(key):
            ids.append(slot_lo + np.arange(n, dtype=np.int64))
        slot_lo += n
    return np.concatenate(ids)


@functools.lru_cache(maxsize=8)
def _pair_family_tables(meta: _s.Meta, mpr: bool) -> dict:
    """Pair arrays and global slot ids of the capsule-capsule group
    (mpr=False) or of all MPR groups merged (mpr=True)."""
    tb = pair_tables(meta)
    g1s, g2s, t1s, t2s, sids = [], [], [], [], []
    slot_lo = 0
    for key, (g1, g2, k) in tb['groups'].items():
        n = len(g1)
        if (key in _MPR_PAIRS) if mpr else (key == _CC_KEY):
            g1s.append(g1)
            g2s.append(g2)
            t1s.append(np.full(n, key[0], np.float64))
            t2s.append(np.full(n, key[1], np.float64))
            sids.append(slot_lo + np.arange(n, dtype=np.int64) * k)
        slot_lo += n * k
    t1, t2 = np.concatenate(t1s), np.concatenate(t2s)
    return dict(g1=np.concatenate(g1s), g2=np.concatenate(g2s), t1=t1, t2=t2,
                smooth=((t1 != _s.GEOM_CYLINDER)
                        & (t2 != _s.GEOM_CYLINDER)).astype(np.float64),
                slot_ids=np.concatenate(sids))


@dataclasses.dataclass
class CompactBlock:
    """P broadphase-selected candidates of one pair family (batched)."""

    idx: torch.Tensor  # (B, P) float global slot ids
    dist: torch.Tensor  # (B, P)
    pos: torch.Tensor  # (B, P, 3)
    normal: torch.Tensor  # (B, P, 3)
    params: torch.Tensor  # (B, P, 14) efc_slot_table rows


@dataclasses.dataclass
class Contact:
    """Dense analytic slots (dense_slot_ids order) plus the compact
    capsule-capsule and MPR blocks."""

    dist: torch.Tensor  # (B, S_dense)
    pos: torch.Tensor
    normal: torch.Tensor
    blocks: tuple = ()


def _geom_cat(data: Data):
    B, n = data.geom_xpos.shape[:2]
    return torch.cat([data.geom_xpos, data.geom_xmat.reshape(B, n, 9)], -1)


def _broadphase(model, data, gcat, ft, P):
    """Top-P closest pairs by bounding spheres; returns (idx, c1, c2)."""
    g1, g2 = ft['g1'], ft['g2']
    rb = model.geom_rbound
    mg = model.geom_margin
    d_bound = (torch.linalg.norm(data.geom_xpos[:, g2] - data.geom_xpos[:, g1],
                                 dim=-1)
               - rb[g1] - rb[g2] - mg[g1] - mg[g2])
    idx = smallest(d_bound, min(P, len(g1)))
    g1t = torch.as_tensor(g1, device=idx.device)[idx]
    g2t = torch.as_tensor(g2, device=idx.device)[idx]
    bi = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return idx, gcat[bi, g1t], gcat[bi, g2t]


def _cc_compact(model: FlyModel, data: Data, gcat, top_p: int
                ) -> CompactBlock:
    """Capsule-capsule: broadphase + exact analytic narrowphase."""
    ft = _pair_family_tables(model.meta, False)
    g1, g2 = ft['g1'], ft['g2']

    def table():
        a = model.np_arrays
        return np.concatenate([
            a['geom_size'][g1], a['geom_size'][g2],
            efc_slot_table_np(model)[ft['slot_ids']],
            ft['slot_ids'][:, None].astype(np.float64)], -1)

    idx, c1, c2 = _broadphase(model, data, gcat, ft, top_p)
    sel = model.const('cc_table', table)[idx]
    d, p, n = _rows(_CC_KEY, c1, c2, sel[..., 0:3], sel[..., 3:6])[0]
    return CompactBlock(idx=sel[..., 20], dist=d, pos=p, normal=n,
                        params=sel[..., 6:20])


def _mpr_merged(model: FlyModel, data: Data, gcat, top_p: int
                ) -> CompactBlock:
    """All mixed-type MPR groups: one broadphase + one MPR sweep."""
    ft = _pair_family_tables(model.meta, True)
    g1, g2 = ft['g1'], ft['g2']

    def table():
        a = model.np_arrays
        return np.concatenate([
            a['geom_size'][g1], a['geom_margin'][g1][:, None],
            a['geom_size'][g2], a['geom_margin'][g2][:, None],
            ft['t1'][:, None], ft['t2'][:, None], ft['smooth'][:, None],
            efc_slot_table_np(model)[ft['slot_ids']],
            ft['slot_ids'][:, None].astype(np.float64)], -1)

    idx, c1, c2 = _broadphase(model, data, gcat, ft, top_p)
    sel = model.const('mpr_table', table)[idx]
    dist, n, pos = _mprk.mpr_merged(c1, c2, sel[..., :11].contiguous(), 8)
    return CompactBlock(idx=sel[..., 25], dist=dist, pos=pos, normal=n,
                        params=sel[..., 11:25])


def collide(model: FlyModel, data: Data, mpr_top_p: int,
            cc_top_p: int) -> Contact:
    """Candidate contacts: dense plane/sphere slots + compact blocks. The
    capsule-capsule and merged-MPR blocks keep the `cc_top_p` and
    `mpr_top_p` broadphase candidates with the smallest bounding-sphere
    distance."""
    gcat = _geom_cat(data)
    dist, pos, normal = _np.narrowphase(dense_segments(model.meta),
                                        data.geom_xpos, data.geom_xmat,
                                        model.geom_size)
    blocks = (_cc_compact(model, data, gcat, cc_top_p),
              _mpr_merged(model, data, gcat, mpr_top_p))
    return Contact(dist=dist, pos=pos, normal=normal, blocks=blocks)
