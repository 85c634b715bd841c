"""Collision detection.

Counterpart of flybody_tpu/physics/collision.py: static pair tables with
MuJoCo's filters and two forms of `collide`.

  * compact (`compact=True`, the engine's path; JAX `collide(compact=
    True)`): the analytic narrowphase for the plane/sphere groups on all
    their pairs (kernel 5, ops/narrowphase.py), a bounding-sphere
    broadphase + exact segment-segment narrowphase on the closest
    capsule-capsule pairs (plain, as in JAX), and one merged broadphase +
    type-dispatching MPR on the closest mixed-type pairs (kernel 6,
    ops/mpr_kernel.py), the last two as CompactBlocks;
  * dense (`compact=False`, the JAX package's default, which its tools
    call): every slot in slot order: kernel 5 on every analytic group,
    capsule-capsule included, and kernel 6 on the merged broadphase's
    closest MPR pairs, scattered back (uncovered slots: dist 1e10, normal
    (0, 0, 1)).

The per-group narrowphase of the JAX tools (`gather_group`, `handler`,
`mpr_topp`) runs an MPR group through the per-type-pair MPR (kernel 20).
Every selection is a stable sort, so ties keep the lower index first as
jax.lax.top_k does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

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
# Broadphase widths of the JAX package (collision.py:556, :620): a group's
# top-P through its own narrowphase (mpr_topp), and the merged MPR's top-P
# in the dense collide.
MPR_TOP_P = 64
MPR_MERGED_TOP_P = 128


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


def _analytic(key, exclude_cc: bool) -> bool:
    """Analytic groups that row 5 evaluates on all pairs: every one in the
    dense collide, all but capsule-capsule in the compact one."""
    return key in _np.ANALYTIC_KEYS and not (exclude_cc and key == _CC_KEY)


@functools.lru_cache(maxsize=8)
def analytic_segments(meta: _s.Meta, exclude_cc: bool) -> tuple:
    """Row 5's segment table: (key, geom1 ids, geom2 ids, rows per pair) of
    each analytic group in slot order (JAX `_analytic_tables`,
    collision.py:863); `exclude_cc` leaves capsule-capsule out."""
    tb = pair_tables(meta)
    return tuple((key, tuple(int(g) for g in g1), tuple(int(g) for g in g2),
                  k) for key, (g1, g2, k) in tb['groups'].items()
                 if _analytic(key, exclude_cc))


def dense_segments(meta: _s.Meta) -> tuple:
    """The compact collide's segment table (no capsule-capsule)."""
    return analytic_segments(meta, True)


@functools.lru_cache(maxsize=8)
def analytic_slot_ids(meta: _s.Meta, exclude_cc: bool) -> np.ndarray:
    """Global slot ids of analytic_segments' rows, in slot order."""
    tb = pair_tables(meta)
    ids, slot_lo = [], 0
    for key, (g1, g2, k) in tb['groups'].items():
        n = len(g1) * k
        if _analytic(key, exclude_cc):
            ids.append(slot_lo + np.arange(n, dtype=np.int64))
        slot_lo += n
    return np.concatenate(ids)


def dense_slot_ids(meta: _s.Meta) -> np.ndarray:
    """Global slot ids of the compact collide's dense analytic slots."""
    return analytic_slot_ids(meta, True)


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
    """Compact: the dense analytic slots (dense_slot_ids order) plus the
    capsule-capsule and MPR blocks. Dense: every slot in slot order, and
    no blocks."""

    dist: torch.Tensor  # (B, S_dense) or (B, S)
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


def merged_candidates(model: FlyModel, data: Data, top_p: int, gcat=None
                      ) -> tuple:
    """The merged MPR's operands on the `top_p` broadphase candidates of
    `data`'s geometry (its position stage's geom_xpos, geom_xmat): (c1, c2,
    prm, sel), prm = sel[..., :11] contiguous (ops/mpr_kernel.py), sel the
    candidates' rows of the pair table (B, P, 26)."""
    gcat = _geom_cat(data) if gcat is None else gcat
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
    return c1, c2, sel[..., :11].contiguous(), sel


def _mpr_merged(model: FlyModel, data: Data, gcat, top_p: int
                ) -> CompactBlock:
    """All mixed-type MPR groups: one broadphase + one MPR sweep."""
    c1, c2, prm, sel = merged_candidates(model, data, top_p, gcat)
    dist, n, pos = _mprk.mpr_merged(c1, c2, prm, 8)
    return CompactBlock(idx=sel[..., 25], dist=dist, pos=pos, normal=n,
                        params=sel[..., 11:25])


def collide(model: FlyModel, data: Data,
            mpr_top_p: int = MPR_MERGED_TOP_P, cc_top_p: int | None = None,
            compact: bool = True) -> Contact:
    """Candidate contacts. Compact (the engine's path): the dense
    plane/sphere slots + the capsule-capsule and merged-MPR blocks of the
    `cc_top_p` and `mpr_top_p` broadphase candidates with the smallest
    bounding-sphere distance. Dense (`compact=False`; JAX collision.py:
    891-972): all slots, row 5 on every analytic group and the merged MPR
    on its `mpr_top_p` closest pairs, scattered to their slots (an MPR
    pair has one slot, _pair_rows, so no row is repeated)."""
    gcat = _geom_cat(data)
    if compact:
        if cc_top_p is None:
            raise ValueError('the compact collide takes cc_top_p')
        dist, pos, normal = _np.narrowphase(dense_segments(model.meta),
                                            data.geom_xpos, data.geom_xmat,
                                            model.geom_size)
        blocks = (_cc_compact(model, data, gcat, cc_top_p),
                  _mpr_merged(model, data, gcat, mpr_top_p))
        return Contact(dist=dist, pos=pos, normal=normal, blocks=blocks)
    meta = model.meta
    B, S = data.geom_xpos.shape[0], pair_tables(meta)['nslot']
    dist = data.geom_xpos.new_full((B, S), 1e10)
    pos = data.geom_xpos.new_zeros((B, S, 3))
    normal = torch.zeros_like(pos)
    normal[..., 2] = 1.0
    aid = torch.as_tensor(analytic_slot_ids(meta, False),
                          device=dist.device)
    dist[:, aid], pos[:, aid], normal[:, aid] = _np.narrowphase(
        analytic_segments(meta, False), data.geom_xpos, data.geom_xmat,
        model.geom_size)
    blk = _mpr_merged(model, data, gcat, mpr_top_p)
    sid = torch.round(blk.idx).long()
    dist.scatter_(1, sid, blk.dist)
    sid3 = sid[..., None].expand(-1, -1, 3)
    pos.scatter_(1, sid3, blk.pos)
    normal.scatter_(1, sid3, blk.normal)
    return Contact(dist=dist, pos=pos, normal=normal)


# ------------------------------------------- per-group narrowphase


class PairGeo(NamedTuple):
    """The geometry of P candidate pairs of one type group (batched)."""

    c1: torch.Tensor  # (B, P, 12) [pos | row-major mat] of geom 1
    c2: torch.Tensor  # (B, P, 12) of geom 2
    prm: torch.Tensor  # (B, P, 8) [size1 | margin1 | size2 | margin2]


def _pair_prm(model: FlyModel, g1, g2):
    """(P, 8) [size1 | margin1 | size2 | margin2] of the pairs (g1, g2)."""
    g1, g2 = np.asarray(g1), np.asarray(g2)

    def table():
        a = model.np_arrays
        return np.concatenate([
            a['geom_size'][g1], a['geom_margin'][g1][:, None],
            a['geom_size'][g2], a['geom_margin'][g2][:, None]], -1)
    return model.const(('pair_prm', tuple(g1), tuple(g2)), table)


def gather_group(model: FlyModel, gcat, g1, g2) -> PairGeo:
    """Every pair of a group, gathered from the pose table gcat (B, ngeom,
    12) (JAX `_gather_group`, collision.py:354)."""
    B = gcat.shape[0]
    return PairGeo(c1=gcat[:, np.asarray(g1)], c2=gcat[:, np.asarray(g2)],
                   prm=_pair_prm(model, g1, g2).expand(B, -1, -1).contiguous())


def handler(key):
    """The narrowphase of type group `key` on a PairGeo: (dist (B, P, k),
    pos (B, P, k, 3), normal (B, P, k, 3)) (JAX `_handler`, collision.py:
    522-550). An MPR group launches kernel 20 (ops/mpr_kernel.mpr_pair)
    with 8 polish steps when neither geom is a cylinder, 0 otherwise; an
    analytic group runs its row formulas (plain, as in JAX)."""
    if key in _MPR_PAIRS:
        polish = 0 if _s.GEOM_CYLINDER in key else 8

        def mpr(pg: PairGeo):
            dist, n, pos = _mprk.mpr_pair(key[0], key[1], polish, pg.c1,
                                          pg.c2, pg.prm)
            return dist[..., None], pos[..., None, :], n[..., None, :]
        return mpr

    def analytic(pg: PairGeo):
        rows = _rows(key, pg.c1, pg.c2, pg.prm[..., 0:3], pg.prm[..., 4:7])
        return (torch.stack([r[0] for r in rows], -1),
                torch.stack([r[1] for r in rows], -2),
                torch.stack([r[2] for r in rows], -2))
    return analytic


def topp_geo(model: FlyModel, data: Data, g1, g2, gcat=None):
    """The MPR_TOP_P pairs of (g1, g2) with the smallest bounding-sphere
    distance: (their indices (B, P), PairGeo)."""
    if gcat is None:
        gcat = _geom_cat(data)
    g1, g2 = np.asarray(g1), np.asarray(g2)
    idx, c1, c2 = _broadphase(model, data, gcat, dict(g1=g1, g2=g2),
                              MPR_TOP_P)
    return idx, PairGeo(c1, c2, _pair_prm(model, g1, g2)[idx])


def mpr_topp(model: FlyModel, data: Data, key, g1, g2, gcat=None):
    """A group's bounding-sphere broadphase and `handler(key)` on its
    MPR_TOP_P closest pairs (topp_geo), scattered back to all its pairs
    and repeated over its k rows: (dist (B, n, k), pos (B, n, k, 3),
    normal (B, n, k, 3)); uncovered pairs get dist 1e10, pos 0 and normal
    (0, 0, 1) (JAX `_mpr_topp`, collision.py:559-614, with indexed
    gathers and scatters in place of its one-hot products)."""
    idx, pg = topp_geo(model, data, g1, g2, gcat)
    d, p, n = handler(key)(pg)
    B, n_all, k = idx.shape[0], len(g1), d.shape[-1]
    d_full = d.new_full((B, n_all), 1e10).scatter_(1, idx, d[..., 0])
    i3 = idx[..., None].expand(-1, -1, 3)
    p_full = p.new_zeros((B, n_all, 3)).scatter_(1, i3, p[..., 0, :])
    n_full = p.new_zeros((B, n_all, 3))
    n_full[..., 2] = 1.0
    n_full.scatter_(1, i3, n[..., 0, :])
    return (d_full[..., None].expand(-1, -1, k),
            p_full[..., None, :].expand(-1, -1, k, -1),
            n_full[..., None, :].expand(-1, -1, k, -1))
