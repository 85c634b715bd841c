"""Collision detection, compact path (plain PyTorch).

Counterpart of flybody_tpu/physics/collision.py `collide(compact=True)`:
static pair tables with MuJoCo's filters, the analytic narrowphase for
plane/sphere groups (all pairs), a bounding-sphere broadphase + exact
segment-segment narrowphase on the 128 closest capsule-capsule pairs, and
one merged broadphase + type-dispatching MPR on the 128 closest mixed-type
pairs. Every selection is a stable sort, so ties keep the lower index first
as jax.lax.top_k does.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.model.spec import FlyModel
from flybody_tpu_torch.physics import mpr as _mpr
from flybody_tpu_torch.physics.state import Data

_EPS = 1e-15

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


# ------------------------------------------------------- analytic rows
# Component algebra on tuples of tensors (the JAX package's narrowphase
# formulas, shared by all analytic pair types).


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _normalize(a):
    n = torch.sqrt(_dot(a, a))
    return _scale(a, 1.0 / torch.clamp(n, min=_EPS)), n


def _where(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def _matcol(m, j):
    return (m[0 + j], m[3 + j], m[6 + j])


def _matvec(m, v):
    return (m[0] * v[0] + m[1] * v[1] + m[2] * v[2],
            m[3] * v[0] + m[4] * v[1] + m[5] * v[2],
            m[6] * v[0] + m[7] * v[1] + m[8] * v[2])


def _matvec_t(m, v):
    return (m[0] * v[0] + m[3] * v[1] + m[6] * v[2],
            m[1] * v[0] + m[4] * v[1] + m[7] * v[2],
            m[2] * v[0] + m[5] * v[1] + m[8] * v[2])


def _plane_sphere_row(pp, pn, c, r):
    dist = _dot(_sub(c, pp), pn) - r
    return dist, _sub(c, _scale(pn, r + 0.5 * dist)), pn


def _rows_plane_sphere(p1, m1, s1, p2, m2, s2):
    return [_plane_sphere_row(p1, _matcol(m1, 2), p2, s2[0])]


def _rows_plane_capsule(p1, m1, s1, p2, m2, s2):
    pn, axis = _matcol(m1, 2), _matcol(m2, 2)
    r, h = s2[0], s2[1]
    return [_plane_sphere_row(p1, pn, _add(p2, _scale(axis, h)), r),
            _plane_sphere_row(p1, pn, _sub(p2, _scale(axis, h)), r)]


def _rows_plane_ellipsoid(p1, m1, s1, p2, m2, s2):
    pn = _matcol(m1, 2)
    nl = _matvec_t(m2, pn)
    sx, sy, sz = s2
    denom = torch.sqrt((sx * nl[0]) ** 2 + (sy * nl[1]) ** 2
                       + (sz * nl[2]) ** 2)
    inv = -1.0 / torch.clamp(denom, min=_EPS)
    x_local = (sx * sx * nl[0] * inv, sy * sy * nl[1] * inv,
               sz * sz * nl[2] * inv)
    point = _add(p2, _matvec(m2, x_local))
    dist = _dot(_sub(point, p1), pn)
    return [(dist, _sub(point, _scale(pn, 0.5 * dist)), pn)]


def _rows_plane_cylinder(p1, m1, s1, p2, m2, s2):
    n, a = _matcol(m1, 2), _matcol(m2, 2)
    r, h = s2[0], s2[1]
    ca = _dot(a, n)
    lower = _sub(p2, _scale(a, torch.sign(ca) * h))
    u_n, un = _normalize(_sub(n, _scale(a, ca)))
    u = _where(un > 1e-12, u_n, _matcol(m2, 0))
    w = _cross(a, u)
    deep = _sub(lower, _scale(u, r))
    c120, s120 = -0.5, 0.866025403784439
    rim2 = _sub(lower, _add(_scale(u, r * c120), _scale(w, r * s120)))
    rim3 = _sub(lower, _sub(_scale(u, r * c120), _scale(w, r * s120)))
    nperp, _ = _normalize(_sub(n, _scale(a, ca)))
    side1 = _sub(_add(p2, _scale(a, h)), _scale(nperp, r))
    side2 = _sub(_sub(p2, _scale(a, h)), _scale(nperp, r))
    lying = torch.abs(ca) < 1e-4
    rows = []
    for i, pt in enumerate([_where(lying, side1, deep),
                            _where(lying, side2, rim2),
                            _where(lying, side2, rim3)]):
        dist = _dot(_sub(pt, p1), n)
        if i == 2:
            dist = torch.where(lying, torch.full_like(dist, 1e10), dist)
        rows.append((dist, _sub(pt, _scale(n, 0.5 * dist)), n))
    return rows


def _sphere_sphere_row(c1, r1, c2, r2):
    n, dn = _normalize(_sub(c2, c1))
    dist = dn - r1 - r2
    return dist, _add(c1, _scale(n, r1 + 0.5 * dist)), n


def _rows_sphere_sphere(p1, m1, s1, p2, m2, s2):
    return [_sphere_sphere_row(p1, s1[0], p2, s2[0])]


def _rows_sphere_capsule(p1, m1, s1, p2, m2, s2):
    a = _matcol(m2, 2)
    h = s2[1]
    t = torch.clamp(_dot(_sub(p1, p2), a), -h, h)
    return [_sphere_sphere_row(p1, s1[0], _add(p2, _scale(a, t)), s2[0])]


def _rows_capsule_capsule(p1, m1, s1, p2, m2, s2):
    a1, a2 = _matcol(m1, 2), _matcol(m2, 2)
    r1, h1, r2, h2 = s1[0], s1[1], s2[0], s2[1]
    rv = _sub(p1, p2)
    a_, e_, f_ = _dot(a1, a1), _dot(a2, a2), _dot(a2, rv)
    cd, b_ = _dot(a1, rv), _dot(a1, a2)
    denom = a_ * e_ - b_ * b_
    s = torch.where(denom > 1e-14,
                    (b_ * f_ - cd * e_) / torch.clamp(denom, min=_EPS),
                    torch.zeros_like(denom))
    s = torch.clamp(s, -h1, h1)
    t = (b_ * s + f_) / torch.clamp(e_, min=_EPS)
    t_cl = torch.clamp(t, -h2, h2)
    s = torch.clamp((b_ * t_cl - cd) / torch.clamp(a_, min=_EPS), -h1, h1)
    t = torch.clamp((b_ * s + f_) / torch.clamp(e_, min=_EPS), -h2, h2)
    q1 = _add(p1, _scale(a1, s))
    q2 = _add(p2, _scale(a2, t))
    d = _sub(q2, q1)
    tiny = torch.sqrt(_dot(d, d)) < 1e-12
    fb = _cross(a1, a2)
    fbn = torch.sqrt(_dot(fb, fb))
    ex = (torch.ones_like(fbn), torch.zeros_like(fbn), torch.zeros_like(fbn))
    fb = _where(fbn > 1e-12, _scale(fb, 1.0 / torch.clamp(fbn, min=_EPS)),
                _cross(a1, ex))
    q2 = _where(tiny, _add(q2, _scale(fb, 1e-12)), q2)
    return [_sphere_sphere_row(q1, r1, q2, r2)]


_ROW_FNS = {
    (_s.GEOM_PLANE, _s.GEOM_SPHERE): _rows_plane_sphere,
    (_s.GEOM_PLANE, _s.GEOM_CAPSULE): _rows_plane_capsule,
    (_s.GEOM_PLANE, _s.GEOM_ELLIPSOID): _rows_plane_ellipsoid,
    (_s.GEOM_PLANE, _s.GEOM_CYLINDER): _rows_plane_cylinder,
    (_s.GEOM_SPHERE, _s.GEOM_SPHERE): _rows_sphere_sphere,
    (_s.GEOM_SPHERE, _s.GEOM_CAPSULE): _rows_sphere_capsule,
    (_s.GEOM_CAPSULE, _s.GEOM_CAPSULE): _rows_capsule_capsule,
}
ANALYTIC_KEYS = frozenset(_ROW_FNS)


def _rows(key, c1, c2, s1, s2):
    """(dist, pos, normal) rows of one type segment; c1/c2 (..., 12)
    [pos | row-major mat], s1/s2 (..., 3)."""
    c1t = c1.unbind(-1)
    c2t = c2.unbind(-1)
    rows = _ROW_FNS[key](c1t[:3], c1t[3:12], s1.unbind(-1), c2t[:3],
                         c2t[3:12], s2.unbind(-1))
    return [(d, torch.stack(p, -1), torch.stack(n, -1)) for d, p, n in rows]


@functools.lru_cache(maxsize=8)
def dense_slot_ids(meta: _s.Meta) -> np.ndarray:
    """Global slot ids of the plane/sphere analytic slots that the
    compact collide emits densely, in slot order."""
    tb = pair_tables(meta)
    ids, slot_lo = [], 0
    for key, (g1, g2, k) in tb['groups'].items():
        n = len(g1) * k
        if key in ANALYTIC_KEYS and key != _CC_KEY:
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
    """Dense plane/sphere slots (dense_slot_ids order) plus the compact
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
    B, P = idx.shape
    dist, n, pos = _mpr.mpr_penetration(
        sel[..., 8], sel[..., 9], c1[..., :3], c1[..., 3:].reshape(B, P, 3, 3),
        sel[..., 0:3], c2[..., :3], c2[..., 3:].reshape(B, P, 3, 3),
        sel[..., 4:7], sel[..., 3], sel[..., 7], polish_iters=8,
        smooth_mask=sel[..., 10] > 0.5)
    return CompactBlock(idx=sel[..., 25], dist=dist, pos=pos, normal=n,
                        params=sel[..., 11:25])


def collide(model: FlyModel, data: Data, mpr_top_p: int,
            cc_top_p: int) -> Contact:
    """Candidate contacts: dense plane/sphere slots + compact blocks. The
    capsule-capsule and merged-MPR blocks keep the `cc_top_p` and
    `mpr_top_p` broadphase candidates with the smallest bounding-sphere
    distance."""
    meta = model.meta
    tb = pair_tables(meta)
    gcat = _geom_cat(data)
    size = model.geom_size
    dists, poss, normals = [], [], []
    for key, (g1, g2, k) in tb['groups'].items():
        if key not in ANALYTIC_KEYS or key == _CC_KEY:
            continue
        rows = _rows(key, gcat[:, g1], gcat[:, g2], size[g1], size[g2])
        # Slot order is pair-major: slot = pair * k + row.
        dists.append(torch.stack([r[0] for r in rows], -1).flatten(1))
        poss.append(torch.stack([r[1] for r in rows], -2).flatten(1, 2))
        normals.append(torch.stack([r[2] for r in rows], -2).flatten(1, 2))
    blocks = (_cc_compact(model, data, gcat, cc_top_p),
              _mpr_merged(model, data, gcat, mpr_top_p))
    return Contact(dist=torch.cat(dists, 1), pos=torch.cat(poss, 1),
                   normal=torch.cat(normals, 1), blocks=blocks)
