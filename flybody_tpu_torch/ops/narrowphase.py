"""The analytic narrowphase: kernel 5.

Counterpart of flybody_tpu/ops/narrowphase.py (`_np_pallas`, row 5 of
PERF.md's kernel table). Every analytic pair type, one segment of pairs
per type key, in canonical pair-major slot order: slot = slot_lo + pair *
k + row. The compact collide hands it every analytic group but
capsule-capsule (which runs on its broadphase-selected pairs in
physics/collision.py), the dense collide all of them.

`narrowphase(segs, geom_xpos, geom_xmat, size_table)` launches
csrc/narrowphase.cu on CUDA tensors (float32, contiguous; anything else
raises) and runs the plain version `narrowphase_ref` on CPU tensors.
`segs` is the static segment table: a tuple of (type key, geom1 ids,
geom2 ids, rows per pair), the ids as tuples, in slot order
(collision.analytic_segments). The component algebra and the per-type row
formulas below are the JAX package's, written once over tuples of
tensors; the capsule-capsule block of collision.py uses them too.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.ops import _cuda

launches = 0
_EPS = 1e-15
# The kernel's phases (csrc/narrowphase.cu PHASE marks): a thread's pair
# and poses read, its rows formed, its rows stored.
PHASES = ('index and gather', 'rows', 'store')

# ----------------------------------------------------- component algebra


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


# The type keys in the order of the kernel's type codes
# (csrc/narrowphase.cu: enum PairType): every analytic key.
KERNEL_KEYS = tuple(_ROW_FNS)


def n_slots(segs) -> int:
    return sum(len(g1) * k for _, g1, _, k in segs)


def narrowphase_ref(segs, geom_xpos, geom_xmat, size_table):
    """(dist (B, S), pos (B, S, 3), normal (B, S, 3)) of every segment's
    rows, pair-major within a segment, segments in order."""
    B, n = geom_xpos.shape[:2]
    gcat = torch.cat([geom_xpos, geom_xmat.reshape(B, n, 9)], -1)
    dists, poss, normals = [], [], []
    for key, g1, g2, k in segs:
        g1, g2 = list(g1), list(g2)
        rows = _rows(key, gcat[:, g1], gcat[:, g2], size_table[g1],
                     size_table[g2])
        dists.append(torch.stack([r[0] for r in rows], -1).flatten(1))
        poss.append(torch.stack([r[1] for r in rows], -2).flatten(1, 2))
        normals.append(torch.stack([r[2] for r in rows], -2).flatten(1, 2))
    return torch.cat(dists, 1), torch.cat(poss, 1), torch.cat(normals, 1)


def pair_table(segs) -> np.ndarray:
    """(P, 4) int32 [type code, geom1, geom2, first slot] per pair, pairs
    in slot order: the kernel's pair table."""
    rows, slot = [], 0
    for key, g1, g2, k in segs:
        if key not in KERNEL_KEYS:
            raise NotImplementedError(f'narrowphase kernel: pair type {key}')
        code = KERNEL_KEYS.index(key)
        for a, b in zip(g1, g2):
            rows.append((code, a, b, slot))
            slot += k
    return np.array(rows, np.int32)


_tables: dict = {}  # (id(segs), device) -> (segs, P, S, pair table)


def _table(segs, device: torch.device) -> tuple:
    """(P, S, the pair table on `device`) of a segment table, found by the
    identity of `segs` (the segment tables are cached tuples, and hashing
    one walks all its ids on every call)."""
    hit = _tables.get((id(segs), device))
    if hit is not None and hit[0] is segs:
        return hit[1:]
    table = torch.as_tensor(pair_table(segs), device=device)
    if len(_tables) >= 8:
        _tables.clear()
    _tables[(id(segs), device)] = (segs, table.shape[0], n_slots(segs),
                                   table)
    return _tables[(id(segs), device)][1:]


def narrowphase(segs, geom_xpos, geom_xmat, size_table):
    """Kernel 5 on CUDA tensors, `narrowphase_ref` on CPU tensors. The
    three outputs are views of one buffer."""
    if geom_xpos.device.type == 'cpu':
        return narrowphase_ref(segs, geom_xpos, geom_xmat, size_table)
    global launches
    B, ng = geom_xpos.shape[:2]
    _cuda.check(geom_xpos, (B, ng, 3), 'geom_xpos')
    _cuda.check(geom_xmat, (B, ng, 3, 3), 'geom_xmat')
    _cuda.check(size_table, (ng, 3), 'size_table')
    P, S, table = _table(segs, geom_xpos.device)
    n = B * S
    buf = torch.empty(7 * n, dtype=torch.float32, device=geom_xpos.device)
    dist = buf[:n].view(B, S)
    pos = buf[n:4 * n].view(B, S, 3)
    normal = buf[4 * n:].view(B, S, 3)
    fn = _cuda.function('narrowphase', 'narrowphase_f32', _ARGTYPES)
    rc = fn(geom_xpos.data_ptr(), geom_xmat.data_ptr(),
            size_table.data_ptr(), table.data_ptr(), dist.data_ptr(),
            pos.data_ptr(), normal.data_ptr(), B, ng, P, S, _cuda.stream())
    _cuda.raise_on(rc, 'narrowphase_f32')
    launches += 1
    return dist, pos, normal


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def kernel_info(segs, batch: int) -> dict:
    """Registers a thread, shared memory a block, blocks an SM (the
    occupancy calculator) and grid blocks of the kernel for this segment
    table at this batch."""
    out = (ctypes.c_int * 4)()
    I = ctypes.c_int
    fn = _cuda.function('narrowphase', 'narrowphase_info',
                        [I] * 2 + [ctypes.POINTER(ctypes.c_int * 4)])
    P = sum(len(g1) for _, g1, _, _ in segs)
    _cuda.raise_on(fn(batch, P, ctypes.byref(out)), 'narrowphase_info')
    return _cuda.info_dict(out)


def record_phases(fn, batch: int, stride: int, device):
    """Runs fn() (kernel launches on `batch` envs) with the kernel's phase
    clocks on: every stride-th env's cycles in each phase of PHASES,
    summed over its pairs' threads, an int64 tensor (ceil(batch / stride),
    len(PHASES)) on the CPU."""
    return _cuda.record_phases('narrowphase', 'narrowphase_phase_clock',
                               len(PHASES), fn, batch, stride, device)
