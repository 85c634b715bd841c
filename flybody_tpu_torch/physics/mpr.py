"""Minkowski Portal Refinement for convex geom pairs (plain PyTorch).

Counterpart of flybody_tpu/physics/mpr.py: XenoCollide with fixed
iteration counts (10 discovery, 24 refinement, optional smooth-pair
polish), margin-inflated supports, per-pair type dispatch. Batched over
any leading dims. Returns (dist, normal, pos) with MuJoCo's conventions
(normal from geom1 into geom2, dist = +1 when separated).
"""

from __future__ import annotations

import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.physics.math import cross

_EPS = 1e-12
DISCOVERY_ITERS = 10
REFINE_ITERS = 24


def _norm(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=_EPS)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _matvec(mat, v):
    return torch.sum(mat * v[..., None, :], dim=-1)


def _matTvec(mat, v):
    return torch.sum(mat * v[..., :, None], dim=-2)


def support_all(pos, mat, size, d):
    """World-frame support points of sphere, capsule, cylinder and
    ellipsoid geoms in unit direction d."""
    dl = _matTvec(mat, d)
    r = size[..., 0:1]
    h = size[..., 1:2]
    sphere = pos + r * d
    zero = torch.zeros_like(h)
    axial = torch.sign(dl[..., 2:3]) * h
    capsule = pos + _matvec(mat, torch.cat([zero, zero, axial], -1)) + r * d
    radial = dl[..., :2]
    rn = torch.linalg.norm(radial, dim=-1, keepdim=True)
    rdir = torch.where(rn > 1e-10, radial / torch.clamp(rn, min=_EPS),
                       torch.zeros_like(radial))
    cylinder = pos + _matvec(mat, torch.cat([r * rdir, axial], -1))
    s2n = size * size * dl
    den = torch.linalg.norm(size * dl, dim=-1, keepdim=True)
    ellipsoid = pos + _matvec(mat, s2n / torch.clamp(den, min=_EPS))
    return sphere, capsule, cylinder, ellipsoid


def support_any(tc, pos, mat, size, d):
    """Support with per-pair type dispatch (tc: float type codes)."""
    sp, ca, cy, el = support_all(pos, mat, size, d)
    t = tc[..., None]
    return torch.where(t == _s.GEOM_SPHERE, sp,
                       torch.where(t == _s.GEOM_CAPSULE, ca,
                                   torch.where(t == _s.GEOM_CYLINDER, cy,
                                               el)))


def mpr_penetration(t1, t2, pos1, mat1, size1, pos2, mat2, size2, margin1,
                    margin2, polish_iters: int = 0, smooth_mask=None,
                    refine_iters: int = REFINE_ITERS):
    """Batched MPR penetration query for mixed-type pairs."""
    total_margin = margin1 + margin2

    def S(d):
        a = support_any(t1, pos1, mat1, size1, d) + margin1[..., None] * d
        b = support_any(t2, pos2, mat2, size2, -d) - margin2[..., None] * d
        return a - b, a + b

    v0 = pos1 - pos2
    tiny = torch.zeros_like(v0)
    tiny[..., 0] = 1e-7
    v0 = torch.where(torch.linalg.norm(v0, dim=-1, keepdim=True) < 1e-10,
                     tiny, v0)

    n = _norm(-v0)
    v1, s1 = S(n)
    sep = _dot(v1, n) <= 0

    n1 = cross(v1, v0)
    degen = torch.linalg.norm(n1, dim=-1) < 1e-14
    alt = cross(v1 - v0, v1.new_tensor([1.0, 0.013, 0.021]))
    alt2 = cross(v1 - v0, v1.new_tensor([0.021, 1.0, 0.013]))
    alt = torch.where(torch.linalg.norm(alt, dim=-1, keepdim=True) < 1e-14,
                      alt2, alt)
    n1 = _norm(torch.where(degen[..., None], alt, n1))
    v2, s2 = S(n1)
    sep = sep | (_dot(v2, n1) <= 0)

    n2 = cross(v1 - v0, v2 - v0)
    swap = (_dot(n2, v0) > 0)[..., None]
    v1, s1, v2, s2 = (torch.where(swap, v2, v1), torch.where(swap, s2, s1),
                      torch.where(swap, v1, v2), torch.where(swap, s1, s2))
    n2 = _norm(torch.where(swap, -n2, n2))
    v3, s3 = S(n2)
    sep = sep | (_dot(v3, n2) <= 0)

    done = torch.zeros_like(sep)
    for _ in range(DISCOVERY_ITERS):
        out1 = _dot(cross(v1, v3), v0) < 0
        out2 = _dot(cross(v3, v2), v0) < 0
        act = ~done & ~sep
        rep2 = act & out1
        rep1 = act & ~out1 & out2
        done = done | (act & ~out1 & ~out2)
        r2, r1 = rep2[..., None], rep1[..., None]
        v2 = torch.where(r2, v3, v2)
        s2 = torch.where(r2, s3, s2)
        v1 = torch.where(r1, v3, v1)
        s1 = torch.where(r1, s3, s1)
        n_new = _norm(torch.where(r2, cross(v1 - v0, v3 - v0),
                                  cross(v3 - v0, v2 - v0)))
        v3n, s3n = S(n_new)
        cont = rep1 | rep2
        sep = sep | (cont & (_dot(v3n, n_new) <= 0))
        c = cont[..., None]
        v3 = torch.where(c, v3n, v3)
        s3 = torch.where(c, s3n, s3)

    conv = torch.zeros_like(sep)
    best_n = torch.zeros_like(v1)
    best_n[..., 2] = 1.0
    best_depth = torch.zeros_like(v1[..., 0])
    for _ in range(refine_iters):
        n = _norm(cross(v2 - v1, v3 - v1))
        v4, s4 = S(n)
        depth = _dot(v1, n)
        gap = _dot(v4 - v3, n)
        best_n = torch.where(conv[..., None], best_n, n)
        best_depth = torch.where(conv, best_depth, depth)
        conv = conv | (gap < 1e-10)
        d1 = _dot(cross(v4, v1), v0)
        d2 = _dot(cross(v4, v2), v0)
        d3 = _dot(cross(v4, v3), v0)
        rep_v1 = ((d1 < 0) & (d2 < 0)) | ((d1 >= 0) & (d3 >= 0))
        rep_v3 = (d1 < 0) & (d2 >= 0)
        rep_v2 = (d1 >= 0) & (d3 < 0)
        live = ~conv

        def repl(cond, old, new):
            return torch.where((cond & live)[..., None], new, old)

        v1, s1 = repl(rep_v1, v1, v4), repl(rep_v1, s1, s4)
        v2, s2 = repl(rep_v2, v2, v4), repl(rep_v2, s2, s4)
        v3, s3 = repl(rep_v3, v3, v4), repl(rep_v3, s3, s4)
    n, depth = best_n, best_depth

    p = depth[..., None] * n
    area = cross(v2 - v1, v3 - v1)
    w1 = _dot(cross(v2 - p, v3 - p), area)
    w2 = _dot(cross(v3 - p, v1 - p), area)
    w3 = _dot(cross(v1 - p, v2 - p), area)
    wsum = w1 + w2 + w3
    bad = torch.abs(wsum) < 1e-20
    safe = torch.where(bad, torch.ones_like(wsum), wsum)
    w1 = torch.where(bad, torch.ones_like(w1), w1 / safe)
    w2 = torch.where(bad, torch.zeros_like(w2), w2 / safe)
    w3 = torch.where(bad, torch.zeros_like(w3), w3 / safe)
    pos = 0.5 * (w1[..., None] * s1 + w2[..., None] * s2
                 + w3[..., None] * s3)

    if polish_iters:
        scale = torch.maximum(torch.max(size1, dim=-1).values,
                              torch.max(size2, dim=-1).values)[..., None]
        u = n
        for _ in range(polish_iters):
            xd, _ = S(u)
            grad_t = xd - _dot(xd, u)[..., None] * u
            u = _norm(u - 0.3 * grad_t / scale)
        v_p, s_p = S(u)
        depth_p = _dot(v_p, u)
        better = depth_p < depth
        if smooth_mask is not None:
            better = better & smooth_mask
        n = torch.where(better[..., None], u, n)
        depth = torch.where(better, depth_p, depth)
        pos = torch.where(better[..., None], 0.5 * s_p, pos)

    dist = torch.where(sep, torch.ones_like(depth), total_margin - depth)
    pos = torch.where(sep[..., None], torch.zeros_like(pos), pos)
    return dist, n, pos
