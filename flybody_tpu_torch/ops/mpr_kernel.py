"""The MPR narrowphase: kernels 6 (merged) and 20 (per type pair).

Counterpart of flybody_tpu/ops/mpr_kernel.py: Minkowski Portal Refinement
at fixed trip counts (10 discovery and 24 refinement iterations, masked by
the done / separated flags, then `polish_iters` polish steps).

  * `mpr_merged` (kernel 6; the TPU's `make_mpr_merged_pe`,
    `_mpr_merged_pallas`): the broadphase-selected candidates of every
    mixed-type pair group at once, each pair with its own geom type codes;
    polish accepted on smooth (cylinder-free) pairs only. Plain version
    `mpr_merged_ref`.
  * `mpr_pair` (kernel 20; the TPU's `make_mpr_pe`, `_mpr_pallas`): the
    candidates of ONE type pair, its supports fixed at compile time; polish
    accepted on every pair (no smooth mask, as the TPU kernel). Plain
    version `mpr_pair_ref`. The kernel has the seven convex pairs of the
    walking model (PAIRS) and raises on any other.

Operands, per env and candidate: c1, c2 (B, P, 12) [pos | row-major
xmat] of the two geoms; prm (B, P, 11) [size1 (3) | margin1 | size2 (3) |
margin2 | type1 | type2 | smooth], the JAX package's per-pair table
layout, of which `mpr_pair` takes the first 8 columns. Returns (dist (B,
P), normal (B, P, 3), pos (B, P, 3)). The wrappers launch csrc/mpr.cu on
CUDA tensors (float32, contiguous; anything else raises) and run the plain
versions (physics/mpr.mpr_penetration) on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.ops import _cuda
from flybody_tpu_torch.physics import mpr as _mpr

launches = 0  # mpr_merged kernel launches
pair_launches = 0  # mpr_pair kernel launches
# The type pairs mpr_pair's kernel is instantiated for (csrc/mpr.cu).
PAIRS = ((_s.GEOM_SPHERE, _s.GEOM_ELLIPSOID),
         (_s.GEOM_SPHERE, _s.GEOM_CYLINDER),
         (_s.GEOM_CAPSULE, _s.GEOM_ELLIPSOID),
         (_s.GEOM_CAPSULE, _s.GEOM_CYLINDER),
         (_s.GEOM_ELLIPSOID, _s.GEOM_ELLIPSOID),
         (_s.GEOM_ELLIPSOID, _s.GEOM_CYLINDER),
         (_s.GEOM_CYLINDER, _s.GEOM_CYLINDER))


def mpr_merged_ref(c1, c2, prm, polish_iters: int,
                   refine_iters: int = _mpr.REFINE_ITERS):
    """The plain version (`refine_iters` other than 24 only for controls
    that are meant to disagree)."""
    mat_shape = c1.shape[:-1] + (3, 3)
    return _mpr.mpr_penetration(
        prm[..., 8], prm[..., 9], c1[..., :3], c1[..., 3:].reshape(mat_shape),
        prm[..., 0:3], c2[..., :3], c2[..., 3:].reshape(mat_shape),
        prm[..., 4:7], prm[..., 3], prm[..., 7], polish_iters=polish_iters,
        smooth_mask=prm[..., 10] > 0.5, refine_iters=refine_iters)


def mpr_merged(c1, c2, prm, polish_iters: int):
    """Kernel 6 on CUDA tensors, `mpr_merged_ref` on CPU tensors."""
    if c1.device.type == 'cpu':
        return mpr_merged_ref(c1, c2, prm, polish_iters)
    global launches
    B, P = c1.shape[:2]
    _cuda.check(c1, (B, P, 12), 'c1')
    _cuda.check(c2, (B, P, 12), 'c2')
    _cuda.check(prm, (B, P, 11), 'prm')
    dist = torch.empty((B, P), dtype=torch.float32, device=c1.device)
    normal = torch.empty((B, P, 3), dtype=torch.float32, device=c1.device)
    pos = torch.empty_like(normal)
    V, I = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function('mpr', 'mpr_merged_f32', [V] * 6 + [I] * 2 + [V])
    rc = fn(c1.data_ptr(), c2.data_ptr(), prm.data_ptr(), dist.data_ptr(),
            normal.data_ptr(), pos.data_ptr(), B * P, polish_iters,
            _cuda.stream())
    _cuda.raise_on(rc, 'mpr_merged_f32')
    launches += 1
    return dist, normal, pos


def mpr_pair_ref(type1: int, type2: int, polish_iters: int, c1, c2, prm,
                 refine_iters: int = _mpr.REFINE_ITERS):
    """The plain version of kernel 20: mpr_penetration with the pair's
    type codes and no smooth mask (`refine_iters` other than 24 only for
    controls that are meant to disagree)."""
    mat_shape = c1.shape[:-1] + (3, 3)
    t1 = prm.new_full(prm.shape[:-1], float(type1))
    t2 = prm.new_full(prm.shape[:-1], float(type2))
    return _mpr.mpr_penetration(
        t1, t2, c1[..., :3], c1[..., 3:].reshape(mat_shape), prm[..., 0:3],
        c2[..., :3], c2[..., 3:].reshape(mat_shape), prm[..., 4:7],
        prm[..., 3], prm[..., 7], polish_iters=polish_iters,
        refine_iters=refine_iters)


def mpr_pair(type1: int, type2: int, polish_iters: int, c1, c2, prm):
    """Kernel 20 on CUDA tensors, `mpr_pair_ref` on CPU tensors. prm (B, P,
    8) [size1 | margin1 | size2 | margin2]."""
    if c1.device.type == 'cpu':
        return mpr_pair_ref(type1, type2, polish_iters, c1, c2, prm)
    global pair_launches
    if (type1, type2) not in PAIRS:
        raise NotImplementedError(f'mpr_pair kernel: type pair '
                                  f'{(type1, type2)}')
    B, P = c1.shape[:2]
    _cuda.check(c1, (B, P, 12), 'c1')
    _cuda.check(c2, (B, P, 12), 'c2')
    _cuda.check(prm, (B, P, 8), 'prm')
    dist = torch.empty((B, P), dtype=torch.float32, device=c1.device)
    normal = torch.empty((B, P, 3), dtype=torch.float32, device=c1.device)
    pos = torch.empty_like(normal)
    V, I = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function('mpr', 'mpr_pair_f32', [I, I] + [V] * 6 + [I] * 2
                        + [V])
    rc = fn(type1, type2, c1.data_ptr(), c2.data_ptr(), prm.data_ptr(),
            dist.data_ptr(), normal.data_ptr(), pos.data_ptr(), B * P,
            polish_iters, _cuda.stream())
    _cuda.raise_on(rc, 'mpr_pair_f32')
    pair_launches += 1
    return dist, normal, pos
