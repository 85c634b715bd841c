"""The merged mixed-type MPR narrowphase: kernel 6.

Counterpart of flybody_tpu/ops/mpr_kernel.py (`make_mpr_merged_pe`,
`_mpr_merged_pallas`, row 6 of PERF.md's kernel table): Minkowski Portal
Refinement on the broadphase-selected candidates of every mixed-type pair
group at once, each pair with its own geom type codes, at fixed trip
counts (10 discovery and 24 refinement iterations, masked by the done /
separated flags; `polish_iters` polish steps accepted on smooth pairs
only).

Operands, per env and candidate: c1, c2 (B, P, 12) [pos | row-major
xmat] of the two geoms; prm (B, P, 11) [size1 (3) | margin1 | size2 (3) |
margin2 | type1 | type2 | smooth], the JAX package's per-pair table
layout. Returns (dist (B, P), normal (B, P, 3), pos (B, P, 3)).
`mpr_merged` launches csrc/mpr.cu on CUDA tensors (float32, contiguous;
anything else raises) and runs the plain version `mpr_merged_ref`
(physics/mpr.mpr_penetration) on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from flybody_tpu_torch.ops import _cuda
from flybody_tpu_torch.physics import mpr as _mpr

launches = 0


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
