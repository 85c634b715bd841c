"""Kernel 20, the per-type-pair MPR, against the JAX package.

`mpr_kernel.mpr_pair(type1, type2, polish, ...)` is the counterpart of the
JAX package's `make_mpr_pe` / `_mpr_pallas` (ops/mpr_kernel.py:334-449):
MPR penetration of one convex type pair, the supports fixed, no smooth
mask. Its plain version `mpr_pair_ref` is physics/mpr.mpr_penetration with
the pair's type codes. Each of the seven convex pairs of the walking model
(mpr_kernel.PAIRS) runs with the polish the collision handler gives it (8
steps unless a geom is a cylinder, collision.py:522-537), on random poses
and sizes made from a numpy seed as tests/test_ops.py:229-279 makes them,
and is held at float64 on the pairs nearer than 1e-3 (separated pairs
have arbitrary normals) against the JAX `mpr_penetration` with the pair's
types as static ints (its per-pair form): dist within 1e-8 and normals'
dot product at least 1 - 1e-8. MPR's discrete choices (which portal face,
whether the polish is accepted) follow the rounding of its inputs, and on
a flat cylinder face the JAX package's own two forms, static types and
per-pair type codes (which the port's plain version follows to 2e-11),
end 5.5e-5 apart in dist at one sphere-cylinder pair of these inputs. So
a near pair may agree with either form, and with the static form on all
but a tenth of the near pairs.

tests/test_torch_mpr_pair_interpret.py holds the float32 wrapper against
the Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.model import spec as _s
from flybody_tpu.physics import mpr as jmpr
from flybody_tpu_torch.ops import mpr_kernel as tmprk

B, P = 4, 8
NEAR = 1e-3
F64_DIST, F64_DOT = 1e-8, 1e-8


def polish_of(types) -> int:
    return 0 if _s.GEOM_CYLINDER in types else 8


def rand_rots(rng, n):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x),
        1 - 2 * (x * x + y * y)], axis=1).reshape(n, 3, 3)


def pair_inputs(seed, dtype):
    """(pos1, mat1, size1, margin1, pos2, mat2, size2, margin2), numpy."""
    rng = np.random.RandomState(seed)
    pos1 = 0.2 * rng.randn(B, P, 3)
    pos2 = pos1 + 0.08 * rng.randn(B, P, 3)
    mat1 = rand_rots(rng, B * P).reshape(B, P, 3, 3)
    mat2 = rand_rots(rng, B * P).reshape(B, P, 3, 3)
    size1 = 0.04 + 0.05 * rng.rand(B, P, 3)
    size2 = 0.04 + 0.05 * rng.rand(B, P, 3)
    mg = np.full((B, P), 5e-4)
    return [a.astype(dtype) for a in (pos1, mat1, size1, mg, pos2, mat2,
                                      size2, mg)]


def port(types, polish, a):
    """mpr_pair on the port's operands c1, c2 (B, P, 12), prm (B, P, 8)."""
    p1, m1, s1, g1, p2, m2, s2, g2 = (torch.as_tensor(x) for x in a)
    c1 = torch.cat([p1, m1.reshape(B, P, 9)], -1)
    c2 = torch.cat([p2, m2.reshape(B, P, 9)], -1)
    prm = torch.cat([s1, g1[..., None], s2, g2[..., None]], -1)
    return [o.numpy() for o in tmprk.mpr_pair(*types, polish, c1, c2, prm)]


def agree(out, ref, dist_tol, dot_tol):
    """Per pair: dist within dist_tol and normals' dot >= dot_tol."""
    return ((np.abs(out[0] - np.asarray(ref[0])) <= dist_tol)
            & (np.sum(out[1] * np.asarray(ref[1]), -1) >= dot_tol))


def held(out, ref, alt, dist_tol, dot_tol):
    """On every near pair of `ref`, `out` agrees with `ref` or with `alt`,
    and with `ref` on all but a tenth of them."""
    near = np.asarray(ref[0]) < NEAR
    assert near.sum() > 5
    ok_ref = agree(out, ref, dist_tol, dot_tol)
    ok = ok_ref | agree(out, alt, dist_tol, dot_tol)
    assert ok[near].all(), np.argwhere(near & ~ok)
    assert (near & ~ok_ref).sum() <= 0.1 * near.sum()


def jax_f64(types, polish, a, codes: bool):
    """The JAX mpr_penetration at float64: the types as static ints (its
    per-pair form) or as per-pair code arrays (its merged form)."""
    def f(*x):
        t1, t2 = (x[8], x[9]) if codes else types
        return jmpr.mpr_penetration(t1, t2, x[0], x[1], x[2], x[4], x[5],
                                    x[6], margin1=x[3], margin2=x[7],
                                    polish_iters=polish)
    a = [np.asarray(x, np.float64) for x in a]
    if codes:
        a += [np.full((B, P), float(t)) for t in types]
    return [np.asarray(o) for o in jax.jit(jax.vmap(f))(*map(jnp.asarray,
                                                            a))]


@pytest.mark.parametrize('types', tmprk.PAIRS)
def test_mpr_pair_ref_matches_jax(types):
    polish = polish_of(types)
    a = pair_inputs(0, np.float64)
    ref = jax_f64(types, polish, a, codes=False)
    held(port(types, polish, a), ref, jax_f64(types, polish, a, codes=True),
         F64_DIST, 1.0 - F64_DOT)
