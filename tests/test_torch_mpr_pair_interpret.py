"""Kernel 20, the per-type-pair MPR, against the Pallas kernel in
interpret mode, at float32 on the CPU.

For each of the seven convex pairs of the walking model
(mpr_kernel.PAIRS), with the collision handler's polish, on the inputs of
tests/test_torch_mpr_pair.py: the wrapper (its plain version on CPU
tensors) against the JAX package's `_mpr_pallas(..., interpret=True)`
(ops/mpr_kernel.py:334), with tests/test_ops.py:229-279's criterion on the
pairs nearer than 1e-3: dist within 1e-4, dot product of the normals above
0.999. Two float32 iterations can part on a cylinder's flat face: at one
cylinder-cylinder pair of these inputs the Pallas kernel lands on another
portal than the float64 answer (-0.0093 against 0.0056), at another the
port's plain version ends 8.9e-5 from float64 where the kernel ends 1.6e-5
away. So a near pair may agree with the Pallas kernel or with the float64
answer (the JAX `mpr_penetration` with static types;
tests/test_torch_collision_interpret.py's rule), and with the kernel on all
but a tenth of the near pairs.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from flybody_tpu.ops import mpr_kernel as jmprk
from flybody_tpu_torch.ops import mpr_kernel as tmprk
from test_torch_mpr_pair import (B, P, held, jax_f64, pair_inputs, polish_of,
                                 port)

F32_DIST, F32_DOT = 1e-4, 0.999


@pytest.mark.parametrize('types', tmprk.PAIRS)
def test_mpr_pair_matches_pallas_interpret(types):
    polish = polish_of(types)
    a = pair_inputs(0, np.float32)

    def lanes(v, c):
        v = np.moveaxis(v.reshape(B, P, c), 0, -1)
        v = np.moveaxis(v, 1, 0)
        pad = (-B) % jmprk.LANES
        return jnp.asarray(np.concatenate(
            [v, np.zeros((c, P, pad), v.dtype)], -1))

    widths = (3, 9, 3, 1, 3, 9, 3, 1)
    d_t, n_t, _ = jmprk._mpr_pallas(
        types[0], types[1], polish,
        *[lanes(x, c) for x, c in zip(a, widths)], interpret=True)

    def back(v, c):
        v = np.moveaxis(np.asarray(v)[..., :B], 0, 1)
        return np.moveaxis(v, -1, 0).reshape(B, P, c)

    held(port(types, polish, a), (back(d_t, 1)[..., 0], back(n_t, 3)),
         jax_f64(types, polish, a, codes=False), F32_DIST, F32_DOT)
