"""The Newton reuse iterations' plain version at float32 against the
Pallas kernel in interpret mode.

Row 10 of PERF.md's kernel table (flybody_tpu/ops/newton_fused.py::
_fused_fn, make_reuse_pe): n Newton iterations with a kept packed arrow
factor F, the Woodbury operands Z and U and the capacitance factor LC, on
tests/test_ops.py:340-383's inputs at one lane block of envs, with M dense
(the path's form) and packed. The port's plain version (`reuse_ref`) is
what the CUDA kernel is held against on the card. Bounds: the JAX test's
own, atol 5e-4 after one iteration and 2e-3 after three, at 30 line-search
steps (with fewer, float32 branch flips in the search leave alpha
mid-bracket).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.ops import arrow as jarrow
from flybody_tpu.ops import newton_fused as jnf
from flybody_tpu_torch.ops import newton_fused as tnf
from test_torch_unpacked_interpret import B, arrow_spd, parts  # noqa: F401


def reuse_inputs(part):
    """tests/test_ops.py:340-383's inputs at batch B (float32): an arrow
    SPD stand-in for M, its reference factor F, random contact rows J and
    Woodbury rows U, Z = A^-1 U, LC = chol(I + U^T Z), the carried state
    and the row parameters."""
    rng = np.random.RandomState(3)
    K, SB3, nlim, nv = 8, 6, 12, part.nv
    lim_dof = tuple(int(v) for v in rng.choice(nv, nlim, replace=False))
    lim_sign = tuple(float(s) for s in rng.choice([-1.0, 1.0], nlim))
    M = jnp.asarray(arrow_spd(part, rng, B))
    F = jax.vmap(lambda a: jarrow.factor_ref(part, a))(M)
    conJ = jnp.asarray(rng.randn(B, K, 3, nv).astype(np.float32) * 0.3)
    U = jnp.asarray(rng.randn(B, nv, SB3).astype(np.float32) * 0.3)
    Z = jax.vmap(lambda f, u: jarrow.solve_ref(part, f, u))(F, U)
    C = (jnp.eye(SB3)[None]
         + jnp.einsum('bik,bil->bkl', U, Z)).astype(jnp.float32)
    LC = jnp.linalg.cholesky(C)
    x = rng.randn(B, nv).astype(np.float32) * 0.1
    msm = rng.randn(B, nv).astype(np.float32) * 0.1
    jar_l = rng.randn(B, nlim).astype(np.float32) * 0.01
    jar_c = rng.randn(B, K, 3).astype(np.float32) * 0.01
    lim_params = np.stack([(rng.rand(B, nlim) < 0.5).astype(np.float32),
                           rng.rand(B, nlim).astype(np.float32) * 100.0], 1)
    con_params = np.stack([0.5 + rng.rand(B, K).astype(np.float32),
                           (rng.rand(B, K) < 0.8).astype(np.float32),
                           (rng.rand(B, K) < 0.6).astype(np.float32),
                           rng.rand(B, K).astype(np.float32) * 100.0], 1)
    return lim_dof, lim_sign, [np.array(a) for a in (
        F, M, conJ, Z, U, LC, x, msm, jar_l, jar_c, lim_params, con_params)]


@pytest.mark.parametrize('form,n_iters,atol', [
    ('dense', 1, 5e-4), ('dense', 3, 2e-3), ('packed', 1, 5e-4),
    ('packed', 3, 2e-3)])
def test_reuse_matches_pallas(parts, form, n_iters, atol):
    """Row 10 (make_reuse_pe), 30 line-search steps."""
    jp, tp = parts
    lim_dof, lim_sign, args = reuse_inputs(jp)
    if form == 'packed':
        args[1] = np.array(jax.vmap(lambda a: jarrow.pack_sym_ref(jp, a))(
            jnp.asarray(args[1])))
    fused = jnf.make_reuse_pe(jp, lim_dof, lim_sign, 30, n_iters=n_iters,
                              interpret=True)
    out_p = jax.vmap(fused)(*(jnp.asarray(a) for a in args))
    t = [torch.as_tensor(a) for a in args]
    # The port's Woodbury rows are U^T (B, 3 SB, nv).
    t[4] = t[4].transpose(1, 2).contiguous()
    out_t = tnf.reuse(tp, lim_dof, lim_sign, *t, 30, n_iters)
    for name, o, r in zip(('x', 'msm', 'jar_l', 'jar_c'), out_t, out_p):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=atol, err_msg=name)
