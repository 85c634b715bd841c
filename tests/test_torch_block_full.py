"""Kernel 9's block-full mode against the JAX package.

The block-full Newton block (`newton_fused.newton_block_full`, csrc/
newton.cu's kBlockFull) assembles each refactor block's packed Hessian and
Woodbury rows inside the kernel, in float32 without the split form's bf16
rounding; the preset `default_full` runs it (the JAX package with
FLYBODY_NEWTON_BLOCK_FULL=1, solver.py:884-891).

  * float64: `newton_block_full_ref` vs the JAX `_ref_block_full` on
    seeded arrow-SPD matrices and arrow-compatible contact rows
    (test_torch_solver_kernels.newton_inputs, as tests/test_ops.py:649-700
    builds them): max |port - jax| <= 1e-8 of each output's largest
    value, at the default preset's 8 line-search steps and at 60, where
    float64's bracket has collapsed. Between the two the exact line
    search's final-bracket midpoint follows the rounding of phi' at the
    Newton probe (ROADMAP section 3): at 30 steps the two packages differ
    by 1e-6 to 3e-5 of scale in x and msm (the same formulas agree to
    1e-15 at 8 steps and 1e-11 at 60).
  * float32: the wrapper (its plain version on CPU tensors) vs
    `make_newton_block_full_pe(..., interpret=True)`, the Pallas kernel
    in interpret mode, at tests/test_ops.py:707's atol 3e-3.

tests/test_torch_block_full_solve.py holds `solver.solve` at the
default_full preset against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flybody_tpu.ops import newton_fused as jnf
from flybody_tpu_torch.ops import newton_fused as tnf
from test_torch_solver_kernels import (_close, _t, newton_inputs,
                                       parts)  # noqa: F401

F64_TOL = 1e-8
INTERPRET_ATOL = 3e-3
OUT = ('x', 'msm', 'jar_l', 'jar_c')


def full_args_jax(d):
    return (d['Mp'], d['conJ'], d['ohb'], d['x'], d['msm'], d['jar_l'],
            d['jar_c'], d['lim_params'], d['con_params5'])


def full_args_torch(d):
    bsel = np.argmax(d['ohb'], axis=-1).astype(np.int32)
    return tuple(_t(a) for a in (
        d['Mp'], d['conJ'], bsel, d['x'], d['msm'], d['jar_l'], d['jar_c'],
        d['lim_params'], d['con_params5']))


@pytest.mark.parametrize('ls_iters', [8, 60])
def test_block_full_ref_matches_jax(parts, ls_iters):
    jp, tp = parts
    n_iters = 3
    d = newton_inputs(jp, np.float64)
    ref = jax.jit(jax.vmap(lambda *a: jnf._ref_block_full(
        jp, d['lim_dof'], d['lim_sign'], ls_iters, n_iters, *a)))(
        *map(jnp.asarray, full_args_jax(d)))
    out = tnf.newton_block_full_ref(tp, d['lim_dof'], d['lim_sign'],
                                    *full_args_torch(d), ls_iters, n_iters)
    for n, o, r in zip(OUT, out, ref):
        _close(o, r, F64_TOL, n)


def test_block_full_matches_pallas_interpret(parts):
    jp, tp = parts
    d = newton_inputs(jp, np.float32)
    full = jnf.make_newton_block_full_pe(jp, d['lim_dof'], d['lim_sign'], 30,
                                         2, interpret=True)
    ref = jax.vmap(full)(*map(jnp.asarray, full_args_jax(d)))
    out = tnf.newton_block_full(tp, d['lim_dof'], d['lim_sign'],
                                *full_args_torch(d), 30, 2)
    for n, o, r in zip(OUT, out, ref):
        o, r = o.numpy(), np.asarray(r)
        assert np.isfinite(r).all() and np.isfinite(o).all(), n
        np.testing.assert_allclose(o, r, rtol=0, atol=INTERPRET_ATOL,
                                   err_msg=n)
