"""The solver slice's wrappers against the JAX package's Pallas kernels.

The TPU kernels 8 (`make_newton_block_pe`), 9 (`make_newton_solve_pe`)
and 11 (`make_noslip_fused_pe`) run in interpret mode on the CPU at
float32, as tests/test_ops.py runs them; the port's wrappers run their
plain versions on the same seeded float32 inputs (built by
test_torch_solver_kernels): the block for one iteration (the default
preset's refactor period), the whole solve for two. Tolerances are the
JAX tests' own: the Newton ops at 30 line-search steps (at float32 the
bracket collapses to rounding) with atol 3e-3 (tests/test_ops.py:715,
:782); the noslip at 3e-6 of max |kernel| (tests/test_ops.py:641-644).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flybody_tpu.ops import newton_fused as jnf
from flybody_tpu.ops import noslip_gs as jngs
from flybody_tpu_torch.ops import newton_fused as tnf
from flybody_tpu_torch.ops import noslip_gs as tngs
from test_torch_solver_kernels import (  # noqa: F401 (parts: a fixture)
    block_args_jax, block_args_torch, newton_inputs, noslip_inputs, parts,
    solve_args_jax, solve_args_torch)

NEWTON_ATOL = 3e-3
NOSLIP_TOL = 3e-6


@pytest.fixture(scope='module')
def f32(parts):
    return newton_inputs(parts[0], np.float32)


def _atol(out, ref, what):
    out, ref = np.asarray(out), np.asarray(ref)
    assert np.isfinite(ref).all(), f'{what}: kernel not finite'
    np.testing.assert_allclose(out, ref, rtol=0, atol=NEWTON_ATOL,
                               err_msg=what)


def test_newton_block_matches_pallas_interpret(parts, f32):
    jp, tp = parts
    d = f32
    op = jnf.make_newton_block_pe(jp, d['lim_dof'], d['lim_sign'], 30, 1,
                                  interpret=True)
    ref = jax.vmap(op)(*map(jnp.asarray, block_args_jax(d)))
    out = tnf.newton_block(tp, d['lim_dof'], d['lim_sign'],
                           *block_args_torch(d), 30, 1)
    for n, o, r in zip(('x', 'msm', 'jar_l', 'jar_c'), out, ref):
        _atol(o, r, n)


def test_newton_solve_matches_pallas_interpret(parts, f32):
    jp, tp = parts
    d = f32
    op = jnf.make_newton_solve_pe(jp, d['lim_dof'], d['lim_sign'], 30, 2,
                                  interpret=True)
    ref = jax.vmap(op)(*map(jnp.asarray, solve_args_jax(d)))
    out = tnf.newton_solve(tp, d['lim_dof'], d['lim_sign'],
                           *solve_args_torch(d), 30, 2)
    for n, o, r in zip(('qacc', 'qfrc', 'f_l', 'f_c'), out, ref):
        _atol(o, r, n)


def test_noslip_fused_matches_pallas_interpret(parts):
    import torch
    jp, tp = parts
    args = noslip_inputs(np.float32, K_ns=8)
    ref = jax.vmap(jngs.make_noslip_fused_pe(jp, 3, interpret=True))(
        *map(jnp.asarray, args))
    out = tngs.noslip_fused(tp, *(torch.as_tensor(a) for a in args), 3)
    for n, o, r in zip(('x', 'ft'), out, ref):
        o, r = np.asarray(o), np.asarray(r)
        scale = max(1e-6, float(np.abs(r).max()))
        assert float(np.abs(o - r).max()) / scale < NOSLIP_TOL, n
