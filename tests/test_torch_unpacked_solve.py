"""The Newton solve and the noslip on the walking fly's dense mass matrix
against the JAX package at float64.

With an arrow partition and a dense qM, the JAX package's solver.solve
takes its arrow branch (solver.py:643-663, 812-960): cross-limb contact
rows leave the Hessian (`hess_active`) and at most SB of them come back by
a rank-3 SB Woodbury correction; each refactor block is one fresh arrow
step (K3 dense form with 1 + 3 SB right-hand sides, the capacitance's
dense factor, the exact line search) and refactor - 1 reuse iterations
(make_reuse_pe); the noslip then sees a packed factor (the fused noslip).
Inputs: the JAX package's profile_engine prep at a flailing state, carried
into the port (tests/walk_states.py); both packages run on the CPU, the
JAX one through its XLA references, the port through its plain versions.

  * solve at SB 8, 8 iterations, refactor 1 and 2, 30 line-search steps:
    per env primal cost and net normal contact force within 1e-9 of the
    largest (ROADMAP's rules: the optimum is flat along near-null
    directions, so x itself is compared where the solve stops early).
  * The dispatch fault of the port's earlier dense-only branch: SB 1, 2
    iterations at refactor 1, from a state where every env has at least 2
    active cross-limb rows, so rows past the budget leave the Hessian in
    the JAX package. The solve stops before convergence on purpose (a
    converged run reaches the same optimum by either algorithm). Per env
    x and primal cost within 1e-9. Both sides run the line search as a
    plain bisection (tests/test_torch_step.py's `bisect_alpha_*`, 60
    halvings): at this state the exact search's probe lands on the root
    of phi' and the rounding of phi' there moves its answer by up to
    2.5e-4 of x's scale between the packages (the midpoint of the final
    bracket; ROADMAP section 3), while with the bisection they agree to
    ~1e-14.
  * noslip with the packed factor on the JAX solve's output, 16 slots: x
    and the friction forces within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.physics import solver as jsol
from flybody_tpu.physics.state import make_data as jmake_data
from flybody_tpu_torch.physics import solver as tsol
from test_torch_step import bisect_alpha_jax, bisect_alpha_torch
from walk_states import jax_efc, jax_prep, models, to_port

TOL = 1e-9


def _close(out, ref, tol, what):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert np.isfinite(ref).all(), f'{what}: reference not finite'
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f'{what}: max err {err:.3e}, scale {scale:.3e}'


def _per_env(out, ref, tol, what):
    """Each env's max error within tol of that env's largest |ref|."""
    out, ref = np.asarray(out), np.asarray(ref)
    err = np.abs(out - ref).reshape(len(ref), -1).max(1)
    scale = np.abs(ref).reshape(len(ref), -1).max(1)
    assert (err <= tol * scale).all(), f'{what}: per env {err / scale}'


@pytest.fixture(scope='module')
def prep():
    return jax_prep()


def jax_solve(prep, iterations, ls_iterations, refactor):
    """The JAX solve, vmapped, traced anew (FLYBODY_SB_BREAK is read at
    trace time)."""
    jm, _ = models()
    d, _, a_free = prep

    def one(qM, qLD, efc, af):
        data = jmake_data(jm).replace(qM=qM, qLD=qLD)
        return jsol.solve(jm, data, jax_efc(efc), af,
                          iterations=iterations,
                          ls_iterations=ls_iterations,
                          refactor_period=refactor)
    return [np.asarray(o) for o in jax.jit(jax.vmap(one))(
        jnp.asarray(d['qM']), jnp.asarray(d['qLD']), prep[1],
        jnp.asarray(a_free))]


def port_solve(prep, iterations, ls_iterations, refactor, sb):
    _, tm = models()
    td, tefc, ta = to_port(prep)
    return tsol.solve(tm, td, tefc, ta, iterations, ls_iterations, None,
                      refactor, sb)


def cost(prep, x):
    td, tefc, ta = to_port(prep)
    return tsol.primal_cost_dense(td.qM, tefc, ta, torch.as_tensor(x))


@pytest.mark.parametrize('refactor', [1, 2])
def test_solve_on_dense_m_matches_jax(prep, refactor, monkeypatch):
    monkeypatch.setenv('FLYBODY_SB_BREAK', '8')
    j = jax_solve(prep, 8, 30, refactor)
    t = port_solve(prep, 8, 30, refactor, 8)
    _close(cost(prep, t[0]), cost(prep, j[0]), TOL, 'primal cost')
    _close(t[3][..., 0].sum(-1), j[3][..., 0].sum(-1), TOL,
           'net normal force')


def test_fault_state_has_cross_limb_rows(prep):
    efc = prep[1]
    brk = (efc['con_active'] * efc['con_break']).sum(1)
    assert (brk >= 2).all(), brk


def test_solve_leaves_rows_past_the_budget_out_of_the_hessian(
        prep, monkeypatch):
    """SB 1, 2 iterations (the dispatch fault's case)."""
    from flybody_tpu.ops import linesearch as jls
    from flybody_tpu_torch.ops import linesearch as tls
    monkeypatch.setenv('FLYBODY_SB_BREAK', '1')
    monkeypatch.setattr(jls, 'alpha_ref', bisect_alpha_jax)
    monkeypatch.setattr(tls, 'alpha_ref', bisect_alpha_torch)
    j = jax_solve(prep, 2, 30, 1)
    t = port_solve(prep, 2, 30, 1, 1)
    _per_env(t[0], j[0], TOL, 'x')
    _per_env(cost(prep, t[0]), cost(prep, j[0]), TOL, 'primal cost')


def test_noslip_on_the_packed_factor_matches_jax(prep, monkeypatch):
    monkeypatch.setenv('FLYBODY_SB_BREAK', '8')
    jm, tm = models()
    d = prep[0]
    qacc, _, _, f_c = jax_solve(prep, 8, 8, 2)

    def one(qLD, efc, q, f):
        data = jmake_data(jm).replace(qLD=qLD)
        return jsol.noslip(jm, data, jax_efc(efc), q, f, iterations=3,
                           max_contacts=16)
    jx, jf = jax.jit(jax.vmap(one))(jnp.asarray(d['qLD']), prep[1],
                                     jnp.asarray(qacc), jnp.asarray(f_c))
    td, tefc, _ = to_port(prep)
    assert td.qLD.dim() == 4  # the packed arrow factor
    tx, tf, _ = tsol.noslip(tm, td, tefc, torch.as_tensor(qacc),
                            torch.as_tensor(f_c), 3, 16)
    _close(tx, jx, TOL, 'x')
    _close(tf, jf, TOL, 'f_c')
