"""The dense path's kernel-bearing ops against the JAX package, float64.

Rows 12 (noslip Gauss-Seidel sweeps), 13 (standalone line search), 15
(single-RHS substitution), 16 (multi-RHS substitution) and 17 (fused
factor + solve): the same numpy inputs, made from a seed, go through the
JAX function as the JAX package runs it on the CPU (its plain XLA
reference: jnp.linalg.cholesky / jax.scipy's cho_solve, alpha_ref,
noslip_gs._reference) and through the port's plain version on CPU tensors.
Tolerance: max |port - jax| <= 1e-9 * max |jax| per output (the same
formulas in another order). The line search runs the bench preset's trip
counts (6 doubling steps, 6 refinement steps): with more, the guarded
Newton probe lands on the root of phi' in some envs and rounding picks
which end of the bracket moves (ROADMAP section 3; at 8 steps one of these
64 envs moves by 0.17 of the largest step).

tests/test_torch_dense_interpret.py holds the same plain versions at
float32 against the Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.ops import cholesky as jchol
from flybody_tpu.ops import linesearch as jls
from flybody_tpu.ops import noslip_gs as jngs
from flybody_tpu_torch.ops import cholesky as tchol
from flybody_tpu_torch.ops import linesearch as tls
from flybody_tpu_torch.ops import noslip_gs as tngs

TOL = 1e-9


def _close(out, ref, what, tol=TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert np.isfinite(ref).all(), f'{what}: reference not finite'
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f'{what}: max err {err:.3e}, scale {scale:.3e}'


def spd(seed, B=6, n=40, decades=0.0):
    """Random SPD matrices G G^T + n I, rows and columns scaled by a
    diagonal spanning `decades` decades (as a fly's mass matrix does)."""
    rng = np.random.RandomState(seed)
    G = rng.randn(B, n, n)
    A = np.einsum('bij,bkj->bik', G, G) + n * np.eye(n)
    s = 10.0 ** (-decades * rng.rand(B, n))
    return A * s[:, :, None] * s[:, None, :], rng.randn(B, n)


@pytest.mark.parametrize('decades', [0.0, 4.0])
def test_chol_solve_matches_jax(decades):
    """Row 17's plain version: the factor and the solution."""
    A, b = spd(0, decades=decades)
    L_j, x_j = jchol.chol_solve(jnp.asarray(A), jnp.asarray(b))
    L_t, x_t = tchol.chol_solve(torch.as_tensor(A), torch.as_tensor(b))
    _close(L_t, L_j, 'L')
    _close(x_t, x_j, 'x')
    assert np.all(np.triu(L_t.numpy(), 1) == 0.0)


@pytest.mark.parametrize('decades', [0.0, 4.0])
def test_cho_solve_matches_jax(decades):
    """Row 15's plain version, given the JAX factor."""
    A, b = spd(1, decades=decades)
    L = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    x_j = jchol.cho_solve(jnp.asarray(L), jnp.asarray(b))
    x_t = tchol.cho_solve(torch.as_tensor(L), torch.as_tensor(b))
    _close(x_t, x_j, 'x')


@pytest.mark.parametrize('m', [1, 32])
def test_cho_solve_multi_matches_jax(m):
    """Row 16's plain version, given the JAX factor."""
    A, _ = spd(2, decades=2.0)
    R = np.random.RandomState(3).randn(A.shape[0], A.shape[1], m)
    L = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    X_j = jchol.cho_solve_multi(jnp.asarray(L), jnp.asarray(R))
    X_t = tchol.cho_solve_multi(torch.as_tensor(L), torch.as_tensor(R))
    _close(X_t, X_j, 'X')


def ls_inputs(seed, B=64, L=24, K=16):
    """Line-search planes as tests/test_ops.py builds them."""
    rng = np.random.RandomState(seed)
    lim = np.stack([rng.randn(B, L), rng.randn(B, L),
                    (rng.rand(B, L) < 0.5).astype(float),
                    rng.rand(B, L) * 100.0], axis=1)
    con = np.concatenate([
        rng.randn(B, 3, K), rng.randn(B, 3, K), 0.2 + rng.rand(B, 1, K),
        (rng.rand(B, 1, K) < 0.8).astype(float),
        (rng.rand(B, 1, K) < 0.7).astype(float),
        rng.rand(B, 1, K) * 100.0], axis=1)
    sc = np.stack([-np.abs(rng.randn(B)) * 10.0,
                   np.abs(rng.randn(B)) * 5.0 + 1.0], axis=1)
    return lim, con, sc


def test_line_search_matches_jax():
    """Row 13's plain version on stacked planes (B, 4, L), (B, 10, K),
    (B, 2)."""
    lim, con, sc = ls_inputs(7)
    ref = jax.vmap(lambda l, c, s: jls.alpha_ref(l, c, s[:, None], 6, 6))(
        jnp.asarray(lim), jnp.asarray(con), jnp.asarray(sc))
    got = tls.line_search(torch.as_tensor(lim), torch.as_tensor(con),
                          torch.as_tensor(sc), 6, 6)
    _close(got, ref, 'alpha')
    assert (np.asarray(ref) > 0).any()


def gs_inputs(seed, B=4, K=16, nv=40):
    """Noslip sweep operands as tests/test_ops.py builds them; Pt in the
    port's (B, K, 2, nv) layout."""
    rng = np.random.RandomState(seed)
    Jt = rng.randn(B, K, 2, nv)
    Pt = rng.randn(B, K, 2, nv) * 0.05
    A = np.einsum('bkrv,bksv->bkrs', Jt, Pt) + 0.5 * np.eye(2)
    return dict(Jt=Jt, Pt=Pt, Ainv=np.linalg.inv(A),
                aref=rng.randn(B, K, 2), lim=np.abs(rng.randn(B, K)),
                use=(rng.rand(B, K) > 0.3).astype(float),
                x0=rng.randn(B, nv), ft0=0.1 * rng.randn(B, K, 2))


@pytest.mark.parametrize('nv', [40, 216])
def test_gs_matches_jax(nv):
    """Row 12's plain version: 3 sweeps."""
    a = gs_inputs(11, nv=nv)
    ref = jax.vmap(lambda *v: jngs._reference(*v, 3))(
        *(jnp.asarray(a[k]) for k in ('Jt',)),
        jnp.asarray(np.swapaxes(a['Pt'], 2, 3)),
        *(jnp.asarray(a[k]) for k in ('Ainv', 'aref', 'lim', 'use', 'x0',
                                      'ft0')))
    got = tngs.gs(*(torch.as_tensor(a[k]) for k in
                    ('Jt', 'Pt', 'Ainv', 'aref', 'lim', 'use', 'x0', 'ft0')),
                  3)
    _close(got[0], ref[0], 'x')
    _close(got[1], ref[1], 'ft')


def test_block_inverses_match_jax_noslip_blocks():
    """The 2x2 inverses the dense noslip hands row 12: the closed form of
    flybody_tpu/physics/solver.py:1012-1018 (restated in numpy), with the
    determinant held 1e-12 from zero, including singular blocks."""
    a = gs_inputs(12)
    Jt, Pt = a['Jt'], a['Pt']
    Pt[:, 0] = 0.0  # singular blocks: det clamped
    A = np.einsum('bkrv,bksv->bkrs', Jt, Pt)
    det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    det = np.where(np.abs(det) > 1e-12, det,
                   np.where(det >= 0, 1e-12, -1e-12))
    ref = np.stack([np.stack([A[..., 1, 1], -A[..., 0, 1]], -1),
                    np.stack([-A[..., 1, 0], A[..., 0, 0]], -1)],
                   -2) / det[..., None, None]
    got = tngs.block_inverses(torch.as_tensor(Jt), torch.as_tensor(Pt))
    _close(got, ref, 'Ainv')
