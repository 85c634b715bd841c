"""The schedules of the dense factor+solve (row 17) and the many-right-hand-
side Cholesky solve (row 16) in plain torch, on the CPU.

csrc/cholesky.cu's row 17 kernel factors by panels of PANEL columns,
left-looking, in the first design's order (its chol_factor: each
entry's terms in four partial sums, term j in partial j mod 4, ascending,
the last k mod 4 in partial 0; combined as (s0 + s1) + (s2 + s3)): thread
t holds row k0 + t's partial sums over the columns left of the panel
(thread pair (t, t ^ 1) forms rows k0 + t and k0 + (t ^ 1) together, each
over half the panel's columns, and the pair swaps halves), warp 0 adds
the diagonal block's own columns and takes its pivots (lane r holds row
r), then every row below adds the panel's columns and takes
them, and subtracts its forward-substitution terms. The backward
substitution goes by panels from the
last: warp 0 solves the panel's rows from the last up, then every row above
subtracts the panel's terms, the last row first. Row 16's kernel sweeps a chunk of
32 or 64 columns (`multi_cols`) by panels of MULTI_PANEL rows (a thread a
column solves the panel's rows: forward from the first row, each row's
terms in column order, backward from the last row, each solved row
subtracted from the rows above it), each lane holding rows lane + 32 u of
its warp's 4 or 8 columns; row 16 multiplies by the diagonal's
reciprocals where row 17 and the plain versions divide. `chol_schedule`
and `subst_schedule` below are those schedules, each product-and-subtract
one rounding (the kernels' fmaf) at float32:

  (a) every term of every entry of the factor goes to the partial sum the
      first design gives it, and every row of a panel to one thread; every
      (row, column) of X to exactly one (chunk block, warp, lane, register
      row);
  (b) at float32 the schedules agree with chol_ref / subst_ref (the same
      terms, in another order and rounded twice there) to F32_TOL of each
      entry's scale (the largest |value| of its column over the batch);
  (c) at float64 they agree with the JAX package's chol_solve and
      cho_solve_multi (their plain XLA path, as tests/test_torch_dense.py
      runs them) to 1e-12 of each entry's scale.

Sizes: n 24 (one and a half panels), 37 (neither panels nor tiles whole),
108 and 216 (the dense path's), m 1, 32, 45 and 128.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.ops import cholesky as jchol
from flybody_tpu_torch.ops import cholesky as tchol

B = 3
NB = tchol.PANEL
NB16 = tchol.MULTI_PANEL
THREADS = 256
TOL64 = 1e-12
# Float32: the schedules round each product-and-subtract once and the
# plain versions twice, with the same terms in the same order; on these
# well-conditioned operands the two differ by a few float32 roundings of
# each entry's scale (at most 4.7e-6 measured, x at n 216).
F32_TOL = 2e-5
SIZES = (24, 37, 108, 216)
SHAPES = ((24, 1), (37, 45), (108, 32), (216, 32), (216, 128))


def spd(n, seed, dtype):
    """B random SPD matrices G G^T / n + I scaled by a diagonal spanning
    two decades (as a mass matrix's rows do), and b (B, n)."""
    rng = np.random.RandomState(seed)
    G = rng.randn(B, n, n)
    A = np.einsum('bij,bkj->bik', G, G) / n + np.eye(n)
    s = 10.0 ** (-2.0 * rng.rand(B, n))
    A = A * s[:, :, None] * s[:, None, :]
    return (torch.as_tensor(A, dtype=dtype),
            torch.as_tensor(rng.randn(B, n), dtype=dtype))


def fms(acc, x, y):
    """acc - x y rounded once (fmaf(-x, y, acc)); float32 through float64,
    whose product of two float32 values is exact."""
    if acc.dtype == torch.float32:
        return (acc.double() - x.double() * y.double()).float()
    return acc - x * y


# --------------------------------------------------------------- row 17


def part_of(jc, kc):
    """csrc/cholesky.cu part_of: the partial sum of term j (jc = j - k0) of
    an entry in column k (kc = k - k0) of the panel k0."""
    return jc & 3 if jc < 4 * (kc // 4) else 0


def chol_factor_part(j, k):
    """The first design's left-looking factor (chol_factor, since removed):
    the partial sum of term j of an entry in column k."""
    return j % 4 if j < 4 * (k // 4) else 0


def fma(acc, x, y):
    """acc + x y rounded once (fmaf(x, y, acc))."""
    return fms(acc, -x, y)


def factor_schedule(A):
    """Row 17's factor by its panels: thread k0 + t holds row k0 + t's four
    partial sums of each panel column over the columns left of the panel
    (term j in partial j mod 4, ascending); warp 0 and then the rows below
    add the panel's own columns (partial part_of), combine the partials as
    (s0 + s1) + (s2 + s3), subtract them from A and take the pivot."""
    n = A.shape[-1]
    Wm = torch.tril(A).clone()
    for k0 in range(0, n, NB):
        kb = min(NB, n - k0)
        parts = torch.zeros((kb, 4) + Wm.shape[:1] + (n - k0,),
                            dtype=A.dtype)
        for c in range(kb):  # over the columns left of the panel
            for j in range(k0):
                m = j % 4
                parts[c, m] = fma(parts[c, m], Wm[:, k0:, j],
                                  Wm[:, k0 + c, j, None])
        for c in range(kb):  # the panel's own columns, then the pivot
            k = k0 + c
            for j in range(c):
                m = part_of(j, c)
                parts[c, m] = fma(parts[c, m], Wm[:, k0:, k0 + j],
                                  Wm[:, k, k0 + j, None])
            p = parts[c]
            e = Wm[:, k0:, k] - ((p[0] + p[1]) + (p[2] + p[3]))
            d = e[:, c]
            s = torch.rsqrt(torch.clamp(d, min=1e-30))
            Wm[:, k + 1:, k] = e[:, c + 1:] * s[:, None]
            Wm[:, k, k] = d * s
    return torch.tril(Wm)


def subst_schedule(L, R, nb, recip):
    """Rows 16 and 17's substitutions by panels of nb rows: X with L L^T X
    = R (B, n, m); recip: multiply by 1 / L[k][k] (row 16) where row 17
    divides."""
    n = L.shape[-1]
    X = R.clone()
    d = torch.diagonal(L, dim1=1, dim2=2)[..., None]

    def over(x, k):
        return x * (1.0 / d[:, k]) if recip else x / d[:, k]
    starts = list(range(0, n, nb))
    for k0 in starts:  # forward
        kb = min(nb, n - k0)
        for r in range(kb):  # the panel's rows: terms in column order
            s = X[:, k0 + r]
            for r2 in range(r):
                s = fms(s, L[:, k0 + r, k0 + r2, None], X[:, k0 + r2])
            X[:, k0 + r] = over(s, k0 + r)
        for q in range(kb):  # the rows below
            X[:, k0 + kb:] = fms(X[:, k0 + kb:], L[:, k0 + kb:, k0 + q, None],
                                 X[:, k0 + q, None])
    for k0 in reversed(starts):  # backward
        kb = min(nb, n - k0)
        for r in range(kb - 1, -1, -1):  # the panel's rows, the last first
            X[:, k0 + r] = over(X[:, k0 + r], k0 + r)
            for r2 in range(r):
                X[:, k0 + r2] = fms(X[:, k0 + r2], L[:, k0 + r, k0 + r2, None],
                                    X[:, k0 + r])
        for j in range(kb - 1, -1, -1):  # the rows above, the last first
            X[:, :k0] = fms(X[:, :k0], L[:, k0 + j, :k0, None],
                            X[:, k0 + j, None])
    return X


def chol_schedule(A, b):
    L = factor_schedule(A)
    return L, subst_schedule(L, b[..., None], NB, False)[..., 0]


def close(out, ref, what, tol):
    """Each entry within tol of its column's largest |ref| over the batch
    (floored at 1e-6 of the largest overall)."""
    out, ref = torch.as_tensor(np.array(out)), torch.as_tensor(np.array(ref))
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert torch.isfinite(ref).all(), f'{what}: reference not finite'
    o, r = out.double(), ref.double()
    scale = r.abs().amax(dim=[d for d in range(r.dim()) if d != r.dim() - 1])
    scale = scale.clamp(min=1e-6 * float(scale.max()))
    err = float(((o - r).abs() / scale).max())
    assert err <= tol, f'{what}: {err:.3e} of the scale (limit {tol:.0e})'
    return err


@pytest.mark.parametrize('n', SIZES)
def test_row17_panels_assign_each_term_as_the_first_design(n):
    """Every term j < k of every entry (i, k), i >= k, goes to the partial
    sum that chol_factor gives it, exactly once: the terms left of the
    panel by j mod 4 (ascending), the panel's own columns by part_of; and
    each row of the panel's columns goes to one thread (row k0 + t to
    thread t, the diagonal block's to warp 0)."""
    for k0 in range(0, n, NB):
        kb = min(NB, n - k0)
        rows = {k0 + t: t for t in range(THREADS) if k0 + t < n}
        assert sorted(rows) == list(range(k0, n))
        assert all(t < 32 for i, t in rows.items() if i < k0 + kb)
        for c in range(kb):
            k = k0 + c
            got = [j % 4 for j in range(k0)] + [part_of(j, c)
                                                for j in range(c)]
            assert got == [chol_factor_part(j, k) for j in range(k)], (n, k)


@pytest.mark.parametrize('n', SIZES)
def test_row17_schedule_matches_chol_ref_at_float32(n):
    A, b = spd(n, n, torch.float32)
    L, x = chol_schedule(A, b)
    Lp, xp = tchol.chol_solve_ref(A, b)
    assert torch.equal(L, torch.tril(L))
    close(L, Lp, 'L', F32_TOL)
    close(x, xp, 'x', F32_TOL)


@pytest.mark.parametrize('n', SIZES)
def test_row17_schedule_matches_jax_at_float64(n):
    A, b = spd(n, n + 1, torch.float64)
    L, x = chol_schedule(A, b)
    L_j, x_j = jchol.chol_solve(jnp.asarray(A.numpy()), jnp.asarray(b.numpy()))
    close(L, L_j, 'L', TOL64)
    close(x, x_j, 'x', TOL64)


# --------------------------------------------------------------- row 16


@pytest.mark.parametrize('n, m', SHAPES)
def test_row16_owners_cover_each_entry_of_x_once(n, m):
    """Block b of env e takes columns [W b, W b + W), W = multi_cols(m) (8
    warps of W / 8); warp w of it the columns W b + (W / 8) w + (0..W/8-1),
    lane l the rows l + 32 u, u < MULTI_ROWS / 32: every (row, column)
    of X once."""
    W = tchol.multi_cols(m)
    tc = W // 8
    count = np.zeros((n, m), dtype=int)
    for blk in range(math.ceil(m / W)):
        for t in range(THREADS):
            w, lane = t // 32, t % 32
            for u in range(tchol.MULTI_ROWS // 32):
                i = lane + 32 * u
                for c in range(tc):
                    col = blk * W + tc * w + c
                    if i < n and col < m:
                        count[i, col] += 1
    assert (count == 1).all()
    assert n <= tchol.MULTI_ROWS


@pytest.mark.parametrize('n, m', SHAPES)
def test_row16_schedule_matches_subst_ref_at_float32(n, m):
    A, _ = spd(n, 2 * n + m, torch.float32)
    L = tchol.chol_ref(A)
    R = torch.as_tensor(np.random.RandomState(m).randn(B, n, m),
                        dtype=torch.float32)
    close(subst_schedule(L, R, NB16, True), tchol.cho_solve_multi_ref(L, R),
          'X', F32_TOL)


@pytest.mark.parametrize('n, m', SHAPES)
def test_row16_schedule_matches_jax_at_float64(n, m):
    A, _ = spd(n, 3 * n + m, torch.float64)
    L = np.array(jnp.linalg.cholesky(jnp.asarray(A.numpy())))
    R = np.random.RandomState(m + 1).randn(B, n, m)
    X_j = jchol.cho_solve_multi(jnp.asarray(L), jnp.asarray(R))
    close(subst_schedule(torch.as_tensor(L), torch.as_tensor(R), NB16, True),
          X_j, 'X', TOL64)
