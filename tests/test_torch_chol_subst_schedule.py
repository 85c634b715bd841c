"""The schedules of the dense factor (row 14) and the one-right-hand-side
Cholesky solve (row 15) in plain torch, on the CPU.

csrc/cholesky.cu's row 14 runs a warp an env at n <= WARP_ROWS (lane r holds
row r; column k from the left: the entry adds its terms L[r][j] L[k][j],
row k's from lane k, then takes the pivot) and above that row 17's factor
phase without the right-hand side (panels of PANEL columns, left-looking:
thread pair (t, t ^ 1) forms rows k0 + t and k0 + (t ^ 1)'s partial sums
over the columns left of the panel, each over half the panel's columns,
and the pair swaps halves; warp 0 takes the diagonal block, then every
row below; a block is one warp at n <= 128, so the rows past 32 below a
panel go in further passes of the same threads, as do those past 256 at
n > 256). Both sum in
the first design's order: each entry's terms in four partial sums (term j
in partial j mod 4 below 4 (k / 4), ascending, the rest in partial 0),
combined as (s0 + s1) + (s2 + s3). Row 15 runs a warp an env, lane l owning
rows l + 32 u (at n > WARP_ROWS streaming TILE x TILE tiles of L): forward,
each row's terms in column order (y_k = r_k / L[k][k]; every row below
subtracts L[i][k] y_k), backward by rows of L, the last first (x_k = r_k /
L[k][k], then every row j < k subtracts L[k][j] x_k), each
product-and-subtract one rounding (the kernels' fmaf).
`warp_factor`, `panel_factor` and `subst` below are those schedules:

  (a) every term of every entry of row 14 goes to the partial sum the first
      design's loops give it, row 15's loops take every row's terms in the
      first design's order, and every row has one owner (a thread of the
      block and a pass, or a lane and register row of the warp) and every
      env one warp at n <= WARP_ROWS;
  (b) at float32 the schedules agree with chol_ref / cho_solve_ref (the
      same terms, in another order and rounded twice there) to F32_TOL of
      each entry's scale (the largest |value| of its column over the
      batch), and the warp and panel factors agree exactly;
  (c) at float64 they agree with the JAX package's chol and cho_solve
      (their plain XLA path, as tests/test_torch_dense.py runs them) to
      1e-12 of each entry's scale.

Sizes: n 24 (the capacitance: the warp forms), 37 (neither panels nor
lanes whole), 108 and 216 (the dense path's) and 300 (row 14's workspace in
global memory, two rows a thread).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.ops import cholesky as jchol
from flybody_tpu_torch.ops import cholesky as tchol

B = 3
NB = tchol.PANEL
TOL64 = 1e-12
# Float32: the schedules round each product-and-subtract once and the plain
# versions twice, with the same terms in another order; on these
# well-conditioned operands they differ by a few float32 roundings of each
# entry's scale (tests/test_torch_cholesky_schedule.py, same limit).
F32_TOL = 2e-5
SIZES = (24, 37, 108, 216, 300)


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


def fma(acc, x, y):
    """acc + x y rounded once (fmaf); float32 through float64, whose
    product of two float32 values is exact."""
    if acc.dtype == torch.float32:
        return (acc.double() + x.double() * y.double()).float()
    return acc + x * y


def first_design_parts(k):
    """The partial sum of each term j < k of an entry in column k, as the
    first design's loops assign them: terms in fours into s0..s3 while j +
    3 < k, the rest into s0."""
    parts, j = [], 0
    while j + 3 < k:
        parts += [0, 1, 2, 3]
        j += 4
    return parts + [0] * (k - j)


def part_of(jc, kc):
    """csrc/cholesky.cu part_of (jc = j - k0, kc = k - k0)."""
    return jc & 3 if jc < 4 * (kc // 4) else 0


def pivot(W, e, k):
    """Column k from its entries e (rows k..): the pivot rsqrt(max(d,
    1e-30)) scales the rows below, the diagonal becomes d rsqrt(d)."""
    d = e[:, 0]
    s = torch.rsqrt(torch.clamp(d, min=1e-30))
    W[:, k + 1:, k] = e[:, 1:] * s[:, None]
    W[:, k, k] = d * s


def warp_factor(A):
    """Row 14 at n <= WARP_ROWS: the lanes (rows) of column k add their
    terms L[r][j] L[k][j] by part_of(j, k), then take the pivot."""
    n = A.shape[-1]
    W = torch.tril(A).clone()
    for k in range(n):
        p = torch.zeros((4, B, n - k), dtype=A.dtype)
        for j in range(k):
            m = part_of(j, k)
            p[m] = fma(p[m], W[:, k:, j], W[:, k, j, None])
        pivot(W, W[:, k:, k] - ((p[0] + p[1]) + (p[2] + p[3])), k)
    return torch.tril(W)


def panel_factor(A):
    """Row 14 above WARP_ROWS: by panels of NB columns, the rows' partial
    sums over the columns left of the panel (term j in partial j mod 4),
    then the panel's own columns (part_of) and the pivot."""
    n = A.shape[-1]
    W = torch.tril(A).clone()
    for k0 in range(0, n, NB):
        kb = min(NB, n - k0)
        p = torch.zeros((kb, 4, B, n - k0), dtype=A.dtype)
        for j in range(k0):  # left of the panel: all kb columns at once
            p[:, j % 4] = fma(p[:, j % 4], W[None, :, k0:, j],
                              W[:, k0:k0 + kb, j].T[:, :, None])
        for c in range(kb):
            k = k0 + c
            for j in range(c):
                m = part_of(j, c)
                p[c, m] = fma(p[c, m], W[:, k0:, k0 + j],
                              W[:, k, k0 + j, None])
            q = p[c]
            e = W[:, k0:, k] - ((q[0] + q[1]) + (q[2] + q[3]))
            pivot(W, e[:, c:], k)
    return torch.tril(W)


def factor(A):
    n = A.shape[-1]
    return warp_factor(A) if n <= tchol.WARP_ROWS else panel_factor(A)


def subst(L, b):
    """Row 15: forward by columns, backward by rows of L from the last."""
    n = L.shape[-1]
    r = b.clone()
    for k in range(n):
        r[:, k] = r[:, k] / L[:, k, k]
        r[:, k + 1:] = fma(r[:, k + 1:], -L[:, k + 1:, k], r[:, k, None])
    for k in range(n - 1, -1, -1):
        r[:, k] = r[:, k] / L[:, k, k]
        r[:, :k] = fma(r[:, :k], -L[:, k, :k], r[:, k, None])
    return r


def sweep_orders(n):
    """The columns (forward) and rows of L (backward) each row takes a
    term of, in the order the kernels take them, and the step at which it
    divides: at n <= WARP_ROWS one column (row of L) at a time; above, tile
    by tile, a row strip at a time (cho_solve_tiles_kernel): forward, for
    each row block u, the tiles (u, v) left of the diagonal (columns
    ascending), then the diagonal tile (its rows' terms and divisions);
    backward, for each U from the last, the diagonal tile (rows of L
    descending), then the tiles (U, v) left of it."""
    fwd = {i: [] for i in range(n)}
    back = {i: [] for i in range(n)}
    div_f, div_b = {}, {}
    T = tchol.TILE if n > tchol.WARP_ROWS else n
    nb = -(-n // T)

    def rows(u):
        return range(T * u, min(T * u + T, n))
    for u in range(nb):
        for v in range(u + 1):
            for k in rows(v):
                for i in rows(u):
                    if i == k:
                        div_f[i] = len(fwd[i])
                    elif i > k:
                        fwd[i].append(k)
    for U in reversed(range(nb)):
        for v in range(U, -1, -1):
            for k in reversed(rows(U)):
                for j in rows(v):
                    if j == k:
                        div_b[j] = len(back[j])
                    elif j < k:
                        back[j].append(k)
    return fwd, back, div_f, div_b


@pytest.mark.parametrize('n', SIZES)
def test_row14_assigns_each_term_as_the_first_design(n):
    """Every term j < k of every entry (i, k), i >= k, goes to the partial
    sum the first design's loops give it; each row of each column has one
    owner: lane r at n <= 32 (one warp an env), else thread (i - k0) mod
    kT of the panel k0 in pass (i - k0) // kT, the diagonal block's rows
    in warp 0."""
    for k in range(n):
        if n <= tchol.WARP_ROWS:
            got = [part_of(j, k) for j in range(k)]
        else:
            k0 = k - k % NB
            got = [j % 4 for j in range(k0)] + [part_of(j - k0, k - k0)
                                                for j in range(k0, k)]
        assert got == first_design_parts(k), (n, k)
    if n <= tchol.WARP_ROWS:  # lane r: row r
        assert len({r % 32 for r in range(n)}) == n
        return
    kT = tchol.chol_threads(n)
    for k0 in range(0, n, NB):
        owners = {i: ((i - k0) % kT, (i - k0) // kT) for i in range(k0, n)}
        assert len(set(owners.values())) == n - k0
        assert all(t < 32 and p == 0 for i, (t, p) in owners.items()
                   if i < k0 + NB)
        # pairs (t, t ^ 1) form rows k0 + t and k0 + (t ^ 1) together
        assert all(owners.get(i ^ 1, (t ^ 1, p)) == (t ^ 1, p)
                   for i, (t, p) in owners.items() if (i - k0) % 2 == 0)


@pytest.mark.parametrize('n', SIZES)
def test_row15_takes_each_rows_terms_in_the_first_designs_order(n):
    """Forward: row i takes columns 0..i-1 ascending and divides after
    them; backward: row j takes rows n-1..j+1 of L descending and divides
    after them. Lane l and register row u own row l + 32 u, once; envs go
    a warp each, four warps a block."""
    fwd, back, div_f, div_b = sweep_orders(n)
    for i in range(n):
        assert fwd[i] == list(range(i)) and div_f[i] == i, i
        assert back[i] == list(range(n - 1, i, -1)) and div_b[i] == n - 1 - i
    nb = -(-n // tchol.TILE)
    rows = [lane + 32 * u for u in range(nb) for lane in range(32)]
    assert sorted(i for i in rows if i < n) == list(range(n))
    for Bn in (1, 5, 8192):
        envs = [4 * blk + w for blk in range(-(-Bn // 4)) for w in range(4)]
        assert sorted(e for e in envs if e < Bn) == list(range(Bn))


@pytest.mark.parametrize('n', SIZES)
def test_schedules_match_plain_versions_at_float32(n):
    A, b = spd(n, n, torch.float32)
    L = factor(A)
    assert torch.equal(L, torch.tril(L))
    Lp = tchol.chol_ref(A)
    close(L, Lp, 'L', F32_TOL)
    close(subst(Lp, b), tchol.cho_solve_ref(Lp, b), 'x', F32_TOL)
    if n <= tchol.WARP_ROWS:  # the two forms: one order
        assert torch.equal(warp_factor(A), panel_factor(A))


@pytest.mark.parametrize('n', SIZES)
def test_schedules_match_jax_at_float64(n):
    A, b = spd(n, n + 1, torch.float64)
    close(factor(A), jchol.chol(jnp.asarray(A.numpy())), 'L', TOL64)
    L = np.array(jnp.linalg.cholesky(jnp.asarray(A.numpy())))
    close(subst(torch.as_tensor(L), b),
          jchol.cho_solve(jnp.asarray(L), jnp.asarray(b.numpy())), 'x', TOL64)


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
