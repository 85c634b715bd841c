"""The dense path's plain versions at float32 against the Pallas kernels.

Rows 12, 13, 15, 16 and 17 of PERF.md's kernel table: the JAX package's
TPU kernels run in interpret mode on the CPU (`pchol.chol_solve`,
`cho_solve`, `cho_solve_multi` with interpret=True, `pls._ls_pallas`,
`ngs._noslip_pallas`) on the same float32 inputs as the port's plain
versions, which are what the CUDA kernels are held against on the card.
Bounds: tests/test_ops.py's for these kernels against their XLA
references (lines 26-100 and 183-230): factor atol 2e-5 / rtol 2e-3,
solve atol 2e-5, multi-RHS solve atol 5e-5 / rtol 2e-3, line search
rtol 2e-2 / atol 1e-3, sweeps atol 1e-4.

The line search returns the midpoint of its final bracket, and rounding
can pick which end moves once the Newton probe lands on the root of phi'
(ROADMAP section 3). Where the Pallas kernel lands off the float64 answer
by more than the bound (two envs of these 64; in one the port does too,
in the other it lands on the float64 answer, 0.00841, and the kernel on
0.00721), the port may be held to the float64 answer instead, and such
envs may be at most a tenth of the batch, as
tests/test_torch_collision_interpret.py does for MPR.
"""

import jax.numpy as jnp
import numpy as np
import torch

from flybody_tpu.ops import cholesky as pchol
from flybody_tpu.ops import linesearch as pls
from flybody_tpu.ops import noslip_gs as ngs
from flybody_tpu_torch.ops import cholesky as tchol
from flybody_tpu_torch.ops import linesearch as tls
from flybody_tpu_torch.ops import noslip_gs as tngs
from test_torch_dense import gs_inputs, ls_inputs

B, N = 128, 54  # one lane block of envs; test_ops.py's matrix size


def spd32(seed):
    rng = np.random.RandomState(seed)
    G = rng.randn(B, N, N)
    A = np.einsum('bij,bkj->bik', G, G) + 10.0 * np.eye(N)
    return A.astype(np.float32), rng.randn(B, N).astype(np.float32)


def test_chol_solve_matches_pallas_interpret():
    A, b = spd32(0)
    L_p, x_p = pchol.chol_solve(jnp.asarray(A), jnp.asarray(b),
                                interpret=True)
    L_t, x_t = tchol.chol_solve(torch.as_tensor(A), torch.as_tensor(b))
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_p), atol=2e-5,
                               rtol=2e-3)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_p), atol=2e-5)
    assert np.all(np.triu(L_t.numpy(), 1) == 0.0)


def test_cho_solve_matches_pallas_interpret():
    A, b = spd32(1)
    L = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    x_p = pchol.cho_solve(jnp.asarray(L), jnp.asarray(b), interpret=True)
    x_t = tchol.cho_solve(torch.as_tensor(L), torch.as_tensor(b))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_p), atol=2e-5)
    res = np.einsum('bij,bj->bi', A.astype(np.float64), x_t.double().numpy())
    assert np.abs(res - b).max() < 1e-4


def test_cho_solve_multi_matches_pallas_interpret():
    A, _ = spd32(2)
    R = np.random.RandomState(3).randn(B, N, 32).astype(np.float32)
    L = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    X_p = pchol.cho_solve_multi(jnp.asarray(L), jnp.asarray(R),
                                interpret=True)
    X_t = tchol.cho_solve_multi(torch.as_tensor(L), torch.as_tensor(R))
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_p), atol=5e-5,
                               rtol=2e-3)


def test_line_search_matches_pallas_interpret():
    lim, con, sc = (a.astype(np.float32) for a in ls_inputs(7))
    Bl = lim.shape[0]
    pad = (-Bl) % pls.LANES
    a_t = pls._ls_pallas(
        pls._tolanes(jnp.asarray(lim), pad),
        pls._tolanes(jnp.asarray(con), pad),
        pls._tolanes(jnp.asarray(sc[:, :, None]), pad), 6, 6, interpret=True)
    pallas = np.asarray(a_t[0, 0, :Bl])
    got = tls.line_search(torch.as_tensor(lim), torch.as_tensor(con),
                          torch.as_tensor(sc), 6, 6).numpy()
    f64 = tls.line_search(*(torch.as_tensor(v).double()
                            for v in (lim, con, sc)), 6, 6).numpy()

    def near(a, b):
        return np.abs(a - b) <= 1e-3 + 2e-2 * np.abs(b)

    off = ~near(pallas, f64)  # the TPU kernel's rounding flips
    assert off.sum() <= Bl // 10, off.sum()
    assert (near(got, pallas) | (off & near(got, f64))).all()
    assert (got > 0).any()


def test_gs_matches_pallas_interpret():
    a = {k: v.astype(np.float32) for k, v in gs_inputs(0, B=8, nv=32).items()}
    Bg, K, _, nv = a['Jt'].shape
    pad = (-Bg) % ngs.LANES

    def lanes(v, shape):
        v = jnp.moveaxis(jnp.asarray(v).reshape((Bg,) + shape), 0, -1)
        return jnp.concatenate([v, jnp.zeros(shape + (pad,), v.dtype)], -1)

    x_t, ft_t = ngs._noslip_pallas(
        lanes(a['Jt'], (2 * K, nv)), lanes(a['Pt'], (2 * K, nv)),
        lanes(np.swapaxes(a['Ainv'].reshape(Bg, K, 4), 1, 2), (4, K)),
        lanes(np.swapaxes(a['aref'], 1, 2), (2, K)), lanes(a['lim'], (1, K)),
        lanes(a['use'], (1, K)), lanes(a['x0'], (nv, 1)),
        lanes(np.swapaxes(a['ft0'], 1, 2), (2, K)), iterations=3,
        interpret=True)
    x_p = np.moveaxis(np.asarray(x_t[:, 0, :Bg]), -1, 0)
    ft_p = np.swapaxes(np.moveaxis(np.asarray(ft_t[..., :Bg]), -1, 0), 1, 2)
    x, ft = tngs.gs(*(torch.as_tensor(a[k]) for k in
                      ('Jt', 'Pt', 'Ainv', 'aref', 'lim', 'use', 'x0',
                       'ft0')), 3)
    np.testing.assert_allclose(x.numpy(), x_p, atol=1e-4)
    np.testing.assert_allclose(ft.numpy(), ft_p, atol=1e-4)
