"""The unpacked-M path's plain versions at float32 against the Pallas
kernels in interpret mode.

Rows 14 (the dense factor), 18 (the arrow factor) and 19 (the arrow
substitution) of PERF.md's kernel table, and K3's dense form (the fused
arrow factor + solve of a dense A with m right-hand sides): the JAX
package's TPU kernels run in interpret mode on the CPU on the same float32
inputs as the port's plain versions, which are what the CUDA kernels are
held against on the card. Bounds: the JAX tests' own for these kernels:
  * factor_batched / solve_batched / factor_solve_batched on dense A
    (tests/test_arrow.py:94-122): atol 3e-6; on packed A (:256-272): atol
    5e-6; with 1 and 25 right-hand sides;
  * cholesky.chol (tests/test_ops.py:26-36): atol 2e-5, rtol 2e-3, and
    zeros above the diagonal; at n 24 (the capacitance, 3 SB at SB 8)
    and 108.
The walking model's partition comes from the shipped asset. Row 10 is in
tests/test_torch_reuse_interpret.py (a second file, so that each stays
within seconds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.model import spec as jspec
from flybody_tpu.ops import arrow as jarrow
from flybody_tpu.ops import cholesky as jchol
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.ops import arrow as tarrow
from flybody_tpu_torch.ops import cholesky as tchol

B = 128  # one lane block of envs


@pytest.fixture(scope='module')
def parts():
    jp = jarrow.build_partition(jspec.load(tspec.WALK_IMITATION_NPZ).meta)
    tp = tarrow.build_partition(tspec.load(device='cpu').meta)
    assert tuple(tp) == tuple(jp)
    return jp, tp


def arrow_spd(part, rng, n):
    """n random SPD matrices with the arrow sparsity (test_ops.py's
    rand_arrow_spd), float32."""
    nv = part.nv
    mask = np.zeros((nv, nv), np.float32)
    mask[:part.nr, :] = 1
    mask[:, :part.nr] = 1
    for lo, d in zip(part.los, part.ds):
        mask[lo:lo + d, lo:lo + d] = 1
    out = []
    for _ in range(n):
        X = rng.randn(nv, nv).astype(np.float32) * 0.2
        A = (X @ X.T + np.eye(nv, dtype=np.float32) * 3.0) * mask
        A = A + np.eye(nv, dtype=np.float32) * 3.0
        out.append((A + A.T) / 2)
    return np.stack(out)


@pytest.fixture(scope='module')
def mats(parts):
    jp, _ = parts
    rng = np.random.RandomState(2)
    A = arrow_spd(jp, rng, B)
    Ap = np.array(jax.vmap(lambda a: jarrow.pack_sym_ref(jp, a))(
        jnp.asarray(A)))
    F = np.array(jax.vmap(lambda a: jarrow.factor_ref(jp, a))(
        jnp.asarray(A)))
    return A, Ap, F, {1: rng.randn(B, jp.nv).astype(np.float32),
                      25: rng.randn(B, jp.nv, 25).astype(np.float32)}


@pytest.mark.parametrize('form', ['dense', 'packed'])
def test_arrow_factor_matches_pallas(parts, mats, form):
    """Row 18."""
    jp, tp = parts
    A, Ap, _, _ = mats
    a = A if form == 'dense' else Ap
    F_p = jarrow.factor_batched(jp, jnp.asarray(a), interpret=True)
    F_t = tarrow.factor(tp, torch.as_tensor(a))
    atol = 3e-6 if form == 'dense' else 5e-6
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_p), rtol=0,
                               atol=atol)


@pytest.mark.parametrize('m', [1, 25])
def test_arrow_solve_matches_pallas(parts, mats, m):
    """Row 19, given the reference factor."""
    jp, tp = parts
    _, _, F, rhs = mats
    x_p = jarrow.solve_batched(jp, jnp.asarray(F), jnp.asarray(rhs[m]),
                               interpret=True)
    x_t = tarrow.solve(tp, torch.as_tensor(F), torch.as_tensor(rhs[m]))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_p), rtol=0,
                               atol=3e-6)


@pytest.mark.parametrize('form,m', [('dense', 1), ('dense', 25),
                                    ('packed', 25)])
def test_arrow_factor_solve_matches_pallas(parts, mats, form, m):
    """K3 with a dense A and m right-hand sides (and packed, m 25)."""
    jp, tp = parts
    A, Ap, _, rhs = mats
    a = A if form == 'dense' else Ap
    F_p, x_p = jarrow.factor_solve_batched(jp, jnp.asarray(a),
                                           jnp.asarray(rhs[m]),
                                           interpret=True)
    F_t, x_t = tarrow.factor_solve(tp, torch.as_tensor(a),
                                   torch.as_tensor(rhs[m]))
    atol = 3e-6 if form == 'dense' else 5e-6
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_p), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_p), rtol=0,
                               atol=atol)


@pytest.mark.parametrize('n', [24, 108])
def test_chol_matches_pallas(n):
    """Row 14."""
    rng = np.random.RandomState(n)
    G = rng.randn(B, n, n)
    A = (np.einsum('bij,bkj->bik', G, G) + 10.0 * np.eye(n)).astype(
        np.float32)
    L_p = jchol.chol(jnp.asarray(A), interpret=True)
    L_t = tchol.chol(torch.as_tensor(A))
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_p), atol=2e-5,
                               rtol=2e-3)
    assert np.all(np.triu(L_t.numpy(), 1) == 0.0)
