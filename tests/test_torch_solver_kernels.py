"""The solver slice's kernel-bearing ops against the JAX package.

Kernels 8 (Newton block), 9 (whole Newton solve) and 11 (fused noslip):
the same numpy inputs, made from a seed, go through the JAX function and
the port's counterpart on CPU tensors (its plain version).

  * float64: `newton_block_ref` vs `newton_fused._ref_block`,
    `newton_solve_ref` vs `_ref_solve_full`, `noslip_fused_ref` vs
    `noslip_gs._fused_ref`; max |port - jax| <= 1e-9 * max |jax| per
    output (the same formulas in another order).
  * float32: the whole-solve reference assembles its Hessian in float32
    without the split form's bf16 rounding; 1e-4 of max |jax| per output
    against `_ref_solve_full` at 30 line-search steps (measured ~5e-6; a
    bf16-rounded Hessian misses by ~5e-3).

At float64 the line-search settings are the presets' (6, 8): with more
steps the guarded Newton probe lands on the root of phi' and the sign of
phi' there (rounding) picks which end of the bracket moves, so the
bracket's midpoint, the step, differs by up to half the bracket. At
float32 30 steps collapse the bracket to rounding, so both sides meet.

Inputs: random arrow-SPD matrices and arrow-compatible contact rows
(tests/helpers.arrow_compatible_rows), as tests/test_ops.py:647-704 builds
them; the noslip inputs come from a real forward pass of the port (the
rows, factor, qacc and forces of `engine.fwd_acc` on contact-rich states,
as tests/test_ops.py:597-637 builds them from the JAX engine).
test_torch_solver_interpret.py holds the float32 wrappers against the
Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.model import spec as jspec
from flybody_tpu.ops import arrow as jarrow
from flybody_tpu.ops import newton_fused as jnf
from flybody_tpu.ops import noslip_gs as jngs
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.ops import arrow as tarrow
from flybody_tpu_torch.ops import newton_fused as tnf
from flybody_tpu_torch.ops import noslip_gs as tngs
from helpers import arrow_compatible_rows

B, K, SB, NLIM_DOFS = 4, 8, 4, 6
F64_TOL = 1e-9
F32_TOL = 1e-4


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(out, ref, tol, what):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert np.isfinite(ref).all(), f'{what}: reference not finite'
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f'{what}: max err {err:.3e}, scale {scale:.3e}'


@pytest.fixture(scope='module')
def parts():
    jm = jspec.load(tspec.WALK_IMITATION_NPZ)
    jp = jarrow.build_partition(jm.meta)
    tp = tarrow.build_partition(tspec.load(device='cpu').meta)
    assert tuple(tp) == tuple(jp)
    return jp, tp


def newton_inputs(part, dtype, seed=7):
    """Seeded per-env inputs of the Newton ops (numpy, `dtype`). Limit
    rows come in (lower, upper) pairs on six dofs, as the model's do."""
    rng = np.random.RandomState(seed)
    nv = part.nv
    dofs = rng.choice(np.arange(part.nr, nv), NLIM_DOFS, replace=False)
    lim_dof = tuple(int(v) for v in np.repeat(dofs, 2))
    lim_sign = tuple([1.0, -1.0] * NLIM_DOFS)
    nlim = len(lim_dof)

    def rand_arrow_spd():
        X = rng.randn(nv, nv) * 0.2
        S = X @ X.T + np.eye(nv) * 3.0
        mask = np.zeros((nv, nv))
        mask[:part.nr, :] = 1
        mask[:, :part.nr] = 1
        for lo, d in zip(part.los, part.ds):
            mask[lo:lo + d, lo:lo + d] = 1
        A = S * mask + np.eye(nv) * 3.0
        return (A + A.T) / 2

    pack = jax.jit(jax.vmap(lambda a: jarrow.pack_sym_ref(part, a)))
    Mp = np.asarray(pack(jnp.asarray(np.stack(
        [rand_arrow_spd() for _ in range(B)]))))
    Hp = np.asarray(pack(jnp.asarray(np.stack(
        [rand_arrow_spd() for _ in range(B)]))))
    conJ, brk = arrow_compatible_rows(part, rng, B, K, nv)
    ohb = np.zeros((B, SB, K))
    for b in range(B):
        ohb[b, np.arange(SB), rng.choice(K, SB, replace=False)] = 1.0
    actc = (rng.rand(B, K) < 0.8).astype(np.float64)
    d = dict(
        lim_dof=lim_dof, lim_sign=lim_sign, Mp=Mp, Hp=Hp, conJ=conJ, ohb=ohb,
        U=rng.randn(B, nv, 3 * SB) * 0.3,
        x=rng.randn(B, nv) * 0.1, msm=rng.randn(B, nv) * 0.1,
        jar_l=rng.randn(B, nlim) * 0.01, jar_c=rng.randn(B, K, 3) * 0.01,
        a_free=rng.randn(B, nv) * 0.1, ws=rng.randn(B, nv) * 0.1,
        lim_aref=rng.randn(B, nlim) * 0.01,
        con_aref=rng.randn(B, K, 3) * 0.01,
        lim_params=np.stack([(rng.rand(B, nlim) < 0.5) * 1.0,
                             rng.rand(B, nlim) * 100.0], axis=1),
        con_params5=np.stack([0.5 + rng.rand(B, K),
                              (rng.rand(B, K) < 0.8) * 1.0, actc,
                              rng.rand(B, K) * 100.0, actc * (1.0 - brk)],
                             axis=1))
    return {k: (v.astype(dtype) if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


def block_args_jax(d):
    return (d['Hp'], d['Mp'], d['conJ'], d['U'], d['x'], d['msm'],
            d['jar_l'], d['jar_c'], d['lim_params'], d['con_params5'][:, :4])


def block_args_torch(d):
    """The port's argument order and layouts (U as rows (B, 3SB, nv))."""
    return tuple(_t(a) for a in (
        d['Hp'], d['Mp'], d['conJ'], np.swapaxes(d['U'], 1, 2), d['x'],
        d['msm'], d['jar_l'], d['jar_c'], d['lim_params'],
        d['con_params5'][:, :4]))


def solve_args_jax(d):
    return (d['Mp'], d['conJ'], d['ohb'], d['a_free'], d['ws'],
            d['lim_aref'], d['con_aref'], d['lim_params'], d['con_params5'])


def solve_args_torch(d):
    bsel = np.argmax(d['ohb'], axis=-1).astype(np.int32)
    return tuple(_t(a) for a in (
        d['Mp'], d['conJ'], bsel, d['a_free'], d['ws'], d['lim_aref'],
        d['con_aref'], d['lim_params'], d['con_params5']))


@pytest.fixture(scope='module')
def f64(parts):
    return newton_inputs(parts[0], np.float64)


@pytest.mark.parametrize('n_iters', [1, 3])
def test_newton_block_ref_matches_jax(parts, f64, n_iters):
    jp, tp = parts
    d = f64
    ref = jax.jit(jax.vmap(lambda *a: jnf._ref_block(
        jp, d['lim_dof'], d['lim_sign'], 8, n_iters, *a)))(
        *map(jnp.asarray, block_args_jax(d)))
    out = tnf.newton_block_ref(tp, d['lim_dof'], d['lim_sign'],
                               *block_args_torch(d), 8, n_iters)
    for n, o, r in zip(('x', 'msm', 'jar_l', 'jar_c'), out, ref):
        _close(o, r, F64_TOL, n)


@pytest.mark.parametrize('ls_iters', [6, 8])
def test_newton_solve_ref_matches_jax(parts, f64, ls_iters):
    jp, tp = parts
    d = f64
    ref = jax.jit(jax.vmap(lambda *a: jnf._ref_solve_full(
        jp, d['lim_dof'], d['lim_sign'], ls_iters, 2, *a)))(
        *map(jnp.asarray, solve_args_jax(d)))
    out = tnf.newton_solve_ref(tp, d['lim_dof'], d['lim_sign'],
                               *solve_args_torch(d), ls_iters, 2)
    for n, o, r in zip(('qacc', 'qfrc', 'f_l', 'f_c'), out, ref):
        _close(o, r, F64_TOL, n)


def test_newton_solve_assembles_its_hessian_in_float32(parts):
    """At float32 the whole-solve reference matches the JAX one closely;
    the split form's bf16-rounded Hessian would not."""
    jp, tp = parts
    d = newton_inputs(jp, np.float32)
    ref = jax.jit(jax.vmap(lambda *a: jnf._ref_solve_full(
        jp, d['lim_dof'], d['lim_sign'], 30, 2, *a)))(
        *map(jnp.asarray, solve_args_jax(d)))
    out = tnf.newton_solve(tp, d['lim_dof'], d['lim_sign'],
                           *solve_args_torch(d), 30, 2)
    for n, o, r in zip(('qacc', 'qfrc', 'f_l', 'f_c'), out, ref):
        _close(o, r, F32_TOL, n)


def noslip_inputs(dtype, K_ns=16, seed=0):
    """Packed factor, tangent rows, forces and qacc of a real forward pass
    of the port on contact-rich states (root lowered onto the floor)."""
    from flybody_tpu_torch.physics import engine
    from flybody_tpu_torch.physics.state import make_data
    tm = tspec.load(device='cpu', dtype=torch.float64)
    rng = np.random.RandomState(seed)
    qpos = np.tile(tm.qpos0.numpy()[None], (B, 1))
    qpos[:, 2] = 0.1
    qpos[:, 7:] += 0.1 * rng.randn(B, tm.meta.nq - 7)
    data = make_data(tm, B).replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(
            0.3 * rng.randn(B, tm.meta.nv)),
        qacc=torch.zeros((B, tm.meta.nv), dtype=torch.float64))
    d, efc, f_c = engine.fwd_acc(tm, data, noslip_iterations=0)
    assert float(efc.con_active[:, :K_ns].sum()) > 2 * B  # contact-rich
    n = lambda t: t.numpy().astype(dtype)  # noqa: E731
    return (n(d.qLD), n(efc.con_J[:, :K_ns, 1:, :]),
            n(efc.con_aref[:, :K_ns, 1:]),
            n(torch.clamp(efc.con_mu[:, :K_ns] * f_c[:, :K_ns, 0], min=0.0)),
            n(efc.con_active[:, :K_ns] * efc.con_frictional[:, :K_ns]),
            n(d.qacc), n(f_c[:, :K_ns, 1:]))


def test_noslip_fused_ref_matches_jax(parts):
    jp, tp = parts
    args = noslip_inputs(np.float64)
    ref = jax.jit(jax.vmap(lambda *a: jngs._fused_ref(jp, 3, *a)))(
        *map(jnp.asarray, args))
    out = tngs.noslip_fused_ref(tp, *map(_t, args), 3)
    for n, o, r in zip(('x', 'ft'), out, ref):
        _close(o, r, F64_TOL, n)
    # The sweeps moved the tangent forces.
    assert float(np.abs(np.asarray(ref[1]) - args[6]).max()) > 0
