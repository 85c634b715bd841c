"""flybody_tpu_torch's kernel-bearing stages against the JAX package.

For each of K1 (position stage), K2 (velocity/force stage), K3 (arrow
factor+solve) and K4 (sensors): the same numpy inputs, made from a seed, go
through the JAX function (its per-env op under jax.vmap: the XLA reference
on the CPU) and the port's wrapper on CPU tensors (its plain version).

Tolerance: float64, max |port - jax| <= 1e-9 * max |jax| per output (the
two sides run the same formulas in another order). test_torch_interpret.py
holds the same stages against the Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.model import spec as jspec
from flybody_tpu.ops import arrow as jarrow
from flybody_tpu.ops import force_stage as jfs
from flybody_tpu.ops import pos_stage as jps
from flybody_tpu.ops import sens_stage as jss
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.ops import arrow as tarrow
from flybody_tpu_torch.ops import force_stage as tfs
from flybody_tpu_torch.ops import pos_stage as tps
from flybody_tpu_torch.ops import sens_stage as tss

B = 3
K = 64
F64_TOL = 1e-9


def _inputs(dtype):
    """Seeded numpy inputs for every stage (position-stage outputs come
    from the JAX reference so both sides see identical arrays)."""
    jm = jspec.load(tspec.WALK_IMITATION_NPZ, dtype=dtype)
    meta = jm.meta
    rng = np.random.RandomState(0)
    qpos = np.tile(np.asarray(jm.qpos0)[None], (B, 1))
    qpos[:, :3] += 0.05 * rng.randn(B, 3)
    qpos[:, 3:7] += 0.2 * rng.randn(B, 4)
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    qpos[:, 7:] += 0.2 * rng.randn(B, meta.nq - 7)
    qpos = qpos.astype(dtype)
    qvel = (2.0 * rng.randn(B, meta.nv)).astype(dtype)
    act = (0.2 * rng.randn(B, meta.na)).astype(dtype)
    ctrl = (0.3 * rng.randn(B, meta.nu)).astype(dtype)
    ps = [np.asarray(x) for x in
          jax.jit(jax.vmap(jps.make_pos_stage_pe(jm)))(jnp.asarray(qpos))]
    fargs = (qpos, qvel, act, ctrl, ps[11], ps[10], ps[3], ps[4], ps[9],
             ps[5], ps[6], ps[14])
    fs = [np.asarray(x) for x in
          jax.jit(jax.vmap(jfs.make_force_stage_pe(jm)))(
              *map(jnp.asarray, fargs))]
    rhs = (50.0 * rng.randn(B, meta.nv)).astype(dtype)
    cb12 = rng.randint(0, meta.nbody, (B, 2, K)).astype(dtype)
    normal = rng.randn(B, K, 3)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    f_c = rng.randn(B, K, 3)
    f_c[..., 0] = np.abs(f_c[..., 0])
    sargs = ((10.0 * rng.randn(B, meta.nv)).astype(dtype), qvel, fs[0],
             ps[11], fs[1], ps[10], ps[7], ps[8], ps[9],
             (0.1 * rng.randn(B, K, 3)).astype(dtype), normal.astype(dtype),
             cb12, (rng.rand(B, K) < 0.3).astype(dtype), f_c.astype(dtype))
    return dict(jm=jm, qpos=qpos, fargs=fargs, Mp=fs[9], rhs=rhs,
                sargs=sargs)


@pytest.fixture(scope='module')
def f64():
    d = _inputs(np.float64)
    d['tm'] = tspec.load(device='cpu', dtype=torch.float64)
    return d


def _jv(f):
    return jax.jit(jax.vmap(f))


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(out, ref, tol, what):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(out - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f'{what}: max err {err:.3e}, scale {scale:.3e}'


# --------------------------------------------------------------- K1


@pytest.fixture(scope='module')
def pos64(f64):
    ref = jax.jit(jax.vmap(jps.make_pos_stage_pe(f64['jm'])))(
        jnp.asarray(f64['qpos']))
    return ref, tps.pos_stage(f64['tm'], _t(f64['qpos']))


@pytest.mark.parametrize('i', range(15), ids=tps.NAMES)
def test_pos_stage_matches_jax(pos64, i):
    ref, out = pos64
    _close(out[i], ref[i], F64_TOL, tps.NAMES[i])


# --------------------------------------------------------------- K2


@pytest.fixture(scope='module')
def force64(f64):
    ref = jax.jit(jax.vmap(jfs.make_force_stage_pe(f64['jm'])))(
        *map(jnp.asarray, f64['fargs']))
    return ref, tfs.force_stage(f64['tm'], *map(_t, f64['fargs']))


@pytest.mark.parametrize('i', range(10), ids=tfs.NAMES)
def test_force_stage_matches_jax(force64, i):
    ref, out = force64
    _close(out[i], ref[i], F64_TOL, tfs.NAMES[i])


# --------------------------------------------------------------- K3


@pytest.fixture(scope='module')
def part(f64):
    p = tarrow.build_partition(f64['tm'].meta)
    assert tuple(p) == tuple(jarrow.build_partition(f64['jm'].meta))
    assert p.ds == (14, 3, 3, 14, 1, 1, 11, 11, 11, 11, 11, 11)
    assert (p.nr, p.dmax) == (6, 14)
    return p


def test_arrow_factor_solve_matches_jax(f64, part):
    jp = jarrow.build_partition(f64['jm'].meta)
    Mp, rhs = f64['Mp'], f64['rhs']
    Fr = _jv(lambda a: jarrow.factor_ref_p(jp, a))(jnp.asarray(Mp))
    xr = _jv(lambda f, b: jarrow.solve_ref(jp, f, b))(Fr,
                                                          jnp.asarray(rhs))
    F, x = tarrow.factor_solve(part, _t(Mp), _t(rhs))
    _close(F, Fr, F64_TOL, 'F')
    _close(x, xr, F64_TOL, 'x')
    res = tarrow.matvec_packed(part, _t(Mp), x) - _t(rhs)
    assert float(res.abs().max()) <= 1e-9 * float(np.abs(rhs).max())


@pytest.mark.parametrize('m', [1, 7])
def test_arrow_packed_helpers_match_jax(f64, part, m):
    jp = jarrow.build_partition(f64['jm'].meta)
    rng = np.random.RandomState(m)
    Mp = f64['Mp']
    x = rng.randn(B, part.nv, m)
    diag = rng.rand(part.nv)
    _close(tarrow.matvec_packed(part, _t(Mp), _t(x)),
           _jv(lambda a, v: jarrow.matvec_packed(jp, a, v))(
               jnp.asarray(Mp), jnp.asarray(x)), F64_TOL, 'matvec')
    _close(tarrow.add_diag_packed(part, _t(Mp), _t(diag)),
           _jv(lambda a: jarrow.add_diag_packed(jp, a,
                                                     jnp.asarray(diag)))(
               jnp.asarray(Mp)), F64_TOL, 'add_diag')
    dense = _jv(lambda a: jarrow.unpack_sym_ref(jp, a))(jnp.asarray(Mp))
    _close(tarrow.pack_sym_ref(part, _t(dense)),
           _jv(lambda a: jarrow.pack_sym_ref(jp, a))(dense), F64_TOL,
           'pack')
    Fr = _jv(lambda a: jarrow.factor_ref_p(jp, a))(jnp.asarray(Mp))
    _close(tarrow.solve_ref(part, _t(Fr), _t(x)),
           _jv(lambda f, b: jarrow.solve_ref(jp, f, b))(
               Fr, jnp.asarray(x)), F64_TOL, 'multi-rhs solve')


# --------------------------------------------------------------- K4


def test_sens_stage_matches_jax(f64):
    ref = jax.jit(jax.vmap(jss.make_sens_stage_pe(f64['jm'])))(
        *map(jnp.asarray, f64['sargs']))
    out = tss.sens_stage(f64['tm'], *map(_t, f64['sargs']))
    ref = np.asarray(ref)
    for s in range(ref.shape[1]):  # per sensordata channel
        _close(out[:, s], ref[:, s], F64_TOL, f'sensordata[{s}]')


# ------------------------------------------- K2 with the ellipsoid model


def test_force_stage_ellipsoid_fluid_matches_jax(f64):
    import dataclasses
    arrays, meta = tspec.read_npz(tspec.WALK_IMITATION_NPZ)
    arrays, meta = tfs.ellipsoid_variant(arrays, meta)
    tm = tspec.from_numpy(arrays, meta, device='cpu', dtype=torch.float64)
    jm = f64['jm'].replace(
        meta=dataclasses.replace(f64['jm'].meta, geom_fluid_active=tuple(
            meta['geom_fluid_active'])),
        geom_fluid=jnp.asarray(arrays['geom_fluid']))
    ref = jax.jit(jax.vmap(jfs.make_force_stage_pe(jm)))(
        *map(jnp.asarray, f64['fargs']))
    out = tfs.force_stage(tm, *map(_t, f64['fargs']))
    base = tfs.force_stage(f64['tm'], *map(_t, f64['fargs']))
    for n, o, r in zip(tfs.NAMES, out, ref):
        _close(o, r, F64_TOL, n)
    # The variant's fluid forces differ from the walking model's.
    assert float((out[5] - base[5]).abs().max()) > 1e-3 * float(
        base[5].abs().max())
