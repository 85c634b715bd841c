"""The walking model's unpacked-M path, prepared by the JAX package and
carried into the port (tests/test_torch_unpacked*.py).

`jax_prep` runs the prep of the JAX package's tools/profile_engine.py
(flybody_tpu/tools/profile_engine.py:144-164) vmapped at float64 on the
CPU, with the compact collide: position stage, collide, velocities, the
contact and limit rows, actuation, the dense mass matrix (smooth.crb),
bias, passive and fluid forces, smooth.factor_m (the packed arrow factor)
and a_free = smooth.solve_m(qfrc_smooth). `to_port` carries its outputs
into the port (state.data_from_numpy, efc_from_numpy).

The state is flailing: qpos0 with every joint below the root moved by
0.2 N(0, 1) rad and qvel ~ N(0, 1) (numpy seed), so the legs and wings
cross each other and the floor: at batch 4 and seed 0, 17-32 active
contact slots of 32 per env, 3-7 of them cross-limb.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flybody_tpu.model import spec as jspec
from flybody_tpu.physics import collision as jcol
from flybody_tpu.physics import fluid as jfl
from flybody_tpu.physics import kinematics as jkin
from flybody_tpu.physics import smooth as jsm
from flybody_tpu.physics import solver as jsol
from flybody_tpu.physics.state import make_data as jmake_data
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.physics import solver as tsol
from flybody_tpu_torch.physics.state import data_from_numpy

DATA = ('time', 'qpos', 'qvel', 'act', 'ctrl', 'qM', 'qLD', 'qfrc_smooth')


@functools.lru_cache(maxsize=1)
def models():
    """(JAX model, port model at float64 on the CPU), both from the
    shipped walk_imitation asset."""
    return (jspec.load(tspec.WALK_IMITATION_NPZ),
            tspec.load(tspec.WALK_IMITATION_NPZ, device='cpu',
                       dtype=torch.float64))


def flail(batch: int, seed: int, joint_std: float = 0.2,
          vel_std: float = 1.0):
    """(qpos, qvel) numpy arrays of the flailing state."""
    jm, _ = models()
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(jm.qpos0)[None], (batch, 1))
    qpos[:, 7:] += joint_std * rng.randn(batch, qpos.shape[1] - 7)
    return qpos, vel_std * rng.randn(batch, jm.meta.nv)


@functools.lru_cache(maxsize=4)
def jax_prep(batch: int = 4, seed: int = 0, ncon: int = 32):
    """The JAX prep at the flailing state: ({Data field: array}, {EfcRows
    field: array}, a_free), numpy float64."""
    jm, _ = models()
    qpos, qvel = flail(batch, seed)

    def one(q, v):
        d = jmake_data(jm).replace(qpos=q, qvel=v)
        d, _, _ = jkin.fwd_position_smooth(jm, d)
        con = jcol.collide(jm, d, compact=True)
        d = jsm.tendon_vel(jm, jsm.com_vel(jm, d))
        efc = jsol.make_efc(jm, d, con, ncon_max=ncon)
        d = jsm.actuation(jm, d)
        d = jfl.fluid(jm, jsm.passive(jm, jsm.rne(jm, jsm.crb(jm, d))))
        qfrc_smooth = (d.qfrc_passive + d.qfrc_fluid + d.qfrc_actuator
                       - d.qfrc_bias)
        d = jsm.factor_m(jm, d.replace(qfrc_smooth=qfrc_smooth))
        return d, efc, jsm.solve_m(jm, d, qfrc_smooth)

    d, efc, a_free = jax.jit(jax.vmap(one))(jnp.asarray(qpos),
                                           jnp.asarray(qvel))
    return ({k: np.asarray(getattr(d, k)) for k in DATA},
            {k: np.asarray(v) for k, v in efc._asdict().items()
             if k not in ('lim_dof', 'lim_sign')},
            np.asarray(a_free))


def to_port(prep):
    """The port's (Data, EfcRows, a_free) of a jax_prep result."""
    _, tm = models()
    d, efc, a_free = prep
    return (data_from_numpy(tm, **d), efc_from_numpy(tm, **efc),
            torch.as_tensor(np.array(a_free)))


def efc_from_numpy(model, **fields):
    """The port's EfcRows from numpy arrays (the JAX package's rows
    carried across): each keyword names a field and holds a (B, ...)
    array; floats take the model's dtype and device, integers int64;
    lim_dof and lim_sign are the model's static tables."""
    lim_dof, lim_sign, _ = tsol.limit_tables(model.meta)
    kw = dict(lim_dof=lim_dof, lim_sign=lim_sign)
    for f in dataclasses.fields(tsol.EfcRows):
        if f.name in kw:
            continue
        a = np.array(fields[f.name])
        kw[f.name] = torch.as_tensor(
            a, dtype=(model.dtype if np.issubdtype(a.dtype, np.floating)
                      else torch.int64), device=model.device)
    return tsol.EfcRows(**kw)


def jax_efc(fields):
    """The JAX EfcRows of jax_prep's row fields (one env's, inside a
    vmap), with the static limit tables restored."""
    jm, _ = models()
    lim_dof, lim_sign, _ = jsol._limit_tables(jm.meta)
    return jsol.EfcRows(lim_dof=lim_dof, lim_sign=lim_sign, **fields)
