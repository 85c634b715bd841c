"""`solver.solve` at the default_full preset against the JAX package.

The preset's setting (10 iterations, 8 line-search steps, refactor 1, 64
slots, Woodbury budget 8, the Hessian of each refactor block assembled in
kernel 9's block-full mode; on CPU tensors its plain version
`newton_fused.newton_block_full_ref`) against the JAX `solver.solve` with
FLYBODY_NEWTON_BLOCK_FULL=1 (set for the JAX side only), at float64 on 4
flailing walking states (tests/walk_states.flail) with a packed M
(smooth.crb_packed, the engine's form), by per-env primal cost and net
normal contact force (ROADMAP's rule for solver outputs): within 1e-6 of
each env's value. The block kernel itself is held in
tests/test_torch_block_full.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.physics import collision as jcol
from flybody_tpu.physics import fluid as jfl
from flybody_tpu.physics import kinematics as jkin
from flybody_tpu.physics import smooth as jsm
from flybody_tpu.physics import solver as jsol
from flybody_tpu.physics.state import make_data as jmake_data
from flybody_tpu_torch.ops import arrow as tarrow
from flybody_tpu_torch.ops import newton_fused as tnf
from flybody_tpu_torch.physics import engine as tengine
from flybody_tpu_torch.physics import solver as tsol
from flybody_tpu_torch.physics.state import data_from_numpy
from walk_states import DATA, efc_from_numpy, flail, jax_efc, models

SOLVE_TOL = 1e-6


@pytest.fixture(scope='module')
def packed_prep():
    """The JAX engine's forward pass up to the Newton solve (packed M:
    smooth.crb_packed, factor_solve_m) at 4 flailing states, float64:
    ({Data field: array}, {EfcRows field: array}, a_free)."""
    jm, _ = models()
    qpos, qvel = flail(4, 0)
    p = tengine.PRESETS['default_full']

    def one(q, v):
        d = jmake_data(jm).replace(qpos=q, qvel=v)
        d, _, _ = jkin.fwd_position_smooth(jm, d)
        con = jcol.collide(jm, d, compact=True)
        d = jsm.tendon_vel(jm, jsm.com_vel(jm, d))
        efc = jsol.make_efc(jm, d, con, ncon_max=p['ncon_max'])
        d = jsm.actuation(jm, d)
        d = jfl.fluid(jm, jsm.passive(jm, jsm.rne(jm, jsm.crb_packed(jm,
                                                                   d))))
        qfrc_smooth = (d.qfrc_passive + d.qfrc_fluid + d.qfrc_actuator
                       - d.qfrc_bias)
        d, a_free = jsm.factor_solve_m(jm, d.replace(qfrc_smooth=qfrc_smooth),
                                       qfrc_smooth)
        return d, efc, a_free

    d, efc, a_free = jax.jit(jax.vmap(one))(jnp.asarray(qpos),
                                           jnp.asarray(qvel))
    return ({k: np.asarray(getattr(d, k)) for k in DATA},
            {k: np.asarray(v) for k, v in efc._asdict().items()
             if k not in ('lim_dof', 'lim_sign')},
            np.asarray(a_free))


def test_solve_default_full_matches_jax(packed_prep, monkeypatch):
    jm, tm = models()
    d, efc, a_free = packed_prep
    p = tengine.PRESETS['default_full']
    assert d['qM'].ndim == 4  # packed: (B, nl + 1, dm + nr, dm)
    ws = np.zeros_like(a_free)

    monkeypatch.setenv('FLYBODY_NEWTON_BLOCK_FULL', '1')

    def one(qM, qLD, e, af, w):
        dd = jmake_data(jm).replace(qM=qM, qLD=qLD)
        return jsol.solve(jm, dd, jax_efc(e), af,
                          iterations=p['solver_iterations'],
                          ls_iterations=p['ls_iterations'], warmstart=w,
                          refactor_period=p['refactor_period'])
    jx, _, _, jfc = jax.jit(jax.vmap(one))(
        jnp.asarray(d['qM']), jnp.asarray(d['qLD']), efc,
        jnp.asarray(a_free), jnp.asarray(ws))
    monkeypatch.delenv('FLYBODY_NEWTON_BLOCK_FULL')

    td = data_from_numpy(tm, **d)
    tefc = efc_from_numpy(tm, **efc)
    ta = torch.as_tensor(np.array(a_free))
    calls = []
    for name in ('newton_block', 'newton_block_full'):
        fn = getattr(tnf, name)
        monkeypatch.setattr(tnf, name, lambda *a, _fn=fn, _n=name: (
            calls.append(_n), _fn(*a))[1])
    x, _, _, fc = tsol.solve(tm, td, tefc, ta, p['solver_iterations'],
                             p['ls_iterations'], torch.zeros_like(ta),
                             p['refactor_period'], p['sb_break'],
                             p['newton_block_full'])
    # Every refactor block (one iteration each) went the block-full way.
    assert calls == ['newton_block_full'] * p['solver_iterations']
    part = tarrow.build_partition(tm.meta)
    ops = tsol.operands(tefc, p['sb_break'])

    def cost(xx):
        return tnf.primal_cost(part, tefc.lim_dof, tefc.lim_sign, td.qM,
                               ops.conJ, ta, tefc.lim_aref, tefc.con_aref,
                               ops.lim_params, ops.con_params,
                               torch.as_tensor(np.array(xx))).numpy()
    assert float(np.asarray(tefc.con_break).sum()) > 0  # Woodbury rows
    for what, o, r in (('cost', cost(x), cost(jx)),
                       ('force', fc[..., 0].sum(-1).numpy(),
                        np.asarray(jfc)[..., 0].sum(-1))):
        err = np.abs(o - r) / np.maximum(np.abs(r), 1e-12)
        assert err.max() <= SOLVE_TOL, (what, err, r)
