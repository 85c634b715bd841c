"""Full physics step (mj_step) for a batch of flies.

Counterpart of flybody_tpu/physics/engine.py. One substep runs, in
MuJoCo's stage order: the position stage (kernel K1), collision, the
velocity/force stage, constraint rows and adhesion transmission, the
factor+solve of the smooth acceleration, the Newton solve and the noslip,
the sensors (K4), then semi-implicit Euler with implicit damping.

Dispatch follows the JAX package's. A model with an arrow partition (one
walking fly) runs the fused force stage (K2) with a packed mass matrix, the
arrow factor+solve (K3), the block or whole-solve Newton kernel and the
fused noslip. A model without one (several flies, ops/arrow.py's
build_partition is None) runs the plain stage chain with a dense mass
matrix, and the dense Cholesky, line-search and Gauss-Seidel kernels
(rows 12-17) through the solver's dense branches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from flybody_tpu_torch.model.spec import FlyModel, TRN_BODY
from flybody_tpu_torch.ops import arrow as _ar
from flybody_tpu_torch.ops import force_stage as _fs
from flybody_tpu_torch.ops import sens_stage as _ss
from flybody_tpu_torch.physics import collision as _col
from flybody_tpu_torch.physics import fluid as _fl
from flybody_tpu_torch.physics import kinematics as _kin
from flybody_tpu_torch.physics import smooth as _sm
from flybody_tpu_torch.physics import solver as _sol
from flybody_tpu_torch.physics.state import Data


@functools.lru_cache(maxsize=8)
def adhesion_tables(meta):
    """Adhesion actuators and the body each one acts through."""
    adh_u = [u for u in range(meta.nu) if meta.actuator_trntype[u] == TRN_BODY]
    return (np.array(adh_u, np.int64),
            np.array([meta.actuator_trnid[u] for u in adh_u], np.int64))


def adhesion_moment(model: FlyModel, efc: _sol.EfcRows):
    """Adhesion transmission moments (B, nu_adh, nv): minus the mean of
    the normal Jacobian rows of the active contacts touching the
    actuator's body."""
    adh_u, adh_body = adhesion_tables(model.meta)
    bodies = torch.as_tensor(adh_body, device=efc.con_J.device)[None, :, None]
    involve = ((efc.con_body1[:, None, :] == bodies)
               | (efc.con_body2[:, None, :] == bodies)).to(efc.con_J.dtype)
    involve = involve * efc.con_active[:, None, :]
    n = torch.sum(involve, -1)
    mom = -torch.einsum('buk,bkv->buv', involve, efc.con_J[:, :, 0, :])
    return adh_u, mom / torch.clamp(n, min=1.0)[..., None]


# Named solver presets, the settings fwd_acc reads.
#   default: the env defaults of flybody_tpu/envs/base.py:92-96, the
#     broadphase widths of physics/collision.py:620/683 and the Woodbury
#     budget of physics/solver.py:778 (FLYBODY_SB_BREAK unset).
#   bench: the setting of bench.py:39-67 and of train/run.py:165-180
#     (--bench-solver, the trainer's setting).
#   default_full: default with each refactor block's Hessian assembled in
#     the Newton kernel (the JAX package run with
#     FLYBODY_NEWTON_BLOCK_FULL=1, solver.py:884-891).
PRESETS = {
    'default': dict(solver_iterations=10, ls_iterations=8, ncon_max=64,
                    refactor_period=1, noslip_contacts=None, mpr_top_p=128,
                    cc_top_p=128, sb_break=8, newton_block_full=False),
    'bench': dict(solver_iterations=8, ls_iterations=6, ncon_max=24,
                  refactor_period=8, noslip_contacts=16, mpr_top_p=32,
                  cc_top_p=16, sb_break=4, newton_block_full=False),
}
PRESETS['default_full'] = dict(PRESETS['default'], newton_block_full=True)


def fwd(model: FlyModel, data: Data, preset: dict | None = None,
        noslip_iterations: int | None = None) -> Data:
    """Forward dynamics: everything up to and including qacc and the
    sensors (mj_forward)."""
    data, efc, f_c = fwd_acc(model, data, preset, noslip_iterations)
    with _span('sensors'):
        sd = _sensors(model, data, efc, f_c)
    return data.replace(sensordata=sd)


def fwd_acc(model: FlyModel, data: Data, preset: dict | None = None,
            noslip_iterations: int | None = None):
    """fwd up to qacc: (data, contact rows, contact forces f_c (B, K, 3)),
    what the sensors read. `preset`: a dict with the keys of PRESETS'
    entries (None: PRESETS['default']); `noslip_iterations`: None takes
    the model's."""
    p = PRESETS['default'] if preset is None else preset
    meta = model.meta
    with _span('position'):
        data, _, _ = _kin.fwd_position_smooth(model, data)
    with _span('collision'):
        con = _col.collide(model, data, p['mpr_top_p'], p['cc_top_p'])
    dense = _ar.build_partition(meta) is None
    if dense:
        # The JAX package's plain chain, in its order (engine.py:121-139).
        with _span('force'):
            data = _sm.com_vel(model, data)
            data = _sm.tendon_vel(model, data)
        with _span('constraint_rows'):
            efc = _sol.make_efc(model, data, con, p['ncon_max'])
            adh_u, adh_mom = adhesion_moment(model, efc)
        with _span('force'):
            data = _sm.actuation(model, data)
    else:
        with _span('force'):
            (cvel, cdof_dot, ten_velocity, qfrc_bias, qfrc_passive,
             qfrc_fluid, qfrc_actuator, actuator_force, act_dot,
             Mp) = _fs.force_stage(
                model, data.qpos, data.qvel, data.act, data.ctrl, data.cdof,
                data.cinert, data.xipos, data.ximat, data.subtree_com,
                data.geom_xpos, data.geom_xmat, data.ten_length)
        data = data.replace(
            cvel=cvel, cdof_dot=cdof_dot, ten_velocity=ten_velocity,
            qfrc_bias=qfrc_bias, qfrc_passive=qfrc_passive,
            qfrc_fluid=qfrc_fluid, qfrc_actuator=qfrc_actuator,
            actuator_force=actuator_force, act_dot=act_dot, qM=Mp)
        with _span('constraint_rows'):
            efc = _sol.make_efc(model, data, con, p['ncon_max'])
            adh_u, adh_mom = adhesion_moment(model, efc)
    if len(adh_u):
        qfrc_adh = torch.einsum('buv,bu->bv', adh_mom,
                                data.actuator_force[:, adh_u])
        data = data.replace(qfrc_actuator=data.qfrc_actuator + qfrc_adh)
    if dense:
        with _span('force'):
            data = _sm.crb(model, data)
            data = _sm.rne(model, data)
            data = _sm.passive(model, data)
            data = _fl.fluid(model, data)

    qfrc_smooth = (data.qfrc_passive + data.qfrc_fluid + data.qfrc_actuator
                   - data.qfrc_bias + _sm.xfrc_accumulate(model, data))
    if data.qfrc_applied is not None:
        qfrc_smooth = qfrc_smooth + data.qfrc_applied
    data = data.replace(qfrc_smooth=qfrc_smooth)

    with _span('factor_solve'):
        data, a_free = _sm.factor_solve_m(model, data, qfrc_smooth)
    with _span('newton'):
        qacc, qfrc_con, _, f_c = _sol.solve(
            model, data, efc, a_free, p['solver_iterations'],
            p['ls_iterations'], data.qacc, p['refactor_period'],
            p['sb_break'], p['newton_block_full'])
    niter = (meta.noslip_iterations if noslip_iterations is None
             else noslip_iterations)
    if niter > 0:
        with _span('noslip'):
            qacc, f_c, dqfrc = _sol.noslip(model, data, efc, qacc, f_c, niter,
                                           p['noslip_contacts'])
            qfrc_con = qfrc_con + dqfrc
    self_force = torch.sum(efc.con_self * efc.con_active
                           * torch.linalg.norm(f_c, dim=-1), -1)
    data = data.replace(qacc=qacc, qfrc_constraint=qfrc_con, contact=con,
                        self_contact_force=self_force)
    return data, efc, f_c


def _sensors(model, data, efc, f_c):
    """sensordata: kernel K4, or the plain version when Cartesian applied
    forces are present (the kernel does not take them)."""
    if data.xfrc_applied is None:
        # The plain force chain of the dense path leaves some of these as
        # strided views; the kernel takes contiguous operands.
        return _ss.sens_stage(model, *_ss.operands(data, efc, f_c))
    from flybody_tpu_torch.physics import sensors as _sens
    return _sens.sensordata(
        model, data.qacc, data.qvel, data.cvel, data.cdof, data.cdof_dot,
        data.cinert, data.site_xpos, data.site_xmat, data.subtree_com,
        efc.con_xpos, efc.con_normal, efc.con_body1, efc.con_body2,
        efc.con_active, f_c, xpos=data.xpos, xfrc_applied=data.xfrc_applied)


def step(model: FlyModel, data: Data, preset: dict | None = None) -> Data:
    """One physics step: forward dynamics + Euler integration."""
    data = fwd(model, data, preset)
    with _span('euler'):
        return _sm.euler(model, data)


def _span(name: str):
    """A named profiler range ('fb/<stage>'); costs a few microseconds
    when no profiler is recording (tools/profile_step.py reads them)."""
    return torch.profiler.record_function('fb/' + name)
