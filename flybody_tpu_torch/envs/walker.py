"""Fly walker: action routing and observable index tables.

Replicates the reference FruitFly walker's action-class semantics
(flybody/fruitfly/fruitfly.py:193-202, 342-379, 532-579): actions are laid
out by class in the fixed order adhesion -> head -> mouth -> antennae ->
wings -> abdomen -> legs -> user, and scattered into the MuJoCo control
vector through per-class index maps. Here the scatter is a constant 0/1
matrix so `ctrl = S @ action` is a single matmul.

A host-side (numpy) copy of flybody_tpu/envs/walker.py for the port.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from flybody_tpu_torch.model import spec as _s

# Actuator/joint name substrings per action class (the JAX package's
# model/surgery.py NAME_SUBSTR).
NAME_SUBSTR = {
    'adhesion': [],
    'head': ['head'],
    'mouth': ['rostrum', 'haustellum', 'labrum'],
    'antennae': ['antenna'],
    'wings': ['wing'],
    'abdomen': ['abdomen'],
    'legs': ['T1', 'T2', 'T3'],
    'user': [],
}

ACTION_CLASS_ORDER = ('adhesion', 'head', 'mouth', 'antennae', 'wings',
                      'abdomen', 'legs', 'user')


@dataclasses.dataclass(frozen=True)
class WalkerTables:
    """Static action/observable tables derived from a compiled FlyModel."""

    num_actions: int
    action_names: tuple[str, ...]
    action_min: np.ndarray
    action_max: np.ndarray
    # ctrl = scatter @ action  (nu, num_actions)
    scatter: np.ndarray
    # Per-class index lists into the action vector.
    action_indices: dict
    ctrl_indices: dict

    # Joint observation tables (all non-free joints, model order).
    joints_qpos_idx: np.ndarray
    joints_dof_idx: np.ndarray

    # Site ids.
    appendage_sites: np.ndarray  # claws (present) + head
    thorax_body: int
    abdomen_body: int
    head_body: int

    # Sensor segments.
    force_adr: np.ndarray
    touch_adr: np.ndarray
    vest_adr: dict  # accelerometer/gyro/velocimeter -> (start, dim)

    # Wing / leg joint qpos/dof addresses (for retraction / init).
    wing_qpos_idx: np.ndarray
    wing_dof_idx: np.ndarray
    leg_qpos_idx: np.ndarray


@functools.lru_cache(maxsize=16)
def build_tables(meta, num_user_actions: int = 0) -> WalkerTables:
    """Build walker tables from static model metadata."""
    names = meta.actuator_names
    nu = meta.nu

    ctrl_indices = {}
    for cls in ACTION_CLASS_ORDER:
        if cls == 'user':
            ctrl_indices[cls] = []
        elif cls == 'adhesion':
            ctrl_indices[cls] = [i for i, n in enumerate(names)
                                 if 'adhere' in n]
        else:
            ctrl_indices[cls] = [
                i for i, n in enumerate(names)
                if any(s in n for s in NAME_SUBSTR[cls]) and 'adhere' not in n]

    action_indices = {}
    counter = 0
    order = []
    for cls in ACTION_CLASS_ORDER:
        n = (num_user_actions if cls == 'user'
             else len(ctrl_indices[cls]))
        action_indices[cls] = list(range(counter, counter + n))
        counter += n
        if cls != 'user':
            order.extend(ctrl_indices[cls])
    num_actions = counter

    scatter = np.zeros((nu, num_actions))
    a = 0
    for cls in ACTION_CLASS_ORDER[:-1]:
        for ci in ctrl_indices[cls]:
            scatter[ci, a] = 1.0
            a += 1

    action_names = tuple(names[i] for i in order) + tuple(
        f'user_{i}' for i in range(num_user_actions))

    # Joint tables (free joint excluded), model order.
    jq, jd = [], []
    wing_q, wing_d, leg_q = [], [], []
    for j in range(meta.njnt):
        if meta.jnt_type[j] == _s.FREE:
            continue
        jq.append(meta.jnt_qposadr[j])
        jd.append(meta.jnt_dofadr[j])
        nm = meta.jnt_names[j]
        if any(s in nm for s in NAME_SUBSTR['wings']):
            wing_q.append(meta.jnt_qposadr[j])
            wing_d.append(meta.jnt_dofadr[j])
        if any(s in nm for s in ('coxa', 'femur', 'tibia', 'tarsus')):
            leg_q.append(meta.jnt_qposadr[j])

    # Appendage sites: claws then head (reference fruitfly.py:479-497).
    app = []
    for nm in ('claw_T1_left', 'claw_T1_right', 'claw_T2_left',
               'claw_T2_right', 'claw_T3_left', 'claw_T3_right', 'head'):
        if nm in meta.site_names:
            app.append(meta.site_names.index(nm))

    # Sensor address groups.
    force_adr, touch_adr = [], []
    vest = {}
    from flybody_tpu_torch.model.spec import (
        SENS_ACCELEROMETER, SENS_FORCE, SENS_GYRO, SENS_TOUCH,
        SENS_VELOCIMETER)
    for i in range(meta.nsensor):
        t, adr = meta.sensor_type[i], meta.sensor_adr[i]
        if t == SENS_FORCE:
            force_adr += [adr, adr + 1, adr + 2]
        elif t == SENS_TOUCH:
            touch_adr.append(adr)
        elif t == SENS_ACCELEROMETER:
            vest['accelerometer'] = (adr, 3)
        elif t == SENS_GYRO:
            vest['gyro'] = (adr, 3)
        elif t == SENS_VELOCIMETER:
            vest['velocimeter'] = (adr, 3)

    def bid(name):
        return meta.body_names.index(name) if name in meta.body_names else 0

    return WalkerTables(
        num_actions=num_actions,
        action_names=action_names,
        action_min=np.zeros(num_actions),  # placeholder; see action_bounds
        action_max=np.zeros(num_actions),
        scatter=scatter,
        action_indices=action_indices,
        ctrl_indices=ctrl_indices,
        joints_qpos_idx=np.array(jq, dtype=np.int64),
        joints_dof_idx=np.array(jd, dtype=np.int64),
        appendage_sites=np.array(app, dtype=np.int64),
        thorax_body=bid('thorax'),
        abdomen_body=bid('abdomen'),
        head_body=bid('head'),
        force_adr=np.array(force_adr, dtype=np.int64),
        touch_adr=np.array(touch_adr, dtype=np.int64),
        vest_adr=vest,
        wing_qpos_idx=np.array(wing_q, dtype=np.int64),
        wing_dof_idx=np.array(wing_d, dtype=np.int64),
        leg_qpos_idx=np.array(leg_q, dtype=np.int64),
    )


def action_bounds(model, tables: WalkerTables):
    """(minimum, maximum) action bounds (reference fruitfly.py:548-579)."""
    ctrlrange = model.np_arrays['actuator_ctrlrange']
    order = []
    for cls in ACTION_CLASS_ORDER[:-1]:
        order.extend(tables.ctrl_indices[cls])
    n_user = tables.num_actions - len(order)
    lo = np.concatenate([ctrlrange[order, 0], -np.ones(n_user)])
    hi = np.concatenate([ctrlrange[order, 1], np.ones(n_user)])
    return lo, hi
