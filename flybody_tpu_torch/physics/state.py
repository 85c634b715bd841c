"""Dynamic state of a batch of flies (counterpart of physics/state.py).

`Data` mirrors mjData: the primary state (qpos, qvel, act, ctrl) plus the
fields the forward pipeline derives from it. Every tensor carries a leading
batch dimension B; fields not computed yet are None.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from flybody_tpu_torch.model.spec import FlyModel

T = Optional[torch.Tensor]


@dataclasses.dataclass
class Data:
    time: torch.Tensor  # (B,)
    qpos: torch.Tensor  # (B, nq)
    qvel: torch.Tensor  # (B, nv)
    act: torch.Tensor  # (B, na)
    ctrl: torch.Tensor  # (B, nu)

    qacc: T = None
    act_dot: T = None

    xpos: T = None  # (B, nbody, 3)
    xquat: T = None
    xmat: T = None
    xipos: T = None
    ximat: T = None
    geom_xpos: T = None
    geom_xmat: T = None
    site_xpos: T = None
    site_xmat: T = None
    subtree_com: T = None
    jnt_xanchor: T = None
    jnt_xaxis: T = None

    cdof: T = None  # (B, nv, 6)
    cinert: T = None  # (B, nbody, 6, 6)
    cvel: T = None
    cdof_dot: T = None

    # Packed block-arrow (B, nl+1, dm+nr, dm) when the model has an arrow
    # partition, else dense (B, nv, nv); qLD is its factor in the same form.
    qM: T = None
    qLD: T = None

    qfrc_bias: T = None
    qfrc_passive: T = None
    qfrc_fluid: T = None
    qfrc_actuator: T = None
    qfrc_applied: T = None
    xfrc_applied: T = None
    qfrc_smooth: T = None
    qfrc_constraint: T = None

    actuator_force: T = None

    ten_length: T = None
    ten_velocity: T = None

    sensordata: T = None
    self_contact_force: T = None  # (B,)

    contact: Any = None

    def replace(self, **kw) -> 'Data':
        return dataclasses.replace(self, **kw)

    def strip(self) -> 'Data':
        """Primary state only (the substep loop's carry)."""
        return Data(time=self.time, qpos=self.qpos, qvel=self.qvel,
                    act=self.act, ctrl=self.ctrl, qacc=self.qacc,
                    qfrc_applied=self.qfrc_applied,
                    xfrc_applied=self.xfrc_applied)

    def index(self, idx) -> 'Data':
        """The envs `idx` of every batched field (None stays None)."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v[idx] if torch.is_tensor(v) else v
        return Data(**kw)

    def to(self, device=None, dtype=None) -> 'Data':
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if torch.is_tensor(v):
                v = v.to(device=device, dtype=(
                    dtype if dtype is not None and v.is_floating_point()
                    else None))
            kw[f.name] = v
        return Data(**kw)


def make_data(model: FlyModel, batch: int) -> Data:
    """B fresh states at qpos0 with zero velocities and controls."""
    meta, dev, dt = model.meta, model.device, model.dtype
    return Data(
        time=torch.zeros((batch,), dtype=dt, device=dev),
        qpos=model.qpos0.expand(batch, meta.nq).clone(),
        qvel=torch.zeros((batch, meta.nv), dtype=dt, device=dev),
        act=torch.zeros((batch, meta.na), dtype=dt, device=dev),
        ctrl=torch.zeros((batch, meta.nu), dtype=dt, device=dev),
    )


def data_from_numpy(model: FlyModel, **fields) -> Data:
    """Data from numpy arrays (e.g. a JAX state carried across): each
    keyword names a Data field and holds a (B, ...) array; floats take
    the model's dtype and device."""
    kw = {}
    for name, v in fields.items():
        if v is None:
            kw[name] = None
            continue
        a = np.array(v)
        if np.issubdtype(a.dtype, np.floating):
            kw[name] = torch.as_tensor(a, dtype=model.dtype,
                                       device=model.device)
        else:
            kw[name] = torch.as_tensor(a, device=model.device)
    return Data(**kw)
