"""FlyModel: the compiled, flat-array model consumed by the engine.

Counterpart of flybody_tpu/model/spec.py. A model is compiled once, on the
host, into static metadata (`Meta`, hashable) plus a dataclass of tensors
(`FlyModel`). The on-disk format is the JAX package's `.npz` (arrays plus
JSON metadata), so a model saved there loads here unchanged. Two models
ship: the walking model (`assets/walk_imitation.npz`, WALK_IMITATION_NPZ)
and the two-fly scene of the JAX package's surgery.multi_fly_xml(2)
(`assets/two_fly.npz`, TWO_FLY_NPZ), which has no arrow partition and so
runs the dense path.

Conventions: quaternions (w, x, y, z), CGS units, topological dof order.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from flybody_tpu_torch.utils import device as _device

FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3

GEOM_PLANE = 0
GEOM_HFIELD = 1
GEOM_SPHERE = 2
GEOM_CAPSULE = 3
GEOM_ELLIPSOID = 4
GEOM_CYLINDER = 5
GEOM_BOX = 6
GEOM_MESH = 7

DYN_NONE = 0
DYN_INTEGRATOR = 1
DYN_FILTER = 2
DYN_FILTEREXACT = 3

GAIN_FIXED = 0
GAIN_AFFINE = 1
BIAS_NONE = 0
BIAS_AFFINE = 1

TRN_JOINT = 0
TRN_TENDON = 3
TRN_SITE = 4
TRN_BODY = 5  # adhesion

SENS_TOUCH = 0
SENS_ACCELEROMETER = 1
SENS_VELOCIMETER = 2
SENS_GYRO = 3
SENS_FORCE = 4
SENS_TORQUE = 5

ASSET_DIR = os.path.join(os.path.dirname(__file__), 'assets')
WALK_IMITATION_NPZ = os.path.join(ASSET_DIR, 'walk_imitation.npz')
TWO_FLY_NPZ = os.path.join(ASSET_DIR, 'two_fly.npz')


@dataclasses.dataclass(frozen=True, eq=True)
class Meta:
    """Hashable static metadata (same fields as the JAX package's)."""

    nq: int
    nv: int
    nu: int
    na: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int
    ncam: int
    ntendon: int
    nsensor: int
    nsensordata: int
    nkey: int

    body_parentid: tuple[int, ...]
    body_rootid: tuple[int, ...]
    body_jntadr: tuple[int, ...]
    body_jntnum: tuple[int, ...]
    body_dofadr: tuple[int, ...]
    body_dofnum: tuple[int, ...]
    body_geomadr: tuple[int, ...]
    body_geomnum: tuple[int, ...]
    body_weldid: tuple[int, ...]
    body_anc: tuple[tuple[int, ...], ...]
    max_jnt_per_body: int

    jnt_type: tuple[int, ...]
    jnt_qposadr: tuple[int, ...]
    jnt_dofadr: tuple[int, ...]
    jnt_bodyid: tuple[int, ...]
    jnt_limited: tuple[bool, ...]

    dof_bodyid: tuple[int, ...]
    dof_jntid: tuple[int, ...]

    geom_type: tuple[int, ...]
    geom_bodyid: tuple[int, ...]
    geom_contype: tuple[int, ...]
    geom_conaffinity: tuple[int, ...]
    geom_condim: tuple[int, ...]
    geom_priority: tuple[int, ...]
    geom_group: tuple[int, ...]
    geom_sameframe: tuple[int, ...]
    geom_fluid_active: tuple[bool, ...]

    site_bodyid: tuple[int, ...]
    site_sameframe: tuple[int, ...]
    cam_bodyid: tuple[int, ...]

    actuator_trntype: tuple[int, ...]
    actuator_trnid: tuple[int, ...]
    actuator_dyntype: tuple[int, ...]
    actuator_gaintype: tuple[int, ...]
    actuator_biastype: tuple[int, ...]
    actuator_actadr: tuple[int, ...]

    exclude_pairs: tuple[tuple[int, int], ...]

    sensor_type: tuple[int, ...]
    sensor_objid: tuple[int, ...]
    sensor_adr: tuple[int, ...]
    sensor_dim: tuple[int, ...]

    integrator: int
    cone: int
    solver_iterations: int
    ls_iterations: int
    noslip_iterations: int
    disableflags: int

    body_names: tuple[str, ...]
    jnt_names: tuple[str, ...]
    geom_names: tuple[str, ...]
    site_names: tuple[str, ...]
    actuator_names: tuple[str, ...]
    sensor_names: tuple[str, ...]
    tendon_names: tuple[str, ...]
    cam_names: tuple[str, ...]


# Tensor fields of FlyModel, in the JAX package's order (shapes per
# flybody_tpu/model/spec.py). Integer fields stay int64.
ARRAY_FIELDS = (
    'timestep', 'gravity', 'density', 'viscosity', 'wind', 'opt_tolerance',
    'opt_impratio', 'qpos0', 'qpos_spring', 'key_qpos', 'body_pos',
    'body_quat', 'body_ipos', 'body_iquat', 'body_mass', 'body_subtreemass',
    'body_inertia', 'body_invweight0', 'jnt_pos', 'jnt_axis', 'jnt_range',
    'jnt_stiffness', 'jnt_solref', 'jnt_solimp', 'jnt_margin',
    'dof_armature', 'dof_damping', 'dof_invweight0', 'dof_frictionloss',
    'body_dof_mask', 'dof_prefix_mask', 'geom_pos', 'geom_quat',
    'geom_size', 'geom_rbound', 'geom_friction', 'geom_margin', 'geom_gap',
    'geom_solref', 'geom_solimp', 'geom_solmix', 'geom_fluid', 'site_pos',
    'site_quat', 'site_size', 'cam_pos', 'cam_quat', 'cam_fovy', 'ten_J',
    'ten_Lq', 'ten_range', 'ten_limited', 'ten_stiffness', 'ten_damping',
    'ten_lengthspring', 'ten_solref', 'ten_solimp', 'ten_margin',
    'actuator_gainprm', 'actuator_biasprm', 'actuator_dynprm',
    'actuator_ctrlrange', 'actuator_forcerange', 'actuator_forcelimited',
    'actuator_gear0', 'actuator_moment', 'act_actuator_id',
    'actuator_act_adr', 'sensor_cutoff',
)


@dataclasses.dataclass(eq=False)
class FlyModel:
    """Static `meta` plus one tensor per ARRAY_FIELDS name (`arrays`),
    all on one device. Attribute access reads the tensors
    (`model.body_pos`); `np_arrays` keeps the float64 host copy that
    host-side table builders read."""

    meta: Meta
    arrays: dict
    np_arrays: dict
    # Device constants derived from the model, built once (see const).
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def __getattr__(self, name):
        arrays = self.__dict__.get('arrays')
        if arrays is not None and name in arrays:
            return arrays[name]
        raise AttributeError(name)

    @property
    def device(self) -> torch.device:
        return self.arrays['qpos0'].device

    @property
    def dtype(self) -> torch.dtype:
        return self.arrays['qpos0'].dtype

    def const(self, key, build):
        """Device tensor built once from host tables: `build()` returns a
        numpy array (ints -> int64, floats -> the model dtype)."""
        t = self._cache.get(key)
        if t is None:
            a = np.asarray(build())
            if np.issubdtype(a.dtype, np.integer) or a.dtype == bool:
                t = torch.as_tensor(a.astype(np.int64), device=self.device)
            else:
                t = torch.as_tensor(a, dtype=self.dtype, device=self.device)
            self._cache[key] = t
        return t


def _detuple(v):
    if isinstance(v, list):
        return tuple(_detuple(x) for x in v)
    return v


def from_numpy(arrays: dict, meta: dict | Meta, device=None,
               dtype: torch.dtype = torch.float32) -> FlyModel:
    """Builds a FlyModel from numpy arrays (keyed by ARRAY_FIELDS) and
    metadata (a Meta or its dict). This carries a JAX-package model across:
    `from_numpy({k: np.asarray(getattr(m, k)) ...}, dataclasses.asdict(
    m.meta))`."""
    dev = _device.resolve(device)
    if not isinstance(meta, Meta):
        meta = Meta(**{k: _detuple(v) for k, v in meta.items()})
    np_arrays, tensors = {}, {}
    for name in ARRAY_FIELDS:
        a = np.asarray(arrays[name])
        if np.issubdtype(a.dtype, np.floating):
            np_arrays[name] = a.astype(np.float64)
            tensors[name] = torch.as_tensor(np_arrays[name], dtype=dtype,
                                            device=dev)
        else:
            np_arrays[name] = a.astype(np.int64)
            tensors[name] = torch.as_tensor(np_arrays[name], device=dev)
    return FlyModel(meta=meta, arrays=tensors, np_arrays=np_arrays)


def read_npz(path: str) -> tuple[dict, dict]:
    """(arrays, meta dict) of a model archive."""
    with np.load(path) as data:
        meta = json.loads(bytes(data['_meta_json'].tobytes()).decode())
        arrays = {k: data[k] for k in ARRAY_FIELDS}
    return arrays, meta


def load(path: str = WALK_IMITATION_NPZ, device=None,
         dtype: torch.dtype = torch.float32) -> FlyModel:
    """Loads a model archive (the JAX package's spec.save format)."""
    arrays, meta = read_npz(path)
    return from_numpy(arrays, meta, device=device, dtype=dtype)


def save(path: str, model: FlyModel) -> None:
    """Writes the archive format that load() and the JAX package read."""
    out = {k: model.np_arrays[k] for k in ARRAY_FIELDS}
    out['_meta_json'] = np.frombuffer(
        json.dumps(dataclasses.asdict(model.meta)).encode(), dtype=np.uint8)
    np.savez_compressed(path, **out)

