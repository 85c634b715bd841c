"""flybody_tpu_torch's stages against the JAX package's Pallas kernels.

The JAX kernels K1-K4 run in interpret mode on the CPU at float32 (as
tests/test_ops.py and tests/test_arrow.py run them); the port's wrappers
run their plain versions on the same seeded float32 inputs (built by
test_torch_stages._inputs). Tolerance: max |port - kernel| <= 1e-4 *
max |kernel| per output, the JAX kernels' own parity bound against their
references (ops/pos_stage.py:44-50).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.ops import arrow as jarrow
from flybody_tpu.ops import force_stage as jfs
from flybody_tpu.ops import pos_stage as jps
from flybody_tpu.ops import sens_stage as jss
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.ops import arrow as tarrow
from flybody_tpu_torch.ops import force_stage as tfs
from flybody_tpu_torch.ops import pos_stage as tps
from flybody_tpu_torch.ops import sens_stage as tss
from test_torch_stages import _close, _inputs, _t

F32_TOL = 1e-4


@pytest.fixture(scope='module')
def f32():
    d = _inputs(np.float32)
    d['tm'] = tspec.load(device='cpu', dtype=torch.float32)
    return d


def test_pos_stage_matches_pallas_interpret(f32):
    ref = jax.vmap(jps.make_pos_stage_pe(f32['jm'], interpret=True))(
        jnp.asarray(f32['qpos']))
    out = tps.pos_stage(f32['tm'], _t(f32['qpos']))
    for n, o, r in zip(tps.NAMES, out, ref):
        _close(o, r, F32_TOL, n)


def test_force_stage_matches_pallas_interpret(f32):
    ref = jax.vmap(jfs.make_force_stage_pe(f32['jm'], interpret=True))(
        *map(jnp.asarray, f32['fargs']))
    out = tfs.force_stage(f32['tm'], *map(_t, f32['fargs']))
    for n, o, r in zip(tfs.NAMES, out, ref):
        _close(o, r, F32_TOL, n)


def test_arrow_factor_solve_matches_pallas_interpret(f32):
    jp = jarrow.build_partition(f32['jm'].meta)
    part = tarrow.build_partition(f32['tm'].meta)
    Fr, xr = jarrow.factor_solve_batched(jp, jnp.asarray(f32['Mp']),
                                         jnp.asarray(f32['rhs']),
                                         interpret=True)
    F, x = tarrow.factor_solve(part, _t(f32['Mp']), _t(f32['rhs']))
    _close(F, Fr, F32_TOL, 'F')
    _close(x, xr, F32_TOL, 'x')


def test_sens_stage_matches_pallas_interpret(f32):
    ref = jax.vmap(jss.make_sens_stage_pe(f32['jm'], interpret=True))(
        *map(jnp.asarray, f32['sargs']))
    out = tss.sens_stage(f32['tm'], *map(_t, f32['sargs']))
    _close(out, ref, F32_TOL, 'sensordata')
