"""chip_smoke.py's kernel-vs-plain comparison catches a wrong channel.

The card check scales each output's error per index of its second axis
(each sensor channel, dof, body or limb block against its own scale), so a
kernel that got one small channel wrong fails it even when another channel
of the same output is orders of magnitude larger. Here, on the CPU, the
plain sensordata of a real forward pass (4 envs, float64) has one sensor
zeroed at a time; the comparison must report a relative error of 1.
"""

import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from flybody_tpu_torch.envs import fly_envs  # noqa: E402
from flybody_tpu_torch.ops import sens_stage  # noqa: E402
from flybody_tpu_torch.physics import engine, sensors  # noqa: E402

B = 4


@pytest.fixture(scope='module')
def sensordata():
    env = fly_envs.walk_imitation(device='cpu', dtype=torch.float64)
    model = env.model
    g = torch.Generator().manual_seed(0)
    state, _ = env.reset(B, generator=g)
    qpos = state.data.qpos.clone()
    qpos[:, 7:] += 0.1 * torch.randn(B, model.meta.nq - 7, generator=g,
                                     dtype=torch.float64)
    qvel = torch.randn(B, model.meta.nv, generator=g, dtype=torch.float64)
    d, efc, f_c = engine.fwd_acc(model, state.data.replace(qpos=qpos,
                                                           qvel=qvel))
    cb12 = torch.stack([efc.con_body1, efc.con_body2], 1).double()
    sd = sens_stage.sens_stage(
        model, d.qacc, d.qvel, d.cvel, d.cdof, d.cdof_dot, d.cinert,
        d.site_xpos, d.site_xmat, d.subtree_com, efc.con_xpos,
        efc.con_normal, cb12, efc.con_active, f_c)
    return model, sd


def test_compare_of_equal_outputs_is_zero(sensordata):
    _, sd = sensordata
    assert chip_smoke.compare('sd', (sd.clone(),), (sd,), ('sd',)) == (
        0.0, 0.0)


@pytest.mark.parametrize('k', range(15))
def test_compare_catches_a_zeroed_sensor(sensordata, k):
    model, sd = sensordata
    rows = sensors.sensor_rows(model.meta)
    assert len(rows) == 15
    r = rows[k]
    ch = slice(r['adr'], r['adr'] + r['dim'])
    assert float(sd[:, ch].abs().max()) > 0, 'sensor reads zero here'
    bad = sd.clone()
    bad[:, ch] = 0.0
    _, rel = chip_smoke.compare('sd', (bad,), (sd,), ('sd',))
    assert rel == pytest.approx(1.0)
