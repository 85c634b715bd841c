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
from flybody_tpu_torch.model import spec  # noqa: E402
from flybody_tpu_torch.ops import sens_stage  # noqa: E402
from flybody_tpu_torch.physics import engine, sensors  # noqa: E402

B = 4


@pytest.fixture(scope='module')
def sens_operands():
    """The model and K4's operands of a real forward pass (float64)."""
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
    return model, sens_stage.operands(d, efc, f_c)


@pytest.fixture(scope='module')
def sensordata(sens_operands):
    model, sargs = sens_operands
    return model, sens_stage.sens_stage(model, *sargs)


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


def _substep(seed, rel):
    """Six substep quantities (qpos, qvel, qacc, sensordata (16, 5); cost
    and force (16,)), each times (1 + rel * N(0, 1)) elementwise."""
    g = torch.Generator().manual_seed(0)
    base = ([torch.randn(16, 5, generator=g, dtype=torch.float64)
             for _ in range(4)]
            + [1.0 + torch.rand(16, generator=g, dtype=torch.float64)
               for _ in range(2)])
    g = torch.Generator().manual_seed(seed)
    return [b * (1.0 + rel * torch.randn(b.shape, generator=g,
                                         dtype=torch.float64))
            for b in base]


def test_two_fly_gate_passes_a_card_like_the_cpu():
    """A card whose errors against float64 are of the CPU float32's size
    passes chip_smoke's two-fly substep gate."""
    gate = chip_smoke.f64_anchored(_substep(1, 1e-4), _substep(2, 1e-4),
                                   _substep(3, 0.0))
    assert all(v['ok'] for v in gate.values()), gate


@pytest.mark.parametrize('k', range(6))
def test_two_fly_gate_catches_one_wrong_env(k):
    """One env of one quantity 1% off fails the gate; every other
    quantity passes."""
    card = _substep(1, 1e-4)
    card[k][3] = card[k][3] * 1.01
    gate = chip_smoke.f64_anchored(card, _substep(2, 1e-4), _substep(3, 0.0))
    names = list(chip_smoke.SUBSTEP_NAMES) + ['cost', 'force']
    assert [v['ok'] for v in gate.values()] == [n != names[k] for n in names]


def test_chol_diagonal_control_touches_one_env():
    """The gate's control scales A's diagonal in the env it names only."""
    from flybody_tpu_torch.ops import cholesky as ch
    g = torch.Generator().manual_seed(0)
    R = torch.randn(3, 6, 6, generator=g, dtype=torch.float64)
    A = R @ R.transpose(1, 2) + 6 * torch.eye(6, dtype=torch.float64)
    b = torch.randn(3, 6, generator=g, dtype=torch.float64)
    x = ch.chol_solve(A, b)[1]
    with chip_smoke.chol_diagonal(1.5, 1):
        y = ch.chol_solve(A, b)[1]
    Ad = A.clone()
    Ad[1] += torch.diag(0.5 * torch.diagonal(A[1]))
    assert torch.equal(y[[0, 2]], x[[0, 2]])
    torch.testing.assert_close(y[1], torch.linalg.solve(Ad[1], b[1]))
    assert ch.chol_solve(A, b)[1].equal(x)  # restored


def test_gs_cases_well_conditioned_sweeps_every_slot():
    """Row 12's well-conditioned case uses every slot, clamps some of them
    and not others, and float32 resolves it (the plain version at float32
    within 1e-4 of each index's scale of its float64)."""
    from flybody_tpu_torch.ops import noslip_gs as ng
    g = torch.Generator().manual_seed(0)
    B, K, n = 3, 8, 12
    R = torch.randn(B, n, n, generator=g)
    L = torch.linalg.cholesky(R @ R.transpose(1, 2) + n * torch.eye(n))

    def rn(*s):
        return torch.randn(*s, generator=g)

    gargs = (rn(B, K, 2, n), rn(B, K, 2, n), rn(B, K, 2, 2), rn(B, K, 2),
             torch.rand(B, K, generator=g), torch.zeros(B, K), rn(B, n),
             rn(B, K, 2), 3)
    every, every64, wc, wc64 = chip_smoke.gs_cases(gargs, L, 0)
    assert bool((wc[5] == 1).all()) and bool((every[5] == 1).all())
    assert wc64[0].dtype == torch.float64 and wc64[8] == 3
    x, ft = ng.gs_ref(*wc)
    x64, ft64 = ng.gs_ref(*wc64)
    at_radius = (ft64.norm(dim=-1) - wc64[4]).abs() < 1e-9
    assert 0 < at_radius.double().mean() < 1
    for o, r in ((x, x64), (ft, ft64)):
        assert chip_smoke.env_err([o], [r]).max() < 1e-4



def _contacts_on_sensors(model, sargs):
    """K4's operands with every contact slot made active, side 0 on a
    touch sensor's body or one of the first bodies of a force sensor's
    subtree in turn, with seeded random forces."""
    sargs = [t.clone() for t in sargs]
    rows = sensors.sensor_rows(model.meta)
    pl = sens_stage.plan(model.meta, rows)
    touch = [model.meta.site_bodyid[r['objid']] for r in rows
             if r['type'] == spec.SENS_TOUCH]
    ids = torch.as_tensor(touch + pl['need'].tolist()[:3],
                          dtype=sargs[11].dtype)
    K = sargs[12].shape[1]
    sargs[11][:, 0] = ids[torch.arange(K) % len(ids)]
    sargs[12][:] = 1.0
    sargs[13][:] = torch.randn(sargs[13].shape, dtype=sargs[13].dtype,
                               generator=torch.Generator().manual_seed(2))
    return sargs


@pytest.mark.parametrize('with_contacts', [False, True])
def test_sens_reads_hold_every_entry_sensordata_depends_on(sens_operands,
                                                           with_contacts):
    """K4's bound counts only the entries chip_smoke.sens_reads keeps:
    every other entry of every operand, set to seeded random values (finite,
    so that the plain version's masked sums stay exact), leaves the plain
    sensordata bit for bit as it was. with_contacts: the contact slots are
    first put on the sensors' bodies (_contacts_on_sensors), so that the
    kept contact rows are exercised."""
    model, sargs = sens_operands
    if with_contacts:
        sargs = _contacts_on_sensors(model, sargs)
    want = sens_stage.sens_stage_ref(model, *sargs)
    masks = chip_smoke.sens_reads(model, sargs)
    g = torch.Generator().manual_seed(1)
    noisy = [torch.where(m, t, 1e3 * torch.randn(t.shape, dtype=t.dtype,
                                                 generator=g))
             for m, t in zip(masks, sargs)]
    noisy[11] = sargs[11]  # every contact's bodies are read
    got = sens_stage.sens_stage_ref(model, *noisy)
    assert torch.equal(got, want)
    kept = sum(int(m.sum()) for m in masks[:11] + masks[12:])
    assert 0 < kept < sum(m.numel() for m in masks[:11] + masks[12:])
    byts, ops = chip_smoke.sens_work(model, sargs)
    assert byts == 8 * (sum(int(m.sum()) for m in masks)
                        + sargs[0].shape[0] * model.meta.nsensordata)
    assert ops > 0


def test_sens_reads_keep_only_entries_sensordata_depends_on(sens_operands):
    """And each entry sens_reads keeps matters: in env 0 of the operands
    of _contacts_on_sensors, each kept entry (the contacts' bodies aside)
    raised by 1e3 alone, one copy of the env each, changes the plain
    sensordata."""
    model, sargs = sens_operands
    sargs = [t[:1] for t in _contacts_on_sensors(model, sargs)]
    want = sens_stage.sens_stage_ref(model, *sargs)
    masks = chip_smoke.sens_reads(model, sargs)
    for i, m in enumerate(masks):
        idx = torch.nonzero(m.reshape(-1))[:, 0]
        if i == 11 or len(idx) == 0:
            continue
        n = len(idx)
        envs = [t.expand(n, *t.shape[1:]).clone() for t in sargs]
        envs[i].view(n, -1)[torch.arange(n), idx] += 1e3
        got = sens_stage.sens_stage_ref(model, *envs)
        moved = (got != want).any(1)
        assert bool(moved.all()), (i, idx[~moved].tolist())
