"""tools/profile_engine.py and tools/profile_newton.py of the port run to
their end on the CPU (every kernel's plain version) at a tiny batch, and
print every stage and micro-bench row of the JAX tool's table (the
position stage is one row, K1's, where the JAX tool has two).
profile_newton's --phases reads the kernels' clocks, so it stops without
a card instead of timing the plain versions."""

import pytest
import torch

from flybody_tpu_torch.tools import profile_engine, profile_newton

ROWS = ('position (K1)', 'collide', 'com_vel+tendon', 'make_efc', 'crb(M)',
        'rne(bias)', 'passive', 'fluid', 'factor_m(arrow)', 'solver(newton)',
        'noslip', 'sensors', 'euler', '[chol factor]', '[chol solve-1rhs]',
        '[chol fused f+s]', '[arrow factor]', '[arrow solve-1rhs]',
        '[arrow fused f+s]', '[arrow solve-25rhs]', 'FULL step',
        'solver+rest (resid)', 'steps/s')


def test_profile_engine_runs_on_the_cpu(capsys):
    results = profile_engine.main(['--cpu', '--batch', '4', '--iters', '1'])
    out = capsys.readouterr().out
    for row in ROWS:
        assert row in out, row
    assert all(v > 0 for v in results.values())
    assert 'platform=cpu' in out


def test_profile_newton_runs_on_the_cpu(capsys):
    assert profile_newton.main(['--cpu', '--batch', '4', '--iters', '1']) > 0
    assert 'solve' in capsys.readouterr().out


def test_profile_newton_phases_stop_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(SystemExit, match='CUDA device'):
        profile_newton.main(['--phases', '--batch', '4'])
