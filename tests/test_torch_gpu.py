"""flybody_tpu_torch on a GPU: each stage kernel against its plain version.

Marked `gpu`; skips without a CUDA device. This file imports no JAX, so it
also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(tests/conftest.py imports JAX.) The full-size check is chip_smoke.py.
"""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def env():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from flybody_tpu_torch.envs import fly_envs
    return fly_envs.walk_imitation(device='cuda')


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card(env):
    """K1-K4 against their plain versions at batch 256 (the checks of
    chip_smoke.py's kernel phase, which raises on a disagreement)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    kernels = chip_smoke.kernel_phase(env, 256, 0, {})
    assert [k['name'] for k in kernels] == list(chip_smoke.SOURCES)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(env):
    """No silent fallback: a CUDA tensor the kernel cannot take raises."""
    from flybody_tpu_torch.ops import pos_stage
    qpos = env.model.qpos0.expand(4, -1)  # stride 0: not contiguous
    with pytest.raises(ValueError, match='contiguous'):
        pos_stage.pos_stage(env.model, qpos)
    with pytest.raises(TypeError, match='float32'):
        pos_stage.pos_stage(env.model, qpos.double().contiguous())
