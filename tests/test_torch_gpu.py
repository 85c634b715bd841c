"""flybody_tpu_torch on a GPU: each stage kernel against its plain version.

Marked `gpu`; skips without a CUDA device. This file imports no JAX, so it
also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(tests/conftest.py imports JAX.) The kernel check runs at chip_smoke.py's
batch and seed; the main path is chip_smoke.py's.
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
    """The seven kernels (K1-K4, the Newton block, the whole Newton solve,
    the fused noslip) against their plain versions (chip_smoke.py's kernel
    phase, which raises on a disagreement) at its batch and seed: the
    Newton kernels' limits are set on the distribution over that batch."""
    sys.path.insert(0, REPO)
    import chip_smoke
    kernels = chip_smoke.kernel_phase(env, chip_smoke.BATCH, chip_smoke.SEED,
                                      {})
    assert sorted(k['name'] for k in kernels) == sorted(chip_smoke.SOURCES)
    assert len(chip_smoke.SOURCES) == 7


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(env):
    """No silent fallback: a CUDA tensor the kernel cannot take raises."""
    from flybody_tpu_torch.ops import pos_stage
    qpos = env.model.qpos0.expand(4, -1)  # stride 0: not contiguous
    with pytest.raises(ValueError, match='contiguous'):
        pos_stage.pos_stage(env.model, qpos)
    with pytest.raises(TypeError, match='float32'):
        pos_stage.pos_stage(env.model, qpos.double().contiguous())


@pytest.mark.gpu
def test_newton_block_refuses_what_its_kernel_does_not_take(env):
    """newton_block raises on a float64 or a non-contiguous CUDA operand
    instead of running its plain version."""
    import torch
    from flybody_tpu_torch.ops import arrow
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.physics import solver
    part = arrow.build_partition(env.model.meta)
    lim_dof, lim_sign, _ = solver.limit_tables(env.model.meta)
    B, K, SB3, L, nv = 2, 4, 6, len(lim_dof), part.nv
    dev = torch.device('cuda')
    Mp = arrow.pack_sym_ref(part, torch.eye(nv, device=dev).expand(B, nv,
                                                                    nv))

    def args(**over):
        a = dict(Hp=Mp.clone(), M=Mp.clone(),
                 conJ=torch.zeros(B, K, 3, nv, device=dev),
                 U=torch.zeros(B, SB3, nv, device=dev),
                 x=torch.zeros(B, nv, device=dev),
                 msm=torch.zeros(B, nv, device=dev),
                 jar_l=torch.zeros(B, L, device=dev),
                 jar_c=torch.zeros(B, K, 3, device=dev),
                 lim_params=torch.zeros(B, 2, L, device=dev),
                 con_params=torch.ones(B, 4, K, device=dev))
        a.update(over)
        return (part, lim_dof, lim_sign) + tuple(a.values()) + (8, 1)

    nf.newton_block(*args())  # the well-formed call launches
    with pytest.raises(TypeError, match='float32'):
        nf.newton_block(*args(x=torch.zeros(B, nv, device=dev,
                                            dtype=torch.float64)))
    with pytest.raises(ValueError, match='contiguous'):
        nf.newton_block(*args(U=torch.zeros(B, nv, SB3,
                                            device=dev).transpose(1, 2)))
