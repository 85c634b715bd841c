"""flybody_tpu_torch: the shipped model asset, carrying a JAX model across,
import hygiene, device selection and host-side kernel tables."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.envs import fly_envs
from flybody_tpu.model import spec as jspec
from flybody_tpu_torch.model import spec as tspec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def fresh(tmp_path_factory):
    """A fresh spec.save of the JAX package's walking model."""
    path = str(tmp_path_factory.mktemp('model') / 'walk.npz')
    jspec.save(path, fly_envs._walking_model())
    return path


def test_asset_matches_fresh_walking_model(fresh):
    """The committed asset is spec.save(fly_envs._walking_model())."""
    a_arr, a_meta = tspec.read_npz(tspec.WALK_IMITATION_NPZ)
    f_arr, f_meta = tspec.read_npz(fresh)
    assert a_meta == f_meta
    for k in tspec.ARRAY_FIELDS:
        np.testing.assert_array_equal(a_arr[k], f_arr[k], err_msg=k)


def test_from_numpy_carries_a_jax_model_across():
    jm = jspec.load(tspec.WALK_IMITATION_NPZ)
    arrays = {k: np.asarray(getattr(jm, k)) for k in tspec.ARRAY_FIELDS}
    tm = tspec.from_numpy(arrays, dataclasses.asdict(jm.meta), device='cpu',
                          dtype=torch.float64)
    ref = tspec.load(device='cpu', dtype=torch.float64)
    assert tm.meta == ref.meta
    for k in tspec.ARRAY_FIELDS:
        assert torch.equal(getattr(tm, k), getattr(ref, k)), k
    assert tm.meta.nq == 109 and tm.meta.nv == 108 and tm.meta.nu == 59


def test_save_load_round_trip(tmp_path):
    m = tspec.load(device='cpu', dtype=torch.float64)
    path = str(tmp_path / 'm.npz')
    tspec.save(path, m)
    jm = jspec.load(path)  # the JAX package reads the port's archive
    assert jm.meta == jspec.load(tspec.WALK_IMITATION_NPZ).meta
    m2 = tspec.load(path, device='cpu', dtype=torch.float64)
    for k in tspec.ARRAY_FIELDS:
        assert torch.equal(getattr(m2, k), getattr(m, k)), k


def test_package_imports_no_jax():
    code = ('import sys, pkgutil, importlib, flybody_tpu_torch as p\n'
            'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
            '    importlib.import_module(m.name)\n'
            'bad = [m for m in sys.modules if m == "jax" or m.startswith('
            '("jax.", "flax", "flybody_tpu.")) or m == "flybody_tpu"]\n'
            'assert not bad, bad\n'
            'print("ok")\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_entry_points_default_to_cuda():
    """Without a GPU the entry points refuse to run unless asked for the
    CPU; with device='cpu' they run there."""
    from flybody_tpu_torch.envs import fly_envs as tfe
    if torch.cuda.is_available():
        pytest.skip('a GPU is present; the default device is usable')
    with pytest.raises(RuntimeError, match='CUDA'):
        tfe.walk_imitation()
    with pytest.raises(RuntimeError, match='CUDA'):
        tspec.load()
    env = tfe.walk_imitation(device='cpu')
    assert env.model.device.type == 'cpu'
    assert env.model.dtype == torch.float32


def test_trajectory_stores_default_to_cuda():
    """The reference-trajectory stores run on CUDA unless asked for the CPU,
    like the other entry points."""
    from flybody_tpu_torch.envs import trajectories as ttraj
    if torch.cuda.is_available():
        pytest.skip('a GPU is present; the default device is usable')
    qpos, qvel = np.zeros((3, 7)), np.zeros((3, 6))
    with pytest.raises(RuntimeError, match='CUDA'):
        ttraj.inference_walking_store()
    with pytest.raises(RuntimeError, match='CUDA'):
        ttraj.store_from_arrays([qpos], [qvel])
    store = ttraj.inference_walking_store(device='cpu')
    assert store.qpos.device.type == 'cpu'
    assert store.qpos.shape == (1, 300, 7)
    store = ttraj.store_from_arrays([qpos, qpos[:2]], [qvel, qvel[:2]],
                                    device='cpu', dtype=torch.float32)
    assert store.qpos.dtype == torch.float32
    assert store.lengths.tolist() == [3, 2]


def test_kernel_tables_match_the_model():
    """Host tables the kernels walk: dof ancestor chains equal the CRB
    sparsity, and the stage packs build for the walking model."""
    from flybody_tpu_torch.ops import force_stage, pos_stage, sens_stage
    from flybody_tpu_torch.physics import kinematics as kin
    m = tspec.load(device='cpu', dtype=torch.float32)
    meta = m.meta
    sub = kin.tables(meta)['subtree_mask']
    db = np.array(meta.dof_bodyid)
    anc = sub[db, :].T[db] * np.tril(np.ones((meta.nv, meta.nv)))
    par = force_stage._dof_parents(meta)
    for i in range(meta.nv):
        chain, j = set(), i
        while j >= 0:
            chain.add(j)
            j = par[j]
        assert chain == set(np.nonzero(anc[i])[0]), i
    for mod in (pos_stage, force_stage, sens_stage):
        p = mod.pack(m)
        assert p.ints[:p.nf].max() < len(p.floats)
        assert p.ints[p.nf:p.nf + p.ni].max() < len(p.ints)
        assert len(p.floats) * 4 + len(p.ints) * 4 < 48 * 1024


@pytest.mark.parametrize('k', [1, 5, 64])
def test_smallest_orders_ties_like_lax_top_k(k):
    """Selections are stable sorts: ties keep the lower index first, as
    jax.lax.top_k on the negated scores does."""
    from flybody_tpu_torch.physics.collision import smallest
    rng = np.random.RandomState(k)
    x = rng.randint(0, 6, size=(3, 80)).astype(np.float64)
    _, ref = jax.lax.top_k(-jnp.asarray(x), k)
    out = smallest(torch.as_tensor(x), k)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

