#!/usr/bin/env python3
"""Smoke run of flybody_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the four stage kernels (csrc/*.cu) with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes (batch 8192, float32), with errors and times;
  4. main path: walk_imitation(functional=True) reset + 5 control steps at
     batch 8192, default solver preset; state finite; every kernel's
     launch count equal to the expected per-step count; env-steps/s;
  5. CPU check: 64 envs of the reset state stepped once on the CPU (plain
     versions) against the card's step: qpos, qvel, act and every
     observation.
The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON, and details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

BATCH = 8192  # envs, the main path's batch
STEPS = 5  # control steps of the main-path phase
CPU_ENVS = 64  # envs re-run on the CPU
SEED = 0

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
TPU_REFS = {  # the TPU kernel each port replaces
    'pos_stage': 'flybody_tpu/ops/pos_stage.py:544',
    'force_stage': 'flybody_tpu/ops/force_stage.py:697',
    'arrow_factor_solve': 'flybody_tpu/ops/arrow.py:585',
    'sens_stage': 'flybody_tpu/ops/sens_stage.py:253',
}
SOURCES = {
    'pos_stage': 'flybody_tpu_torch/csrc/pos_stage.cu',
    'force_stage': 'flybody_tpu_torch/csrc/force_stage.cu',
    'arrow_factor_solve': 'flybody_tpu_torch/csrc/arrow.cu',
    'sens_stage': 'flybody_tpu_torch/csrc/sens_stage.cu',
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median per-call time over `reps` timed calls after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def compare(name, outs, refs, names):
    """Max abs error of each output, and its error relative to the largest
    |ref| at the same index of axis 1 (each body, dof, limb block, tendon,
    actuator or sensor channel against its own scale, floored at 1e-6 of
    the output's largest |ref|). Returns the worst abs and rel errors."""
    worst_abs, worst_rel = 0.0, 0.0
    for n, o, r in zip(names, outs, refs):
        if r.numel() == 0:
            continue
        o, r = o.double(), r.double()
        dims = [d for d in range(r.dim()) if d != 1]
        err = (o - r).abs().amax(dim=dims)
        scale = r.abs().amax(dim=dims)
        scale = scale.clamp(min=max(1e-6 * scale.max().item(), 1e-30))
        rel = err / scale
        i = int(rel.argmax())
        log(f'  {name}.{n}: max abs {err.max().item():.3e}  rel '
            f'{rel[i].item():.3e} (worst at [{i}] of {r.shape[1]}, scale '
            f'{scale[i].item():.3e})')
        worst_abs = max(worst_abs, err.max().item())
        worst_rel = max(worst_rel, rel[i].item())
    return worst_abs, worst_rel


def kernel_phase(env, batch, seed, report):
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.ops import arrow, force_stage, pos_stage, sens_stage
    from flybody_tpu_torch.physics import engine

    model = env.model
    meta = model.meta
    dev = model.device
    g = torch.Generator(device='cpu').manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)

    state, _ = env.reset(batch, generator=g)
    qpos = state.data.qpos.clone()
    qpos[:, 7:] += randn(batch, meta.nq - 7, scale=0.1)
    qvel = randn(batch, meta.nv, scale=1.0)
    act = randn(batch, meta.na, scale=0.2)
    ctrl = randn(batch, meta.nu, scale=0.3)
    kernels = []

    def entry(name, err, ms, plain_ms, byts, flops, library_ms=None):
        bound = max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        kernels.append({
            'name': name, 'route': 'cuda', 'source': SOURCES[name],
            'replaces': TPU_REFS[name], 'launches': None,
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound,
            'bound_by': ('bytes' if byts / HBM_BYTES_PER_S
                         >= flops / FP32_FLOPS else 'operations'),
            'library_ms': library_ms})

    # K1.
    out = pos_stage.pos_stage(model, qpos)
    ref = pos_stage.pos_stage_ref(model, qpos)
    err, rel = compare('pos_stage', out, ref, pos_stage.NAMES)
    if not rel <= 1e-4:
        raise AssertionError(f'pos_stage disagrees: rel {rel:.3e}')
    ms = cuda_ms(lambda: pos_stage.pos_stage(model, qpos), 20)
    pms = cuda_ms(lambda: pos_stage.pos_stage_ref(model, qpos), 5)
    fl = batch * (meta.nbody * 400 + (meta.ngeom + meta.nsite) * 60
                  + meta.nv * 30 + meta.ntendon * meta.nq * 2)
    entry('pos_stage', err, ms, pms, nbytes([qpos]) + nbytes(out), fl)
    log(f'pos_stage: {ms:.3f} ms kernel, {pms:.3f} ms plain')

    # K2 on the plain K1 outputs.
    ref = tuple(t.contiguous() for t in ref)
    (xpos, xquat, xmat, xipos, ximat, gpos, gmat, spos, smat, scom, cinert,
     cdof, janc, jaxw, tenl) = ref
    fargs = (qpos, qvel, act, ctrl, cdof, cinert, xipos, ximat, scom, gpos,
             gmat, tenl)
    out2 = force_stage.force_stage(model, *fargs)
    ref2 = tuple(t.contiguous() for t in
                 force_stage.force_stage_ref(model, *fargs))
    err, rel = compare('force_stage', out2, ref2, force_stage.NAMES)
    if not rel <= 1e-4:
        raise AssertionError(f'force_stage disagrees: rel {rel:.3e}')
    ms = cuda_ms(lambda: force_stage.force_stage(model, *fargs), 20)
    pms = cuda_ms(lambda: force_stage.force_stage_ref(model, *fargs), 5)
    # The walking model activates no ellipsoid fluid geom, so the kernel
    # reads no geom frames.
    used = [t for t in fargs if t is not gpos and t is not gmat]
    fl = batch * (meta.nbody * 36 * 2 * 5 + meta.nv * 12 * 10
                  + 2 * meta.ntendon * meta.nv * 2 + meta.nu * 20)
    entry('force_stage', err, ms, pms, nbytes(used) + nbytes(out2), fl)
    log(f'force_stage: {ms:.3f} ms kernel, {pms:.3f} ms plain')
    # K2's ellipsoid fluid branch, on the walking model with it switched on.
    vm = spec.from_numpy(*force_stage.ellipsoid_variant(
        *spec.read_npz(spec.WALK_IMITATION_NPZ)), device=dev,
        dtype=model.dtype)
    _, rel = compare('force_stage[ellipsoid fluid]',
                     force_stage.force_stage(vm, *fargs),
                     force_stage.force_stage_ref(vm, *fargs),
                     force_stage.NAMES)
    if not rel <= 1e-4:
        raise AssertionError(f'force_stage (ellipsoid) disagrees: {rel:.3e}')

    # K3 on the damped packed mass matrix (euler's operand).
    part = arrow.build_partition(meta)
    Mp = arrow.add_diag_packed(part, ref2[9], model.timestep
                               * model.dof_damping)
    rhs = randn(batch, meta.nv, scale=100.0)
    F, x = arrow.factor_solve(part, Mp, rhs)
    Fr, xr = arrow.factor_solve_ref(part, Mp, rhs)
    err, rel = compare('arrow', (F, x), (Fr, xr), ('F', 'x'))
    res = ((arrow.matvec_packed(part, Mp, x) - rhs).norm(dim=-1)
           / rhs.norm(dim=-1)).max().item()
    log(f'  arrow residual max ||M x - b|| / ||b|| = {res:.3e}')
    if not res <= 1e-4:
        raise AssertionError(f'arrow_factor_solve residual {res:.3e}')
    ms = cuda_ms(lambda: arrow.factor_solve(part, Mp, rhs), 20)
    pms = cuda_ms(lambda: arrow.factor_solve_ref(part, Mp, rhs), 5)
    dense = unpack(part, Mp)
    lms = cuda_ms(lambda: torch.linalg.solve(dense, rhs), 5)
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    fl = batch * sum(d ** 3 / 3 + 2 * d * d * nr + 4 * d * d + 4 * d * nr
                     for d in part.ds) + batch * (nr ** 3 + 4 * nr * nr)
    entry('arrow_factor_solve', err, ms, pms,
          nbytes([Mp, rhs]) + nbytes([F, x]), fl, library_ms=lms)
    log(f'arrow_factor_solve: {ms:.3f} ms kernel, {pms:.3f} ms plain, '
        f'{lms:.3f} ms torch.linalg.solve (dense)')

    # K4 on what fwd hands the sensors for this state: its contact rows,
    # constraint forces and accelerations.
    d, efc, f_c = engine.fwd_acc(model, state.data.replace(
        qpos=qpos, qvel=qvel, act=act, ctrl=ctrl))
    K = efc.con_active.shape[1]
    cb12 = torch.stack([efc.con_body1, efc.con_body2], 1).float()
    sargs = tuple(t.contiguous() for t in (
        d.qacc, d.qvel, d.cvel, d.cdof, d.cdof_dot, d.cinert, d.site_xpos,
        d.site_xmat, d.subtree_com, efc.con_xpos, efc.con_normal, cb12,
        efc.con_active, f_c))
    out4 = sens_stage.sens_stage(model, *sargs)
    ref4 = sens_stage.sens_stage_ref(model, *sargs)
    err, rel = compare('sens_stage', (out4,), (ref4,), ('sensordata',))
    if not rel <= 1e-4:
        raise AssertionError(f'sens_stage disagrees: rel {rel:.3e}')
    ms = cuda_ms(lambda: sens_stage.sens_stage(model, *sargs), 20)
    pms = cuda_ms(lambda: sens_stage.sens_stage_ref(model, *sargs), 5)
    fl = batch * (meta.nbody * 200 + K * 40 * 2 + meta.nsensordata * 20)
    entry('sens_stage', err, ms, pms, nbytes(sargs) + nbytes([out4]), fl)
    log(f'sens_stage: {ms:.3f} ms kernel, {pms:.3f} ms plain; active '
        f'contacts per env {efc.con_active.sum(1).mean().item():.2f}')
    report['kernel_checks'] = kernels
    return kernels


def unpack(part, Mp):
    """Dense symmetric (B, nv, nv) from the packed arrow layout."""
    import torch
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    A = Mp.new_zeros((Mp.shape[0], part.nv, part.nv))
    for i, (lo, d) in enumerate(zip(part.los, part.ds)):
        A[:, lo:lo + d, lo:lo + d] = Mp[:, i, :d, :d]
        A[:, :nr, lo:lo + d] = Mp[:, i, dm:dm + nr, :d]
        A[:, lo:lo + d, :nr] = Mp[:, i, dm:dm + nr, :d].transpose(1, 2)
    A[:, :nr, :nr] = Mp[:, nl, :nr, :nr]
    return A


def main_path_phase(batch, steps, cpu_envs, seed, report):
    """walk_imitation reset + `steps` control steps on the card."""
    import torch
    from flybody_tpu_torch.envs import fly_envs
    from flybody_tpu_torch.ops import arrow, force_stage, pos_stage, sens_stage
    mods = {'pos_stage': pos_stage, 'force_stage': force_stage,
            'arrow_factor_solve': arrow, 'sens_stage': sens_stage}
    env = fly_envs.walk_imitation(functional=True)
    g = torch.Generator(device='cpu').manual_seed(seed)
    lo = torch.as_tensor(env.action_min, dtype=torch.float32)
    hi = torch.as_tensor(env.action_max, dtype=torch.float32)
    actions = [(lo + (hi - lo) * torch.rand(batch, len(lo), generator=g)
                ).cuda() for _ in range(steps)]
    for m in mods.values():
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, ts = env.reset(batch, generator=torch.Generator().manual_seed(
        seed))
    state0 = state
    torch.cuda.synchronize()
    t_reset = time.perf_counter() - t0
    step_times, first = [], None
    for a in actions:
        t0 = time.perf_counter()
        state, ts = env.step(state, a)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        if first is None:
            first = {f: getattr(state.data, f)[:cpu_envs].cpu()
                     for f in ('qpos', 'qvel', 'act')}
            first.update({f'obs/{k}': v[:cpu_envs].cpu()
                          for k, v in ts.observation.items()})
    launches = {n: m.launches for n, m in mods.items()}
    per_step = {'pos_stage': 11, 'force_stage': 10,
                'arrow_factor_solve': 20, 'sens_stage': 10}
    expect = {n: c * steps + (1 if n == 'pos_stage' else 0)
              for n, c in per_step.items()}
    log(f'main path: launches {launches} (expected {expect})')
    if launches != expect:
        raise AssertionError(f'launch counts {launches} != {expect}')
    d = state.data
    for name in ('qpos', 'qvel', 'act', 'qacc'):
        if not torch.isfinite(getattr(d, name)).all():
            raise AssertionError(f'non-finite {name} after {steps} steps')
    for k, v in ts.observation.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f'non-finite observation {k}')
    first_timed = 2 if steps > 1 else 1
    steady = step_times[first_timed - 1:]
    rate = batch * len(steady) / sum(steady)
    log(f'main path: reset {t_reset:.3f} s, step times '
        f'{[round(t, 4) for t in step_times]} s, {rate:.1f} env-steps/s '
        f'(steps {first_timed}..{steps}, batch {batch})')
    report['main_path'] = dict(batch=batch, steps=steps, reset_s=t_reset,
                               step_s=step_times, env_steps_per_s=rate,
                               launches=launches)
    return env, state0, actions[0], first, launches


def cpu_phase(state0, action, first, cpu_envs, report):
    """The first control step of `cpu_envs` envs, re-run on the CPU."""
    import torch
    from flybody_tpu_torch.envs import fly_envs
    env = fly_envs.walk_imitation(functional=True, device='cpu')
    n = cpu_envs
    task = type(state0.task)(traj_idx=state0.task.traj_idx[:n].cpu(),
                             episode_steps=state0.task.episode_steps[:n].cpu())
    st = state0.replace(data=state0.data.index(slice(0, n)).to('cpu'),
                        step_idx=state0.step_idx[:n].cpu(),
                        prev_action=state0.prev_action[:n].cpu(), task=task)
    t0 = time.perf_counter()
    st, ts = env.step(st, action[:n].cpu())
    t = time.perf_counter() - t0
    # Each state field and observation (the observations carry the
    # substep-mean sensors, K4's output) against the card's, relative to
    # its largest magnitude there.
    errs = {}
    for name, gpu in first.items():
        cpu = (ts.observation[name[4:]] if name.startswith('obs/')
               else getattr(st.data, name))
        errs[name] = ((cpu - gpu).abs().max()
                      / gpu.abs().max().clamp(min=1e-30)).item()
    log(f'cpu check ({n} envs, {t:.1f} s): rel err {errs}')
    report['cpu_check'] = errs
    bad = {k: e for k, e in errs.items() if not e <= 1e-3}
    if bad:
        raise AssertionError(f'card and CPU disagree: {bad}')


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from flybody_tpu_torch.ops import _cuda  # fails outside the repository
    # float32 matmuls in full precision (the solver's Hessian assembly
    # expects it; TF32 is off by default, set here explicitly).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f'card: {card}')
    log(f'torch {torch.__version__} cuda {torch.version.cuda}')
    report = {'card': card}

    t0 = time.perf_counter()
    ptxas = _cuda.build_all()
    report['build_s'] = time.perf_counter() - t0
    log(f'build: {report["build_s"]:.1f} s')
    for name, text in ptxas.items():
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'  {name}: {line.strip()}')

    from flybody_tpu_torch.envs import fly_envs
    env = fly_envs.walk_imitation(functional=True)
    kernels = kernel_phase(env, BATCH, SEED, report)
    del env
    torch.cuda.empty_cache()
    _, state0, action, first, launches = main_path_phase(
        BATCH, STEPS, CPU_ENVS, SEED, report)
    for k in kernels:
        k['launches'] = launches[k['name']]
    cpu_phase(state0, action, first, CPU_ENVS, report)

    if 'jax' in sys.modules or any(m.startswith('flybody_tpu.')
                                   or m == 'flybody_tpu'
                                   for m in sys.modules):
        raise AssertionError('the port imported jax or the JAX package')
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'chip_smoke.json'), 'w') as f:
        json.dump(report, f, indent=1)
    log(json.dumps({'kernels': kernels}))
    log(card)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
