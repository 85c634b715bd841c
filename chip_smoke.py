#!/usr/bin/env python3
"""Smoke run of flybody_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

These paths are driven, each the counterpart of the JAX package's default
configuration (no kill switch in its dispatch gate,
flybody_tpu/ops/dispatch.py) or of one named switch, so every TPU kernel
that the JAX package launches on them runs here as a hand-written CUDA
kernel: walk_imitation's batched step at both solver presets (one fly, the
block-arrow path) and at `default_full` (the JAX package with
FLYBODY_NEWTON_BLOCK_FULL=1: the Hessian assembled in the Newton kernel);
engine.step on the two-fly scene at both presets
(model/assets/two_fly.npz: no arrow partition, so the dense path); the
collision tools tools/profile_collide.py and tools/profile_micro.py (the
dense collide, the per-type-pair MPR); and tools/profile_engine.py's stage
chain, the walking model with a dense mass matrix (the arrow path on an
unpacked M).

Phases (any failure exits non-zero):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the kernels (csrc/*.cu) with nvcc, one process each;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes (batch 8192, float32), with errors and times:
     the stage kernels K1-K4; the analytic narrowphase (row 5 of PERF.md's
     kernel table), the merged MPR (row 6, held per pair beside wrong
     controls) and the contact rows (row 7) on the geometry and candidates
     of a forward pass at each preset's widths; the Newton block (row 8)
     and the fused noslip (row 11) on the rows and factor of a
     default-preset forward pass; the whole Newton solve (row 9) and the
     noslip on 16 slots on a bench-preset forward pass. The Newton kernels
     are held per env (newton_checks), beside readings of the plain
     version at float64 and of deliberately wrong controls. Then the dense
     path's kernels on the operands of a two-fly step at batch 4096
     (dense_kernels): the fused factor+solve (row 17, per env beside two
     wrong controls) on M, a Newton Hessian and the damped Euler matrix,
     the substitutions (rows 15, 16; row 16 also on a bench substep's 32
     right-hand sides), the noslip sweeps (row 12) and the
     line search (row 13, per search beside one refinement step fewer);
     and the last slice's (dense_collision_kernels, block_full_check): row
     5 on the dense collide's 1,213 slots (capsule-capsule included), row
     20 on the seven MPR groups' candidates per near pair beside two wrong
     controls that must fail (mpr_kernel.passes_gate), row 7 on the dense
     make_efc's 2,048 candidates (K 64), and row 9's block-full mode on the
     default forward pass through newton_checks beside three wrong controls
     that must fail (a bf16-rounded Hessian, one iteration more, one
     fewer). Rows 5 and 20 print their device time and the wrapper's host
     time beside the CUDA-event time (tools/device_time.py).
     Each Newton mode's, K1's, K2's, K3's (its packed
     one-right-hand-side kernel), K4's, the narrowphase's (compact and
     dense), the merged MPR's, the contact rows' (each preset's and the
     dense widths), the fused noslip's and the line search's (row 13,
     two-fly widths) registers a thread, shared
     memory a block, blocks an SM and grid are printed
     (kernel_resources), with the share of the merged
     MPR's warps whose lanes share one type-pair key at each preset's P
     and its pre-pass order held against the plain one
     (mpr_order_readings), and the noslip operands' path work: envs by the
     number of slots they list (use > 0), the slots row 11 sweeps;
  4. main path, at each preset (default, default_full, bench):
     walk_imitation(functional=True) reset + 5 control steps at batch
     8192; state finite; every kernel's launch count equal to the
     expected count (default_full: 100 block-full launches a control step,
     no block launch); env-steps/s, default_full's beside default's;
  5. CPU check, at each preset: 64 envs of the reset state stepped once on
     the CPU (plain versions) against the card's step, per env (cpu_phase;
     read, not held, at the bench preset), and one substep's forward pass
     from the card's stepped state on both (substep_phase; printed beside
     it, a control with rows 5-7 plain on the card and the CPU's float32
     against its float64);
  6. two_fly, at each preset: reset + 5 engine.step substeps of the
     two-fly scene at batch 4096 (8,192 flies); state finite; launch
     counts exact; scene-substeps/s; one substep of 16 envs from the
     stepped state on the card and on the CPU at float32 and float64
     (held at the default preset: the card no further from the float64
     answer than the CPU's float32, since float32 does not resolve this
     substep to 1e-3 in every env; read at the bench one).
  7. tools (tools_phase): one profile_collide pass (the seven groups'
     per-pair MPR launches, the FULL collide's rows 5 and 6) and one
     profile_micro chain at batch 8192, every launch counted exactly and
     every output finite, K1's resources and the merged MPR's readings on
     the dense collide's candidates, then both tables;
  8. unpacked: tools/profile_engine.py's stage chain on the walking model
     with a dense mass matrix and the dense collide at batch 8192
     (unpacked_phase): one pass with exact launch counts (rows 18 and 19 once, K3 five times: four
     fresh arrow Newton steps with 1 + 3 SB right-hand sides and euler;
     rows 14, 15, 13 and the reuse kernel, row 10, four times; row 11 and
     K4 once); then on a flailing state's operands the new kernels against
     their plain versions (rows 18, 19, 14 and K3's dense form per env by
     each dof's scale and residual, beside a bf16-rounded-A control that
     must fail, K3's dense form at m 25 and at m 1 (Euler's damped M),
     each timed beside its bound and torch.linalg.solve, with its
     resources; row 15 at n 24 and 108 against its plain version, each
     shape timed beside its bound and torch.cholesky_solve; row 13 at the
     chain's widths (L 204, K 32) per search against its plain version at
     30 refinement steps (read at the path's 6), timed beside its bound,
     with its resources; row 10
     through newton_checks beside one iteration more, which must fail,
     with its resources and its cycles an env per phase, reuse_phases)
     and solver.solve on the dense M for 64 envs, card
     against CPU, by primal cost and net normal force; then the tool's
     stage table.
Each phase's seconds are printed.
The last line is {"ok": true, "device": {...}}; the two lines before it
hold the per-kernel JSON and the card's name and power limit, and details
go to chiprun_out/chip_smoke.json.

    python3 chip_smoke.py --gate-seeds N

only reads phase 6's two-fly gate at seeds 0..N-1 (gate_seeds).
"""

from __future__ import annotations

import contextlib
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
    'narrowphase': 'flybody_tpu/ops/narrowphase.py:269',
    'mpr_merged': 'flybody_tpu/ops/mpr_kernel.py:360',
    'efc_contacts': 'flybody_tpu/ops/efc_stage.py:241',
    'newton_block': 'flybody_tpu/ops/newton_fused.py:461',
    'newton_solve': 'flybody_tpu/ops/newton_fused.py:1038',
    'noslip_fused': 'flybody_tpu/ops/noslip_gs.py:227',
    'noslip_gs': 'flybody_tpu/ops/noslip_gs.py:77',
    'line_search': 'flybody_tpu/ops/linesearch.py:229',
    'cho_solve': 'flybody_tpu/ops/cholesky.py:186',
    'cho_solve_multi': 'flybody_tpu/ops/cholesky.py:256',
    'chol_solve': 'flybody_tpu/ops/cholesky.py:333',
    'chol': 'flybody_tpu/ops/cholesky.py:79',
    'arrow_factor': 'flybody_tpu/ops/arrow.py:524',
    'arrow_solve': 'flybody_tpu/ops/arrow.py:554',
    'newton_reuse': 'flybody_tpu/ops/newton_fused.py:232',
    'newton_block_full': 'flybody_tpu/ops/newton_fused.py:1038',
    'mpr_pair': 'flybody_tpu/ops/mpr_kernel.py:334',
}
SOURCES = {
    'pos_stage': 'flybody_tpu_torch/csrc/pos_stage.cu',
    'force_stage': 'flybody_tpu_torch/csrc/force_stage.cu',
    'arrow_factor_solve': 'flybody_tpu_torch/csrc/arrow.cu',
    'sens_stage': 'flybody_tpu_torch/csrc/sens_stage.cu',
    'narrowphase': 'flybody_tpu_torch/csrc/narrowphase.cu',
    'mpr_merged': 'flybody_tpu_torch/csrc/mpr.cu',
    'efc_contacts': 'flybody_tpu_torch/csrc/efc_stage.cu',
    'newton_block': 'flybody_tpu_torch/csrc/newton.cu',
    'newton_solve': 'flybody_tpu_torch/csrc/newton.cu',
    'noslip_fused': 'flybody_tpu_torch/csrc/noslip.cu',
    'noslip_gs': 'flybody_tpu_torch/csrc/noslip_gs.cu',
    'line_search': 'flybody_tpu_torch/csrc/linesearch.cu',
    'cho_solve': 'flybody_tpu_torch/csrc/cholesky.cu',
    'cho_solve_multi': 'flybody_tpu_torch/csrc/cholesky.cu',
    'chol_solve': 'flybody_tpu_torch/csrc/cholesky.cu',
    'chol': 'flybody_tpu_torch/csrc/cholesky.cu',
    'arrow_factor': 'flybody_tpu_torch/csrc/arrow.cu',
    'arrow_solve': 'flybody_tpu_torch/csrc/arrow.cu',
    'newton_reuse': 'flybody_tpu_torch/csrc/newton.cu',
    'newton_block_full': 'flybody_tpu_torch/csrc/newton.cu',
    'mpr_pair': 'flybody_tpu_torch/csrc/mpr.cu',
}
DENSE = ('noslip_gs', 'line_search', 'cho_solve', 'cho_solve_multi',
         'chol_solve')
UNPACKED = ('chol', 'arrow_factor', 'arrow_solve', 'newton_reuse')
LAST = ('newton_block_full', 'mpr_pair')
PRESETS = ('default', 'bench')
# Launches of each kernel on the main path: reset (pos_stage once), then
# per control step (10 substeps).
PER_STEP = {
    'default': {'pos_stage': 11, 'narrowphase': 10, 'mpr_merged': 10,
                'force_stage': 10, 'efc_contacts': 10,
                'arrow_factor_solve': 20, 'sens_stage': 10,
                'newton_block': 100, 'newton_solve': 0, 'noslip_fused': 10,
                **{n: 0 for n in DENSE + UNPACKED + LAST}},
    'bench': {'pos_stage': 11, 'narrowphase': 10, 'mpr_merged': 10,
              'force_stage': 10, 'efc_contacts': 10,
              'arrow_factor_solve': 20, 'sens_stage': 10,
              'newton_block': 0, 'newton_solve': 10, 'noslip_fused': 10,
              **{n: 0 for n in DENSE + UNPACKED + LAST}},
}
# default_full: the default preset with kernel 9's block-full mode in place
# of the split form (the Hessian assembled in the kernel).
PER_STEP['default_full'] = dict(PER_STEP['default'], newton_block=0,
                                newton_block_full=100)
# The two-fly scene (model/assets/two_fly.npz: two flies, no arrow
# partition, so the dense path): batch, substeps of its main-path phase,
# envs re-run on the CPU, and launches of each kernel per substep (the
# factor+solve of the smooth acceleration and of the damped Euler step
# plus one per fresh Newton step; a substitution per reuse step; a line
# search per Newton step).
TWO_FLY_BATCH = 4096
TWO_FLY_STEPS = 5
TWO_FLY_CPU_ENVS = 16
TWO_FLY_PER_SUBSTEP = {
    'default': {'pos_stage': 1, 'narrowphase': 1, 'mpr_merged': 1,
                'sens_stage': 1, 'chol_solve': 12, 'cho_solve': 0,
                'line_search': 10, 'cho_solve_multi': 1, 'noslip_gs': 1},
    'bench': {'pos_stage': 1, 'narrowphase': 1, 'mpr_merged': 1,
              'sens_stage': 1, 'chol_solve': 3, 'cho_solve': 7,
              'line_search': 8, 'cho_solve_multi': 1, 'noslip_gs': 1},
}
# The Newton kernels against their plain versions (newton_checks), per env:
# a few envs end on another point than the plain version's, as the plain
# float32 version does against itself at float64 (PERF.md section 6).
# At 30 line-search steps the share of envs whose outputs all agree to
# NEWTON_ENV_TOL (relative to each dof's / row's / slot's scale) is at
# least NEWTON_ENV_SHARE, and the kernel's share against the plain version
# at float64 is at most F64_SHARE_SLACK (and 4 envs) below the plain
# float32 version's.
# At the preset's own steps the per-env primal cost and net normal contact
# force agree in distribution: their median env relative difference and
# the relative difference of their batch means are at most COST_REL_TOL.
# Each limit lies between the kernel's reading and those of the controls
# newton_checks also prints (a wrong Hessian rounding, a wrong trip
# count), measured on an NVIDIA H100 (PERF.md section 6).
NEWTON_ENV_TOL = 1e-3
NEWTON_ENV_SHARE = 0.98
F64_SHARE_SLACK = 0.005
COST_REL_TOL = {'newton_block': (1e-5, 1e-2),  # (median env, batch mean)
                'newton_solve': (2e-3, 8e-3),
                'newton_reuse': (1e-5, 1e-2),  # row 8's
                'newton_block_full': (1e-5, 1e-2)}
NOSLIP_REL_TOL = 1e-3  # per-index rel. error of the noslip kernel
NARROW_REL_TOL = 1e-5  # per-slot rel. error of the narrowphase kernel
EFC_REL_TOL = 1e-5  # per-field rel. error of the contact-row kernel
# The MPR kernels (rows 6 and 20) against their plain version, per
# candidate pair: ops/mpr_kernel.py's gate (`agreement`, `passes_gate`).


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


def sens_reads(model, sargs) -> list:
    """The entries of each K4 operand (sens_stage's order, batch first)
    that sensordata depends on, as boolean tensors of the operands'
    shapes: qacc, cdof and cdof_dot at the dofs of the chains of the
    bodies whose acceleration the sensors read (sens_stage.plan's `dofs`),
    and qvel at those whose cdof_dot row is not zero (in this run's data:
    the free joint's translations have a zero one);
    the force rows (3-5) of cinert of the force sensors' subtrees
    (`need`): a force sensor reads only the force part of the internal
    forces, which takes no torque; cvel of those bodies and of the
    gyros', velocimeters' and accelerometers' bodies; the site positions
    of the velocimeters and accelerometers and the site frames of every
    sensor but touch; subtree_com at the roots of the velocimeters' and
    accelerometers' bodies; every contact's bodies; the normal, force and
    active flag of each contact with a side on `need` (in this run's
    data; its position only moves the torque), and the normal force and
    active flag of each other contact on a touch sensor's body."""
    import torch
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.ops import sens_stage
    from flybody_tpu_torch.physics import sensors
    meta = model.meta
    rows = sensors.sensor_rows(meta)
    pl = sens_stage.plan(meta, rows)

    def sites(*types):
        return sorted({r['objid'] for r in rows if r['type'] in types})

    def bodies(*types):
        return {meta.site_bodyid[r['objid']] for r in rows
                if r['type'] in types}
    arm = (spec.SENS_VELOCIMETER, spec.SENS_ACCELEROMETER)
    need = pl['need'].tolist()
    masks = [torch.zeros(t.shape, dtype=torch.bool, device=t.device)
             for t in sargs]
    (qacc, qvel, cvel, cdof, cdd, cinert, spos, smat, scom, cpos, cn, cb12,
     cact, fc) = masks
    dofs = sorted(set(pl['dofs'].tolist()))
    for m in (qacc, cdof, cdd):
        m[:, dofs] = True
    qvel[:, dofs] = (sargs[4][:, dofs] != 0).any(-1)
    cinert[:, need, 3:] = True
    cvel[:, sorted(set(need) | bodies(spec.SENS_GYRO, *arm))] = True
    spos[:, sites(*arm)] = True
    smat[:, sites(spec.SENS_GYRO, spec.SENS_FORCE, *arm)] = True
    scom[:, sorted({meta.body_rootid[b] for b in bodies(*arm)})] = True
    cb12[:] = True
    b12 = torch.round(sargs[11]).long()

    def on(ids):
        ids = torch.as_tensor(sorted(ids), dtype=torch.long,
                              device=b12.device)
        return torch.isin(b12, ids).any(1)
    wrench, touch = on(need), on(bodies(spec.SENS_TOUCH))
    for m in (cn, fc):
        m[wrench] = True
    fc[..., 0] |= touch
    cact[:] = wrench | touch
    return masks


def sens_work(model, sargs) -> tuple:
    """(bytes, operations) K4 must spend on these operands: the entries
    of sens_reads, each read once, and sensordata written once; the
    accelerations over the `dofs` chains (4 an entry a component), the body
    forces of `need` (~200 each), the wrenches of the contacts sens_reads
    keeps (80 each, both sides) and the subtree sums (6 a term), 20 a
    sensordata entry."""
    from flybody_tpu_torch.ops import sens_stage
    from flybody_tpu_torch.physics import sensors
    meta = model.meta
    pl = sens_stage.plan(meta, sensors.sensor_rows(meta))
    masks = sens_reads(model, sargs)
    B = sargs[0].shape[0]
    byts = sum(int(m.sum()) * t.element_size()
               for m, t in zip(masks, sargs))
    byts += B * meta.nsensordata * sargs[0].element_size()
    ops = (B * (24 * len(pl['dofs']) + 200 * len(pl['need'])
                + 6 * len(pl['sub']) + 20 * meta.nsensordata)
           + 80 * int(masks[9][..., 0].sum()))
    return byts, ops


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


def kernel_entry(name, err, ms, plain_ms, byts, flops, library_ms=None):
    """A kernel's line of the kernels JSON; the bound is the larger of
    bytes over the memory rate and operations over the float32 rate."""
    return {'name': name, 'route': 'cuda', 'source': SOURCES[name],
            'replaces': TPU_REFS[name], 'launches': None,
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': max(byts / HBM_BYTES_PER_S,
                            flops / FP32_FLOPS) * 1e3,
            'bound_by': ('bytes' if byts / HBM_BYTES_PER_S
                         >= flops / FP32_FLOPS else 'operations'),
            'library_ms': library_ms}


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

    def entry(*a, **kw):
        kernels.append(kernel_entry(*a, **kw))

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
    kernel_resources('pos_stage', pos_stage.kernel_info(model, batch), batch,
                     report)

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
    kernel_resources('force_stage', force_stage.kernel_info(model, batch),
                     batch, report)
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
    kernel_resources('arrow_factor_solve', arrow.kernel_info(part, batch),
                     batch, report)

    # K4 on what fwd hands the sensors for this state: its contact rows,
    # constraint forces and accelerations.
    d, efc, f_c = engine.fwd_acc(model, state.data.replace(
        qpos=qpos, qvel=qvel, act=act, ctrl=ctrl))
    K = efc.con_active.shape[1]
    sargs = sens_stage.operands(d, efc, f_c)
    out4 = sens_stage.sens_stage(model, *sargs)
    ref4 = sens_stage.sens_stage_ref(model, *sargs)
    err, rel = compare('sens_stage', (out4,), (ref4,), ('sensordata',))
    if not rel <= 1e-4:
        raise AssertionError(f'sens_stage disagrees: rel {rel:.3e}')
    ms = cuda_ms(lambda: sens_stage.sens_stage(model, *sargs), 20)
    pms = cuda_ms(lambda: sens_stage.sens_stage_ref(model, *sargs), 5)
    entry('sens_stage', err, ms, pms, *sens_work(model, sargs))
    log(f'sens_stage: {ms:.3f} ms kernel, {pms:.3f} ms plain; active '
        f'contacts per env {efc.con_active.sum(1).mean().item():.2f}')
    kernel_resources('sens_stage', sens_stage.kernel_info(model, K, batch),
                     batch, report)

    data_in = state.data.replace(qpos=qpos, qvel=qvel, act=act, ctrl=ctrl)
    collision_kernels(model, data_in, entry, report)
    dense_collision_kernels(model, data_in, entry, report)
    solver_kernels(model, data_in, entry, report)
    report['kernel_checks'] = kernels
    return kernels


def arrow_flops(part, nrhs: int, factor: bool) -> float:
    """Operations of a packed arrow substitution of nrhs right-hand sides,
    plus the factor if asked."""
    nr = part.nr
    fl = nrhs * (sum(2 * d * d + 4 * d * nr for d in part.ds) + 2 * nr * nr)
    if factor:
        fl += sum(d ** 3 / 3 + d * d * nr for d in part.ds)
        fl += nr * nr * sum(part.ds) + nr ** 3 / 3
    return fl


def newton_flops(part, K, L, SB3, n_iters, ls_iters, whole: bool,
                 assemble: bool | None = None) -> float:
    """Operations of one env's Newton block (assemble, by default as
    whole: with the Hessian and Woodbury assembly; whole: also the
    warmstart pick and the closing forces)."""
    nv, R3 = part.nv, 3 * K
    msize = (len(part.ds) + 1) * (part.dmax + part.nr) * part.dmax
    ls_eval = 8 * L + 60 * K
    it = (4 * R3 * nv + arrow_flops(part, 1, False) + 4 * SB3 * nv
          + 2 * SB3 * SB3 + 2 * msize + 8 * nv
          + (6 + 2 * ls_iters + 1) * ls_eval)
    fl = (arrow_flops(part, SB3, True) + SB3 * SB3 * nv + SB3 ** 3 / 2
          + n_iters * it)
    if whole if assemble is None else assemble:
        live = (sum(d * (d + 1) / 2 + part.nr * d for d in part.ds)
                + part.nr * (part.nr + 1) / 2)
        fl += 6 * R3 * nv + 2 * live * R3 + 2 * SB3 * nv
    if whole:
        fl += 4 * R3 * nv + 2 * msize + 2 * R3 * nv + 4 * ls_eval
    return fl


def cost_force(part, efc, ops, M, a_free, x, f_n):
    """Per-env primal cost at x and net normal contact force."""
    from flybody_tpu_torch.ops import newton_fused as nf
    c = nf.primal_cost(part, efc.lim_dof, efc.lim_sign, M, ops.conJ, a_free,
                       efc.lim_aref, efc.con_aref, ops.lim_params,
                       ops.con_params, x)
    return c.double(), f_n.sum(-1).double()


def cost_force_stats(got, want):
    """For the primal cost and the net normal force: the median env
    relative difference and the relative difference of the batch means."""
    out = {}
    for what, a, b in zip(('cost', 'force'), got, want):
        env_rel = (a - b).abs() / b.abs().clamp(
            min=1e-6 * b.abs().max().item() + 1e-30)
        out[what] = dict(median_env=env_rel.median().item(),
                         batch_mean=((a.mean() - b.mean()).abs()
                                     / b.abs().mean().clamp(min=1e-30)).item())
    return out


def env_err(outs, refs):
    """Per env, the largest error of any output relative to the scale of
    its index on axis 1 (each dof / row / slot / channel, as `compare`
    scales), outputs flattened past axis 1."""
    import torch
    worst = None
    for o, r in zip(outs, refs):
        if r.dim() == 1:
            o, r = o[:, None], r[:, None]
        o = o.double().reshape(o.shape[0], o.shape[1], -1)
        r = r.double().reshape(r.shape[0], r.shape[1], -1)
        scale = r.abs().amax(dim=(0, 2))
        scale = scale.clamp(min=max(1e-6 * scale.max().item(), 1e-30))
        e = ((o - r).abs() / scale[None, :, None]).flatten(1).amax(1)
        worst = e if worst is None else torch.maximum(worst, e)
    return worst


def share(err, tol=NEWTON_ENV_TOL) -> float:
    return (err <= tol).double().mean().item()


def f64(args):
    """The same arguments with every float tensor in float64."""
    import torch
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def bf16_hessian(plain):
    """`plain`, a plain version that assembles its Hessian in float32
    (newton_solve_ref, newton_block_full_ref), with the split form's
    bf16-rounded J^T W J: a control, what a kernel that rounded like row 8
    would give."""
    from flybody_tpu_torch.ops import newton_fused as nf

    def run(*args):
        orig = nf.assemble_hessian
        nf.assemble_hessian = lambda *a, bf16: orig(*a, bf16=True)
        try:
            return plain(*args)
        finally:
            nf.assemble_hessian = orig
    return run


def kernel_resources(name, info, batch, report, key='kernel_resources'):
    """Logs and records a kernel's registers a thread, shared memory a
    block, blocks an SM and grid (its kernel_info)."""
    report.setdefault(key, {})[name] = info
    log(f'{name} kernel: {info["registers"]} registers a thread, '
        f'{info["smem_bytes"]} B shared memory a block, '
        f'{info["blocks_per_sm"]} blocks an SM, grid {info["grid"]} '
        f'(batch {batch})')


def newton_resources(mode, part, batch, K, SB3, L, report):
    """kernel_resources of a Newton mode at these widths."""
    from flybody_tpu_torch.ops import newton_fused as nf
    kernel_resources(f'newton {mode}',
                     nf.kernel_info(mode, part, batch, K, SB3, L), batch,
                     report, 'newton_resources')


def newton_checks(name, kernel, plain, args, ls, n_it, controls, stats):
    """A Newton kernel against its plain version, with the readings of the
    plain version at float64 and of the controls (deliberately wrong
    versions: name -> fn(ls, n_it) giving their outputs), at 30
    line-search steps per env and at the preset's steps by primal cost
    and net normal force (`stats(outs)` -> (cost, force) per env)."""
    o30, r30 = kernel(*args, 30, n_it), plain(*args, 30, n_it)
    r64 = plain(*f64(args), 30, n_it)
    e_kp, e_p64, e_k64 = env_err(o30, r30), env_err(r30, r64), env_err(o30,
                                                                      r64)
    bad = e_kp > NEWTON_ENV_TOL
    rd = dict(kernel_vs_plain=share(e_kp), plain_vs_f64=share(e_p64),
              kernel_vs_f64=share(e_k64),
              median_env=e_kp.median().item(),
              disagreeing=int(bad.sum()),
              disagreeing_where_plain_departs_from_f64=int(
                  (bad & (e_p64 > NEWTON_ENV_TOL)).sum()))
    outs = [fn(*args, ls, n_it) for fn in (kernel, plain)]
    want = stats(outs[1])
    rd['preset_steps'] = cost_force_stats(stats(outs[0]), want)
    for cname, fn in controls.items():
        rd[f'control {cname}'] = dict(
            kernel_vs_plain=share(env_err(fn(30, n_it), r30)),
            preset_steps=cost_force_stats(stats(fn(ls, n_it)), want))
    log(f'  {name} readings (share of envs within {NEWTON_ENV_TOL:.0e} at '
        f'ls 30; cost / force at the preset\'s {ls} steps): '
        + json.dumps(rd))
    if not rd['kernel_vs_plain'] >= NEWTON_ENV_SHARE:
        raise AssertionError(f'{name}: only {rd["kernel_vs_plain"]:.4f} of '
                             f'the envs agree at ls 30')
    slack = max(F64_SHARE_SLACK, 4 / len(e_kp))
    if not rd['kernel_vs_f64'] >= rd['plain_vs_f64'] - slack:
        raise AssertionError(f'{name}: further from float64 than the plain '
                             f'version: {rd}')
    med_tol, mean_tol = COST_REL_TOL[name]
    for what, v in rd['preset_steps'].items():
        if not (v['median_env'] <= med_tol and v['batch_mean'] <= mean_tol):
            raise AssertionError(f'{name}: {what} at the preset\'s steps '
                                 f'differs: {v}')
    return o30, r30, outs[0], rd


# Operations of the collision kernels, counted from csrc/narrowphase.cu
# and csrc/mpr.cu (each multiply, add, divide and square root one; the
# comparisons and selects not counted).
NARROW_FLOPS = {(0, 2): 17, (0, 3): 46, (0, 4): 67, (0, 5): 140,
                (2, 2): 23, (2, 3): 39, (3, 3): 88}  # per pair, by type key
SUPPORT_FLOPS = {2: 6, 3: 40, 5: 42}  # sphere, capsule, cylinder
ELLIPSOID_SUPPORT_FLOPS = 51  # any other type code


def mpr_flops(prm, polish: int) -> float:
    """Operations of the merged MPR kernel on these candidates (_mpr_ops):
    polish only on the smooth pairs (prm[..., 10]), since the kernel skips
    it on the others."""
    import torch
    t = prm[..., 8:10].round().long()
    cost = torch.tensor([SUPPORT_FLOPS.get(c, ELLIPSOID_SUPPORT_FLOPS)
                         for c in range(int(t.max()) + 1)], device=t.device)
    sup = cost[t].sum(-1).double()
    smooth = prm[..., 10] > 0.5
    ns = int(smooth.sum())
    return (_mpr_ops(sup.numel() - ns, float(sup[~smooth].sum()), 0)
            + _mpr_ops(ns, float(sup[smooth].sum()), polish))


def _mpr_ops(n: int, sup: float, polish: int) -> float:
    """Operations of MPR on n pairs whose geom supports take `sup` in all,
    with `polish` polish steps each (0: none): 3 + 10 + 24 Minkowski
    supports per pair, and polish + 1 more where it polishes (two geom
    supports and 21 more each), the discovery (57 each), refinement (79
    each) and polish (29 each) iterations' own algebra, and ~246 for the
    start and the witness."""
    evals = 3 + 10 + 24 + (polish + 1 if polish else 0)
    return evals * (sup + 21 * n) + n * (246 + 10 * 57 + 24 * 79
                                         + polish * 29)


def mpr_pair_flops(key, polish: int, n: int) -> float:
    """mpr_flops of n pairs of type pair `key`."""
    sup = sum(SUPPORT_FLOPS.get(c, ELLIPSOID_SUPPORT_FLOPS) for c in key)
    return _mpr_ops(n, n * sup, polish)


def efc_flops(K, nv, C) -> float:
    """Per env: the selection (C log2 C comparisons, what a sort needs),
    the Jacobian rows (13 a dof: the 6-term sum, the mask difference, the
    product) and their velocities (2 a dof), and ~120 a slot for the
    frame, arm, impedance, aref and D."""
    import math
    return C * math.log2(C) + 3 * K * nv * 15 + K * 120


def collision_kernels(model, data_in, entry, report):
    """Rows 5, 6 and 7 against their plain versions on the geometry of a
    forward pass (its position stage) at each preset's broadphase widths
    and slot count."""
    import torch
    from flybody_tpu_torch.ops import efc_stage as ef
    from flybody_tpu_torch.ops import mpr_kernel as mk
    from flybody_tpu_torch.ops import narrowphase as nk
    from flybody_tpu_torch.physics import collision, engine, kinematics
    from flybody_tpu_torch.physics import solver
    from flybody_tpu_torch.tools import device_time

    batch = data_in.qpos.shape[0]
    meta = model.meta
    d, _, _ = kinematics.fwd_position_smooth(model, data_in)

    # Row 5: the same work at both presets.
    segs = collision.dense_segments(meta)
    nargs = (segs, d.geom_xpos, d.geom_xmat, model.geom_size)
    out = nk.narrowphase(*nargs)
    ref = nk.narrowphase_ref(*nargs)
    err, rel = compare('narrowphase', out, ref, ('dist', 'pos', 'normal'))
    if not rel <= NARROW_REL_TOL:
        raise AssertionError(f'narrowphase disagrees: rel {rel:.3e}')
    ms = cuda_ms(lambda: nk.narrowphase(*nargs), 20)
    pms = cuda_ms(lambda: nk.narrowphase_ref(*nargs), 5)
    geoms = sorted({g for _, g1, g2, _ in segs for g in g1 + g2})
    fl = batch * sum(NARROW_FLOPS[key] * len(g1) for key, g1, _, _ in segs)
    byts = (batch * len(geoms) * 12 * 4 + len(geoms) * 3 * 4
            + 16 * sum(len(g1) for _, g1, _, _ in segs) + nbytes(out))
    entry('narrowphase', err, ms, pms, byts, fl)
    dev = device_time.readings(lambda: nk.narrowphase(*nargs))
    report['narrowphase'] = dict(ms=ms, plain_ms=pms, **dev)
    log(f'narrowphase: {ms:.3f} ms kernel ({device_time.line(dev)}), '
        f'{pms:.3f} ms plain ({out[0].shape[1]} slots)')
    kernel_resources('narrowphase', nk.kernel_info(segs, batch),
                     batch, report)

    for preset in PRESETS:
        cfg = engine.PRESETS[preset]
        # Row 6 on the preset's merged broadphase candidates.
        P = cfg['mpr_top_p']
        c1, c2, prm, _ = collision.merged_candidates(model, d, P)
        margs = (c1, c2, prm, 8)
        mpr_order_readings(f'P {P}', prm, batch, report)
        out = mk.mpr_merged(*margs)
        ref = mk.mpr_merged_ref(*margs)
        f64 = mk.mpr_merged_ref(c1.double(), c2.double(), prm.double(), 8)
        runs = {'kernel': out, 'plain': ref,
                'control one refinement iteration fewer': mk.mpr_merged_ref(
                    *margs[:3], 8, refine_iters=mk._mpr.REFINE_ITERS - 1),
                'control polish off': mk.mpr_merged_ref(*margs[:3], 0)}
        rd = mk.gate_readings(runs, f64)
        log(f'  mpr_merged readings [{preset}, P {P}]: ' + json.dumps(rd))
        report[f'mpr_readings_{preset}'] = rd
        if not mk.passes_gate(rd, 'kernel'):
            raise AssertionError(f'mpr_merged [{preset}] disagrees: {rd}')
        err = rd['kernel']['near_dist_err_q50_q99_max'][2]
        ms = cuda_ms(lambda: mk.mpr_merged(*margs), 20)
        order_ms = cuda_ms(lambda: mk.mpr_order(prm), 20)  # within ms
        pms = cuda_ms(lambda: mk.mpr_merged_ref(*margs), 3)
        fl = mpr_flops(prm, 8)
        byts = nbytes([c1, c2, prm]) + nbytes(out)
        report[f'mpr_{preset}'] = dict(pairs=P, ms=ms, pre_pass_ms=order_ms,
                                       plain_ms=pms, bytes=byts, flops=fl,
                                       max_abs_err=err)
        if preset == 'default':
            entry('mpr_merged', err, ms, pms, byts, fl)
        log(f'mpr_merged ({preset}, {P} pairs): {ms:.3f} ms kernel (its '
            f'pre-pass mpr_order alone {order_ms:.4f}), {pms:.3f} ms plain, '
            f'bound '
            f'{max(byts / HBM_BYTES_PER_S, fl / FP32_FLOPS) * 1e3:.4f} ms')

        # Row 7 on the preset's candidates (the kernels' collide).
        con = collision.collide(model, d, cfg['mpr_top_p'], cfg['cc_top_p'])
        efc_check(model, d, solver.contact_candidates(model, con),
                  cfg['ncon_max'], preset, entry if preset == 'default'
                  else None, report)


def mpr_order_readings(tag, prm, batch, report):
    """Row 6's resources (kernel_resources), the share of warps whose 32
    lanes share one type-pair key in the kernel's lane order and unsorted,
    and whether the pre-pass's order is the plain `type_order`, which it
    must be."""
    import torch
    from flybody_tpu_torch.ops import mpr_kernel as mk
    kernel_resources(f'mpr_merged[{tag}]', mk.kernel_info(prm.shape[0]
                                                          * prm.shape[1]),
                     batch, report)
    rd = {'ordered': mk.uniform_share(prm), 'unsorted': mk.uniform_share(
        prm, 1)}
    rd['pre_pass_order_is_plain'] = bool(torch.equal(
        mk.mpr_order(prm).long(), mk.type_order(prm)))
    log(f'  mpr_merged [{tag}]: type-uniform warps ' + json.dumps(rd))
    report.setdefault('mpr_uniform_warps', {})[tag] = rd
    if not rd['pre_pass_order_is_plain']:
        raise AssertionError(f'mpr_merged [{tag}]: the pre-pass order is '
                             f'not the plain type_order')


def efc_errors(out, ref, tag):
    """Row 7's outputs (con_J, rows) against the plain version's: the slot
    and body ids exactly (raises otherwise); the largest absolute error
    and the worst error of a field relative to its largest value, which
    must be within EFC_REL_TOL (raises otherwise)."""
    import torch
    err, worst = 0.0, 0.0
    for i, (o, r) in enumerate(zip([out[0]] + out[1], [ref[0]] + ref[1])):
        if i - 1 in (14, 15, 18):  # body1, body2, slot id: exactly
            if not torch.equal(o, r):
                raise AssertionError(f'efc_contacts [{tag}]: row {i - 1} '
                                     f'differs')
            continue
        e = (o - r).abs().max().item()
        err = max(err, e)
        worst = max(worst, e / max(r.abs().max().item(), 1e-6))
    if not worst <= EFC_REL_TOL:
        raise AssertionError(f'efc_contacts [{tag}] disagrees: {worst:.3e}')
    return err, worst


def efc_check(model, d, cand, K, tag, entry, report):
    """Row 7 against its plain version on the candidates `cand`: the slot
    and body ids exactly, every other field within EFC_REL_TOL of its
    largest value; timed. `entry`: the kernels' JSON entry to fill, or
    None."""
    from flybody_tpu_torch.ops import efc_stage as ef
    batch, meta = d.qpos.shape[0], model.meta
    out = ef.contact_rows(model, d, *cand, K)
    ref = ef.contact_rows_ref(model, d, *cand, K)
    outs = [out[0]] + out[1]
    err, worst = efc_errors(out, ref, tag)
    log(f'  efc_contacts[{tag}]: max abs {err:.3e}, worst field rel '
        f'{worst:.3e}; slot and body ids equal')
    ms = cuda_ms(lambda: ef.contact_rows(model, d, *cand, K), 20)
    pms = cuda_ms(lambda: ef.contact_rows_ref(model, d, *cand, K), 5)
    # Bytes the kernel reads: each candidate's score operands (dist,
    # includemargin), the whole row of the K selected ones (7 + 14 + 1
    # floats), qvel, cdof, the subtree CoM, the body masks' bits and the
    # limb table; it writes con_J and the 19 rows.
    C = cand[0].shape[1]
    byts = (batch * (2 * C + 22 * K) * 4 + nbytes([d.qvel, d.cdof])
            + batch * 12 + nbytes([ef.mask_bits(model)])
            + 4 * meta.nbody + nbytes(outs))
    fl = batch * efc_flops(K, meta.nv, C)
    report[f'efc_{tag}'] = dict(candidates=C, slots=K, ms=ms, plain_ms=pms,
                                bytes=byts, flops=fl, max_abs_err=err,
                                rel_err=worst)
    if entry is not None:
        entry('efc_contacts', err, ms, pms, byts, fl)
    log(f'efc_contacts ({tag}, C {C}, K {K}): {ms:.3f} ms kernel, '
        f'{pms:.3f} ms plain, bound '
        f'{max(byts / HBM_BYTES_PER_S, fl / FP32_FLOPS) * 1e3:.4f} ms; '
        f'active contacts per env {out[1][1].sum(1).mean().item():.2f}')
    kernel_resources(f'efc_contacts[{tag}]',
                     ef.kernel_info(batch, C, K, meta), batch, report)


def dense_collision_kernels(model, data_in, entry, report):
    """The dense collide's kernels on the geometry of the forward pass of
    collision_kernels: row 5 on every analytic group, capsule-capsule
    included (per slot, NARROW_REL_TOL); row 20 on the candidates the JAX
    tools give each of the seven MPR groups (a group's top MPR_TOP_P by
    bounding sphere, or all its pairs), per near pair beside two wrong
    controls that must fail the gate (mpr_kernel.passes_gate), the device
    time and the wrapper's host time of each group's launch beside the
    CUDA-event time (tools/device_time.py); row 7 on the dense
    make_efc's candidates (the two-stage tile prefilter: C 2,048, K 64),
    the slot and body ids exactly."""
    import torch
    from flybody_tpu_torch.ops import mpr_kernel as mk
    from flybody_tpu_torch.ops import narrowphase as nk
    from flybody_tpu_torch.physics import collision, kinematics, solver
    from flybody_tpu_torch.tools import device_time, profile_collide

    batch, meta = data_in.qpos.shape[0], model.meta
    d, _, _ = kinematics.fwd_position_smooth(model, data_in)

    # Row 5 with the capsule-capsule segment.
    segs = collision.analytic_segments(meta, False)
    nargs = (segs, d.geom_xpos, d.geom_xmat, model.geom_size)
    out = nk.narrowphase(*nargs)
    err, rel = compare('narrowphase[dense]', out, nk.narrowphase_ref(*nargs),
                       ('dist', 'pos', 'normal'))
    if not rel <= NARROW_REL_TOL:
        raise AssertionError(f'narrowphase (dense) disagrees: rel {rel:.3e}')
    ms = cuda_ms(lambda: nk.narrowphase(*nargs), 20)
    pms = cuda_ms(lambda: nk.narrowphase_ref(*nargs), 5)
    geoms = sorted({g for _, g1, g2, _ in segs for g in g1 + g2})
    fl = batch * sum(NARROW_FLOPS[key] * len(g1) for key, g1, _, _ in segs)
    byts = (batch * len(geoms) * 12 * 4 + len(geoms) * 3 * 4
            + 16 * sum(len(g1) for _, g1, _, _ in segs) + nbytes(out))
    bound = max(byts / HBM_BYTES_PER_S, fl / FP32_FLOPS) * 1e3
    dev = device_time.readings(lambda: nk.narrowphase(*nargs))
    report['narrowphase_dense'] = dict(
        pairs=sum(len(g1) for _, g1, _, _ in segs), slots=out[0].shape[1],
        ms=ms, plain_ms=pms, bound_ms=bound, max_abs_err=err, rel_err=rel,
        **dev)
    log(f'narrowphase (dense, {out[0].shape[1]} slots): {ms:.3f} ms kernel '
        f'({device_time.line(dev)}), {pms:.3f} ms plain, bound '
        f'{bound:.4f} ms')
    kernel_resources('narrowphase[dense]',
                     nk.kernel_info(segs, batch), batch, report)

    # Row 20 on each MPR group's candidates.
    groups = profile_collide.mpr_groups(model, d)

    def run(fn):
        outs = [fn(key, pol, pg) for key, pol, pg in groups]
        return tuple(torch.cat([o[i] for o in outs], 1) for i in range(2))

    runs = {
        'kernel': run(lambda k, pol, pg: mk.mpr_pair(*k, pol, *pg)),
        'plain': run(lambda k, pol, pg: mk.mpr_pair_ref(*k, pol, *pg)),
        'control one refinement iteration fewer': run(
            lambda k, pol, pg: mk.mpr_pair_ref(
                *k, pol, *pg, refine_iters=mk._mpr.REFINE_ITERS - 1)),
        'control polish off': run(
            lambda k, pol, pg: mk.mpr_pair_ref(*k, 0, *pg))}
    f64 = run(lambda k, pol, pg: mk.mpr_pair_ref(
        *k, pol, *(t.double() for t in pg)))
    rd = mk.gate_readings(runs, f64)
    rd['candidates'] = {str(k): pg[0].shape[1] for k, _, pg in groups}
    log('  mpr_pair readings (the seven groups together): '
        + json.dumps(rd))
    report['mpr_pair_readings'] = rd
    if not mk.passes_gate(rd, 'kernel'):
        raise AssertionError(f'mpr_pair disagrees: {rd}')
    for name in runs:
        if name.startswith('control') and mk.passes_gate(rd, name):
            raise AssertionError(f'mpr_pair: the {name} passes the gate: '
                                 f'{rd}')
    ms = sum(cuda_ms(lambda: mk.mpr_pair(*k, pol, *pg), 20)
             for k, pol, pg in groups)
    pms = sum(cuda_ms(lambda: mk.mpr_pair_ref(*k, pol, *pg), 3)
              for k, pol, pg in groups)
    fl = sum(mpr_pair_flops(k, pol, pg[0].shape[0] * pg[0].shape[1])
             for k, pol, pg in groups)
    byts = sum(nbytes(pg) + batch * pg[0].shape[1] * 7 * 4
               for _, _, pg in groups)
    err = rd['kernel']['near_dist_err_q50_q99_max'][2]
    entry('mpr_pair', err, ms, pms, byts, fl)
    n_c = sum(pg[0].shape[1] for _, _, pg in groups)
    per_group = {str(k): device_time.readings(
        lambda k=k, pol=pol, pg=pg: mk.mpr_pair(*k, pol, *pg))
        for k, pol, pg in groups}
    dev = {w: (None if any(r[w] is None for r in per_group.values())
               else sum(r[w] for r in per_group.values()))
           for w in ('device_ms', 'host_ms')}
    report['mpr_pair'] = dict(ms=ms, plain_ms=pms, per_group=per_group,
                              **dev)
    log(f'mpr_pair (the seven groups, {n_c} candidates an env): '
        f'{ms:.3f} ms kernels (device {device_time.fmt(dev["device_ms"])}, '
        f'wrapper host {dev["host_ms"]:.4f}), {pms:.3f} ms plain, '
        f'bound {max(byts / HBM_BYTES_PER_S, fl / FP32_FLOPS) * 1e3:.4f} ms')
    for k, r in per_group.items():
        log(f'  mpr_pair[{k}]: {device_time.line(r)}')

    # Row 7 on the dense make_efc's candidates.
    con = collision.collide(model, d, compact=False)
    cand = solver.contact_candidates(model, con, 64)
    efc_check(model, d, cand, 64, 'dense', None, report)


def solver_kernels(model, data_in, entry, report):
    """Rows 8, 9 and 11 against their plain versions on the rows, factor
    and forces of real forward passes at both presets."""
    import torch
    from flybody_tpu_torch.ops import arrow
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.ops import noslip_gs as ng
    from flybody_tpu_torch.physics import engine, solver

    part = arrow.build_partition(model.meta)
    batch = data_in.qpos.shape[0]
    for preset in PRESETS:
        cfg = engine.PRESETS[preset]
        d, efc, f_c = engine.fwd_acc(model, data_in, cfg)
        a_free = arrow.solve_ref(part, d.qLD, d.qfrc_smooth)
        ops = solver.operands(efc, cfg['sb_break'])
        K, L = efc.con_J.shape[1], len(efc.lim_dof)
        ls = cfg['ls_iterations']
        log(f'{preset} forward pass: {K} slots, active contacts per env '
            f'{efc.con_active.sum(1).mean().item():.2f}, cross-limb '
            f'{ops.brk.sum(1).mean().item():.2f}')
        if preset == 'default':  # row 8, one iteration a block
            st = solver.start_state(part, d.qM, efc, ops, a_free, d.qacc)
            args = solver.block_args(part, d.qM, efc, ops, st)
            # Control: the kernel given the Hessian without the bf16
            # rounding the plain version applies.
            Hp32 = nf.assemble_hessian(
                part, d.qM, ops.conJ, efc.lim_dof,
                efc.lim_D * efc.lim_active * (st[2] < 0),
                nf.cone_hessian(st[3], efc.con_mu, efc.con_frictional,
                                ops.hess_active) * efc.con_D[..., None, None],
                bf16=False)
            args32 = args[:3] + (Hp32,) + args[4:]

            def stats(o):
                fc = -efc.con_D[..., None] * nf.cone_residual(
                    o[3], efc.con_mu, efc.con_frictional, efc.con_active)
                return cost_force(part, efc, ops, d.qM, a_free, o[0],
                                  fc[..., 0])
            controls = {
                'float32 Hessian (no bf16 rounding)':
                    lambda ls_, n: nf.newton_block(*args32, ls_, n),
                'one iteration more':
                    lambda ls_, n: nf.newton_block(*args, ls_, n + 1)}
            o30, r30, out, rd = newton_checks(
                'newton_block', nf.newton_block, nf.newton_block_ref, args,
                ls, 1, controls, stats)
            err, _ = compare('newton_block[ls 30]', o30, r30,
                             ('x', 'msm', 'jar_l', 'jar_c'))
            ms = cuda_ms(lambda: nf.newton_block(*args, ls, 1), 20)
            pms = cuda_ms(lambda: nf.newton_block_ref(*args, ls, 1), 3)
            SB3 = args[6].shape[1]
            entry('newton_block', err, ms, pms,
                  nbytes(args[3:]) + nbytes(out),
                  batch * newton_flops(part, K, L, SB3, 1, ls, False))
            log(f'newton_block: {ms:.3f} ms kernel, {pms:.3f} ms plain '
                f'(K {K}, 3SB {SB3}, ls {ls}, 1 iteration)')
            newton_resources('block', part, batch, K, SB3, L, report)
            block_full_check(part, d, efc, ops, st, stats, ls, entry,
                             report)
        else:  # row 9, the whole solve
            it = cfg['solver_iterations']
            args = solver.solve_args(part, d.qM, efc, ops, a_free, d.qacc)

            def stats(o):
                return cost_force(part, efc, ops, d.qM, a_free, o[0],
                                  o[3][..., 0])
            controls = {
                'bf16-rounded Hessian':
                    lambda ls_, n: bf16_hessian(nf.newton_solve_ref)(
                        *args, ls_, n),
                'one iteration fewer':
                    lambda ls_, n: nf.newton_solve(*args, ls_, n - 1)}
            o30, r30, out, rd = newton_checks(
                'newton_solve', nf.newton_solve, nf.newton_solve_ref, args,
                ls, it, controls, stats)
            err, _ = compare('newton_solve[ls 30]', o30, r30,
                             ('qacc', 'qfrc', 'f_l', 'f_c'))
            ms = cuda_ms(lambda: nf.newton_solve(*args, ls, it), 20)
            pms = cuda_ms(lambda: nf.newton_solve_ref(*args, ls, it), 3)
            SB = args[5].shape[1]
            entry('newton_solve', err, ms, pms,
                  nbytes(args[3:]) + nbytes(out),
                  batch * newton_flops(part, K, L, 3 * SB, it, ls, True))
            log(f'newton_solve: {ms:.3f} ms kernel, {pms:.3f} ms plain '
                f'(K {K}, SB {SB}, ls {ls}, {it} iterations)')
            newton_resources('whole', part, batch, K, 3 * SB, L, report)
        report[f'newton_readings_{preset}'] = rd

        # Row 11 on the slots the preset sweeps; the path's work: how many
        # slots each env lists (use > 0), the ones the kernel sweeps.
        nargs = solver.noslip_operands(d.qLD, efc, d.qacc, f_c,
                                       cfg['noslip_contacts'])
        ns = nargs[1].shape[1]
        hist = torch.bincount((nargs[4] > 0).sum(1).cpu(),
                              minlength=ns + 1).tolist()
        report[f'noslip_listed_{preset}'] = hist
        log(f'noslip path work ({preset}, {ns} slots): envs by listed '
            f'slots ' + ', '.join(f'{n}: {c}' for n, c in enumerate(hist)
                                  if c)
            + f'; {sum(n * c for n, c in enumerate(hist))} of {batch * ns} '
            f'slots listed')
        out = ng.noslip_fused(part, *nargs, 3)
        err, rel = compare(f'noslip_fused[{ns} slots]', out,
                           ng.noslip_fused_ref(part, *nargs, 3),
                           ('x', 'ft'))
        if not rel <= NOSLIP_REL_TOL:
            raise AssertionError(f'noslip_fused disagrees: {rel:.3e}')
        ms = cuda_ms(lambda: ng.noslip_fused(part, *nargs, 3), 20)
        pms = cuda_ms(lambda: ng.noslip_fused_ref(part, *nargs, 3), 3)
        fl = batch * (arrow_flops(part, 2 * ns, False)
                      + 8 * ns * part.nv + 3 * ns * 8 * part.nv)
        byts = nbytes(nargs) + nbytes(out)
        report[f'noslip_{preset}'] = dict(slots=ns, ms=ms, plain_ms=pms,
                                          bytes=byts, max_abs_err=err,
                                          rel_err=rel)
        if preset == 'default':
            entry('noslip_fused', err, ms, pms, byts, fl)
        log(f'noslip_fused ({preset}, {ns} slots): {ms:.3f} ms kernel, '
            f'{pms:.3f} ms plain, bound '
            f'{max(byts / HBM_BYTES_PER_S, fl / FP32_FLOPS) * 1e3:.4f} ms')
        kernel_resources(f'noslip_fused[{ns} slots]',
                         ng.kernel_info(part, batch, ns), batch, report)


def block_full_check(part, d, efc, ops, st, stats, ls, entry, report):
    """Row 9's block-full mode on the default preset's forward pass, from
    the block's start state st, through newton_checks beside three wrong
    controls that must fail its gate: the bf16-rounded Hessian of the
    split form, one iteration more and one fewer."""
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.physics import solver
    args = solver.block_full_args(part, d.qM, efc, ops, st)
    controls = {
        'bf16-rounded Hessian':
            lambda ls_, n: bf16_hessian(nf.newton_block_full_ref)(
                *args, ls_, n),
        'one iteration more':
            lambda ls_, n: nf.newton_block_full(*args, ls_, n + 1),
        'one iteration fewer':
            lambda ls_, n: nf.newton_block_full(*args, ls_, n - 1)}
    o30, r30, out, rd = newton_checks(
        'newton_block_full', nf.newton_block_full, nf.newton_block_full_ref,
        args, ls, 1, controls, stats)
    report['newton_readings_default_full'] = rd
    for c in controls:
        if not newton_gate_fails('newton_block_full', rd[f'control {c}']):
            raise AssertionError(f'newton_block_full: the control {c!r} '
                                 f'passes the gate: {rd}')
    err, _ = compare('newton_block_full[ls 30]', o30, r30,
                     ('x', 'msm', 'jar_l', 'jar_c'))
    ms = cuda_ms(lambda: nf.newton_block_full(*args, ls, 1), 10)
    pms = cuda_ms(lambda: nf.newton_block_full_ref(*args, ls, 1), 3)
    K, SB, L = args[4].shape[1], args[5].shape[1], len(efc.lim_dof)
    batch = args[4].shape[0]
    entry('newton_block_full', err, ms, pms, nbytes(args[3:]) + nbytes(out),
          batch * newton_flops(part, K, L, 3 * SB, 1, ls, False,
                               assemble=True))
    log(f'newton_block_full: {ms:.3f} ms kernel, {pms:.3f} ms plain '
        f'(K {K}, SB {SB}, ls {ls}, 1 iteration)')
    newton_resources('block_full', part, batch, K, 3 * SB, L, report)


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


def counters():
    """Each kernel's launch counter: (module, attribute)."""
    from flybody_tpu_torch.ops import (arrow, cholesky, efc_stage,
                                       force_stage, linesearch, mpr_kernel,
                                       narrowphase, newton_fused, noslip_gs,
                                       pos_stage, sens_stage)
    return {'pos_stage': (pos_stage, 'launches'),
            'narrowphase': (narrowphase, 'launches'),
            'mpr_merged': (mpr_kernel, 'launches'),
            'efc_contacts': (efc_stage, 'launches'),
            'force_stage': (force_stage, 'launches'),
            'arrow_factor_solve': (arrow, 'launches'),
            'sens_stage': (sens_stage, 'launches'),
            'newton_block': (newton_fused, 'launches'),
            'newton_solve': (newton_fused, 'solve_launches'),
            'noslip_fused': (noslip_gs, 'launches'),
            'noslip_gs': (noslip_gs, 'gs_launches'),
            'line_search': (linesearch, 'launches'),
            'cho_solve': (cholesky, 'cho_solve_launches'),
            'cho_solve_multi': (cholesky, 'cho_solve_multi_launches'),
            'chol_solve': (cholesky, 'chol_solve_launches'),
            'chol': (cholesky, 'chol_launches'),
            'arrow_factor': (arrow, 'factor_launches'),
            'arrow_solve': (arrow, 'solve_launches'),
            'newton_reuse': (newton_fused, 'reuse_launches'),
            'newton_block_full': (newton_fused, 'block_full_launches'),
            'mpr_pair': (mpr_kernel, 'pair_launches')}


def main_path_phase(preset, batch, steps, cpu_envs, seed, report):
    """walk_imitation reset + `steps` control steps on the card."""
    import torch
    from flybody_tpu_torch.envs import fly_envs
    env = fly_envs.walk_imitation(functional=True, preset=preset)
    g = torch.Generator(device='cpu').manual_seed(seed)
    lo = torch.as_tensor(env.action_min, dtype=torch.float32)
    hi = torch.as_tensor(env.action_max, dtype=torch.float32)
    actions = [(lo + (hi - lo) * torch.rand(batch, len(lo), generator=g)
                ).cuda() for _ in range(steps)]
    torch.cuda.synchronize()
    for m, attr in counters().values():
        setattr(m, attr, 0)
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
            data1 = state.data.index(slice(0, cpu_envs))
    launches = {n: getattr(m, attr) for n, (m, attr) in counters().items()}
    expect = {n: c * steps + (1 if n == 'pos_stage' else 0)
              for n, c in PER_STEP[preset].items()}
    log(f'main path [{preset}]: launches {launches} (expected {expect})')
    if launches != expect:
        raise AssertionError(f'{preset}: launch counts {launches} != '
                             f'{expect}')
    d = state.data
    for name in ('qpos', 'qvel', 'act', 'qacc'):
        if not torch.isfinite(getattr(d, name)).all():
            raise AssertionError(f'{preset}: non-finite {name} after '
                                 f'{steps} steps')
    for k, v in ts.observation.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f'{preset}: non-finite observation {k}')
    first_timed = 2 if steps > 1 else 1
    steady = step_times[first_timed - 1:]
    rate = batch * len(steady) / sum(steady)
    log(f'main path [{preset}]: reset {t_reset:.3f} s, step times '
        f'{[round(t, 4) for t in step_times]} s, {rate:.1f} env-steps/s '
        f'(steps {first_timed}..{steps}, batch {batch})')
    report[f'main_path_{preset}'] = dict(
        batch=batch, steps=steps, reset_s=t_reset, step_s=step_times,
        env_steps_per_s=rate, launches=launches)
    return state0, actions[0], first, (env.model, data1), launches


CPU_TOL = 1e-3  # card vs CPU, relative to each index's scale (env_err)
CPU_ENV_SHARE = 0.98  # share of the CPU_ENVS envs that must agree
NUDGE = 1e-6  # relative change of the root position: the CPU's own spread


def cpu_phase(preset, state0, action, first, cpu_envs, report):
    """The first control step of `cpu_envs` envs, re-run on the CPU, and
    again with the root position scaled by 1 + NUDGE. Per env, every field
    and observation (each index against its scale, as env_err) agrees to
    CPU_TOL in at least CPU_ENV_SHARE of the envs, and per field the
    largest error is within CPU_TOL of the field's largest value. The
    bench preset's step cannot meet this: the CPU's own step moves by O(1)
    under the nudge in nearly every env (PERF.md section 6), so there the
    readings are printed and the gate is substep_phase's."""
    from flybody_tpu_torch.envs import fly_envs
    env = fly_envs.walk_imitation(functional=True, preset=preset,
                                  device='cpu')
    n = cpu_envs
    task = type(state0.task)(traj_idx=state0.task.traj_idx[:n].cpu(),
                             episode_steps=state0.task.episode_steps[:n].cpu())
    st = state0.replace(data=state0.data.index(slice(0, n)).to('cpu'),
                        step_idx=state0.step_idx[:n].cpu(),
                        prev_action=state0.prev_action[:n].cpu(), task=task)
    t0 = time.perf_counter()
    out = env.step(st, action[:n].cpu())
    t = time.perf_counter() - t0
    qpos = st.data.qpos.clone()
    qpos[:, :3] *= 1.0 + NUDGE
    out2 = env.step(st.replace(data=st.data.replace(qpos=qpos)),
                    action[:n].cpu())

    def field(o, name):
        return (o[1].observation[name[4:]] if name.startswith('obs/')
                else getattr(o[0].data, name))

    names = list(first)
    cpu = [field(out, k) for k in names]
    errs = {k: ((c - first[k]).abs().max()
                / first[k].abs().max().clamp(min=1e-30)).item()
            for k, c in zip(names, cpu)}
    e_card = env_err([first[k] for k in names], cpu)
    e_self = env_err([field(out2, k) for k in names], cpu)
    rd = dict(field_rel_err=errs, card_share=share(e_card, CPU_TOL),
              nudge_share=share(e_self, CPU_TOL),
              median_env_card=e_card.median().item(),
              median_env_nudge=e_self.median().item())
    log(f'cpu check [{preset}] ({n} envs, {t:.1f} s): share of envs within '
        f'{CPU_TOL:.0e}: card {rd["card_share"]:.4f}, CPU under a '
        f'{NUDGE:.0e} root nudge {rd["nudge_share"]:.4f} (median env '
        f'{rd["median_env_card"]:.2e} / {rd["median_env_nudge"]:.2e}); '
        f'field rel err {errs}')
    report[f'cpu_check_{preset}'] = rd
    if preset == 'bench':
        return
    worst = max(errs.values())
    if not (rd['card_share'] >= CPU_ENV_SHARE and worst <= CPU_TOL):
        raise AssertionError(f'{preset}: card and CPU disagree: share '
                             f'{rd["card_share"]:.4f}, worst field {worst}')


def substep_outputs(model, data, cfg):
    """One substep (engine.step) and one forward pass at `cfg`: qpos, qvel,
    qacc and sensordata after the substep, and the forward pass's primal
    cost and net normal force, each moved to the CPU as float64."""
    from flybody_tpu_torch.ops import arrow
    from flybody_tpu_torch.physics import engine, solver
    part = arrow.build_partition(model.meta)
    out = engine.step(model, data, cfg)
    dd, efc, f_c = engine.fwd_acc(model, data, cfg)
    a_free = arrow.solve_ref(part, dd.qLD, dd.qfrc_smooth)
    ops = solver.operands(efc, cfg['sb_break'])
    return [getattr(out, k).cpu().double() for k in SUBSTEP_NAMES] + [
        t.cpu() for t in cost_force(part, efc, ops, dd.qM, a_free, dd.qacc,
                                    f_c[..., 0])]


SUBSTEP_NAMES = ('qpos', 'qvel', 'qacc', 'sensordata')


def substep_shares(got, want):
    """Per quantity of substep_outputs, the share of envs where `got`
    agrees with `want`: qpos, qvel, qacc, sensordata to CPU_TOL of each
    index's scale (env_err); the primal cost and net normal force to
    CPU_TOL of their own value."""
    rd = {f'{k}_share': share(env_err([a], [b]), CPU_TOL)
          for k, a, b in zip(SUBSTEP_NAMES, got, want)}
    rd['median_env'] = env_err(got[:4], want[:4]).median().item()
    for what, a, b in (('cost', got[4], want[4]),
                       ('force', got[5], want[5])):
        rel = (a - b).abs() / b.abs().clamp(
            min=1e-6 * b.abs().max().item() + 1e-30)
        rd[f'{what}_share'] = share(rel, CPU_TOL)
        rd[f'{what}_disagreeing_envs'] = (rel > CPU_TOL).nonzero().flatten(
            ).tolist()
    return rd


@contextlib.contextmanager
def plain_collision():
    """Rows 5-7 by their plain versions on the card: the path as it stood
    before the collision kernels, as a control."""
    from flybody_tpu_torch.ops import efc_stage, mpr_kernel, narrowphase
    saved = (narrowphase.narrowphase, mpr_kernel.mpr_merged,
             efc_stage.contact_rows)
    narrowphase.narrowphase = narrowphase.narrowphase_ref
    mpr_kernel.mpr_merged = mpr_kernel.mpr_merged_ref
    efc_stage.contact_rows = efc_stage.contact_rows_ref
    try:
        yield
    finally:
        (narrowphase.narrowphase, mpr_kernel.mpr_merged,
         efc_stage.contact_rows) = saved


def substep_phase(preset, model, data1, report):
    """One substep (engine.step: collision at the preset's broadphase
    widths, constraint rows, the Newton kernel through the solver's wiring,
    the noslip on the preset's prefix and its qfrc update, sensors, Euler)
    on the card and on the CPU, from the card's state after the first
    control step, at the preset but for 30 line-search steps (where the
    search closes). Every share of substep_shares, the card against the
    CPU, is at least CPU_ENV_SHARE. Printed beside it: a control on the
    card with rows 5-7 by their plain versions (the path before them), and
    the CPU's float32 against its float64 (what float32 resolves)."""
    import torch
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.physics import engine
    cfg = dict(engine.PRESETS[preset], ls_iterations=30)
    card = substep_outputs(model, data1, cfg)
    with plain_collision():
        ctl = substep_outputs(model, data1, cfg)
    cpu = substep_outputs(spec.load(spec.WALK_IMITATION_NPZ, device='cpu'),
                          data1.to('cpu'), cfg)
    cpu64 = substep_outputs(
        spec.load(spec.WALK_IMITATION_NPZ, device='cpu',
                  dtype=torch.float64),
        data1.to('cpu', dtype=torch.float64), cfg)
    rd = {'card_vs_cpu': substep_shares(card, cpu),
          'control_rows_5_7_plain_vs_cpu': substep_shares(ctl, cpu),
          'cpu_vs_cpu_float64': substep_shares(cpu, cpu64),
          'card_vs_cpu_float64': substep_shares(card, cpu64)}
    for k, v in rd.items():
        log(f'substep check [{preset}, ls 30] ({data1.qpos.shape[0]} envs) '
            f'{k}: ' + json.dumps(v))
    report[f'substep_check_{preset}'] = rd
    low = {k: v for k, v in rd['card_vs_cpu'].items()
           if k.endswith('_share') and not v >= CPU_ENV_SHARE}
    if low:
        raise AssertionError(f'{preset}: card and CPU disagree in one '
                             f'substep: {low}')


# ------------------------------------------------------- the two-fly scene
#
# The dense path: the two-fly scene has no arrow partition, so its step
# runs rows 12, 13, 15, 16 and 17 (PERF.md's kernel table) besides K1, K4
# and rows 5 and 6.

# Row 17 per env: x against the plain version to this error relative to
# each dof's scale (env_err), in at least this share of the envs; the
# relative residual ||A x - b|| / (||A|| ||x||) of the kernel's x at most
# this many times the plain version's worst. The kernel reads 1.0 and a
# ratio of at most 1.2, the controls 0.0 (A rounded to bfloat16) and a
# ratio of 26-71 (the diagonal scaled by 1 + 1e-5) (measured on one
# H100).
CHOL_ENV_TOL = 1e-3
CHOL_ENV_SHARE = 0.98
CHOL_RESIDUAL_RATIO = 10.0
# Row 13 per line search: |alpha - alpha_plain| <= LS_ATOL + LS_RTOL
# |alpha_plain| (tests/test_ops.py's bounds for the TPU kernel) in at least
# LS_SHARE of the searches; the limit lies between the kernel's reading and
# that of the plain version with one refinement step fewer.
LS_ATOL = 1e-3
LS_RTOL = 2e-2
LS_SHARE = 0.99  # kernel 0.99685, control 0.98171 (one H100)
SUBST_REL_TOL = 1e-3  # rows 15, 16 and 12: per-index relative error
# The two-fly substep, card against CPU. Float32 does not resolve this
# scene's substep to CPU_TOL: the CPU's own float32 step (the plain
# versions, the JAX package's algorithm) departs from its float64 by more
# than 1e-3 of a dof's scale on qacc in 5-7 of 16 envs (median env
# 7.4e-4, measured on one H100; ROADMAP section 3). So the card is held
# against the CPU's float64: per quantity, its median env error at most
# TWO_FLY_F64_RATIO times the CPU float32's (or CPU_TOL, if larger), and
# its worst env error at most TWO_FLY_F64_RATIO times the CPU float32's
# worst. The limit lies between the card's reading (at most 2.0 times the
# CPU float32's, on one H100) and those of the wrong controls of
# two_fly_controls, which the phase runs on the card through the same
# gate and which must fail it (PERF.md section 6). The card-vs-CPU shares
# of substep_shares are printed beside it.
TWO_FLY_F64_RATIO = 3.0


def two_fly_data(model, batch, seed):
    """The two-fly scene's reset state with qvel ~ N(0, 1) and ctrl ~
    U(-1, 1) (numpy, `seed`): the flies flail into self- and inter-fly
    contact."""
    import numpy as np
    import torch
    from flybody_tpu_torch.physics.state import make_data
    rng = np.random.RandomState(seed)
    meta = model.meta
    d = make_data(model, batch)
    return d.replace(
        qvel=torch.as_tensor(rng.randn(batch, meta.nv), dtype=model.dtype,
                             device=model.device),
        ctrl=torch.as_tensor(rng.uniform(-1.0, 1.0, (batch, meta.nu)),
                             dtype=model.dtype, device=model.device))


def contact_line(efc) -> str:
    n = efc.con_active.sum(1)
    return (f'active contact rows per env: min {int(n.min())}, mean '
            f'{n.mean().item():.2f}, max {int(n.max())} (of '
            f'{efc.con_active.shape[1]} slots)')


@contextlib.contextmanager
def recording(mod, name, keep):
    """Calls of mod.<name> in the block: {call index: its arguments} for
    the indices in `keep`."""
    orig = getattr(mod, name)
    got, n = {}, [0]

    def wrapped(*a):
        if n[0] in keep:
            got[n[0]] = a
        n[0] += 1
        return orig(*a)

    setattr(mod, name, wrapped)
    try:
        yield got
    finally:
        setattr(mod, name, orig)


def residuals(A, b, x):
    """Per env ||A x - b|| / (||A|| ||x||) for b, x (B, n) or (B, n, m), A
    read from its lower triangle, in float64."""
    import torch
    A, b, x = A.double(), b.double(), x.double()
    S = torch.tril(A) + torch.tril(A, -1).transpose(1, 2)
    r = (S @ (x if x.dim() == 3 else x[..., None])).reshape(b.shape) - b
    return r.flatten(1).norm(dim=-1) / (A.norm(dim=(1, 2))
                                        * x.flatten(1).norm(dim=-1)).clamp(
        min=1e-30)


def chol_checks(what, A, b):
    """Row 17 on one operand (A, b) against its plain version, per env,
    beside two wrong controls: the plain version on A with its diagonal
    scaled by 1 + 1e-5, and on A rounded to bfloat16."""
    import torch
    from flybody_tpu_torch.ops import cholesky as ch
    L, x = ch.chol_solve(A, b)
    Lp, xp = ch.chol_solve_ref(A, b)
    ctl = {'diagonal x (1 + 1e-5)': ch.chol_solve_ref(
               A + 1e-5 * torch.diag_embed(torch.diagonal(A, dim1=1,
                                                           dim2=2)), b)[1],
           'bf16-rounded A': ch.chol_solve_ref(
               A.to(torch.bfloat16).float(), b)[1]}
    res_k, res_p = residuals(A, b, x), residuals(A, b, xp)
    rd = {'kernel_share': share(env_err([x], [xp]), CHOL_ENV_TOL),
          'kernel_L_share': share(env_err([L], [Lp]), CHOL_ENV_TOL),
          'residual_max_kernel': res_k.max().item(),
          'residual_max_plain': res_p.max().item(),
          'residual_median_kernel': res_k.median().item()}
    for name, xc in ctl.items():
        rd[f'control {name}'] = dict(
            share=share(env_err([xc], [xp]), CHOL_ENV_TOL),
            residual_max=residuals(A, b, xc).max().item())
    log(f'  chol_solve[{what}] readings (share of envs within '
        f'{CHOL_ENV_TOL:.0e} of each dof\'s scale): ' + json.dumps(rd))
    if not (rd['kernel_share'] >= CHOL_ENV_SHARE
            and rd['kernel_L_share'] >= CHOL_ENV_SHARE
            and rd['residual_max_kernel']
            <= CHOL_RESIDUAL_RATIO * rd['residual_max_plain']):
        raise AssertionError(f'chol_solve [{what}] disagrees: {rd}')
    return (L, x), (Lp, xp), rd


def gs_cases(gargs, L, seed):
    """Row 12's operands beyond the path's own (gargs, whose contacts are
    frictionless, so the sweeps change nothing): (1) the path's rows with
    every slot swept as frictional at radius 1, ill-posed (the inactive
    slots' 2x2 blocks are near-singular), read at float32 against float64
    as a witness; (2) a well-conditioned case that sweeps all K slots: rows
    J_t ~ N(0, 1) scaled per dof by sqrt(M_jj) from the path's factor L of
    M, P = M^-1 J_t^T by row 16's plain version, aref and the radii drawn
    at the rows' own scale (a generator seeded with `seed`), every slot
    used. Returns the two cases' arguments, each at float32 and float64."""
    import torch
    from flybody_tpu_torch.ops import cholesky as ch
    from flybody_tpu_torch.ops import noslip_gs as ng
    Jt, Pt, Ainv, aref, _, use, x0, ft0, it = gargs
    Bn, K, _, n = Jt.shape
    ones = torch.ones_like(use)
    every = (Jt, Pt, Ainv, aref, ones, ones, x0, ft0, it)

    def in64(a):
        J, P = a[0].double(), a[1].double()
        return (J, P, ng.block_inverses(J, P)) + f64(a[3:8]) + (a[8],)

    g = torch.Generator(device=Jt.device).manual_seed(seed)

    def rand(*shape, normal=True):
        f = torch.randn if normal else torch.rand
        return f(*shape, generator=g, device=Jt.device, dtype=Jt.dtype)

    d = (torch.tril(L) ** 2).sum(-1).sqrt()  # sqrt(M_jj), M = L L^T
    Jw = (rand(Bn, K, 2, n) * d[:, None, None, :]).contiguous()
    Pw = ch.cho_solve_multi_ref(L, Jw.reshape(Bn, 2 * K, n).transpose(
        1, 2).contiguous()).reshape(Bn, n, K, 2).permute(0, 2, 3, 1)
    Pw = Pw.contiguous()
    Aw = ng.block_inverses(Jw, Pw).contiguous()
    jx = torch.einsum('bkrv,bv->bkr', Jw, x0)
    arefw = (jx + rand(Bn, K, 2) * jx.abs().mean((1, 2), keepdim=True))
    first = torch.einsum('bkrs,bks->bkr', Aw, jx - arefw).norm(dim=-1)
    limw = 4 * rand(Bn, K, normal=False) * first.median(1,
                                                         keepdim=True).values
    wc = (Jw, Pw, Aw, arefw.contiguous(), limw.contiguous(), ones, x0,
          torch.zeros_like(ft0), it)
    return every, in64(every), wc, in64(wc)


def ls_share(a, ref):
    return ((a - ref).abs() <= LS_ATOL + LS_RTOL * ref.abs()).double(
        ).mean().item()


def dense_kernels(batch, seed, report):
    """Rows 12, 13, 15, 16 and 17 against their plain versions on the
    operands of a real dense step of the two-fly scene at batch `batch`:
    the mass matrix, the damped Euler matrix and a Newton Hessian (row
    17), the noslip's factor and M^-1 J_t^T columns (rows 16, 12; row 16
    also on the bench preset's, m 32, 8 substeps in), the search planes of
    every Newton step (row 13) and a reuse step's substitution (row 15,
    bench preset, 8 substeps in, where half the envs are in contact). Row 12 also on gs_cases' operands, since the path's
    contacts are frictionless. Rows 13 and 17 are held per env beside
    wrong controls."""
    import torch
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.ops import cholesky as ch
    from flybody_tpu_torch.ops import linesearch as lsm
    from flybody_tpu_torch.ops import noslip_gs as ng
    from flybody_tpu_torch.physics import engine

    model = spec.load(spec.TWO_FLY_NPZ, device='cuda')
    data = two_fly_data(model, batch, seed)
    for _ in range(2):  # into contact
        data = engine.step(model, data).strip()
    n = model.meta.nv
    entries = []
    calls = engine.PRESETS['default']['solver_iterations'] + 2
    with recording(ch, 'chol_solve', {0, 1, calls - 1}) as c17, \
            recording(ch, 'cho_solve_multi', {0}) as c16, \
            recording(ng, 'gs', {0}) as c12, \
            recording(lsm, 'line_search', set(range(10))) as c13:
        engine.step(model, data)
    # Row 15's operands: a bench substep further into contact (at the
    # path's depth most envs have none, and then a zero reuse gradient).
    bench = engine.PRESETS['bench']
    deeper = data
    for _ in range(6):
        deeper = engine.step(model, deeper, bench).strip()
    with recording(ch, 'cho_solve', {0}) as c15, \
            recording(ch, 'cho_solve_multi', {0}) as c16b:
        engine.step(model, deeper, bench)
    _, efc, _ = engine.fwd_acc(model, deeper, bench)
    log('two-fly kernel operands (row 15, 8 substeps in): '
        + contact_line(efc))
    del deeper, efc
    _, efc, _ = engine.fwd_acc(model, data)
    log('two-fly kernel operands: ' + contact_line(efc))
    del efc

    # Row 17.
    rd17 = {}
    for what, i in (('M', 0), ('Newton Hessian', 1), ('M + dt damping',
                                                      calls - 1)):
        A, b = c17[i]
        out, ref, rd17[what] = chol_checks(what, A, b)
    err = (out[1] - ref[1]).abs().max().item()
    ms = cuda_ms(lambda: ch.chol_solve(A, b), 20)
    pms = cuda_ms(lambda: ch.chol_solve_ref(A, b), 3)
    lms = cuda_ms(lambda: torch.cholesky_solve(
        b[..., None], torch.linalg.cholesky(A)), 5)
    byts = batch * 4 * (n * (n + 1) // 2 + n * n + 2 * n)
    fl = batch * (n ** 3 / 3 + 2 * n * n)
    entries.append(kernel_entry('chol_solve', err, ms, pms, byts, fl, lms))
    kernel_resources('chol_solve', ch.kernel_info(batch, n), batch, report)
    report['chol_solve_readings'] = rd17
    log(f'chol_solve (n {n}): {ms:.3f} ms kernel, {pms:.3f} ms plain, '
        f'{lms:.3f} ms torch.linalg.cholesky + torch.cholesky_solve')

    # Row 15: a reuse step's substitution (bench preset), where envs with
    # no active contact have a zero gradient, and the factor of M with the
    # smooth force (every env, nonzero).
    L, g = c15[0]
    x, xr = ch.cho_solve(L, g), ch.cho_solve_ref(L, g)
    err, rel = compare('cho_solve', (x,), (xr,), ('x',))
    LM = ch.chol_solve(*c17[0])[0]
    err_m, rel_m = compare('cho_solve[M, qfrc_smooth]',
                       (ch.cho_solve(LM, c17[0][1]),),
                       (ch.cho_solve_ref(LM, c17[0][1]),), ('x',))
    del LM
    report['cho_solve_nonzero_share'] = (g.abs().amax(1) > 0).double(
        ).mean().item()
    log(f'  cho_solve: envs with a nonzero reuse gradient '
        f'{report["cho_solve_nonzero_share"]:.3f}')
    if not max(rel, rel_m) <= SUBST_REL_TOL:
        raise AssertionError(f'cho_solve disagrees: rel {rel:.3e} / '
                             f'{rel_m:.3e}')
    ms = cuda_ms(lambda: ch.cho_solve(L, g), 20)
    pms = cuda_ms(lambda: ch.cho_solve_ref(L, g), 3)
    lms = cuda_ms(lambda: torch.cholesky_solve(g[..., None], L), 5)
    entries.append(kernel_entry('cho_solve', max(err, err_m), ms, pms,
                                batch * 4 * (n * (n + 1) // 2 + 2 * n),
                                batch * 2 * n * n, lms))
    log(f'cho_solve: {ms:.3f} ms kernel, {pms:.3f} ms plain, {lms:.3f} ms '
        f'torch.cholesky_solve')

    # Row 16 (the noslip's M^-1 J_t^T, m = 2K: the default preset's m 128
    # and a bench substep's m 32), an entry each.
    for L, R in (c16[0], c16b[0]):
        m = R.shape[2]
        X, Xr = ch.cho_solve_multi(L, R), ch.cho_solve_multi_ref(L, R)
        err, rel = compare(f'cho_solve_multi[m {m}]', (X,), (Xr,), ('X',))
        if not rel <= SUBST_REL_TOL:
            raise AssertionError(f'cho_solve_multi [m {m}] disagrees: rel '
                                 f'{rel:.3e}')
        ms = cuda_ms(lambda: ch.cho_solve_multi(L, R), 20)
        pms = cuda_ms(lambda: ch.cho_solve_multi_ref(L, R), 3)
        lms = cuda_ms(lambda: torch.cholesky_solve(R, L), 5)
        entries.append(kernel_entry(
            'cho_solve_multi', err, ms, pms,
            batch * 4 * (n * (n + 1) // 2 + 2 * n * m), batch * 2 * n * n * m,
            lms))
        kernel_resources(f'cho_solve_multi[m {m}]',
                         ch.kernel_info(batch, n, m), batch, report)
        log(f'cho_solve_multi (m {m}): {ms:.3f} ms kernel, {pms:.3f} ms '
            f'plain, {lms:.3f} ms torch.cholesky_solve')
    del c16b

    # Row 12 (the sweeps, default preset: all 64 slots). The path's own
    # operands are frictionless in this state, so its sweeps change
    # nothing (held all the same); gs_cases adds the ill-posed every-slot
    # witness (read) and a well-conditioned case over all K slots (held).
    gargs = c12[0]
    K, it = gargs[0].shape[1], gargs[8]
    every, every64, wc, wc64 = gs_cases(gargs, c16[0][0], seed)
    _, rel = compare(f'noslip_gs[{K} slots, path]', ng.gs(*gargs),
                     ng.gs_ref(*gargs), ('x', 'ft'))
    rd12 = {'path_frictional_slots': int((gargs[5] > 0).sum())}
    for what, a, a64 in (('every slot, radius 1', every, every64),
                         ('well-conditioned', wc, wc64)):
        ref = ng.gs_ref(*a)
        _, r = compare(f'noslip_gs[{K} slots, {what}]', ng.gs(*a), ref,
                       ('x', 'ft'))
        _, r64 = compare(f'noslip_gs plain[{K} slots, {what}] vs float64',
                         ref, ng.gs_ref(*a64), ('x', 'ft'))
        rd12[what] = {'kernel_vs_plain': r, 'plain_vs_float64': r64}
    log('  noslip_gs readings (worst per-index relative error): '
        + json.dumps(rd12))
    report['noslip_gs_readings'] = rd12
    rel = max(rel, rd12['well-conditioned']['kernel_vs_plain'])
    if not rel <= SUBST_REL_TOL:
        raise AssertionError(f'noslip_gs disagrees: rel {rel:.3e}')
    err = (ng.gs(*wc)[0] - ng.gs_ref(*wc)[0]).abs().max().item()
    # The kernel does the same work whatever the mask: timed on the
    # well-conditioned case.
    ms = cuda_ms(lambda: ng.gs(*wc), 20)
    pms = cuda_ms(lambda: ng.gs_ref(*wc), 3)
    entries.append(kernel_entry(
        'noslip_gs', err, ms, pms, nbytes(wc[:8]) + nbytes(gargs[6:8]),
        batch * it * K * (8 * n + 20)))
    del every, every64, wc, wc64
    log(f'noslip_gs (K {K}, {it} sweeps): {ms:.3f} ms kernel, {pms:.3f} ms '
        f'plain')

    # Row 13 (every Newton step's search, default preset), per search.
    outs, refs, ctls = [], [], []
    for i in sorted(c13):
        lim, con, sc, e_it, l_it = c13[i]
        outs.append(lsm.line_search(lim, con, sc, e_it, l_it))
        refs.append(lsm.line_search_ref(lim, con, sc, e_it, l_it))
        ctls.append(lsm.line_search_ref(lim, con, sc, e_it, l_it - 1))
    a, r, c = torch.cat(outs), torch.cat(refs), torch.cat(ctls)
    rd13 = {'kernel_share': ls_share(a, r),
            'control one refinement step fewer': ls_share(c, r),
            'searches': a.numel(), 'steps_taken': (r > 0).double().mean(
                ).item()}
    log('  line_search readings (share of searches within '
        f'{LS_ATOL:.0e} + {LS_RTOL:.0e} |alpha|): ' + json.dumps(rd13))
    report['line_search_readings'] = rd13
    if not rd13['kernel_share'] >= LS_SHARE:
        raise AssertionError(f'line_search disagrees: {rd13}')
    lim, con, sc, e_it, l_it = c13[0]
    L_, K_ = lim.shape[2], con.shape[2]
    ms = cuda_ms(lambda: lsm.line_search(lim, con, sc, e_it, l_it), 20)
    pms = cuda_ms(lambda: lsm.line_search_ref(lim, con, sc, e_it, l_it), 3)
    evals = e_it + 2 * l_it + 1
    entries.append(kernel_entry(
        'line_search', (a - r).abs().max().item(), ms, pms,
        nbytes((lim, con, sc)) + 4 * batch,
        batch * evals * (8 * L_ + 60 * K_)))
    log(f'line_search (L {L_}, K {K_}, {l_it} steps): {ms:.3f} ms kernel, '
        f'{pms:.3f} ms plain; limit rows kept '
        f'{lsm.live_rows(lim, e_it).double().mean().item():.4f}')
    kernel_resources(f'line_search[L {L_}, K {K_}]',
                     lsm.kernel_info(batch, L_, K_), batch, report)
    return entries


@contextlib.contextmanager
def path_work():
    """How much real work rows 15 and 12 get on the path run in the block:
    {'cho_solve': [(env, launch) pairs with a nonzero right-hand side,
    pairs], 'noslip_gs': [slots swept as active and frictional, slots]},
    the first counts summed on the card without a synchronisation."""
    from flybody_tpu_torch.ops import cholesky as ch
    from flybody_tpu_torch.ops import noslip_gs as ng
    acc = {'cho_solve': [0, 0], 'noslip_gs': [0, 0]}
    o15, o12 = ch.cho_solve, ng.gs

    def w15(L, b):
        acc['cho_solve'][0] = acc['cho_solve'][0] + (b.abs().amax(1) > 0
                                                     ).sum()
        acc['cho_solve'][1] += b.shape[0]
        return o15(L, b)

    def w12(*a):
        acc['noslip_gs'][0] = acc['noslip_gs'][0] + (a[5] > 0).sum()
        acc['noslip_gs'][1] += a[5].numel()
        return o12(*a)

    ch.cho_solve, ng.gs = w15, w12
    try:
        yield acc
    finally:
        ch.cho_solve, ng.gs = o15, o12
        for v in acc.values():
            v[0] = int(v[0])


@contextlib.contextmanager
def chol_diagonal(scale, env=None):
    """A wrong control: row 17 factors A with its diagonal times `scale`,
    in env `env` only (None: every env)."""
    import torch
    from flybody_tpu_torch.ops import cholesky as ch
    orig = ch.chol_solve

    def wrong(A, b):
        s = A.new_full((A.shape[0], 1), scale)
        if env is not None:
            s.fill_(1.0)
            s[env] = scale
        d = torch.diagonal(A, dim1=1, dim2=2)
        return orig((A + torch.diag_embed(d * (s - 1.0))).contiguous(), b)

    ch.chol_solve = wrong
    try:
        yield
    finally:
        ch.chol_solve = orig


def two_fly_controls():
    """The two-fly gate's controls on the card: (name, context, preset
    changes, whether the gate must fail it). The last is read only: at
    this state the solve has converged before its last iteration."""
    return [("row 17 with A's diagonal x (1 + 1e-3), every env",
             lambda: chol_diagonal(1 + 1e-3), {}, True),
            ("row 17 with A's diagonal x (1 + 1e-2), env 0 only",
             lambda: chol_diagonal(1 + 1e-2, 0), {}, True),
            ('one Newton iteration', contextlib.nullcontext,
             {'solver_iterations': 1}, True),
            ('one Newton iteration fewer', contextlib.nullcontext,
             {'solver_iterations': 9}, False)]


def two_fly_phase(preset, batch, steps, cpu_envs, seed, report):
    """The two-fly scene's dense path on the card: reset + `steps`
    engine.step substeps at `preset`; every env finite, every kernel's
    launch count exact; scene-substeps/s. Then one substep of `cpu_envs`
    envs from the stepped state on the card and on the CPU at float32 and
    float64, at the preset with 30 line-search steps: held at the default
    preset by f64_anchored (the card at most TWO_FLY_F64_RATIO times as
    far from float64 as the CPU's float32), beside the wrong controls of
    two_fly_controls run on the card, which must fail it; read at the
    bench one. The card-vs-CPU shares of substep_shares are printed, and
    how much real work rows 15 and 12 got on the path (path_work)."""
    import torch
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.physics import engine
    cfg = engine.PRESETS[preset]
    model = spec.load(spec.TWO_FLY_NPZ, device='cuda')
    torch.cuda.synchronize()
    for m, attr in counters().values():
        setattr(m, attr, 0)
    t0 = time.perf_counter()
    data = two_fly_data(model, batch, seed)
    torch.cuda.synchronize()
    t_reset = time.perf_counter() - t0
    times = []
    with path_work() as work:
        for _ in range(steps):
            t0 = time.perf_counter()
            data = engine.step(model, data, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            data = data.strip()
    launches = {n: getattr(m, attr) for n, (m, attr) in counters().items()}
    log(f'two_fly [{preset}]: work on the path: row 15 right-hand sides '
        f'nonzero in {work["cho_solve"][0]} of {work["cho_solve"][1]} '
        f'(env, launch); row 12 slots swept as active and frictional: '
        f'{work["noslip_gs"][0]} of {work["noslip_gs"][1]}')
    expect = {n: steps * TWO_FLY_PER_SUBSTEP[preset].get(n, 0)
              for n in launches}
    log(f'two_fly [{preset}]: launches {launches} (expected {expect})')
    if launches != expect:
        raise AssertionError(f'two_fly {preset}: launch counts {launches} '
                             f'!= {expect}')
    for name in ('qpos', 'qvel', 'qacc'):
        if not torch.isfinite(getattr(data, name)).all():
            raise AssertionError(f'two_fly {preset}: non-finite {name} '
                                 f'after {steps} substeps')
    steady = times[1:] if steps > 1 else times
    rate = batch * len(steady) / sum(steady)
    _, efc, _ = engine.fwd_acc(model, data, cfg)
    log(f'two_fly [{preset}]: ' + contact_line(efc))
    log(f'two_fly [{preset}]: reset {t_reset:.3f} s, substep times '
        f'{[round(t, 4) for t in times]} s, {rate:.1f} scene-substeps/s '
        f'(substeps 2..{steps}, batch {batch}, {2 * batch} flies)')
    rd = dict(batch=batch, substeps=steps, substep_s=times,
              scene_substeps_per_s=rate, launches=launches, path_work=work,
              active_contacts_mean=efc.con_active.sum(1).mean().item())
    del efc

    sub = data.index(slice(0, cpu_envs))
    cfg30 = dict(cfg, ls_iterations=30)
    card = two_fly_substep_outputs(model, sub, cfg30)
    cpu = two_fly_substep_outputs(spec.load(spec.TWO_FLY_NPZ, device='cpu'),
                                  sub.to('cpu'), cfg30)
    cpu64 = two_fly_substep_outputs(
        spec.load(spec.TWO_FLY_NPZ, device='cpu', dtype=torch.float64),
        sub.to('cpu', dtype=torch.float64), cfg30)
    chk = {'card_vs_cpu': substep_shares(card, cpu),
           'cpu_vs_cpu_float64': substep_shares(cpu, cpu64),
           'card_vs_cpu_float64': substep_shares(card, cpu64)}
    for k, v in chk.items():
        log(f'two_fly substep check [{preset}, ls 30] ({cpu_envs} envs) '
            f'{k}: ' + json.dumps(v))
    gate = f64_anchored(card, cpu, cpu64)
    log(f'two_fly substep gate [{preset}] (per quantity: the card\'s and '
        f'the CPU float32\'s median / worst env error against the CPU '
        f'float64): ' + json.dumps(gate))
    chk['f64_anchored'] = gate
    rd['substep_check'] = chk
    report[f'two_fly_{preset}'] = rd
    if preset != 'default':
        return launches
    bad = {k: v for k, v in gate.items() if not v['ok']}
    if bad:
        raise AssertionError(f'two_fly: the card departs from float64 more '
                             f'than the CPU float32 does: {bad}')
    chk['controls'] = {}
    for name, ctx, change, must_fail in two_fly_controls():
        with ctx():
            out = two_fly_substep_outputs(model, sub, dict(cfg30, **change))
        g = f64_anchored(out, cpu, cpu64)
        passed = all(v['ok'] for v in g.values())
        chk['controls'][name] = dict(
            passes=passed, must_fail=must_fail,
            ratio={k: v['ratio'] for k, v in g.items()})
        log(f'two_fly substep gate [{preset}] control: {name}: '
            f'{"passes" if passed else "fails"} (card / CPU float32, median '
            f'and worst env, per quantity: '
            + json.dumps({k: [round(r, 2) for r in v['ratio']]
                          for k, v in g.items()}) + ')')
        if must_fail and passed:
            raise AssertionError(f'two_fly: the gate passes a wrong '
                                 f'control: {name}')
    return launches


def f64_anchored(card, cpu, cpu64, names=SUBSTEP_NAMES + ('cost', 'force')):
    """Per quantity of substep_outputs (or of `names`): the median and worst
    per-env error against the CPU's float64 of the card and of the CPU's
    float32 (qpos, qvel, qacc, sensordata relative to each index's scale,
    as env_err; a quantity of one number per env, the primal cost and net
    normal force, relative to its own value), and whether the card's are
    within TWO_FLY_F64_RATIO times the CPU's (the median also within
    CPU_TOL)."""
    out = {}
    for i, k in enumerate(names):
        if card[i].dim() > 1:
            ec = env_err([card[i]], [cpu64[i]])
            ep = env_err([cpu[i]], [cpu64[i]])
        else:
            b = cpu64[i].abs().clamp(
                min=1e-6 * cpu64[i].abs().max().item() + 1e-30)
            ec = (card[i] - cpu64[i]).abs() / b
            ep = (cpu[i] - cpu64[i]).abs() / b
        v = dict(card=[ec.median().item(), ec.max().item()],
                 cpu_float32=[ep.median().item(), ep.max().item()])
        v['ratio'] = [c / max(p, 1e-30) for c, p in zip(v['card'],
                                                         v['cpu_float32'])]
        v['ok'] = all(c <= max(TWO_FLY_F64_RATIO * p, floor)
                      for c, p, floor in zip(v['card'], v['cpu_float32'],
                                             (CPU_TOL, 0.0)))
        out[k] = v
    return out


def two_fly_substep_outputs(model, data, cfg):
    """substep_outputs for a dense-path model: qpos, qvel, qacc and
    sensordata after one substep, the forward pass's primal cost and net
    normal force, on the CPU as float64."""
    from flybody_tpu_torch.ops import cholesky as ch
    from flybody_tpu_torch.physics import engine, solver
    out = engine.step(model, data, cfg)
    dd, efc, f_c = engine.fwd_acc(model, data, cfg)
    a_free = ch.cho_solve_ref(dd.qLD, dd.qfrc_smooth)
    cost = solver.primal_cost_dense(dd.qM, efc, a_free, dd.qacc)
    return [getattr(out, k).cpu().double() for k in SUBSTEP_NAMES] + [
        cost.cpu().double(), f_c[..., 0].sum(-1).cpu().double()]


# The unpacked-M path (tools/profile_engine.py's stage chain on the walking
# model with a dense mass matrix): batch, line-search steps of its
# card-vs-CPU solve, and the launches of one pass of the chain (prep:
# position, collide, contact rows, factor_m, solve_m; the Newton solve at 8
# iterations / refactor 2: four fresh arrow steps (K3 on the Hessian with
# 1 + 3 SB right-hand sides, row 14 on the capacitance, row 15, row 13) and
# four reuse launches of one iteration each (row 10); noslip, sensors, and
# euler (K3 on the dense damped M)).
UNPACKED_BATCH = 8192
UNPACKED_CPU_ENVS = 64
UNPACKED_PER_CHAIN = {'pos_stage': 1, 'narrowphase': 1, 'mpr_merged': 1,
                      'efc_contacts': 1, 'arrow_factor': 1, 'arrow_solve': 1,
                      'arrow_factor_solve': 5, 'chol': 4, 'cho_solve': 4,
                      'line_search': 4, 'newton_reuse': 4,
                      'noslip_fused': 1, 'sens_stage': 1}


def flail_data(model, batch, seed):
    """The walking model's flailing state (tests/walk_states.py): qpos0
    with every joint below the root moved by 0.2 N(0, 1) rad, qvel ~ N(0,
    1) (numpy, `seed`), qacc zero: legs and wings cross each other and the
    floor, so the Woodbury part of the arrow Newton step carries load."""
    import numpy as np
    import torch
    from flybody_tpu_torch.physics.state import make_data
    rng = np.random.RandomState(seed)
    d = make_data(model, batch)
    qpos = d.qpos.cpu().double().numpy()
    qpos[:, 7:] += 0.2 * rng.randn(batch, qpos.shape[1] - 7)
    as_t = lambda a: torch.as_tensor(a, dtype=model.dtype,
                                     device=model.device)
    return d.replace(qpos=as_t(qpos),
                     qvel=as_t(rng.randn(batch, model.meta.nv)),
                     qacc=torch.zeros_like(d.qvel))


def solve_gate(what, A, b, x, xp, ctl):
    """A kernel's solution x of A x = b against the plain version's xp, per
    env (as chol_checks holds row 17): at least CHOL_ENV_SHARE of the envs
    within CHOL_ENV_TOL of each dof's scale, and the worst residual at most
    CHOL_RESIDUAL_RATIO times the plain version's. `ctl`: the plain
    version's solution from A rounded to bfloat16, a wrong control that
    must fail the same gate."""
    res_p = residuals(A, b, xp).max().item()

    def reading(y):
        return {'share': share(env_err([y], [xp]), CHOL_ENV_TOL),
                'residual_ratio': residuals(A, b, y).max().item()
                / max(res_p, 1e-30)}

    def passes(r):
        return (r['share'] >= CHOL_ENV_SHARE
                and r['residual_ratio'] <= CHOL_RESIDUAL_RATIO)
    rd = {'kernel': reading(x), 'control bf16-rounded A': reading(ctl),
          'residual_max_plain': res_p}
    log(f'  {what} readings (share of envs within {CHOL_ENV_TOL:.0e} of '
        f'each dof\'s scale; worst residual over the plain version\'s): '
        + json.dumps(rd))
    if not passes(rd['kernel']):
        raise AssertionError(f'{what} disagrees: {rd}')
    if passes(rd['control bf16-rounded A']):
        raise AssertionError(f'{what}: the bf16 control passes: {rd}')
    return rd


def bf16(A):
    import torch
    return A.to(torch.bfloat16).float()


def newton_gate_fails(name, reading) -> bool:
    """Whether a control's newton_checks reading fails the kernel's gate."""
    med_tol, mean_tol = COST_REL_TOL[name]
    return (reading['kernel_vs_plain'] < NEWTON_ENV_SHARE
            or any(v['median_env'] > med_tol or v['batch_mean'] > mean_tol
                   for v in reading['preset_steps'].values()))


def arrow_dense_bytes(part) -> int:
    """Bytes of one env's dense A (row-major, float32) that the arrow
    kernels' gather reads, counted in whole 32-byte sectors: the root
    block, the borders A[0:nr, limb] and each limb's block; the zeros
    between limbs are never read."""
    nv, nr = part.nv, part.nr
    idx = {r * nv + c for r in range(nr) for c in range(nr)}
    for lo, d in zip(part.los, part.ds):
        idx |= {r * nv + lo + c for r in range(nr) for c in range(d)}
        idx |= {(lo + r) * nv + lo + c for r in range(d) for c in range(d)}
    return 32 * len({4 * i // 32 for i in idx})


def reuse_flops(part, K, L, SB3, n_iters, ls_iters) -> float:
    """Operations of one env's reuse launch (dense M): the capacitance
    inverse, then per iteration the gradient, the substitution, the
    Woodbury correction, M dx and J dx, and the line search."""
    nv, R3 = part.nv, 3 * K
    ls_eval = 8 * L + 60 * K
    it = (4 * R3 * nv + arrow_flops(part, 1, False) + 4 * SB3 * nv
          + 2 * SB3 * SB3 + 2 * nv * nv + 8 * nv
          + (6 + 2 * ls_iters + 1) * ls_eval)
    return SB3 ** 3 / 3 + n_iters * it


def reuse_phases(args10, ls, n_it, batch, report, stride=16):
    """Logs and records row 10's cycles an env per phase of
    ops/newton_fused.PHASES (the kernel's clock instantiation, every
    stride-th env) on a reuse launch's arguments."""
    import torch
    from flybody_tpu_torch.ops import newton_fused as nf
    clk = nf.record_phases(lambda: nf.reuse(*args10, ls, n_it), batch,
                           stride, torch.device('cuda')).double().mean(0)
    phases = {p: c for p, c in zip(nf.PHASES, clk.tolist()) if c}
    report['newton_reuse_phases'] = phases
    log(f'newton_reuse phase clocks (thousands of cycles an env, every '
        f'{stride}th env): {clk.sum().item() / 1e3:.1f} = ' + ', '.join(
            f'{p} {c / 1e3:.1f}' for p, c in phases.items()))


def unpacked_kernels(model, args, batch, seed, report, path=None):
    """Rows 13, 14, 18, 19 and 10 and K3's dense form against their plain
    versions at the path's shapes, on the operands of one pass of the
    chain from the flailing state: rows 18 (factor_m on the dense M) and 19
    (solve_m, m 1; and m 25, the JAX tool's micro-bench) and K3 (the first
    fresh Newton step: the Hessian with 1 + 3 SB right-hand sides; euler:
    the damped M, m 1) per env
    by each dof's scale and residual, beside a bf16-rounded-A control that
    must fail; row 14 on that step's capacitance (n 24) and on M (n 108)
    the same way; row 15 on the capacitance's solve (n 24) and on M's
    factor with qfrc_smooth (n 108) against its plain version; row 13 on
    the first search (L 204, K 32) per search at 30 refinement steps.
    Row 10 on the first reuse launch's operands of the
    tool's own state (`path`: (the launch's arguments, M, efc, a_free) of
    the counted chain; None: a chain is run from it here) through
    newton_checks with row 8's limits, beside one iteration more, a control
    that must fail; on the flailing state's, its share of envs within
    NEWTON_ENV_TOL at 30 line-search steps is held too, and its cost and
    force at the preset's steps are read, beside the plain float32
    version's and the kernel's against the plain float64 version: there a
    few envs' costs are orders of magnitude above the rest, so the
    batch-mean statistic follows the line search's rounding-level choices
    in those envs (ROADMAP section 3). Then solver.solve on the card
    against the CPU (see below). Returns the kernels' JSON entries."""
    import torch
    from flybody_tpu_torch.ops import arrow as ar
    from flybody_tpu_torch.ops import cholesky as ch
    from flybody_tpu_torch.ops import linesearch as lsm
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.physics import engine, solver
    from flybody_tpu_torch.tools import profile_engine as pe

    part = ar.build_partition(model.meta)
    nv = part.nv
    d0 = flail_data(model, batch, seed)
    euler_call = UNPACKED_PER_CHAIN['arrow_factor_solve'] - 1
    with recording(ar, 'factor_solve', {0, euler_call}) as c3, \
            recording(ch, 'chol', {0}) as c14, \
            recording(ch, 'cho_solve', {0}) as c15, \
            recording(nf, 'reuse', {0}) as c10, \
            recording(lsm, 'line_search', {0}) as c13:
        d, efc, a_free, qacc, _, _ = pe.chain(model, d0, args)
    ops = solver.operands(efc, engine.PRESETS['default']['sb_break'])
    log('unpacked kernel operands (flailing state): ' + contact_line(efc)
        + f'; cross-limb {ops.brk.sum(1).mean().item():.2f} per env')
    report['unpacked_operands'] = dict(
        active_mean=efc.con_active.sum(1).mean().item(),
        cross_limb_mean=ops.brk.sum(1).mean().item())
    entries, rd = [], {}
    M, b = d.qM.contiguous(), d.qfrc_smooth.contiguous()

    # Row 18 on M (factor_m), held through the solution it gives.
    F, Fp = ar.factor(part, M), ar.factor_ref(part, M)
    rd['arrow_factor'] = solve_gate(
        'arrow_factor[M]', M, b, ar.solve_ref(part, F, b),
        ar.solve_ref(part, Fp, b),
        ar.solve_ref(part, ar.factor_ref(part, bf16(M)), b))
    err = (F - Fp).abs().max().item()
    ms = cuda_ms(lambda: ar.factor(part, M), 20)
    pms = cuda_ms(lambda: ar.factor_ref(part, M), 3)
    lms = cuda_ms(lambda: torch.linalg.cholesky(M), 5)
    a_bytes = batch * arrow_dense_bytes(part)
    entries.append(kernel_entry('arrow_factor', err, ms, pms,
                                a_bytes + nbytes((F,)),
                                batch * arrow_flops(part, 0, True), lms))
    log(f'arrow_factor (dense A): {ms:.3f} ms kernel, {pms:.3f} ms plain, '
        f'{lms:.3f} ms torch.linalg.cholesky')

    # Row 19 with the plain factor: m 1 (solve_m) and m 25.
    Fc = ar.factor_ref(part, bf16(M))
    Ld = torch.linalg.cholesky(M)
    g = torch.Generator(device=M.device).manual_seed(seed)
    g25 = torch.cat([b[..., None], torch.randn(
        batch, nv, 24, generator=g, device=M.device)], -1).contiguous()
    times = {}
    for m, rhs in ((1, b), (25, g25)):
        x = ar.solve(part, Fp, rhs)
        rd[f'arrow_solve m {m}'] = solve_gate(
            f'arrow_solve[m {m}]', M, rhs, x, ar.solve_ref(part, Fp, rhs),
            ar.solve_ref(part, Fc, rhs))
        r2 = rhs if m > 1 else rhs[..., None]
        times[m] = dict(
            ms=cuda_ms(lambda: ar.solve(part, Fp, rhs), 20),
            plain_ms=cuda_ms(lambda: ar.solve_ref(part, Fp, rhs), 3),
            library_ms=cuda_ms(lambda: torch.cholesky_solve(r2, Ld), 5),
            bytes=nbytes((Fp, rhs, x)), flops=batch * arrow_flops(
                part, m, False),
            err=(x - ar.solve_ref(part, Fp, rhs)).abs().max().item())
        log(f'arrow_solve (m {m}): {times[m]["ms"]:.3f} ms kernel, '
            f'{times[m]["plain_ms"]:.3f} ms plain, '
            f'{times[m]["library_ms"]:.3f} ms torch.cholesky_solve')
    t = times[1]
    entries.append(kernel_entry('arrow_solve', t['err'], t['ms'],
                                t['plain_ms'], t['bytes'], t['flops'],
                                t['library_ms']))
    report['arrow_solve_m25'] = dict(times[25], bound_ms=max(
        times[25]['bytes'] / HBM_BYTES_PER_S,
        times[25]['flops'] / FP32_FLOPS) * 1e3)
    del Fc, Ld, g25

    # K3's dense form on the first fresh step's Hessian, 1 + 3 SB columns.
    _, H, rhs = c3[0]
    Fk, xk = ar.factor_solve(part, H, rhs)
    Fr, xr = ar.factor_solve_ref(part, H, rhs)
    rd['arrow_factor_solve dense'] = solve_gate(
        f'arrow_factor_solve[Hessian, m {rhs.shape[2]}]', H, rhs, xk, xr,
        ar.factor_solve_ref(part, bf16(H), rhs)[1])
    ms = cuda_ms(lambda: ar.factor_solve(part, H, rhs), 20)
    pms = cuda_ms(lambda: ar.factor_solve_ref(part, H, rhs), 3)
    lms = cuda_ms(lambda: torch.linalg.solve(H, rhs), 5)
    byts = a_bytes + nbytes((rhs, Fk, xk))
    report['arrow_factor_solve_dense'] = dict(
        m=rhs.shape[2], ms=ms, plain_ms=pms, library_ms=lms,
        max_abs_err=(xk - xr).abs().max().item(),
        bound_ms=max(byts / HBM_BYTES_PER_S, batch * arrow_flops(
            part, rhs.shape[2], True) / FP32_FLOPS) * 1e3)
    log(f'arrow_factor_solve (dense A, m {rhs.shape[2]}): {ms:.3f} ms '
        f'kernel, {pms:.3f} ms plain, {lms:.3f} ms torch.linalg.solve, '
        f'bound {report["arrow_factor_solve_dense"]["bound_ms"]:.4f} ms')
    kernel_resources(f'arrow_factor_solve[dense, m {rhs.shape[2]}]',
                     ar.kernel_info(part, batch, rhs.shape[2]), batch,
                     report)
    del H, rhs, Fk, xk, Fr, xr

    # K3's dense form at m 1: euler's damped M, a launch a chain.
    _, Me, be = c3[euler_call]
    Fk, xk = ar.factor_solve(part, Me, be)
    Fr, xr = ar.factor_solve_ref(part, Me, be)
    rd['arrow_factor_solve dense m 1'] = solve_gate(
        'arrow_factor_solve[euler M, m 1]', Me, be, xk, xr,
        ar.factor_solve_ref(part, bf16(Me), be)[1])
    ms = cuda_ms(lambda: ar.factor_solve(part, Me, be), 20)
    pms = cuda_ms(lambda: ar.factor_solve_ref(part, Me, be), 3)
    lms = cuda_ms(lambda: torch.linalg.solve(Me, be), 5)
    byts = a_bytes + nbytes((be, Fk, xk))
    report['arrow_factor_solve_dense_m1'] = dict(
        m=1, ms=ms, plain_ms=pms, library_ms=lms,
        max_abs_err=(xk - xr).abs().max().item(),
        bound_ms=max(byts / HBM_BYTES_PER_S, batch * arrow_flops(
            part, 1, True) / FP32_FLOPS) * 1e3)
    log(f'arrow_factor_solve (dense A, m 1): {ms:.3f} ms kernel, {pms:.3f} '
        f'ms plain, {lms:.3f} ms torch.linalg.solve, bound '
        f'{report["arrow_factor_solve_dense_m1"]["bound_ms"]:.4f} ms')
    kernel_resources('arrow_factor_solve[dense, m 1]',
                     ar.kernel_info(part, batch, 1), batch, report)
    del Me, be, Fk, xk, Fr, xr

    # Row 13 at the chain's widths (L 204, K 32), per search: held at 30
    # refinement steps, where the bracket collapses (at the path's 6 steps
    # on these flailing operands rounding picks which end of the bracket
    # moves in a few percent of the searches: read, beside one refinement
    # step fewer), and timed.
    lim, con, sc, e_it, l_it = c13[0]
    a13 = lsm.line_search(lim, con, sc, e_it, l_it)
    r13 = lsm.line_search_ref(lim, con, sc, e_it, l_it)
    rd13 = {'kernel_share at ls 30': ls_share(
                lsm.line_search(lim, con, sc, e_it, 30),
                lsm.line_search_ref(lim, con, sc, e_it, 30)),
            'kernel_share at the path\'s steps (read)': ls_share(a13, r13),
            'control one refinement step fewer (read)': ls_share(
                lsm.line_search_ref(lim, con, sc, e_it, l_it - 1), r13),
            'limit rows kept': lsm.live_rows(lim, e_it).double().mean(
                ).item()}
    log('  line_search readings, chain (share of searches within '
        f'{LS_ATOL:.0e} + {LS_RTOL:.0e} |alpha|): ' + json.dumps(rd13))
    if not rd13['kernel_share at ls 30'] >= LS_SHARE:
        raise AssertionError(f'line_search (chain) disagrees: {rd13}')
    rd['line_search'] = rd13
    L_, K_ = lim.shape[2], con.shape[2]
    ms = cuda_ms(lambda: lsm.line_search(lim, con, sc, e_it, l_it), 20)
    pms = cuda_ms(lambda: lsm.line_search_ref(lim, con, sc, e_it, l_it), 3)
    evals = e_it + 2 * l_it + 1
    byts = nbytes((lim, con, sc)) + 4 * batch
    fl = batch * evals * (8 * L_ + 60 * K_)
    report['line_search_unpacked'] = dict(
        L=L_, K=K_, ls=l_it, ms=ms, plain_ms=pms, library_ms=None,
        max_abs_err=(a13 - r13).abs().max().item(),
        bound_ms=max(byts / HBM_BYTES_PER_S, fl / FP32_FLOPS) * 1e3)
    log(f'line_search (L {L_}, K {K_}, {l_it} steps): {ms:.3f} ms kernel, '
        f'{pms:.3f} ms plain, bound '
        f'{report["line_search_unpacked"]["bound_ms"]:.4f} ms')
    kernel_resources(f'line_search[L {L_}, K {K_}]',
                     lsm.kernel_info(batch, L_, K_), batch, report)
    del lim, con, sc, a13, r13, c13

    # Row 14: the capacitance (n 24, with the rhs U t of its cho_solve) and
    # M (n 108).
    C = c14[0][0]
    t24 = c15[0][1]
    for what, A, rhs in (('capacitance', C, t24), ('M', M, b)):
        L, Lp = ch.chol(A), ch.chol_ref(A)
        rd[f'chol {what}'] = solve_gate(
            f'chol[{what}, n {A.shape[1]}]', A, rhs,
            ch.cho_solve_ref(L, rhs), ch.cho_solve_ref(Lp, rhs),
            ch.cho_solve_ref(ch.chol_ref(bf16(A)), rhs))
        ms = cuda_ms(lambda: ch.chol(A), 20)
        pms = cuda_ms(lambda: ch.chol_ref(A), 3)
        lms = cuda_ms(lambda: torch.linalg.cholesky(A), 5)
        n = A.shape[1]
        fl = batch * n ** 3 / 3
        byts = batch * 4 * n * (n + 1) // 2 + nbytes((L,))  # A's lower half
        report[f'chol_{what}'] = dict(n=n, ms=ms, plain_ms=pms,
                                      library_ms=lms, bound_ms=max(
                                          byts / HBM_BYTES_PER_S,
                                          fl / FP32_FLOPS) * 1e3)
        if what == 'capacitance':
            entries.append(kernel_entry('chol', (L - Lp).abs().max().item(),
                                        ms, pms, byts, fl, lms))
        log(f'chol (n {n}): {ms:.3f} ms kernel, {pms:.3f} ms plain, '
            f'{lms:.3f} ms torch.linalg.cholesky')
    report['unpacked_readings'] = rd

    # Row 15 at the chain's shapes, each with its own time, bound and
    # torch.cholesky_solve time (the kernels line keeps the two-fly n 216):
    # the capacitance's solve (n 24, its factor and U t) and M's factor
    # with the smooth force (n 108).
    for what, L15, rhs in (('capacitance', *c15[0]),
                           ('M', ch.chol(M), b)):
        x, xr = ch.cho_solve(L15, rhs), ch.cho_solve_ref(L15, rhs)
        n = L15.shape[1]
        err, rel = compare(f'cho_solve[{what}, n {n}]', (x,), (xr,), ('x',))
        if not rel <= SUBST_REL_TOL:
            raise AssertionError(f'cho_solve [{what}] disagrees: rel '
                                 f'{rel:.3e}')
        ms = cuda_ms(lambda: ch.cho_solve(L15, rhs), 20)
        pms = cuda_ms(lambda: ch.cho_solve_ref(L15, rhs), 3)
        lms = cuda_ms(lambda: torch.cholesky_solve(rhs[..., None], L15), 5)
        byts = batch * 4 * (n * (n + 1) // 2 + 2 * n)
        report[f'cho_solve_{what}'] = dict(
            n=n, ms=ms, plain_ms=pms, library_ms=lms, max_abs_err=err,
            bound_ms=max(byts / HBM_BYTES_PER_S,
                         batch * 2 * n * n / FP32_FLOPS) * 1e3)
        log(f'cho_solve (n {n}): {ms:.3f} ms kernel, {pms:.3f} ms plain, '
            f'{lms:.3f} ms torch.cholesky_solve, bound '
            f'{report[f"cho_solve_{what}"]["bound_ms"]:.4f} ms')
    del L15, rhs, x, xr

    # Row 10: the flailing state's first reuse launch, then the tool's.
    def stats_of(efc_, M_, af_):
        ops_ = solver.operands(efc_, engine.PRESETS['default']['sb_break'])

        def stats(o):
            fc = -efc_.con_D[..., None] * nf.cone_residual(
                o[3], efc_.con_mu, efc_.con_frictional, efc_.con_active)
            return cost_force(part, efc_, ops_, M_, af_, o[0], fc[..., 0])
        return stats

    f10 = c10[0]
    fo30 = nf.reuse(*f10[:-2], 30, f10[-1])
    k32, p32 = nf.reuse(*f10), nf.reuse_ref(*f10)
    p64 = nf.reuse_ref(*f64(f10[:-2]), *f10[-2:])
    s64 = stats_of(efc.to(dtype=torch.float64), M.double(), a_free.double())

    def at64(o):  # cost and force of outputs, evaluated in float64
        return s64([t.double() for t in o])
    rdf = {'kernel_vs_plain': share(env_err(
        fo30, nf.reuse_ref(*f10[:-2], 30, f10[-1]))),
        'preset_steps (read)': cost_force_stats(
            stats_of(efc, M, a_free)(k32), stats_of(efc, M, a_free)(p32)),
        'preset_steps, plain float32 vs float64 (read)': cost_force_stats(
            at64(p32), at64(p64)),
        'preset_steps, kernel vs float64 (read)': cost_force_stats(
            at64(k32), at64(p64))}
    del k32, p32, p64
    log('  newton_reuse readings, flailing state (share of envs within '
        f'{NEWTON_ENV_TOL:.0e} at ls 30; cost / force at the preset\'s '
        'steps, read, the plain float32 version\'s and the kernel\'s '
        'against float64 beside): ' + json.dumps(rdf))
    if not rdf['kernel_vs_plain'] >= NEWTON_ENV_SHARE:
        raise AssertionError(f'newton_reuse (flailing state): {rdf}')
    del fo30, f10, c10
    if path is None:
        with recording(nf, 'reuse', {0}) as c10:
            dp, ep, ap = pe.chain(model, pe.setup(args)[1], args)[:3]
        path = (c10[0], dp.qM, ep, ap)
    a10, Mp_, efc_p, af_p = path
    args10, ls, n_it = a10[:-2], a10[-2], a10[-1]
    controls = {'one iteration more':
                lambda ls_, n: nf.reuse(*args10, ls_, n + 1)}
    o30, r30, out, rd10 = newton_checks('newton_reuse', nf.reuse,
                                        nf.reuse_ref, args10, ls, n_it,
                                        controls,
                                        stats_of(efc_p, Mp_, af_p))
    if not newton_gate_fails('newton_reuse',
                             rd10['control one iteration more']):
        raise AssertionError(f'newton_reuse: the control passes: {rd10}')
    rd10['flailing state'] = rdf
    report['newton_readings_reuse'] = rd10
    err, _ = compare('newton_reuse[ls 30]', o30, r30,
                     ('x', 'msm', 'jar_l', 'jar_c'))
    ms = cuda_ms(lambda: nf.reuse(*args10, ls, n_it), 20)
    pms = cuda_ms(lambda: nf.reuse_ref(*args10, ls, n_it), 3)
    K, L, SB3 = efc_p.con_J.shape[1], len(efc_p.lim_dof), args10[7].shape[1]
    entries.append(kernel_entry(
        'newton_reuse', err, ms, pms,
        nbytes(a for a in args10 if torch.is_tensor(a)) + nbytes(out),
        batch * reuse_flops(part, K, L, SB3, n_it, ls)))
    log(f'newton_reuse: {ms:.3f} ms kernel, {pms:.3f} ms plain (dense M, K '
        f'{K}, 3SB {SB3}, ls {ls}, {n_it} iteration)')
    newton_resources('reuse', part, batch, K, SB3, L, report)
    reuse_phases(args10, ls, n_it, batch, report)

    # solver.solve on the dense M (30 line-search steps) for the first
    # UNPACKED_CPU_ENVS envs on the card and on the CPU at float32 and
    # float64, by primal cost and net normal force per env: held as the
    # two-fly substep is (f64_anchored), since float32 does not resolve
    # every flailing env's solve, beside one Newton iteration on the card,
    # which must fail the gate; the card-vs-CPU shares are printed.
    from flybody_tpu_torch.model import spec
    sl = slice(0, UNPACKED_CPU_ENVS)

    def cost_force_on(device, dtype, flags=()):
        args30 = pe.parser().parse_args(['--iters-ls', '30', *flags])
        m_ = spec.load(spec.WALK_IMITATION_NPZ, device=device, dtype=dtype)
        dd = d.index(sl).to(device, dtype=dtype)
        ee = efc.index(sl).to(device, dtype)
        af = a_free[sl].to(device, dtype=dtype)
        o = pe.solve(m_, dd, ee, af, args30)
        return [solver.primal_cost_dense(dd.qM, ee, af, o[0]).double().cpu(),
                o[3][..., 0].sum(-1).double().cpu()]
    card = cost_force_on(d.qpos.device, torch.float32)
    cpu = cost_force_on('cpu', torch.float32)
    cpu64 = cost_force_on('cpu', torch.float64)
    gate = f64_anchored(card, cpu, cpu64, ('cost', 'force'))
    # A wrong control on the card through the same gate, which must fail.
    ctl = f64_anchored(cost_force_on(d.qpos.device, torch.float32,
                                     ('--iters-solver', '1')),
                       cpu, cpu64, ('cost', 'force'))
    shares = {k: share((a - b).abs() / b.abs().clamp(
        min=1e-6 * b.abs().max().item() + 1e-30), CPU_TOL)
        for k, a, b in zip(('cost', 'force'), card, cpu)}
    log(f'unpacked solve gate ({UNPACKED_CPU_ENVS} envs, ls 30; per '
        'quantity: the card\'s and the CPU float32\'s median / worst env '
        'error against the CPU float64): ' + json.dumps(gate)
        + f'; card vs CPU float32, share of envs within {CPU_TOL:.0e}: '
        + json.dumps(shares))
    log('  control one Newton iteration, through the gate: '
        + json.dumps(ctl))
    report['unpacked_solve_gate'] = dict(
        gate=gate, card_vs_cpu=shares, control_one_newton_iteration=ctl)
    if not all(v['ok'] for v in gate.values()):
        raise AssertionError(f'unpacked solve: card vs CPU float64 {gate}')
    if all(v['ok'] for v in ctl.values()):
        raise AssertionError(f'unpacked solve: the control passes: {ctl}')
    return entries


def unpacked_phase(batch, seed, report):
    """tools/profile_engine.py's stage chain on the card at batch `batch`:
    one pass from the tool's own state with every launch counted (exactly
    UNPACKED_PER_CHAIN, everything else 0) and its outputs finite, then
    unpacked_kernels on a flailing state, then the tool's stage table (3
    timed calls a stage). Returns (kernel entries, launches)."""
    import torch
    from flybody_tpu_torch.tools import profile_engine as pe
    args = pe.parser().parse_args(['--batch', str(batch), '--iters', '3',
                                   '--seed', str(seed)])
    from flybody_tpu_torch.ops import newton_fused as nf
    model, d0 = pe.setup(args)
    torch.cuda.synchronize()
    for m, attr in counters().values():
        setattr(m, attr, 0)
    t0 = time.perf_counter()
    with recording(nf, 'reuse', {0}) as c10:
        outs = pe.chain(model, d0, args)
    torch.cuda.synchronize()
    t_chain = time.perf_counter() - t0
    launches = {n: getattr(m, attr) for n, (m, attr) in counters().items()}
    expect = {n: UNPACKED_PER_CHAIN.get(n, 0) for n in launches}
    log(f'unpacked chain: launches {launches} (expected {expect}), '
        f'{t_chain:.3f} s')
    if launches != expect:
        raise AssertionError(f'unpacked chain: launch counts {launches} != '
                             f'{expect}')
    for name, t in zip(('a_free', 'qacc', 'qacc after noslip', 'qpos'),
                       outs[2:]):
        if not torch.isfinite(t).all():
            raise AssertionError(f'unpacked chain: non-finite {name}')
    entries = unpacked_kernels(model, args, batch, seed, report,
                               (c10[0], outs[0].qM, outs[1], outs[2]))
    del outs, c10
    torch.cuda.empty_cache()
    results = pe.stages(model, d0, args)
    tab = pe.table(results, batch, f'gpu ({torch.cuda.get_device_name(0)})',
                   args.iters)
    log(tab)
    report['profile_engine'] = dict(
        batch=batch, iters=args.iters,
        ms={k: v * 1e3 for k, v in results.items()},
        steps_per_s=batch / results['FULL step'], launches=launches)
    return entries, launches


# The collision tools' phase (tools_phase): batch, timed calls a line, and
# the launches of one profile_collide pass (the seven MPR groups' per-pair
# MPR, then the FULL collide: row 5 once, the merged MPR once) and of one
# profile_micro chain as it is built: the position stage; the collide
# groups; the dense collide; make_efc (row 7) for the operands and for its
# line; factor_m (row 18) and solve_m (row 19) for the operands and for
# their lines; the dense factor (row 14) for the operands, for its line and
# for the capacitance of each of the eight fresh arrow steps of `solve
# 8x6`; its substitution (row 15) for its line and those eight; K3 (1 + 3 SB
# right-hand sides) and the line search (row 13) eight times; noslip (row
# 11) once.
TOOLS_BATCH = 8192
TOOLS_ITERS = 3
COLLIDE_PER_PASS = {'mpr_pair': 7, 'narrowphase': 1, 'mpr_merged': 1}
MICRO_PER_CHAIN = {'pos_stage': 1, 'mpr_pair': 7, 'narrowphase': 1,
                   'mpr_merged': 1, 'efc_contacts': 2, 'arrow_factor': 2,
                   'arrow_solve': 2, 'chol': 10, 'cho_solve': 9,
                   'arrow_factor_solve': 8, 'line_search': 8,
                   'noslip_fused': 1}


def all_finite(obj) -> bool:
    """Whether every floating tensor in obj (tensors, tuples, lists,
    dicts, dataclasses) is finite."""
    import dataclasses
    import torch
    if torch.is_tensor(obj):
        return not obj.is_floating_point() or bool(torch.isfinite(obj).all())
    if isinstance(obj, (tuple, list)):
        return all(all_finite(o) for o in obj)
    if isinstance(obj, dict):
        return all(all_finite(o) for o in obj.values())
    if dataclasses.is_dataclass(obj):
        return all(all_finite(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return True


def counted(what, expect, fn, total):
    """fn() with every launch counter set to 0 before it and read after:
    the counts must be `expect` (0 where it names none) and every output
    finite; the counts are added to `total`. Returns fn's outputs."""
    import torch
    torch.cuda.synchronize()
    for m, attr in counters().values():
        setattr(m, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    launches = {n: getattr(m, attr) for n, (m, attr) in counters().items()}
    exp = {n: expect.get(n, 0) for n in launches}
    log(f'{what}: launches {launches} (expected {exp})')
    if launches != exp:
        raise AssertionError(f'{what}: launch counts {launches} != {exp}')
    if not all_finite(out):
        raise AssertionError(f'{what}: non-finite outputs')
    for n, c in launches.items():
        total[n] += c
    return out


def tools_phase(batch, seed, report):
    """tools/profile_collide.py and tools/profile_micro.py on the card at
    batch `batch`: one profile_collide pass (COLLIDE_PER_PASS) and one
    profile_micro chain (MICRO_PER_CHAIN) with every launch counted and
    every output finite, then both tables (TOOLS_ITERS timed calls a
    line). Returns the launches."""
    import torch
    from flybody_tpu_torch.tools import profile_collide as pc
    from flybody_tpu_torch.tools import profile_engine as pe
    from flybody_tpu_torch.tools import profile_micro as pm
    flags = ['--batch', str(batch), '--iters', str(TOOLS_ITERS), '--seed',
             str(seed)]
    total = {n: 0 for n in counters()}
    args = pc.parser().parse_args(flags)
    model, d = pc.setup(args)
    counted('profile_collide pass', COLLIDE_PER_PASS,
            lambda: pc.collide_pass(model, d), total)
    from flybody_tpu_torch.ops import pos_stage
    from flybody_tpu_torch.physics import collision, kinematics
    kernel_resources('pos_stage[tools]', pos_stage.kernel_info(model, batch),
                     batch, report)
    mpr_order_readings('dense collide', collision.merged_candidates(
        model, kinematics.fwd_position_smooth(model, d)[0],
        collision.MPR_MERGED_TOP_P)[2], batch, report)
    margs = pm.parser().parse_args(flags)
    margs.task = 'walk_imitation'
    _, d0 = pe.setup(margs)
    counted('profile_micro chain', MICRO_PER_CHAIN,
            lambda: pm.chain(model, d0), total)
    torch.cuda.empty_cache()
    name = torch.cuda.get_device_name(0)
    r = pc.results(model, d, args)
    log(pc.table(r, batch, f'gpu ({name})'))
    del d
    rm = pm.main(flags)
    report['tools'] = dict(batch=batch, iters=TOOLS_ITERS,
                           profile_collide_ms={k: v * 1e3
                                               for k, v in r.items()},
                           profile_micro_ms={k: v * 1e3
                                             for k, v in rm.items()},
                           launches=total)
    return total


def gate_seeds(count: int) -> None:
    """The two-fly substep gate of two_fly_phase (f64_anchored at the
    default preset) at seeds 0..count-1 in place of SEED: per seed, the
    state after TWO_FLY_STEPS substeps at TWO_FLY_BATCH and the gate over
    its first TWO_FLY_CPU_ENVS envs, printed (whether it holds, and each
    quantity's worst-env ratio card / CPU float32). It shows how far the
    gate's verdict follows the state that the card's roundings lead to."""
    import torch
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.physics import engine
    cfg = engine.PRESETS['default']
    cfg30 = dict(cfg, ls_iterations=30)
    model = spec.load(spec.TWO_FLY_NPZ, device='cuda')
    cpu_m = spec.load(spec.TWO_FLY_NPZ, device='cpu')
    cpu64_m = spec.load(spec.TWO_FLY_NPZ, device='cpu', dtype=torch.float64)
    for seed in range(count):
        data = two_fly_data(model, TWO_FLY_BATCH, seed)
        for _ in range(TWO_FLY_STEPS):
            data = engine.step(model, data, cfg).strip()
        sub = data.index(slice(0, TWO_FLY_CPU_ENVS))
        gate = f64_anchored(
            two_fly_substep_outputs(model, sub, cfg30),
            two_fly_substep_outputs(cpu_m, sub.to('cpu'), cfg30),
            two_fly_substep_outputs(cpu64_m, sub.to('cpu',
                                                    dtype=torch.float64),
                                    cfg30))
        log(f'two_fly gate at seed {seed}: '
            f'{"holds" if all(v["ok"] for v in gate.values()) else "fails"}'
            '; worst-env ratio card / CPU float32: ' + json.dumps(
                {k: round(v['ratio'][1], 2) for k, v in gate.items()}))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    if sys.argv[1:2] == ['--gate-seeds']:  # a reading, not the smoke run
        from flybody_tpu_torch.ops import _cuda
        _cuda.build_all()
        log(f'card: {card_line()}')
        gate_seeds(int(sys.argv[2]))
        return 0
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
    seconds = {}
    t0 = time.perf_counter()
    env = fly_envs.walk_imitation(functional=True)
    kernels = kernel_phase(env, BATCH, SEED, report)
    del env
    torch.cuda.empty_cache()
    kernels += dense_kernels(TWO_FLY_BATCH, SEED, report)
    torch.cuda.empty_cache()
    seconds['kernels'] = time.perf_counter() - t0
    total = {n: 0 for n in SOURCES}
    for preset in PRESETS:
        t0 = time.perf_counter()
        state0, action, first, (model, data1), launches = main_path_phase(
            preset, BATCH, STEPS, CPU_ENVS, SEED, report)
        for n, c in launches.items():
            total[n] += c
        seconds[f'main_path_{preset}'] = time.perf_counter() - t0
        if preset == 'default':
            # The default step again with kernel 9's block-full mode.
            t0 = time.perf_counter()
            launches = main_path_phase('default_full', BATCH, STEPS,
                                       CPU_ENVS, SEED, report)[-1]
            for n, c in launches.items():
                total[n] += c
            log('main path: default_full {:.1f} env-steps/s beside default '
                '{:.1f}'.format(*(report[f'main_path_{p}']['env_steps_per_s']
                                  for p in ('default_full', 'default'))))
            torch.cuda.empty_cache()
            seconds['main_path_default_full'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_phase(preset, state0, action, first, CPU_ENVS, report)
        substep_phase(preset, model, data1, report)
        del state0, model, data1
        torch.cuda.empty_cache()
        seconds[f'cpu_check_{preset}'] = time.perf_counter() - t0
    for preset in PRESETS:
        t0 = time.perf_counter()
        launches = two_fly_phase(preset, TWO_FLY_BATCH, TWO_FLY_STEPS,
                                 TWO_FLY_CPU_ENVS, SEED, report)
        for n, c in launches.items():
            total[n] += c
        torch.cuda.empty_cache()
        seconds[f'two_fly_{preset}'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for n, c in tools_phase(TOOLS_BATCH, SEED, report).items():
        total[n] += c
    torch.cuda.empty_cache()
    seconds['tools'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    entries, launches = unpacked_phase(UNPACKED_BATCH, SEED, report)
    kernels += entries
    for n, c in launches.items():
        total[n] += c
    torch.cuda.empty_cache()
    seconds['unpacked'] = time.perf_counter() - t0
    for k in kernels:  # launches over the main-path runs of both models
        k['launches'] = total[k['name']]
    seconds['build'] = report['build_s']
    report['phase_seconds'] = seconds
    log('phase seconds: ' + json.dumps({k: round(v, 1)
                                        for k, v in seconds.items()}))

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
