"""Where a walk_imitation control step spends its time, on one GPU.

    python -m flybody_tpu_torch.tools.profile_step --batch 8192 \
        [--preset default|bench]

Resets `batch` envs at the solver preset, takes one warm-up control step,
then records one
control step with torch.profiler (CPU and CUDA activities). Prints and
writes (--out, JSON):
  * the step's wall time (host clock, ending in a synchronize);
  * per engine stage (the 'fb/<stage>' ranges of physics/engine.py),
    summed over the 10 substeps: the host time inside the range, the
    device time of the work it launched, and the operators it dispatched.
    The device time counts the PyTorch operators dispatched inside the
    range and the hand kernels (csrc/*.cu) that the stage launches: the
    profiler links a kernel launched through ctypes to no operator, so
    each goes to its stage by name (HAND_KERNELS; the arrow kernel, which
    factor_solve and euler each launch once a substep, half to each, and
    the observations' pos_stage launch after the substeps to position);
  * device busy time (sum of kernel and copy times) and the idle share
    1 - busy / wall;
  * the kernels with the most device time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time


def _device_us(e, total: bool) -> float:
    """Device time of a profiler event (attribute names differ across
    PyTorch versions)."""
    names = (('device_time_total', 'cuda_time_total') if total else
             ('self_device_time_total', 'self_cuda_time_total'))
    for attr in names:
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


# The hand kernels by the name of their __global__ function, and the
# engine stages that launch them (physics/engine.py).
HAND_KERNELS = {
    'pos_stage_kernel': ('position',),
    'narrowphase_kernel': ('collision',),
    'mpr_kernel': ('collision',),
    'force_stage_kernel': ('force',),
    'efc_kernel': ('constraint_rows',),
    'arrow_factor_solve_kernel': ('factor_solve', 'euler'),
    'newton_kernel': ('newton',),
    'noslip_kernel': ('noslip',),
    'sens_stage_kernel': ('sensors',),
}


def _hand_kernel(name: str):
    return next((k for k in HAND_KERNELS if k in name), None)


def _is_kernel(e) -> bool:
    """A device-side event that is real work (the device copies of the
    'fb/' ranges are annotations spanning many kernels)."""
    import torch
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith('fb/'))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=8192)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--preset', default='default',
                    help="solver preset (physics/engine.py PRESETS)")
    ap.add_argument('--out', default=None,
                    help='JSON path (chiprun_out/profile_step_<preset>.json)')
    ap.add_argument('--trace', default=None,
                    help='optional chrome trace path')
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile
    from flybody_tpu_torch.envs import fly_envs

    if not torch.cuda.is_available():
        raise SystemExit('profile_step needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    env = fly_envs.walk_imitation(functional=True, preset=args.preset)
    g = torch.Generator().manual_seed(args.seed)
    lo = torch.as_tensor(env.action_min, dtype=torch.float32)
    hi = torch.as_tensor(env.action_max, dtype=torch.float32)

    def action():
        return (lo + (hi - lo) * torch.rand(args.batch, len(lo),
                                            generator=g)).cuda()

    state, _ = env.reset(args.batch, generator=g)
    state, _ = env.step(state, action())
    a = action()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = env.step(state, a)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = prof.events()
    spans = {}
    for e in events:
        if (e.name.startswith('fb/')
                and e.device_type != torch.autograd.DeviceType.CUDA):
            sp = spans.setdefault(e.name[3:], dict(host_ms=0.0, calls=0,
                                                   ops=0, device_ms=0.0))
            sp['host_ms'] += e.time_range.elapsed_us() / 1e3
            sp['calls'] += 1
    for e in events:  # operators dispatched directly inside a range
        p = e.cpu_parent
        if p is not None and p.name.startswith('fb/'):
            spans[p.name[3:]]['ops'] += 1
            spans[p.name[3:]]['device_ms'] += _device_us(e, True) / 1e3
    # Hand kernels (launched through ctypes, so no operator of their own):
    # to the stages that launch them, by name.
    for sp in spans.values():
        sp['hand_kernel_ms'] = 0.0
    kern = {}
    for e in events:
        if _is_kernel(e):
            ms = _device_us(e, False) / 1e3
            k = kern.setdefault(e.name, [0.0, 0])
            k[0] += ms
            k[1] += 1
            hand = _hand_kernel(e.name)
            for st in HAND_KERNELS.get(hand, ()):
                if st in spans:
                    share = ms / len(HAND_KERNELS[hand])
                    spans[st]['hand_kernel_ms'] += share
                    spans[st]['device_ms'] += share
    kernels = sorted(((n, t, c) for n, (t, c) in kern.items()),
                     key=lambda x: -x[1])
    busy = sum(k[1] for k in kernels) / 1e3
    report = dict(card=card, batch=args.batch, preset=args.preset,
                  wall_s=wall,
                  device_busy_s=busy, idle_share=1.0 - busy / wall,
                  env_steps_per_s=args.batch / wall, spans=spans,
                  top_kernels=[dict(name=n, device_ms=t, count=c)
                               for n, t, c in kernels[:25]])
    print(f'card: {card}')
    print(f'step wall {wall:.3f} s at batch {args.batch}, preset '
          f'{args.preset}; device busy {busy:.3f} s; idle share '
          f'{report["idle_share"]:.3f}')
    for k, v in sorted(spans.items(), key=lambda kv: -kv[1]['host_ms']):
        print(f'  {k:16s} host {v["host_ms"]:9.1f} ms  device '
              f'{v["device_ms"]:9.1f} ms (hand kernels '
              f'{v["hand_kernel_ms"]:7.1f})  ops {v["ops"]}')
    for n, t, c in kernels[:15]:
        print(f'  {t:9.2f} ms  x{c:<6d} {n[:90]}')
    out = args.out or f'chiprun_out/profile_step_{args.preset}.json'
    os.makedirs(os.path.dirname(out) or '.', exist_ok=True)
    with open(out, 'w') as f:
        json.dump(report, f, indent=1)
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == '__main__':
    main()
