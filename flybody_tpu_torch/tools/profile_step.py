"""Where a control step spends its time, on one GPU.

    python -m flybody_tpu_torch.tools.profile_step --batch 8192 \
        [--preset default|default_full|bench]
    python -m flybody_tpu_torch.tools.profile_step --model two_fly \
        [--batch 4096] [--preset default|bench]

walk_imitation (the default model): resets `batch` envs at the solver
preset, takes one warm-up control step, then records one control step
(10 substeps) with torch.profiler (CPU and CUDA activities). two_fly: the
two-fly scene's dense path (model/assets/two_fly.npz) from its reset
state with qvel ~ N(0, 1) and ctrl ~ U(-1, 1) (numpy, --seed), two
warm-up substeps, then 10 recorded engine.step substeps. Prints and
writes (--out, JSON):
  * the step's wall time (host clock, ending in a synchronize);
  * per engine stage (the 'fb/<stage>' ranges of physics/engine.py),
    summed over the 10 substeps: the host time inside the range, the
    device time of the work it launched, and the operators it dispatched.
    The device time counts the PyTorch operators dispatched inside the
    range and the hand kernels (csrc/*.cu) that the stage launches: the
    profiler links a kernel launched through ctypes to no operator, so
    each goes to its stages by the exact name of its __global__ function,
    template arguments stripped (HAND_KERNELS, which must name every
    __global__ function of csrc/*.cu: the tool refuses to start
    otherwise, and a kernel in the trace named as one of those functions
    but not in HAND_KERNELS is an error). A kernel that several stages
    launch is split by their launches a substep (stage_weights): K3's
    kernels and the arrow kernel half to factor_solve and half to euler;
    the dense factor+solve (row 17) and K3's dense form one share each to
    factor_solve and euler and one a fresh Newton step to newton; the
    observations' pos_stage launch after the substeps goes to position;
  * device busy time (sum of kernel and copy times) and the idle share
    1 - busy / wall;
  * the kernels with the most device time.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
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


# The hand kernels by the name of their __global__ function (csrc/*.cu),
# and the engine stages that launch them (physics/engine.py).
HAND_KERNELS = {
    'pos_stage_kernel': ('position',),  # K1
    'narrowphase_kernel': ('collision',),  # row 5
    'mpr_order_kernel': ('collision',),  # row 6's pre-pass
    'mpr_kernel': ('collision',),  # row 6
    'mpr_pair_kernel': ('collision',),  # row 20 (the tools' group lines)
    'force_stage_kernel': ('force',),  # K2
    'efc_kernel': ('constraint_rows',),  # row 7
    'arrow_fs1_kernel': ('factor_solve', 'euler'),  # K3, packed, m 1
    'arrow_dense_kernel': ('factor_solve', 'newton', 'euler'),  # K3, dense
    'arrow_kernel': ('factor_solve', 'euler'),  # K3 off its tile; 18, 19
    'newton_kernel': ('newton',),  # rows 8, 9
    'newton_reuse_kernel': ('newton',),  # row 10
    'noslip_kernel': ('noslip',),  # row 11
    'noslip_gs_kernel': ('noslip',),  # row 12
    'linesearch_kernel': ('newton',),  # row 13
    'linesearch_rows_kernel': ('newton',),  # row 13 off its tile
    'chol_warp_kernel': ('newton',),  # row 14 (n <= 32): the capacitance
    'chol_panel_kernel': ('newton',),  # row 14 (n > 32)
    'cho_solve_warp32_kernel': ('newton',),  # row 15 (n <= 32)
    'cho_solve_tiles_kernel': ('newton',),  # row 15 (n > 32)
    'cho_solve_multi_kernel': ('noslip',),  # row 16
    'chol_solve_kernel': ('factor_solve', 'newton', 'euler'),  # row 17
    'sens_stage_kernel': ('sensors',),  # K4
}
# Launched once by factor_solve and euler and once a fresh Newton step.
_FRESH_SPLIT = ('chol_solve_kernel', 'arrow_dense_kernel')


def stage_weights(hand: str, preset: dict) -> dict:
    """Each stage's share of a hand kernel's launches in a substep."""
    stages = HAND_KERNELS[hand]
    if hand in _FRESH_SPLIT:  # one a fresh Newton step
        p = max(1, preset['refactor_period'])
        fresh = -(-preset['solver_iterations'] // p)
        w = {'factor_solve': 1, 'newton': fresh, 'euler': 1}
    else:
        w = {st: 1 for st in stages}
    total = sum(w.values())
    return {st: v / total for st, v in w.items()}


CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc')
_GLOBAL = re.compile(r'__global__\s+void\s+(?:__launch_bounds__\s*'
                     r'\([^()]*(?:\([^()]*\)[^()]*)*\)\s*)?(\w+)\s*\(')
_ANON = '(anonymous namespace)::'


@functools.lru_cache(maxsize=4)
def csrc_kernels(csrc: str = CSRC) -> frozenset:
    """The names of the __global__ functions in csrc/*.cu."""
    names = set()
    for fn in sorted(os.listdir(csrc)):
        if fn.endswith('.cu'):
            with open(os.path.join(csrc, fn)) as f:
                names.update(_GLOBAL.findall(f.read()))
    return frozenset(names)


def check_map(csrc: str = CSRC):
    """Raises unless HAND_KERNELS names exactly the __global__ functions
    of csrc/*.cu."""
    have = csrc_kernels(csrc)
    if have != set(HAND_KERNELS):
        raise ValueError(
            f'HAND_KERNELS does not match csrc/*.cu: no stage for '
            f'{sorted(have - set(HAND_KERNELS))}, no kernel for '
            f'{sorted(set(HAND_KERNELS) - have)}')


def kernel_name(name: str) -> str:
    """The bare function name of a device kernel's name as the profiler
    gives it, demangled or mangled: return type, namespaces, template
    arguments and parameters stripped."""
    if name.startswith('_Z'):  # the last <length><name> of the nested name
        i, base = 3 if name[2:3] == 'N' else 2, ''
        while i < len(name) and name[i].isdigit():
            j = i
            while j < len(name) and name[j].isdigit():
                j += 1
            n = int(name[i:j])
            base, i = name[j:j + n], j + n
        return base
    s = name.strip()
    if s.startswith('void '):
        s = s[5:].lstrip()
    s = s.replace(_ANON, '').split('(', 1)[0].split('<', 1)[0]
    return s.split('::')[-1].strip()


def _hand_kernel(name: str, known=None):
    """The HAND_KERNELS key of a trace's kernel name, None for a library
    kernel. A kernel is a hand kernel when its bare name is a __global__
    function of csrc/*.cu (`known`, csrc_kernels() by default); one that
    HAND_KERNELS does not name raises KeyError, so that no hand kernel
    drops out of the stage table."""
    base = kernel_name(name)
    if base in HAND_KERNELS:
        return base
    if base in (csrc_kernels() if known is None else known):
        raise KeyError(f'{name!r}: a hand kernel with no stage in '
                       f'HAND_KERNELS (tools/profile_step.py)')
    return None


def _is_kernel(e) -> bool:
    """A device-side event that is real work (the device copies of the
    'fb/' ranges are annotations spanning many kernels)."""
    import torch
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith('fb/'))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model', default='walk_imitation',
                    choices=('walk_imitation', 'two_fly'))
    ap.add_argument('--batch', type=int, default=None,
                    help='envs (8192 walk_imitation, 4096 two_fly)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--preset', default='default',
                    help="solver preset (physics/engine.py PRESETS)")
    ap.add_argument('--out', default=None,
                    help='JSON path (chiprun_out/profile_step'
                         '[_two_fly]_<preset>.json)')
    ap.add_argument('--trace', default=None,
                    help='optional chrome trace path')
    args = ap.parse_args(argv)
    check_map()

    import torch
    from torch.profiler import ProfilerActivity, profile
    from flybody_tpu_torch.physics import engine

    if not torch.cuda.is_available():
        raise SystemExit('profile_step needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    two_fly = args.model == 'two_fly'
    if args.batch is None:
        args.batch = 4096 if two_fly else 8192
    run = (_two_fly_run if two_fly else _walk_run)(args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
            if hand is None:
                continue
            weights = stage_weights(hand, engine.PRESETS[args.preset])
            for st, wt in weights.items():
                if st in spans:
                    spans[st]['hand_kernel_ms'] += ms * wt
                    spans[st]['device_ms'] += ms * wt
    kernels = sorted(((n, t, c) for n, (t, c) in kern.items()),
                     key=lambda x: -x[1])
    busy = sum(k[1] for k in kernels) / 1e3
    rate = args.batch * (SUBSTEPS if two_fly else 1) / wall
    unit = 'scene_substeps_per_s' if two_fly else 'env_steps_per_s'
    report = dict(card=card, model=args.model, batch=args.batch,
                  preset=args.preset, wall_s=wall,
                  device_busy_s=busy, idle_share=1.0 - busy / wall,
                  spans=spans, top_kernels=[dict(name=n, device_ms=t,
                                                 count=c)
                                            for n, t, c in kernels[:25]])
    report[unit] = rate
    print(f'card: {card}')
    print(f'{args.model}: {SUBSTEPS} substeps, wall {wall:.3f} s at batch '
          f'{args.batch}, preset {args.preset} ({unit} {rate:.1f}); device '
          f'busy {busy:.3f} s; idle share {report["idle_share"]:.3f}')
    for k, v in sorted(spans.items(), key=lambda kv: -kv[1]['host_ms']):
        print(f'  {k:16s} host {v["host_ms"]:9.1f} ms  device '
              f'{v["device_ms"]:9.1f} ms (hand kernels '
              f'{v["hand_kernel_ms"]:7.1f})  ops {v["ops"]}')
    for n, t, c in kernels[:15]:
        print(f'  {t:9.2f} ms  x{c:<6d} {n[:90]}')
    out = args.out or (f'chiprun_out/profile_step'
                       f'{"_two_fly" if two_fly else ""}_{args.preset}.json')
    os.makedirs(os.path.dirname(out) or '.', exist_ok=True)
    with open(out, 'w') as f:
        json.dump(report, f, indent=1)
    if args.trace:
        prof.export_chrome_trace(args.trace)


SUBSTEPS = 10  # physics substeps of the recorded window


def _walk_run(args):
    """walk_imitation at batch, after one warm-up control step: returns
    the recorded control step."""
    import torch
    from flybody_tpu_torch.envs import fly_envs
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
    return lambda: env.step(state, a)


def _two_fly_run(args):
    """The two-fly scene at batch after two warm-up substeps: returns
    the recorded SUBSTEPS substeps."""
    import numpy as np
    import torch
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.physics import engine
    from flybody_tpu_torch.physics.state import make_data
    model = spec.load(spec.TWO_FLY_NPZ, device='cuda')
    rng = np.random.RandomState(args.seed)
    meta = model.meta
    data = make_data(model, args.batch).replace(
        qvel=torch.as_tensor(rng.randn(args.batch, meta.nv),
                             dtype=torch.float32, device='cuda'),
        ctrl=torch.as_tensor(rng.uniform(-1.0, 1.0, (args.batch, meta.nu)),
                             dtype=torch.float32, device='cuda'))
    cfg = engine.PRESETS[args.preset]
    for _ in range(2):
        data = engine.step(model, data, cfg).strip()

    def run():
        d = data
        for _ in range(SUBSTEPS):
            d = engine.step(model, d, cfg).strip()
    return run


if __name__ == '__main__':
    main()
