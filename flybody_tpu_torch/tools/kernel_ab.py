"""K2 and row 11 against an earlier tree's kernels on the card.

    python -m flybody_tpu_torch.tools.kernel_ab --parent DIR [--batch 8192]

DIR is the root of an unpacked earlier tree (for example `git archive` of
the parent commit into a directory that .gitignore lists). Its
csrc/force_stage.cu and csrc/noslip.cu are built into separate libraries
and driven through its own wrappers (ops/force_stage.py, ops/noslip_gs.py,
loaded under other module names), beside this tree's kernels, on the same
operands: the force stage (K2) on a default-preset forward pass's
position-stage outputs of tools/profile_newton.py's walk state and on the
ellipsoid-fluid variant of the model (ops/force_stage.ellipsoid_variant),
the fused noslip (row 11) on both presets' noslip operands (64 and 16
slots; and with the first envs made edge cases of the slot lists and the
guard, `edge_envs`). Per case it prints whether every output is the
earlier kernel's bit for bit (torch.equal, NaN in the same places) and
both kernels' times (CUDA events over --reps calls, tools/profile_engine's
timer), taken in turns: earlier, this, this, earlier. For an output that
differs it prints how many entries do and the largest difference. It
writes chiprun_out/kernel_ab.json and exits 1 if an output differs.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import torch

from flybody_tpu_torch.ops import _cuda


def parent_lib(root: str, name: str) -> ctypes.CDLL:
    """The earlier tree's csrc/<name>.cu built with this tree's nvcc
    command into _build/ (once)."""
    csrc = os.path.join(root, 'flybody_tpu_torch', 'csrc')
    out = os.path.join(_cuda.BUILD, f'libparent_{name}.so')
    if not os.path.exists(out):
        os.makedirs(_cuda.BUILD, exist_ok=True)
        cmd = _cuda._command(name, out)
        cmd[-1] = os.path.join(csrc, f'{name}.cu')
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    return ctypes.CDLL(out)


def parent_module(root: str, name: str):
    """The earlier tree's ops/<name>.py as a module of its own (its
    imports resolve to this tree's package)."""
    path = os.path.join(root, 'flybody_tpu_torch', 'ops', f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'parent_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def library(name: str, lib: ctypes.CDLL):
    """Kernel calls through _cuda.function(name, ...) go to `lib`."""
    saved_lib = _cuda._libs.get(name)
    saved_fns = {k: v for k, v in _cuda._fns.items() if k[0] == name}
    _cuda._libs[name] = lib
    for k in saved_fns:
        del _cuda._fns[k]
    try:
        yield
    finally:
        for k in [k for k in _cuda._fns if k[0] == name]:
            del _cuda._fns[k]
        _cuda._fns.update(saved_fns)
        if saved_lib is None:
            _cuda._libs.pop(name, None)
        else:
            _cuda._libs[name] = saved_lib


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """torch.equal with NaN in the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, torch.zeros_like(a), a),
        torch.where(nb, torch.zeros_like(b), b)))


def edge_envs(nargs) -> tuple:
    """Row 11's operands with the first envs made edge cases of the
    slot lists and the guard: a NaN in the factor; a zero on the factor's
    diagonal (unlisted columns of P overflow); every slot listed (more
    than a chunk at 64 slots); no slot listed; a NaN in an unlisted
    slot's J_t row; an infinite force of an unlisted slot."""
    F, Jt, aref, lim, use, x0, ft0 = (t.clone() for t in nargs)
    F[0, 0, 3, 1] = float('nan')
    F[1, 1, 0, 0] = 0.0
    use[2] = 1.0
    use[3] = 0.0
    for env, what in ((4, 'J'), (5, 'ft')):
        k = int(torch.nonzero(use[env] == 0)[0]) if (use[env] == 0).any() \
            else use.shape[1] - 1
        use[env, k] = 0.0
        if what == 'J':
            Jt[env, k, 0, 7] = float('nan')
        else:
            ft0[env, k, 1] = float('inf')
    return F, Jt, aref, lim, use, x0, ft0


def cases(batch: int, seed: int, root: str):
    """[(name, lib name, earlier fn, this fn)], each fn() one launch."""
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.ops import force_stage as fs
    from flybody_tpu_torch.ops import noslip_gs as ng
    from flybody_tpu_torch.tools import profile_newton as pn
    pfs, png = parent_module(root, 'force_stage'), parent_module(
        root, 'noslip_gs')
    model, part, passes = pn.walk_passes(batch, seed)
    dev, dt = model.device, model.dtype

    def fresh(variant=False):  # separate models: the packs are cached
        arrays, meta = spec.read_npz(spec.WALK_IMITATION_NPZ)
        if variant:
            arrays, meta = fs.ellipsoid_variant(arrays, meta)
        return spec.from_numpy(arrays, meta, device=dev, dtype=dt)

    fargs = pn.force_args(passes['default'][0])
    out = []
    for tag, variant in (('force_stage', False),
                         ('force_stage[ellipsoid fluid]', True)):
        old_m, new_m = fresh(variant), fresh(variant)
        out.append((tag, 'force_stage',
                    lambda m=old_m: pfs.force_stage(m, *fargs),
                    lambda m=new_m: fs.force_stage(m, *fargs)))
    for preset, (d, efc, f_c) in passes.items():
        nargs = pn.noslip_args(d, efc, f_c, preset)
        K = nargs[1].shape[1]
        for tag, a in (('', nargs), (', edge envs', edge_envs(nargs))):
            out.append((f'noslip_fused[{K} slots{tag}]', 'noslip',
                        lambda a=a: png.noslip_fused(part, *a, 3),
                        lambda a=a: ng.noslip_fused(part, *a, 3)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--parent', required=True,
                   help='root of the earlier tree')
    p.add_argument('--batch', type=int, default=8192)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--reps', type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('kernel_ab runs the kernels: it needs a CUDA device')
    from flybody_tpu_torch.tools.profile_engine import _time
    _cuda.build_all()
    libs = {n: parent_lib(args.parent, n) for n in ('force_stage', 'noslip')}
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(f'card: {card}')
    report, ok = dict(card=card, batch=args.batch, cases={}), True
    for name, lib, old, new in cases(args.batch, args.seed, args.parent):
        with library(lib, libs[lib]):
            ref = old()
        got = new()
        torch.cuda.synchronize()
        eq = [same(a, b) for a, b in zip(got, ref)]
        times = {'earlier': [], 'this': []}
        for who in ('earlier', 'this', 'this', 'earlier'):
            if who == 'earlier':
                with library(lib, libs[lib]):
                    times[who].append(_time(old, args.reps, True) * 1e3)
            else:
                times[who].append(_time(new, args.reps, True) * 1e3)
        for i, (a, b) in enumerate(zip(got, ref)):
            if not eq[i]:
                diff = (a.double() - b.double()).abs().nan_to_num(1e300)
                at = torch.nonzero(diff == diff.max())[0].tolist()
                print(f'  output {i}: {int((diff > 0).sum())} of '
                      f'{diff.numel()} entries differ, largest '
                      f'{float(diff.max()):.3e} at {tuple(at)}')
        nan = sum(int(torch.isnan(t).sum()) for t in got)
        report['cases'][name] = dict(bit_equal=eq, nan_entries=nan, **times)
        ok &= all(eq)
        print(f'{name}: outputs bit for bit the earlier kernel\'s: {eq} '
              f'(NaN entries {nan}); ms earlier '
              f'{times["earlier"][0]:.3f} / {times["earlier"][1]:.3f}, '
              f'this {times["this"][0]:.3f} / {times["this"][1]:.3f}')
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'kernel_ab.json'), 'w') as f:
        json.dump(report, f, indent=1)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
