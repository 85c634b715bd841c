"""Newton-solve-only profiler: the time of solver.solve at walking states.

    python -m flybody_tpu_torch.tools.profile_newton --batch 8192 --iters 10
    python -m flybody_tpu_torch.tools.profile_newton --cpu --batch 64

Counterpart of flybody_tpu/tools/profile_newton.py, with its flags. It
prepares the scene once with tools/profile_engine.py's `setup` and `prep`
(the dense mass matrix, so the solve takes the arrow path on an unpacked M:
fresh arrow steps and the reuse kernel, row 10 of PERF.md's kernel table)
and times only the contact solve: CUDA events on the card, the host clock
on the CPU. The JAX tool's host-sync round trip does not exist here, so it
has no --rtt row.
"""

from __future__ import annotations

import argparse

import torch

from flybody_tpu_torch.tools import profile_engine as pe


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--batch', type=int, default=8192)
    p.add_argument('--iters', type=int, default=10)
    p.add_argument('--cpu', action='store_true')
    p.add_argument('--iters-solver', type=int, default=8)
    p.add_argument('--iters-ls', type=int, default=6)
    p.add_argument('--ncon', type=int, default=24)
    p.add_argument('--refactor', type=int, default=8)
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)
    args.task = 'walk_imitation'
    model, d0 = pe.setup(args)
    d, efc, a_free = pe.prep(model, d0, args)
    t = pe._time(lambda: pe.solve(model, d, efc, a_free, args), args.iters,
                 not args.cpu)
    platform = ('cpu' if args.cpu else
                f'gpu ({torch.cuda.get_device_name(0)})')
    print(f'batch={args.batch} platform={platform} '
          f'solver_iters={args.iters_solver} ls={args.iters_ls} '
          f'ncon={args.ncon} refactor={args.refactor}')
    print(f'solve              {t * 1e3:9.3f} ms')
    return t


if __name__ == '__main__':
    main()
