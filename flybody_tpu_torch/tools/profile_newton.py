"""Newton-solve-only profiler: the time of solver.solve at walking states.

    python -m flybody_tpu_torch.tools.profile_newton --batch 8192 --iters 10
    python -m flybody_tpu_torch.tools.profile_newton --cpu --batch 64
    python -m flybody_tpu_torch.tools.profile_newton --phases --batch 8192

Counterpart of flybody_tpu/tools/profile_newton.py, with its flags. It
prepares the scene once with tools/profile_engine.py's `setup` and `prep`
(the dense mass matrix, so the solve takes the arrow path on an unpacked M:
fresh arrow steps and the reuse kernel, row 10 of PERF.md's kernel table)
and times only the contact solve: CUDA events on the card, the host clock
on the CPU. The JAX tool's host-sync round trip does not exist here, so it
has no --rtt row.

--phases (card only) reads the Newton kernels' phase clocks instead, per
mode at the main path's shapes: the block kernel (row 8) and the
block-full mode (row 9) on a default-preset forward pass, the whole solve
(row 9) on a bench-preset one, from a walk_imitation state perturbed as
chip_smoke.py's kernel phase perturbs it. Per mode it prints the
registers, shared memory, blocks an SM and grid of the kernel, its time,
and the cycles of each phase (ops/newton_fused.PHASES) per env, averaged
over every --stride-th env, with their shares; it writes the tables to
chiprun_out/profile_newton_phases.json.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from flybody_tpu_torch.tools import profile_engine as pe


def phase_operands(batch: int, seed: int):
    """(part, {mode: (kernel, args without the trip counts, ls, iters)})
    for the three modes the walk_imitation presets launch."""
    from flybody_tpu_torch.envs import fly_envs
    from flybody_tpu_torch.ops import arrow
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.physics import engine, solver
    env = fly_envs.walk_imitation(functional=True)
    model, meta = env.model, env.model.meta
    g = torch.Generator(device='cpu').manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(model.device)

    state, _ = env.reset(batch, generator=g)
    qpos = state.data.qpos.clone()
    qpos[:, 7:] += randn(batch, meta.nq - 7, scale=0.1)
    data_in = state.data.replace(qpos=qpos, qvel=randn(batch, meta.nv),
                                 act=randn(batch, meta.na, scale=0.2),
                                 ctrl=randn(batch, meta.nu, scale=0.3))
    part = arrow.build_partition(meta)
    modes = {}
    for preset in ('default', 'bench'):
        cfg = engine.PRESETS[preset]
        d, efc, _ = engine.fwd_acc(model, data_in, cfg)
        a_free = arrow.solve_ref(part, d.qLD, d.qfrc_smooth)
        ops = solver.operands(efc, cfg['sb_break'])
        ls = cfg['ls_iterations']
        if preset == 'default':
            st = solver.start_state(part, d.qM, efc, ops, a_free, d.qacc)
            modes['block'] = (nf.newton_block,
                              solver.block_args(part, d.qM, efc, ops, st),
                              ls, 1)
            modes['block_full'] = (nf.newton_block_full,
                                   solver.block_full_args(part, d.qM, efc,
                                                          ops, st), ls, 1)
        else:
            modes['whole'] = (nf.newton_solve,
                              solver.solve_args(part, d.qM, efc, ops,
                                                a_free, d.qacc),
                              ls, cfg['solver_iterations'])
    return part, modes


def phase_tables(batch: int, seed: int, stride: int, iters: int) -> dict:
    """Per mode: the kernel's resources and time and its phase cycles."""
    from flybody_tpu_torch.ops import newton_fused as nf
    part, modes = phase_operands(batch, seed)
    out = {}
    for mode, (fn, args, ls, it) in modes.items():
        if mode == 'block':  # (.., Hp, M, conJ, U, ..)
            K, SB3 = args[5].shape[1], args[6].shape[1]
        else:  # (.., M, conJ, bsel, ..)
            K, SB3 = args[4].shape[1], 3 * args[5].shape[1]
        info = nf.kernel_info(mode, part, batch, K, SB3, len(args[1]))
        ms = pe._time(lambda: fn(*args, ls, it), iters, True) * 1e3
        clk = nf.record_phases(lambda: fn(*args, ls, it), batch, stride,
                               args[3].device).double()
        cyc = clk.mean(0)
        total = float(cyc.sum())
        out[mode] = dict(K=K, SB3=SB3, ls=ls, iterations=it, ms=ms,
                         sampled_envs=clk.shape[0], cycles_per_env=total,
                         phases={p: dict(cycles=float(c),
                                         share=float(c) / total)
                                 for p, c in zip(nf.PHASES, cyc)},
                         **info)
    return out


def print_tables(tables: dict, batch: int):
    for mode, r in tables.items():
        print(f'{mode}: K {r["K"]}, 3SB {r["SB3"]}, ls {r["ls"]}, '
              f'{r["iterations"]} iteration(s); {r["ms"]:.3f} ms at batch '
              f'{batch}; {r["registers"]} registers, {r["smem_bytes"]} B '
              f'shared a block, {r["blocks_per_sm"]} blocks an SM, grid '
              f'{r["grid"]}; {r["cycles_per_env"]:.0f} cycles an env '
              f'({r["sampled_envs"]} envs sampled)')
        for p, v in r['phases'].items():
            print(f'  {p:22s} {v["cycles"]:12.0f} {100 * v["share"]:6.1f}%')


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
    p.add_argument('--phases', action='store_true',
                   help='per-phase cycles of the Newton kernels (card)')
    p.add_argument('--stride', type=int, default=16,
                   help='--phases: record every stride-th env')
    args = p.parse_args(argv)
    if args.phases:
        if args.cpu or not torch.cuda.is_available():
            raise SystemExit('--phases reads the kernels\' clocks: it needs '
                             'a CUDA device')
        tables = phase_tables(args.batch, args.seed, args.stride, args.iters)
        print(f'device {torch.cuda.get_device_name(0)}')
        print_tables(tables, args.batch)
        os.makedirs('chiprun_out', exist_ok=True)
        with open(os.path.join('chiprun_out', 'profile_newton_phases.json'),
                  'w') as f:
            json.dump(dict(device=torch.cuda.get_device_name(0),
                           batch=args.batch, tables=tables), f, indent=1)
        return sum(r['ms'] for r in tables.values()) / 1e3
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
