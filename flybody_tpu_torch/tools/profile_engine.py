"""Engine stage profiler: time of each stage of the physics step, and
micro-benches of the dense-matrix kernels, on the walking model.

    python -m flybody_tpu_torch.tools.profile_engine --batch 8192 --iters 50
    python -m flybody_tpu_torch.tools.profile_engine --cpu --batch 64

Counterpart of flybody_tpu/tools/profile_engine.py, with its flags, stage
chain, micro-benches and table. The walking model's state is qpos0 + 0.01
N(0, 1) and qvel 0.1 N(0, 1) (a torch generator seeded with --seed). Each
stage consumes the previous stage's output and is timed alone. The prep
(`prep`) runs the JAX tool's chain with a dense mass matrix (smooth.crb),
so factor_m, solve_m, the Newton solve and euler take the arrow path on an
unpacked M: the arrow factor (row 18 of PERF.md's kernel table) and
substitution (row 19), the Newton solve's fresh arrow steps (K3 with
1 + 3 SB right-hand sides, row 14 on the capacitance, row 15, row 13) and
its reuse iterations (row 10), the packed-factor noslip (row 11), the
sensors (K4) and euler (K3 on the dense damped M). collide is the dense
`collide(compact=False)` of the JAX chain (row 5 on every analytic group,
the merged MPR, row 6, at top-P 128, every slot), and make_efc takes its
contacts (row 7 on the prefilter's candidates). One departure from the JAX
tool: the position stage is one kernel (K1), so the JAX tool's
`kinematics` and `com_pos+cdof` rows are one row here. The last row,
`FULL step`, is one engine.step (the engine's compact path) at a preset
built from the flags, with the Woodbury budget 8 and top-P 128/128 of the
`default` preset.

Times: on the card, CUDA events around `--iters` calls after two warm-up
calls, then a synchronize; on the CPU (--cpu: every kernel's plain
version), the host clock. `steps/s` is batch / the FULL step's time.
"""

from __future__ import annotations

import argparse
import time

import torch


def _time(fn, iters: int, card: bool, warmup: int = 2) -> float:
    """Seconds a call of fn, averaged over `iters` calls: CUDA events on
    the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if card:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--batch', type=int, default=8192)
    p.add_argument('--iters', type=int, default=50)
    p.add_argument('--cpu', action='store_true')
    p.add_argument('--task', default='walk_imitation')
    p.add_argument('--iters-solver', type=int, default=8)
    p.add_argument('--iters-ls', type=int, default=6)
    p.add_argument('--ncon', type=int, default=32)
    p.add_argument('--refactor', type=int, default=2)
    p.add_argument('--noslip-con', type=int, default=16)
    p.add_argument('--seed', type=int, default=0)
    return p


def preset(args) -> dict:
    """The engine preset of the flags (the FULL step's solver setting)."""
    from flybody_tpu_torch.physics import engine
    return dict(engine.PRESETS['default'],
                solver_iterations=args.iters_solver,
                ls_iterations=args.iters_ls, ncon_max=args.ncon,
                refactor_period=args.refactor,
                noslip_contacts=args.noslip_con)


def setup(args):
    """(model, d0): the walking model (float32) on the card or the CPU and
    the perturbed start state of `args.batch` envs (qacc, the Newton
    warmstart, zero)."""
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.physics.state import make_data
    if args.task != 'walk_imitation':
        raise ValueError('only --task walk_imitation is ported')
    model = spec.load(spec.WALK_IMITATION_NPZ,
                      device='cpu' if args.cpu else None)
    B = args.batch
    g = torch.Generator(device='cpu').manual_seed(args.seed)
    d0 = make_data(model, B)
    qpos = d0.qpos + 0.01 * torch.randn(d0.qpos.shape, generator=g).to(
        d0.qpos)
    qvel = 0.1 * torch.randn(d0.qvel.shape, generator=g).to(d0.qvel)
    return model, d0.replace(qpos=qpos, qvel=qvel,
                             qacc=torch.zeros_like(qvel))


def prep(model, d, args):
    """The JAX tool's prep: position, collide, velocities, constraint rows,
    actuation, the dense M and smooth forces, factor_m and
    a_free = solve_m(qfrc_smooth). Returns (data, efc, a_free)."""
    from flybody_tpu_torch.physics import collision as col
    from flybody_tpu_torch.physics import fluid as fl
    from flybody_tpu_torch.physics import kinematics as kin
    from flybody_tpu_torch.physics import smooth as sm
    from flybody_tpu_torch.physics import solver
    d, _, _ = kin.fwd_position_smooth(model, d)
    con = col.collide(model, d, compact=False)
    d = sm.tendon_vel(model, sm.com_vel(model, d))
    efc = solver.make_efc(model, d, con, args.ncon)
    d = sm.actuation(model, d)
    d = fl.fluid(model, sm.passive(model, sm.rne(model, sm.crb(model, d))))
    qfrc_smooth = (d.qfrc_passive + d.qfrc_fluid + d.qfrc_actuator
                   - d.qfrc_bias)
    d = sm.factor_m(model, d.replace(qfrc_smooth=qfrc_smooth))
    a_free = sm.solve_m(model, d, qfrc_smooth)
    return d.replace(contact=con), efc, a_free


def solve(model, d, efc, a_free, args):
    """The Newton solve at the flags (arrow path on the dense M), with the
    default preset's Woodbury budget."""
    from flybody_tpu_torch.physics import engine, solver
    return solver.solve(model, d, efc, a_free, args.iters_solver,
                        args.iters_ls, None, args.refactor,
                        engine.PRESETS['default']['sb_break'])


def noslip(model, d, efc, qacc, args):
    from flybody_tpu_torch.physics import solver
    zero_f = qacc.new_zeros(efc.con_J.shape[:2] + (3,))
    return solver.noslip(model, d, efc, qacc, zero_f, 3, args.noslip_con)


def sensors(model, d, efc, qacc):
    from flybody_tpu_torch.physics import engine
    zero_f = qacc.new_zeros(efc.con_J.shape[:2] + (3,))
    return engine._sensors(model, d.replace(qacc=qacc), efc, zero_f)


def euler(model, d, qacc):
    from flybody_tpu_torch.physics import smooth as sm
    return sm.euler(model, d.replace(
        qacc=qacc, qfrc_constraint=torch.zeros_like(qacc))).qpos


def chain(model, d0, args):
    """One pass of the stage chain from d0: prep, solve, noslip, sensors,
    euler. Returns (data, efc, a_free, qacc, noslip's qacc, qpos)."""
    d, efc, a_free = prep(model, d0, args)
    qacc = solve(model, d, efc, a_free, args)[0]
    qacc_ns = noslip(model, d, efc, qacc, args)[0]
    sensors(model, d, efc, qacc)
    return d, efc, a_free, qacc, qacc_ns, euler(model, d, qacc)


def stages(model, d0, args) -> dict:
    """{row name: seconds a call} for every stage and micro-bench."""
    from flybody_tpu_torch.ops import arrow as ar
    from flybody_tpu_torch.ops import cholesky as ch
    from flybody_tpu_torch.physics import collision as col
    from flybody_tpu_torch.physics import engine, fluid as fl
    from flybody_tpu_torch.physics import kinematics as kin
    from flybody_tpu_torch.physics import smooth as sm
    from flybody_tpu_torch.physics import solver
    it = args.iters
    few = max(5, it // 5)
    card = d0.qpos.device.type == 'cuda'

    def T(fn, n):
        return _time(fn, n, card)

    d_pos = kin.fwd_position_smooth(model, d0)[0]
    con = col.collide(model, d_pos, compact=False)
    d_vel = sm.tendon_vel(model, sm.com_vel(model, d_pos))
    d_crb = sm.crb(model, d_vel)
    d, efc, a_free = prep(model, d0, args)
    qacc = solve(model, d, efc, a_free, args)[0]

    r = {}
    r['position (K1)'] = T(lambda: kin.fwd_position_smooth(model, d0),
                               it)
    r['collide'] = T(lambda: col.collide(model, d_pos, compact=False), it)
    r['com_vel+tendon'] = T(
        lambda: sm.tendon_vel(model, sm.com_vel(model, d_pos)), it)
    r['make_efc'] = T(
        lambda: solver.make_efc(model, d_vel, con, args.ncon), it)
    r['crb(M)'] = T(lambda: sm.crb(model, d_vel), it)
    r['rne(bias)'] = T(lambda: sm.rne(model, d_crb), it)
    r['passive'] = T(lambda: sm.passive(model, d_crb), it)
    r['fluid'] = T(lambda: fl.fluid(model, d_crb), it)
    r['factor_m(arrow)'] = T(lambda: sm.factor_m(model, d_crb), it)
    r['solver(newton)'] = T(
        lambda: solve(model, d, efc, a_free, args), few)
    r['noslip'] = T(lambda: noslip(model, d, efc, qacc, args), few)
    r['sensors'] = T(lambda: sensors(model, d, efc, qacc), it)
    r['euler'] = T(lambda: euler(model, d, qacc), it)

    # Kernel micro-benches on the live dense M (arrow-patterned, so the
    # arrow factorization is exact).
    H, g = d.qM.contiguous(), a_free.contiguous()
    part = ar.build_partition(model.meta)
    L = ch.chol(H)
    r['[chol factor]'] = T(lambda: ch.chol(H), it)
    r['[chol solve-1rhs]'] = T(lambda: ch.cho_solve(L, g), it)
    r['[chol fused f+s]'] = T(lambda: ch.chol_solve(H, g), it)
    F = ar.factor(part, H)
    g25 = g[:, :, None].expand(g.shape + (25,)).contiguous()
    r['[arrow factor]'] = T(lambda: ar.factor(part, H), it)
    r['[arrow solve-1rhs]'] = T(lambda: ar.solve(part, F, g), it)
    r['[arrow fused f+s]'] = T(lambda: ar.factor_solve(part, H, g), it)
    r['[arrow solve-25rhs]'] = T(lambda: ar.solve(part, F, g25), it)

    cfg = preset(args)
    r['FULL step'] = T(lambda: engine.step(model, d0, cfg), few)
    return r


def table(results: dict, batch: int, platform: str, iters: int) -> str:
    t_full = results['FULL step']
    known = sum(v for k, v in results.items()
                if k != 'FULL step' and not k.startswith('['))
    lines = [f'batch={batch} platform={platform} ({iters} iters)',
             f'{"stage":<20} {"ms":>9} {"% of step":>10}']
    for k, v in results.items():
        lines.append(f'{k:<20} {v * 1e3:>9.3f} {100 * v / t_full:>9.1f}%')
    lines.append(f'{"solver+rest (resid)":<20} {(t_full - known) * 1e3:>9.3f}'
                 f' {100 * (1 - known / t_full):>9.1f}%')
    lines.append(f'steps/s (physics substeps x batch): {batch / t_full:,.0f}')
    return '\n'.join(lines)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    model, d0 = setup(args)
    results = stages(model, d0, args)
    platform = ('cpu' if args.cpu else
                f'gpu ({torch.cuda.get_device_name(0)})')
    print(table(results, args.batch, platform, args.iters), flush=True)
    return results


if __name__ == '__main__':
    main()
