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

--phases (card only) reads kernels' phase clocks instead, per mode at the
main path's shapes, from a walk_imitation state perturbed as
chip_smoke.py's kernel phase perturbs it: the Newton block kernel (row 8)
and the block-full mode (row 9) on a default-preset forward pass, the
whole solve (row 9) on a bench-preset one, and the reuse iterations (row
10) on tools/profile_engine.py's chain (kernel_ab.unpacked_operands: its
first reuse launch, dense M, K 32, 3 SB 24, L 204, ls 6, at its one
iteration and at three) (ops/newton_fused.PHASES); the
position stage (K1) on that state's qpos (ops/pos_stage.PHASES); the
force stage (K2) on that default forward pass's position-stage outputs
(ops/force_stage.PHASES); the fused noslip (row 11) on each forward
pass's noslip operands, 64 slots (default) and 16 (bench)
(ops/noslip_gs.PHASES), with the histogram of slots each env sweeps;
the arrow factor+solve (K3, its packed one-right-hand-side kernel) on
that default forward pass's free-acceleration operand, qM and
qfrc_smooth (ops/arrow.PHASES); the sensor stage (K4) on that forward
pass's sensor operands (ops/sens_stage.PHASES); the contact rows (row
7) on each preset's candidates of that forward pass's geometry (C 430, K
64; C 222, K 24) and on the dense make_efc's (C 2,048, K 64)
(ops/efc_stage.PHASES); the dense factor+solve (row 17) and the
many-right-hand-side solve (row 16) on the two-fly scene's operands two
substeps from its flailing start at batch / 2 scenes (tools/kernel_ab.py's
two_fly_state and dense_operands): row 17 on a default substep's M, first
Newton Hessian and damped Euler matrix, row 16 on the default and bench
noslip's M^-1 J_t^T, m 128 and 32, row 15 on a bench substep 8 substeps in
(n 216); the factor (row 14) and row 15 on tools/profile_engine.py's chain
at --batch (kernel_ab.unpacked_operands: row 14 on the capacitance, n 24,
and the dense M, n 108; row 15 on the capacitance's solve and on M's
factor with qfrc_smooth) (ops/cholesky.PHASES); K3's dense form on that
chain's first fresh arrow Newton step (m 25) and its euler (m 1)
(ops/arrow.PHASES); the line search (row 13) on the two-fly default
substep's first search (L 408, K 64, ls 8), the bench one's 8 substeps in
(K 24, ls 6) and the chain's first (L 204, K 32, ls 6), with the share of
limit rows it keeps (ops/linesearch.PHASES); the analytic narrowphase
(row 5) on the default forward pass's geometry, the compact collide's
segments (174 slots) and the dense collide's (1,213), each env's cycles
summed over its pairs' threads (ops/narrowphase.PHASES); the per-type-pair
MPR (row 20) on each of the seven groups' candidates of
tools/profile_collide.py's state (profile_collide.mpr_groups), clocked per
candidate, every --stride-th one, an env's cycles being P candidates'
(ops/mpr_kernel.PHASES).
--modes picks some of block, block_full, whole, reuse, pos_stage, force_stage,
noslip_fused, arrow_factor_solve, sens_stage, efc_contacts, chol_solve,
cho_solve_multi, chol, cho_solve, arrow_dense, line_search, narrowphase,
mpr_pair.
Per mode it prints the registers, shared memory, blocks an SM and grid of
the kernel, its time (CUDA events around back-to-back calls, and beside
it the kernels' device time, the same calls queued behind a sleep of the
card, and the wrapper's host time: tools/device_time.py), and the cycles
of each phase per env, averaged over every --stride-th env, with their
shares; it writes the tables to chiprun_out/profile_newton_phases.json.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from flybody_tpu_torch.tools import profile_engine as pe


MODES = ('block', 'block_full', 'whole', 'reuse', 'pos_stage',
         'force_stage', 'noslip_fused', 'arrow_factor_solve', 'sens_stage',
         'efc_contacts', 'chol_solve', 'cho_solve_multi', 'chol',
         'cho_solve', 'arrow_dense', 'line_search', 'narrowphase',
         'mpr_pair')
# two flies'
DENSE_MODES = ('chol_solve', 'cho_solve_multi', 'cho_solve', 'line_search')
# tools/profile_engine.py's chain
UNPACKED_MODES = ('chol', 'cho_solve', 'arrow_dense', 'line_search',
                  'reuse')


def walk_passes(batch: int, seed: int):
    """(model, part, {preset: (d, efc, f_c)}): a default- and a
    bench-preset forward pass (engine.fwd_acc) of a walk_imitation state
    perturbed as chip_smoke.py's kernel phase perturbs it."""
    from flybody_tpu_torch.envs import fly_envs
    from flybody_tpu_torch.ops import arrow
    from flybody_tpu_torch.physics import engine
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
    return model, arrow.build_partition(meta), {
        preset: engine.fwd_acc(model, data_in, engine.PRESETS[preset])
        for preset in ('default', 'bench')}


def force_args(d) -> tuple:
    """K2's operands (after the model) from a forward pass's data."""
    return tuple(t.contiguous() for t in (
        d.qpos, d.qvel, d.act, d.ctrl, d.cdof, d.cinert, d.xipos, d.ximat,
        d.subtree_com, d.geom_xpos, d.geom_xmat, d.ten_length))


def noslip_args(d, efc, f_c, preset) -> tuple:
    """Row 11's operands (after the partition) on the preset's slots."""
    from flybody_tpu_torch.physics import engine, solver
    return solver.noslip_operands(d.qLD, efc, d.qacc, f_c,
                                  engine.PRESETS[preset]['noslip_contacts'])


def newton_operands(part, passes):
    """{mode: (kernel, args without the trip counts, ls, iters)} for the
    three Newton modes the walk_imitation presets launch."""
    from flybody_tpu_torch.ops import arrow
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.physics import engine, solver
    modes = {}
    for preset, (d, efc, _) in passes.items():
        cfg = engine.PRESETS[preset]
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
    return modes


def phase_operands(batch: int, seed: int):
    """(part, {mode: (kernel, args without the trip counts, ls, iters)})
    for the three Newton modes the walk_imitation presets launch."""
    _, part, passes = walk_passes(batch, seed)
    return part, newton_operands(part, passes)


def kernel_runs(batch: int, seed: int, modes=MODES) -> dict:
    """{table: (fn, phases module, resources, histogram)} for the kernels
    of `modes` on the walk_imitation presets' forward passes (and the
    two-fly scene's, dense_runs); fn() launches the kernel once;
    histogram: envs by listed slots (row 11)."""
    from flybody_tpu_torch.ops import arrow as ar
    from flybody_tpu_torch.ops import force_stage as fs
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.ops import noslip_gs as ng
    from flybody_tpu_torch.ops import pos_stage as ps
    from flybody_tpu_torch.ops import sens_stage as ss
    out = dense_runs(batch // 2, seed, modes)
    out.update(unpacked_runs(batch, seed, modes))
    if 'mpr_pair' in modes:
        out.update(mpr_pair_runs(batch, seed))
    if not set(modes) - set(DENSE_MODES) - set(UNPACKED_MODES) - {
            'mpr_pair'}:
        return out
    model, part, passes = walk_passes(batch, seed)
    for mode, (kern, args, ls, it) in newton_operands(part, passes).items():
        if mode not in modes:
            continue
        if mode == 'block':  # (.., Hp, M, conJ, U, ..)
            K, SB3 = args[5].shape[1], args[6].shape[1]
        else:  # (.., M, conJ, bsel, ..)
            K, SB3 = args[4].shape[1], 3 * args[5].shape[1]
        info = dict(nf.kernel_info(mode, part, batch, K, SB3, len(args[1])),
                    K=K, SB3=SB3, ls=ls, iterations=it)
        out[mode] = (lambda kern=kern, args=args, ls=ls, it=it:
                     kern(*args, ls, it), nf, info, None)
    if 'pos_stage' in modes:
        qpos = passes['default'][0].qpos.contiguous()
        out['pos_stage'] = (lambda: ps.pos_stage(model, qpos), ps,
                            ps.kernel_info(model, batch), None)
    if 'force_stage' in modes:
        fargs = force_args(passes['default'][0])
        out['force_stage'] = (lambda: fs.force_stage(model, *fargs), fs,
                              fs.kernel_info(model, batch), None)
    if 'noslip_fused' in modes:
        for preset, (d, efc, f_c) in passes.items():
            nargs = noslip_args(d, efc, f_c, preset)
            ns = nargs[1].shape[1]
            hist = torch.bincount((nargs[4] > 0).sum(1).cpu(),
                                  minlength=ns + 1).tolist()
            out[f'noslip_fused[{ns} slots]'] = (
                lambda nargs=nargs: ng.noslip_fused(part, *nargs, 3), ng,
                dict(ng.kernel_info(part, batch, ns), K=ns, sweeps=3), hist)
    if 'arrow_factor_solve' in modes:
        d = passes['default'][0]
        A, b = d.qM.contiguous(), d.qfrc_smooth.contiguous()
        out['arrow_factor_solve'] = (lambda: ar.factor_solve(part, A, b),
                                     ar, ar.kernel_info(part, batch), None)
    if 'sens_stage' in modes:
        sargs = ss.operands(*passes['default'])
        K = sargs[-1].shape[1]
        out['sens_stage'] = (lambda: ss.sens_stage(model, *sargs), ss,
                             dict(ss.kernel_info(model, K, batch), K=K),
                             None)
    out.update(efc_runs(model, passes['default'][0], batch, modes))
    if 'narrowphase' in modes:
        out.update(narrow_runs(model, passes['default'][0], batch))
    return out


def narrow_runs(model, d, batch: int) -> dict:
    """kernel_runs' entries of row 5 on the geometry of d: the compact
    collide's segments and the dense collide's."""
    from flybody_tpu_torch.ops import narrowphase as nk
    from flybody_tpu_torch.physics import collision
    out = {}
    for what, segs in (('compact', collision.dense_segments(model.meta)),
                       ('dense', collision.analytic_segments(model.meta,
                                                             False))):
        a = (segs, d.geom_xpos, d.geom_xmat, model.geom_size)
        P, S = sum(len(g1) for _, g1, _, _ in segs), nk.n_slots(segs)
        out[f'narrowphase[{what}, {S} slots]'] = (
            lambda a=a: nk.narrowphase(*a), nk,
            dict(nk.kernel_info(segs, batch), P=P, S=S), None)
    return out


def mpr_pair_runs(batch: int, seed: int) -> dict:
    """kernel_runs' entries of row 20 on tools/profile_collide.py's state
    (qpos0 + 0.01 N(0, 1)): each of the seven groups' launch
    (profile_collide.mpr_groups). Its clocks are per candidate
    (info['clock_items']: the B P candidates; info['per_env']: P)."""
    from flybody_tpu_torch.ops import mpr_kernel as mk
    from flybody_tpu_torch.tools import profile_collide as pc
    model, d = pc.setup(pc.parser().parse_args(
        ['--batch', str(batch), '--seed', str(seed)]))
    out = {}
    for key, pol, (c1, c2, prm) in pc.mpr_groups(model, d):
        P = c1.shape[1]
        out[f'mpr_pair[{key}]'] = (
            lambda key=key, pol=pol, a=(c1, c2, prm):
            mk.mpr_pair(*key, pol, *a), mk,
            dict(mk.pair_info(*key, batch * P), P=P, polish=pol,
                 clock_items=batch * P, per_env=P), None)
    return out


def dense_runs(batch: int, seed: int, modes) -> dict:
    """kernel_runs' entries of rows 17, 16 and 15 on the two-fly scene at
    `batch` scenes (info['batch'])."""
    from flybody_tpu_torch.ops import cholesky as ch
    from flybody_tpu_torch.tools import kernel_ab as ab
    if not set(modes) & set(DENSE_MODES):
        return {}
    model, data = ab.two_fly_state(batch, seed)[:2]
    ops = ab.dense_operands(model, data)
    out = {}
    if 'chol_solve' in modes:
        for what, A, b in ops['chol_solve']:
            n = A.shape[1]
            out[f'chol_solve[{what}]'] = (
                lambda A=A, b=b: ch.chol_solve(A, b), ch,
                dict(ch.kernel_info(batch, n), n=n, batch=batch), None)
    if 'cho_solve_multi' in modes:
        for L, R in ops['cho_solve_multi']:
            n, m = R.shape[1:]
            out[f'cho_solve_multi[m {m}]'] = (
                lambda L=L, R=R: ch.cho_solve_multi(L, R), ch,
                dict(ch.kernel_info(batch, n, m), n=n, m=m, batch=batch),
                None)
    if 'cho_solve' in modes:
        L, g = ops['cho_solve']
        n = L.shape[1]
        out[f'cho_solve[n {n}, bench, 8 substeps in]'] = (
            lambda: ch.cho_solve(L, g), ch,
            dict(ch.kernel_info(batch, n, row=15), n=n, batch=batch), None)
    if 'line_search' in modes:
        for what, a in ops['line_search']:
            out[f'line_search[{what}]'] = ls_run(a, batch)
    return out


def ls_run(a, batch: int):
    """kernel_runs' entry of row 13 on its operands a (lim, con, sc,
    expand, ls) at `batch` envs."""
    from flybody_tpu_torch.ops import linesearch as lsm
    L, K = a[0].shape[2], a[1].shape[2]
    live = lsm.live_rows(a[0], a[3]).double().mean().item()
    return (lambda: lsm.line_search(*a), lsm,
            dict(lsm.kernel_info(batch, L, K), L=L, K=K, ls=a[4],
                 batch=batch, live_rows=live), None)


def unpacked_runs(batch: int, seed: int, modes) -> dict:
    """kernel_runs' entries of rows 13-15, K3's dense form and row 10 on
    tools/profile_engine.py's chain (kernel_ab.unpacked_operands: n 24
    and 108; m 25 and 1; L 204, K 32; the first reuse launch, dense M,
    at its one iteration and at three)."""
    from flybody_tpu_torch.ops import arrow as ar
    from flybody_tpu_torch.ops import cholesky as ch
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.tools import kernel_ab as ab
    if not set(modes) & set(UNPACKED_MODES):
        return {}
    ops = ab.unpacked_operands(batch, seed)
    out = {}
    if 'chol' in modes:
        for what, A in ops['chol']:
            n = A.shape[1]
            out[f'chol[n {n}, {what}]'] = (
                lambda A=A: ch.chol(A), ch,
                dict(ch.kernel_info(batch, n, row=14), n=n), None)
    if 'cho_solve' in modes:
        for what, (L, b) in ops['cho_solve']:
            n = L.shape[1]
            out[f'cho_solve[n {n}, {what}]'] = (
                lambda L=L, b=b: ch.cho_solve(L, b), ch,
                dict(ch.kernel_info(batch, n, row=15), n=n), None)
    if 'arrow_dense' in modes:
        for what, (part, A, b) in ops['factor_solve']:
            m = 1 if b.dim() == 2 else b.shape[2]
            out[f'arrow_dense[m {m}, {what}]'] = (
                lambda p=part, A=A, b=b: ar.factor_solve(p, A, b), ar,
                dict(ar.kernel_info(part, batch, m), m=m), None)
    if 'line_search' in modes:
        out['line_search[unpacked chain]'] = ls_run(ops['line_search'],
                                                    batch)
    if 'reuse' in modes:
        a = ops['reuse']
        part, ls = a[0], a[-2]
        K, SB3, L = a[5].shape[1], a[7].shape[1], len(a[1])
        for it in (a[-1], 3):
            out[f'reuse[dense M, {it} iteration{"s" if it > 1 else ""}]'] = (
                lambda it=it: nf.reuse(*a[:-1], it), nf,
                dict(nf.kernel_info('reuse', part, batch, K, SB3, L), K=K,
                     SB3=SB3, L=L, ls=ls, iterations=it), None)
    return out


def efc_runs(model, d, batch: int, modes) -> dict:
    """kernel_runs' entries of row 7 on the geometry of d."""
    from flybody_tpu_torch.ops import efc_stage as ef
    from flybody_tpu_torch.physics import collision, engine, solver
    out = {}
    if 'efc_contacts' in modes:
        runs = []
        for preset in ('default', 'bench'):
            cfg = engine.PRESETS[preset]
            con = collision.collide(model, d, cfg['mpr_top_p'],
                                    cfg['cc_top_p'])
            runs.append((solver.contact_candidates(model, con),
                         cfg['ncon_max']))
        con = collision.collide(model, d, compact=False)
        runs.append((solver.contact_candidates(model, con, 64), 64))
        for cand, K in runs:
            C = cand[0].shape[1]
            out[f'efc_contacts[C {C}, K {K}]'] = (
                lambda cand=cand, K=K: ef.contact_rows(model, d, *cand, K),
                ef, dict(ef.kernel_info(batch, C, K, model.meta), C=C,
                         K=K), None)
    return out


def phase_tables(batch: int, seed: int, stride: int, iters: int,
                 modes=MODES) -> dict:
    """Per mode: the kernel's resources and time and its phase cycles."""
    from flybody_tpu_torch.tools import device_time
    out = {}
    for name, (fn, mod, info, hist) in kernel_runs(batch, seed,
                                                   modes).items():
        ms = pe._time(fn, iters, True) * 1e3
        rd = device_time.readings(fn, iters)
        clk = mod.record_phases(
            fn, info.get('clock_items', info.get('batch', batch)), stride,
            torch.device('cuda')).double()
        # per-candidate clocks (row 20): an env's are P candidates'
        cyc = clk.mean(0) * info.get('per_env', 1)
        total = float(cyc.sum())
        out[name] = dict(ms=ms, device_ms=rd['device_ms'],
                         queued_ms=rd['queued_ms'], host_ms=rd['host_ms'],
                         sampled_envs=clk.shape[0], cycles_per_env=total,
                         phases={p: dict(cycles=float(c),
                                         share=float(c) / total)
                                 for p, c in zip(mod.PHASES, cyc)},
                         **info)
        if hist is not None:
            out[name]['listed_slots_histogram'] = hist
    return out


def print_tables(tables: dict, batch: int):
    from flybody_tpu_torch.tools import device_time
    for mode, r in tables.items():
        shape = ', '.join(f'{k} {r[k]}' for k in ('C', 'L', 'K', 'SB3', 'ls',
                                                  'iterations', 'sweeps', 'n',
                                                  'm', 'live_rows', 'P', 'S',
                                                  'polish')
                          if k in r)
        sampled = (f'{r["sampled_envs"]} candidates sampled'
                   if 'per_env' in r else
                   f'{r["sampled_envs"]} envs sampled')
        print(f'{mode}: {shape + "; " if shape else ""}{r["ms"]:.3f} ms at '
              f'batch {r.get("batch", batch)} (device '
              f'{device_time.fmt(r["device_ms"])}, queued '
              f'{device_time.fmt(r["queued_ms"])}, wrapper host '
              f'{r["host_ms"]:.4f}); '
              f'{r["registers"]} registers, '
              f'{r["smem_bytes"]} B shared a block, {r["blocks_per_sm"]} '
              f'blocks an SM, grid {r["grid"]}; {r["cycles_per_env"]:.0f} '
              f'cycles an env ({sampled})')
        for p, v in r['phases'].items():
            print(f'  {p:22s} {v["cycles"]:12.0f} {100 * v["share"]:6.1f}%')
        if 'listed_slots_histogram' in r:
            h = r['listed_slots_histogram']
            print('  envs by listed slots: ' + ', '.join(
                f'{n}: {c}' for n, c in enumerate(h) if c))


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
    p.add_argument('--modes', nargs='+', choices=MODES, default=MODES,
                   help='--phases: the kernels to read')
    args = p.parse_args(argv)
    if args.phases:
        if args.cpu or not torch.cuda.is_available():
            raise SystemExit('--phases reads the kernels\' clocks: it needs '
                             'a CUDA device')
        tables = phase_tables(args.batch, args.seed, args.stride, args.iters,
                              args.modes)
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
