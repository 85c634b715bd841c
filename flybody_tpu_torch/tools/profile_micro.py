"""Micro-profiler of collide, make_efc and the Newton solve's pieces.

    python -m flybody_tpu_torch.tools.profile_micro --batch 8192 --iters 10
    python -m flybody_tpu_torch.tools.profile_micro --cpu --batch 64

Counterpart of flybody_tpu/tools/profile_micro.py, with its flags (and
--seed) and lines. The walking model's state is qpos0 + 0.01 N(0, 1) and
qvel 0.1 N(0, 1) (a torch generator seeded with --seed) after its
position stage and body velocities. Lines, each printed as it lands:
  * `collide <key> n=<pairs>`: tools/profile_collide.py's group lines
    (MPR groups through the per-type-pair MPR, kernel 20);
  * `efc top_k(64)`: the 64 smallest dist - includemargin of the dense
    collide's slots; `efc full`: make_efc on them (64 slots; row 7 on the
    prefilter's candidates);
  * `factor_m`, `solve_m (vec)`: the arrow factor (row 18) of the dense
    `crb` M and its substitution (row 19) of qfrc_smooth = -qfrc_bias;
  * `newton grad+hess`: the Newton gradient and dense Hessian at a_free
    (plain);
  * `newton chol(H)`, `newton cho_solve`: the dense factor of H + 1e-12 I
    (row 14 at n 108) and its substitution of the gradient (row 15);
  * `solve 8x6`: solver.solve at 8 iterations, 6 line-search steps,
    refactor 1 on the dense M (the arrow path on an unpacked M: K3 with
    1 + 3 SB right-hand sides, rows 14, 15 and 13 a step);
  * `noslip 3`: solver.noslip, 3 sweeps over all slots (row 11 on the
    packed factor).
Times: CUDA events on the card, the host clock on the CPU (--cpu: every
kernel's plain version; tools/profile_engine._time).
"""

from __future__ import annotations

import argparse

import torch


class _Results(dict):
    """Prints each time as it lands (a late failure keeps the earlier
    lines)."""

    def __setitem__(self, k, v):
        print(f'{k:<40} {v * 1e3:>9.3f} ms', flush=True)
        super().__setitem__(k, v)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--batch', type=int, default=8192)
    p.add_argument('--iters', type=int, default=10)
    p.add_argument('--cpu', action='store_true')
    p.add_argument('--seed', type=int, default=0)
    return p


def grad_hess(d, efc, x):
    """The Newton gradient M x - S f_l - J^T f_c and the dense Hessian
    M + J^T (D H) J + the limit diagonal at x (plain; JAX
    profile_micro.py:136-152)."""
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.physics import solver
    M = d.qM
    sign = x.new_tensor(efc.lim_sign)
    jar_l = x[:, efc.lim_dof] * sign - efc.lim_aref
    jar_c = nf.jv(efc.con_J, x) - efc.con_aref
    f_l, f_c = solver._forces(efc, jar_l, jar_c)
    nv = x.shape[-1]
    g = (torch.einsum('bvw,bw->bv', M, x)
         - nf.lim_scatter(nv, efc.lim_dof, f_l * sign) - nf.jtf(efc.con_J,
                                                                f_c))
    hd = efc.lim_D * efc.lim_active * (jar_l < 0)
    Hc = nf.cone_hessian(jar_c, efc.con_mu, efc.con_frictional,
                         efc.con_active) * efc.con_D[..., None, None]
    JH = torch.einsum('bkrs,bksv->bkrv', Hc, efc.con_J)
    H = (M + torch.einsum('bkrv,bkrw->bvw', efc.con_J, JH)
         + torch.diag_embed(nf.lim_scatter(nv, efc.lim_dof, hd)))
    return g, H


def position(model, d0):
    """The position stage (K1) and the body velocities."""
    from flybody_tpu_torch.physics import kinematics as kin
    from flybody_tpu_torch.physics import smooth as sm
    return sm.com_vel(model, kin.fwd_position_smooth(model, d0)[0])


def build(model, d_pos):
    """The operands of the lines after the collide groups, built once in
    the lines' order: {name: value}."""
    from flybody_tpu_torch.ops import cholesky as ch
    from flybody_tpu_torch.physics import collision as col
    from flybody_tpu_torch.physics import smooth as sm
    from flybody_tpu_torch.physics import solver
    con = col.collide(model, d_pos, compact=False)
    efc = solver.make_efc(model, d_pos, con, 64)
    d_crb = sm.rne(model, sm.crb(model, d_pos))
    d_crb = d_crb.replace(qfrc_smooth=-d_crb.qfrc_bias)
    d_fac = sm.factor_m(model, d_crb)
    a_free = sm.solve_m(model, d_fac, d_fac.qfrc_smooth)
    g, H = grad_hess(d_fac, efc, a_free)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    Hj = (H + 1e-12 * eye).contiguous()
    return dict(d_pos=d_pos, con=con, efc=efc, d_crb=d_crb, d_fac=d_fac,
                a_free=a_free, g=g.contiguous(), H=Hj, L=ch.chol(Hj))


def lines(model, ops) -> dict:
    """{line name: fn()} of every line after the collide groups."""
    from flybody_tpu_torch.ops import cholesky as ch
    from flybody_tpu_torch.physics import collision as col
    from flybody_tpu_torch.physics import smooth as sm
    from flybody_tpu_torch.physics import solver
    d_pos, con, efc = ops['d_pos'], ops['con'], ops['efc']
    d_fac, a_free = ops['d_fac'], ops['a_free']
    table = col.efc_slot_table(model)
    return {
        'efc top_k(64)': lambda: col.smallest(con.dist - table[:, 0], 64),
        'efc full': lambda: solver.make_efc(model, d_pos, con, 64),
        'factor_m': lambda: sm.factor_m(model, ops['d_crb']),
        'solve_m (vec)': lambda: sm.solve_m(model, d_fac, a_free),
        'newton grad+hess': lambda: grad_hess(d_fac, efc, a_free),
        'newton chol(H)': lambda: ch.chol(ops['H']),
        'newton cho_solve': lambda: ch.cho_solve(ops['L'], ops['g']),
        'solve 8x6': lambda: solver.solve(model, d_fac, efc, a_free, 8, 6,
                                          None, 1, 8),
        'noslip 3': lambda: solver.noslip(
            model, d_fac, efc, a_free, torch.zeros_like(efc.con_aref), 3,
            None),
    }


def chain(model, d0) -> dict:
    """{line name: outputs} of one pass of every line, as it is built:
    the collide groups, the operands, then each later line once."""
    from flybody_tpu_torch.tools import profile_collide as pc
    d_pos = position(model, d0)
    out = {f'collide {n}': f(d_pos)
           for n, f in pc.group_passes(model).items()}
    ops = build(model, d_pos)
    out.update({n: f() for n, f in lines(model, ops).items()})
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    from flybody_tpu_torch.tools import profile_collide as pc
    from flybody_tpu_torch.tools import profile_engine as pe
    args.task = 'walk_imitation'
    model, d0 = pe.setup(args)
    card = not args.cpu
    platform = ('cpu' if args.cpu else
                f'gpu ({torch.cuda.get_device_name(0)})')
    print(f'batch={args.batch} platform={platform}', flush=True)
    r = _Results()
    ops = build(model, position(model, d0))
    for name, f in pc.group_passes(model).items():
        r[f'collide {name}'] = pe._time(lambda f=f: f(ops['d_pos']),
                                        args.iters, card)
    few = max(2, args.iters // 3)
    for name, f in lines(model, ops).items():
        r[name] = pe._time(f, few if name in ('solve 8x6', 'noslip 3')
                           else args.iters, card)
    print(f'done: batch={args.batch} platform={platform}', flush=True)
    return dict(r)


if __name__ == '__main__':
    main()
