"""Collide-stage micro-profiler: per-group narrowphase times at batch.

    python -m flybody_tpu_torch.tools.profile_collide --batch 8192
    python -m flybody_tpu_torch.tools.profile_collide --cpu --batch 64

Counterpart of flybody_tpu/tools/profile_collide.py, with its flags (and
--seed). The walking model's state is qpos0 + 0.01 N(0, 1) (a torch
generator seeded with --seed) after its position stage. One line per pair
group (collision.pair_tables order), `key n=<pairs>`: a single-row group
that is not a plane's and has more than MPR_TOP_P (64) pairs runs
`collision.mpr_topp` (the bounding-sphere top 64, its narrowphase, the
scatter back), every other group `handler(key)(gather_group(...))` on all
its pairs. An MPR group's narrowphase is the per-type-pair MPR (kernel 20
of PERF.md's table), an analytic group's its plain row formulas. The last
line, `FULL collide`, is the dense `collide(compact=False)`. Times: CUDA
events on the card, the host clock on the CPU (--cpu: every kernel's plain
version; tools/profile_engine._time).
"""

from __future__ import annotations

import argparse

import torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--batch', type=int, default=8192)
    p.add_argument('--iters', type=int, default=20)
    p.add_argument('--cpu', action='store_true')
    p.add_argument('--seed', type=int, default=0)
    return p


def setup(args):
    """(model, data): the walking model (float32) on the card or the CPU,
    position stage done, at qpos0 + 0.01 N(0, 1)."""
    from flybody_tpu_torch.physics import kinematics as kin
    from flybody_tpu_torch.tools import profile_engine as pe
    args.task = 'walk_imitation'
    model, d0 = pe.setup(args)
    return model, kin.fwd_position_smooth(model, d0)[0]


def group_passes(model) -> dict:
    """{line name: fn(data)} of every pair group's narrowphase, in slot
    order, each from the pose table on (JAX profile_collide.py:57-64)."""
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.physics import collision as col
    out = {}
    for key, (g1, g2, k) in col.pair_tables(model.meta)['groups'].items():
        def f(d, key=key, g1=g1, g2=g2, k=k):
            gcat = col._geom_cat(d)
            if (k == 1 and key[0] != spec.GEOM_PLANE
                    and len(g1) > col.MPR_TOP_P):
                return col.mpr_topp(model, d, key, g1, g2, gcat=gcat)
            return col.handler(key)(col.gather_group(model, gcat, g1, g2))
        out[f'{key} n={len(g1)}'] = f
    return out


def mpr_groups(model, d) -> list:
    """[(key, polish, (c1, c2, prm))] of the seven MPR groups
    (mpr_kernel.PAIRS) on d's geometry: the operands of each group line's
    kernel 20 launch (its MPR_TOP_P pairs by bounding sphere, or all its
    pairs), contiguous, and the polish the handler gives it."""
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.ops import mpr_kernel as mk
    from flybody_tpu_torch.physics import collision as col
    tb = col.pair_tables(model.meta)
    gcat = col._geom_cat(d)
    out = []
    for key in mk.PAIRS:
        g1, g2, _ = tb['groups'][key]
        pg = (col.topp_geo(model, d, g1, g2, gcat)[1]
              if len(g1) > col.MPR_TOP_P
              else col.gather_group(model, gcat, g1, g2))
        out.append((key, 0 if spec.GEOM_CYLINDER in key else 8,
                    tuple(t.contiguous() for t in pg)))
    return out


def collide_pass(model, d) -> dict:
    """{line name: outputs} of one pass of every line: the groups, then
    the FULL collide."""
    from flybody_tpu_torch.physics import collision as col
    out = {name: f(d) for name, f in group_passes(model).items()}
    con = col.collide(model, d, compact=False)
    out['FULL collide'] = (con.dist, con.pos, con.normal)
    return out


def results(model, d, args) -> dict:
    """{line name: seconds a call}."""
    from flybody_tpu_torch.physics import collision as col
    from flybody_tpu_torch.tools import profile_engine as pe
    card = d.qpos.device.type == 'cuda'
    r = {name: pe._time(lambda f=f: f(d), args.iters, card)
         for name, f in group_passes(model).items()}
    r['FULL collide'] = pe._time(
        lambda: col.collide(model, d, compact=False), args.iters, card)
    return r


def table(r: dict, batch: int, platform: str) -> str:
    return '\n'.join([f'batch={batch} platform={platform}'] + [
        f'{k:<28} {v * 1e3:>9.3f} ms' for k, v in r.items()])


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    model, d = setup(args)
    r = results(model, d, args)
    platform = ('cpu' if args.cpu else
                f'gpu ({torch.cuda.get_device_name(0)})')
    print(table(r, args.batch, platform), flush=True)
    return r


if __name__ == '__main__':
    main()
