"""K1-K4 and rows 5-11, 13-17 and 20 against an earlier tree's kernels on the card.

    python -m flybody_tpu_torch.tools.kernel_ab --parent DIR [--batch 8192]

DIR is the root of an unpacked earlier tree (for example `git archive` of
the parent commit into a directory that .gitignore lists). Its
csrc/pos_stage.cu, csrc/narrowphase.cu, csrc/mpr.cu, csrc/efc_stage.cu,
csrc/force_stage.cu, csrc/noslip.cu, csrc/arrow.cu, csrc/sens_stage.cu,
csrc/cholesky.cu, csrc/linesearch.cu and csrc/newton.cu (`KERNELS`) are
built into separate libraries and driven through its own wrappers
(ops/pos_stage.py, ops/narrowphase.py, ops/mpr_kernel.py,
ops/efc_stage.py, ops/force_stage.py, ops/noslip_gs.py, ops/arrow.py,
ops/sens_stage.py, ops/cholesky.py, ops/linesearch.py,
ops/newton_fused.py, loaded under other module names), beside this tree's
kernels, on the same operands: the position stage (K1) on the
walk state of tools/profile_newton.py, on walk_imitation's state after a
control step at each preset, on the two-fly scene two substeps from its
flailing start (batch / 2 scenes) and on edge envs (`pos_edge_envs`); the
analytic narrowphase (row 5) on the geometry the last substep of each
preset's control step handed it (the compact segments), on the dense
segments of the walk state, on the two-fly scene's second substep and on
edge envs (`narrow_edge_envs`); the merged MPR (row 6) on the broadphase
candidates of the walk state at P 128 and P 32 and of the two-fly state at
P 128, and on edge candidates (`mpr_edge_candidates`); the per-type-pair
MPR (row 20, csrc/mpr.cu) on each of the seven groups' candidates
(tools/profile_collide.mpr_groups) of the walk state and of
tools/profile_collide.py's state (qpos0 + 0.01 N(0, 1)), on the seven
together, and on each group of the walk state with edge candidates
(`mpr_pair_edge_candidates`); the contact rows
(row 7) on the candidates of that last substep at each preset (C 430, K 64;
C 222, K 24), on the dense make_efc's (C 2,048, K 64) and on edge scores
(`efc_edge_scores`: ties, -0 / +0, +-inf, NaN and 1e10 at K 1, 24, 64 and
C); the force stage (K2) on a default-preset forward pass's
position-stage outputs and on the ellipsoid-fluid variant of the model
(ops/force_stage.ellipsoid_variant); the fused noslip (row 11) on both
presets' noslip operands (64 and 16 slots; and with the first envs made
edge cases of the slot lists and the guard, `edge_envs`); the arrow
factor+solve (K3, packed, one right-hand side) on the operands the last
substep of each preset's control step gave it (the free acceleration and
Euler's damped solve) and on edge envs (`arrow_edge_envs`), with rows 18
and 19 and K3's four-right-hand-side form on the first of them; the
sensor stage (K4) on the operands of that substep and of the two-fly
scene's second substep, and on edge envs (`sens_edge_envs`); the dense
Cholesky family (`cholesky_cases`, on the two-fly scene two substeps from
its flailing start, batch / 2 scenes): the fused factor+solve (row 17) on
a default substep's M, first Newton Hessian and damped Euler matrix, the
many-right-hand-side solve (row 16) on the default and bench noslip's M^-1
J_t^T (m 128 and 32), the single-right-hand-side solve (row 15) on a bench
substep 8 substeps in and on the default substep's M factored (row 17)
with qfrc_smooth (n 216), and on tools/profile_engine.py's chain
(`unpacked_operands`: the capacitance's solve, n 24, and the dense M's
factor with qfrc_smooth, n 108), and the factor (row 14) on that chain's
capacitance (n 24) and dense M (n 108) and on the two-fly M (n 216, as
smooth.factor_m would factor it); K3's dense form (`arrow_ls_cases`) on
that chain's first fresh arrow Newton step (the Hessian, m 25) and its
Euler solve (the damped M, m 1), and on dense edge envs of both
(`arrow_dense_edge_envs`); the line search (row 13) on the first search
of a two-fly default substep (L 408, K 64, ls 8), of the bench substep 8
substeps in (K 24, ls 6) and of that chain (L 204, K 32, ls 6), and on
edge envs (`ls_edge_envs`), printing the share of limit rows it keeps
(ops/linesearch.live_rows) on each; the Newton kernels (`newton_cases`):
the block (row 8) on a default-preset forward pass's block operands (K 64,
refactor 1), the whole solve (row 9) on a bench-preset one (K 24, 8
iterations, 6 line-search steps) and the block-full mode (row 9) at
default_full (K 64), each on tools/profile_newton.py's walk state
(newton_operands), and the reuse iterations (row 10) on that chain's first
reuse launch (dense M, nv 108, K 32, 3 SB 24, L 204, 6 line-search steps,
one iteration), on the same operands at three iterations, on the packed M
(ops/arrow.pack_sym_ref, the JAX kernel's packed_m form), on edge envs
(`reuse_edge_envs`: a zero reuse gradient with no active contact; no slot
touching the root; a NaN in one J row) with dense M and packed M at three
iterations, and on a ragged batch (`ragged`: batch + 37 envs). Per case it
prints whether every output is the earlier kernel's bit for bit
(`same`: the same bits, NaN in the same places) and both kernels' times (CUDA events
over --reps calls, tools/profile_engine's timer), taken in turns: earlier,
this, this, earlier; then each tree's device time and wrapper host time
a call (tools/device_time.py: the kernels' own durations from the
profiler, and the host clock while the card sleeps). For an output that differs it prints how many entries
do and the largest difference. Rows 16 and 17 were redesigned to sum in
another order, so their cases are judged by `env_share` instead: the share
of envs whose outputs all lie within CHOL_ENV_TOL (row 17) or
SUBST_REL_TOL (row 16) of each index's scale, against the earlier kernel
and against the plain version at float64 (printed beside the earlier
kernel's own share against float64); a case fails when its share against
the earlier kernel is below CHOL_ENV_SHARE, or its share against float64
below both CHOL_ENV_SHARE and the earlier kernel's. Row 20 may round
otherwise than its earlier kernel (no stepping gate reads it), so its
cases are judged by `mpr_pair_judged`: on the seven groups together
the gate of rows 6 and 20 against the plain version and no more near
misses against float64 than the earlier kernel (on the walk state two
wrong controls must fail the gate); on one group the classification and
the gate's float64 rule held to the earlier kernel. Every other case fails
when an output differs. It writes chiprun_out/kernel_ab.json and exits 1
if a case fails.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types

import torch

from flybody_tpu_torch.ops import _cuda


def parent_libs(root: str, names) -> dict:
    """{name: the earlier tree's csrc/<name>.cu built with this tree's nvcc
    command into _build/ (once; one nvcc per source, all started
    together)}. Prints each built kernel's registers (ptxas)."""
    csrc = os.path.join(root, 'flybody_tpu_torch', 'csrc')
    os.makedirs(_cuda.BUILD, exist_ok=True)
    procs = {}
    for name in names:
        out = os.path.join(_cuda.BUILD, f'libparent_{name}.so')
        if not os.path.exists(out):
            cmd = _cuda._command(name, out)
            cmd[-1] = os.path.join(csrc, f'{name}.cu')
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for the earlier {name}.cu:\n'
                               f'{log}')
        entry = None
        for line in log.splitlines():
            if 'Compiling entry function' in line:
                entry = line.split("'")[1]
            elif 'Used' in line and entry:
                print(f'earlier {name}: {entry}: {line.split(": ", 1)[-1]}')
                entry = None
    return {name: ctypes.CDLL(os.path.join(_cuda.BUILD,
                                           f'libparent_{name}.so'))
            for name in names}


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
    """Bit for bit: NaN in the same places, every other entry the same
    bits (so -0 and +0 differ; NaN payloads are not compared)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    a = torch.where(na, torch.zeros_like(a), a)
    b = torch.where(nb, torch.zeros_like(b), b)
    if a.dtype in (torch.float32, torch.float64) and a.dtype == b.dtype:
        bits = torch.int32 if a.dtype == torch.float32 else torch.int64
        a, b = a.contiguous().view(bits), b.contiguous().view(bits)
    return bool(torch.equal(a, b))


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


def pos_edge_envs(qpos) -> torch.Tensor:
    """K1's qpos with the first envs made edge cases: a NaN in the free
    joint's position, a zero free-joint quaternion, a hinge angle of 1e6,
    a NaN hinge angle."""
    q = qpos.clone()
    q[0, 1] = float('nan')
    q[1, 3:7] = 0.0
    q[2, 7] = 1e6
    q[3, 20] = float('nan')
    return q


@contextlib.contextmanager
def recorded(mod, name: str, last: int, keep=()):
    """Calls of mod.<name> in the block: `n`, how many, `args`, clones of
    the arguments of the last `last` of them in call order, and `kept`,
    {call index: clones of its arguments} for the indices in `keep`."""
    orig = getattr(mod, name)
    got = types.SimpleNamespace(n=0, args=[], kept={})

    def copy(x):
        if torch.is_tensor(x):
            return x.clone()
        if type(x).__name__ == 'Data':  # physics/state.Data
            return dataclasses.replace(x, **{
                f.name: getattr(x, f.name).clone()
                for f in dataclasses.fields(x)
                if torch.is_tensor(getattr(x, f.name))})
        return x

    def wrapped(*a):
        if got.n in keep:
            got.kept[got.n] = tuple(copy(x) for x in a)
        got.n += 1
        got.args = (got.args + [tuple(copy(x) for x in a)])[-last:]
        return orig(*a)

    setattr(mod, name, wrapped)
    try:
        yield got
    finally:
        setattr(mod, name, orig)


def walk_states(batch: int, seed: int) -> dict:
    """{preset: (qpos, K3 operands, K4 operands, row 5 operands, row 7
    operands)} of walk_imitation after one control step from reset at each
    preset (seeded uniform actions): the qpos it ends at, the (part, A, b)
    of the last substep's two K3 launches (the free acceleration, Euler's
    damped solve) and the operands (after the model) of its K4 launch, and
    the operands of its row 5 and row 7 launches (row 7's with the model)."""
    from flybody_tpu_torch.envs import fly_envs
    from flybody_tpu_torch.ops import arrow, efc_stage, narrowphase
    from flybody_tpu_torch.ops import sens_stage
    out = {}
    for preset in ('default', 'bench'):
        env = fly_envs.walk_imitation(functional=True, preset=preset)
        g = torch.Generator(device='cpu').manual_seed(seed)
        lo = torch.as_tensor(env.action_min, dtype=torch.float32)
        hi = torch.as_tensor(env.action_max, dtype=torch.float32)
        state, _ = env.reset(batch, generator=g)
        a = (lo + (hi - lo) * torch.rand(batch, len(lo), generator=g)).to(
            state.data.qpos.device)
        with recorded(arrow, 'factor_solve', 2) as k3, \
                recorded(sens_stage, 'sens_stage', 1) as k4, \
                recorded(narrowphase, 'narrowphase', 1) as r5, \
                recorded(efc_stage, 'contact_rows', 1) as r7:
            state, _ = env.step(state, a)
        # Two K3 launches and one K4, row 5 and row 7 launch a substep.
        n = env.n_sub
        assert (k3.n, k4.n, r5.n, r7.n) == (2 * n, n, n, n), (
            k3.n, k4.n, r5.n, r7.n)
        out[preset] = (state.data.qpos.contiguous(), tuple(k3.args),
                       k4.args[0][1:], r5.args[0], r7.args[0])
    return out


def narrow_edge_envs(nargs) -> tuple:
    """Row 5's operands (segs, geom_xpos, geom_xmat, size) with the first
    envs made edge cases: a NaN position of a pair's second geom; every
    cylinder lying on its plane (its axis in the plane, |cos| < 1e-4);
    every capsule-capsule pair's second capsule on its first one's axis
    (coincident axes: the 1e-12 nudge), where the table has that type; a
    sphere exactly on its plane (the plane's frame the identity at the
    origin, the sphere's centre at height r)."""
    from flybody_tpu_torch.model import spec as _s
    segs, xpos, xmat, size = nargs
    xpos, xmat = xpos.clone(), xmat.clone()
    by_key = {key: (g1, g2) for key, g1, g2, _ in segs}
    g2 = segs[0][2][0]
    xpos[0, g2, 0] = float('nan')
    side = torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0],
                         [-1.0, 0.0, 0.0]], device=xmat.device)
    for a, b in zip(*by_key.get((_s.GEOM_PLANE, _s.GEOM_CYLINDER),
                                ((), ()))):
        xmat[1, a] = torch.eye(3, device=xmat.device)
        xmat[1, b] = side
    for a, b in zip(*by_key.get((_s.GEOM_CAPSULE, _s.GEOM_CAPSULE),
                                ((), ()))):
        xpos[2, b], xmat[2, b] = xpos[2, a], xmat[2, a]
    sph = by_key.get((_s.GEOM_PLANE, _s.GEOM_SPHERE))
    if sph:
        pl, sp = sph[0][0], sph[1][0]
        xpos[3, pl] = 0.0
        xmat[3, pl] = torch.eye(3, device=xmat.device)
        xpos[3, sp, 2] = size[sp, 0]
    return segs, xpos.contiguous(), xmat.contiguous(), size


def efc_edge_scores(args, seed: int) -> tuple:
    """Row 7's operands (model, data, cand_b, cand_u, cand_g) with every
    score drawn from 0, -0, +-1e-3, +-inf, NaN and 1e10 (includemargin 0):
    ties, signed zeros, infinities and NaN, as tests/test_torch_gpu.py
    draws them."""
    model, d, cand_b, cand_u, cand_g = args[:5]
    g = torch.Generator(device='cpu').manual_seed(seed)
    choice = torch.tensor([0.0, -0.0, 1e-3, -1e-3, float('inf'),
                           float('-inf'), float('nan'), 1e10])
    cand_b, cand_u = cand_b.clone(), cand_u.clone()
    cand_b[..., 0] = choice[torch.randint(0, len(choice), cand_b.shape[:2],
                                          generator=g)].to(cand_b.device)
    cand_u[..., 0] = 0.0
    return model, d, cand_b, cand_u, cand_g


def arrow_edge_envs(A, b) -> tuple:
    """K3's packed operands with the first envs made edge cases: a NaN
    entry of a limb block; a negative pivot of a limb block and a zero
    one of the root block (both floored at 1e-30)."""
    A = A.clone()
    nl = A.shape[1] - 1
    A[0, 0, 2, 1] = float('nan')
    A[1, 1, 0, 0] = -1.0
    A[2, nl, 0, 0] = 0.0
    return A, b


def sens_edge_envs(args) -> tuple:
    """K4's operands (after the model) with the first envs made edge
    cases: an inactive contact with a NaN force; contacts on the world
    body (either side); both sides of an active contact on one body."""
    args = [t.clone() for t in args]
    cb12, act, fc = args[11], args[12], args[13]
    act[0, 1] = 0.0
    fc[0, 1] = float('nan')
    cb12[1, 0, 0:2] = 0.0
    cb12[1, 1, 2] = 0.0
    act[1, 0:3] = 1.0
    cb12[2, 0, 3] = cb12[2, 1, 3]
    act[2, 3] = 1.0
    fc[2, 3] = torch.tensor([0.5, 0.1, -0.2], device=fc.device)
    return tuple(args)


def two_fly_state(batch: int, seed: int, device='cuda'):
    """(model, data, K4 operands, row 5 operands) of the two-fly scene two
    default-preset substeps from reset with qvel ~ N(0, 1), ctrl ~ U(-1,
    1) (numpy, `seed`); the operands (after the model) of the second
    substep's K4 launch and the operands of its row 5 launch."""
    import numpy as np
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.physics import engine
    from flybody_tpu_torch.physics.state import make_data
    model = spec.load(spec.TWO_FLY_NPZ, device=device)
    rng = np.random.RandomState(seed)
    meta = model.meta
    d = make_data(model, batch).replace(
        qvel=torch.as_tensor(rng.randn(batch, meta.nv), dtype=model.dtype,
                             device=model.device),
        ctrl=torch.as_tensor(rng.uniform(-1.0, 1.0, (batch, meta.nu)),
                             dtype=model.dtype, device=model.device))
    from flybody_tpu_torch.ops import narrowphase, sens_stage
    with recorded(sens_stage, 'sens_stage', 1) as k4, \
            recorded(narrowphase, 'narrowphase', 1) as r5:
        for _ in range(2):
            d = engine.step(model, d, engine.PRESETS['default']).strip()
    assert (k4.n, r5.n) == (2, 2), (k4.n, r5.n)  # one of each a substep
    return model, d, k4.args[0][1:], r5.args[0]


def mpr_edge_candidates(c1, c2, prm) -> tuple:
    """Row 6's operands (B * P >= 512) with edge candidates: in env 0
    coincident centres (the v0 fallback), a separated pair, a spherical
    sphere-ellipsoid pair along the line of centres (degenerate n1), a NaN
    pose; candidates 128-255 all of the most common pair key (one block of
    128 type-uniform), candidates 256-383 cycling through every key present
    (a block of all-different neighbours)."""
    from flybody_tpu_torch.model import spec as _s
    from flybody_tpu_torch.ops import mpr_kernel as mk
    B, P = prm.shape[:2]
    c1, c2, prm = (t.reshape(B * P, -1).clone() for t in (c1, c2, prm))
    c2[0, :3] = c1[0, :3]
    c2[1, :3] = c1[1, :3] + 10.0
    eye = torch.eye(3, dtype=c1.dtype, device=c1.device).flatten()
    c1[2, 3:], c2[2, 3:] = eye, eye
    c2[2, :3] = c1[2, :3] + torch.tensor([0.0, 0.0, 0.008], device=c1.device)
    prm[2, 0:3] = 0.004
    prm[2, 4:7] = 0.006
    prm[2, 8:11] = torch.tensor([float(_s.GEOM_SPHERE),
                                 float(_s.GEOM_ELLIPSOID), 1.0],
                                device=c1.device)
    c1[3, 0] = float('nan')
    keys = mk.pair_keys(prm)
    present = torch.unique(keys)
    top = int(torch.mode(keys).values)
    src = torch.nonzero(keys == top).flatten()[:128]
    dst = torch.arange(128, 128 + len(src), device=c1.device)
    cyc = []
    pools = {int(k): torch.nonzero(keys == k).flatten().tolist()
             for k in present}
    for j in range(128):
        pool = pools[int(present[j % len(present)])]
        cyc.append(pool[(j // len(present)) % len(pool)])
    src = torch.cat([src, torch.as_tensor(cyc, device=c1.device)])
    dst = torch.cat([dst, torch.arange(256, 384, device=c1.device)])
    for t in (c1, c2, prm):
        t[dst] = t[src].clone()
    return tuple(t.reshape(B, P, -1).contiguous() for t in (c1, c2, prm))


def mpr_pair_edge_candidates(c1, c2, prm) -> tuple:
    """Row 20's operands (c1, c2 (B, P, 12), prm (B, P, 8)) with edge
    candidates in env 0: coincident centres (the v0 fallback), a separated
    pair, both frames the identity with geom 2 straight above geom 1 (every
    type's supports along the line of centres lie on it: a degenerate first
    portal), a NaN pose."""
    c1, c2 = c1.clone(), c2.clone()
    c2[0, 0, :3] = c1[0, 0, :3]
    c2[0, 1, :3] = c1[0, 1, :3] + 10.0
    eye = torch.eye(3, dtype=c1.dtype, device=c1.device).flatten()
    c1[0, 2, 3:], c2[0, 2, 3:] = eye, eye
    c2[0, 2, :3] = c1[0, 2, :3] + torch.tensor([0.0, 0.0, 0.008],
                                               device=c1.device)
    c1[0, 3, 0] = float('nan')
    return c1, c2, prm


def mpr_pair_judged(groups, seven: bool, controls: bool):
    """A judge for a row 20 case on `groups` [(type pair, polish, (c1, c2,
    prm))], the outputs concatenated over them. On the seven groups
    together (`seven`) the kernel passes the gate of rows 6 and 20 against
    the plain version (mpr_kernel.passes_gate) and misses no more near
    pairs against the plain version at float64 than the earlier kernel;
    with `controls` (the walk state, where chip_smoke.py holds the gate),
    the two wrong controls (one refinement iteration fewer, the polish off)
    fail the gate. On one group, whose few near pairs the gate (set over
    all seven) does not resolve, its classification agrees on at least
    mpr_kernel.CLASS_SHARE of the pairs and it misses at most
    mpr_kernel.F64_RATIO times the earlier kernel's near misses against
    float64, plus 4 (the gate's float64 rule, held to the earlier
    kernel)."""
    from flybody_tpu_torch.ops import mpr_kernel as mk

    def run(fn):
        outs = [fn(k, p, g) for k, p, g in groups]
        return tuple(torch.cat([o[i] for o in outs], 1) for i in range(3))

    def judge(got, ref):
        runs = {'kernel': got, 'earlier': ref,
                'plain': run(lambda k, p, g: mk.mpr_pair_ref(*k, p, *g))}
        if controls:
            runs['control one refinement iteration fewer'] = run(
                lambda k, p, g: mk.mpr_pair_ref(
                    *k, p, *g, refine_iters=mk._mpr.REFINE_ITERS - 1))
            runs['control polish off'] = run(
                lambda k, p, g: mk.mpr_pair_ref(*k, 0, *g))
        f64 = run(lambda k, p, g: mk.mpr_pair_ref(
            *k, p, *(t.double() for t in g)))
        rd = mk.gate_readings(runs, f64)
        m64 = rd['near_misses_against_float64']
        if seven:
            ok = (mk.passes_gate(rd, 'kernel')
                  and m64['kernel'] <= m64['earlier'])
            ok &= not any(mk.passes_gate(rd, n) for n in runs
                          if n.startswith('control'))
        else:
            ok = (rd['kernel']['class_share'] >= mk.CLASS_SHARE
                  and m64['kernel'] <= mk.F64_RATIO * m64['earlier'] + 4)
        short = {n: dict(class_share=r['class_share'],
                         near_pairs=r['near_pairs'],
                         near_share=r['near_share'])
                 for n, r in rd.items() if n != 'near_misses_against_float64'}
        short['near_misses_against_float64'] = m64
        return ok, short
    return judge


def mpr_pair_cases(states, root: str):
    """Row 20's cases: on each state (name, model, d after its position
    stage) each of the seven groups' launch (profile_collide.mpr_groups)
    and the seven together (with the controls); on the first state each
    group with edge candidates (mpr_pair_edge_candidates)."""
    from flybody_tpu_torch.ops import mpr_kernel as mk
    from flybody_tpu_torch.tools import profile_collide as pc
    pmk = parent_module(root, 'mpr_kernel')
    out = []
    for i, (what, model, d) in enumerate(states):
        groups = pc.mpr_groups(model, d)
        cases = [(f'{what}, {k}, P {g[0].shape[1]}', [(k, p, g)])
                 for k, p, g in groups]
        cases.append((f'{what}, seven groups', groups))
        if i == 0:
            cases += [(f'{what}, {k}, edge candidates',
                       [(k, p, mpr_pair_edge_candidates(*g))])
                      for k, p, g in groups]
        for tag, gs in cases:
            def call(mod, gs=gs):
                outs = [mod.mpr_pair(*k, p, *g) for k, p, g in gs]
                return tuple(torch.cat([o[j] for o in outs], 1)
                             for j in range(3))
            out.append((f'mpr_pair (row 20)[{tag}]', 'mpr',
                        lambda call=call: call(pmk),
                        lambda call=call: call(mk),
                        mpr_pair_judged(gs, len(gs) > 1,
                                        len(gs) > 1 and i == 0)))
    return out


KERNELS = ('pos_stage', 'narrowphase', 'mpr', 'efc_stage', 'force_stage',
           'noslip', 'arrow', 'sens_stage', 'cholesky', 'linesearch',
           'newton')
# chip_smoke.py's limits for rows 16 and 17 (CHOL_ENV_TOL, SUBST_REL_TOL,
# CHOL_ENV_SHARE).
CHOL_ENV_TOL = 1e-3
SUBST_REL_TOL = 1e-3
CHOL_ENV_SHARE = 0.98


def env_share(outs, refs, tol) -> float:
    """Share of envs (axis 0) whose outputs all lie within tol of the
    largest |ref| at their index on axis 1 over the batch (floored at 1e-6
    of the output's largest), outputs flattened past axis 1: chip_smoke.py's
    env_err and share."""
    worst = None
    for o, r in zip(outs, refs):
        if r.dim() == 2:
            o, r = o[..., None], r[..., None]
        o = o.double().flatten(2)
        r = r.double().flatten(2)
        scale = r.abs().amax(dim=(0, 2))
        scale = scale.clamp(min=max(1e-6 * scale.max().item(), 1e-30))
        e = ((o - r).abs() / scale[None, :, None]).flatten(1).amax(1)
        worst = e if worst is None else torch.maximum(worst, e)
    return (worst <= tol).double().mean().item()


def judged(tol, f64_fn):
    """A judge for a redesigned kernel's case: (passes, readings) from its
    outputs and the earlier kernel's, against each other and against
    f64_fn(), the plain version at float64."""
    def judge(got, ref):
        r64 = f64_fn()
        rd = dict(share_vs_earlier=env_share(got, ref, tol),
                  share_vs_float64=env_share(got, r64, tol),
                  earlier_share_vs_float64=env_share(ref, r64, tol))
        ok = (rd['share_vs_earlier'] >= CHOL_ENV_SHARE
              and rd['share_vs_float64'] >= min(
                  CHOL_ENV_SHARE, rd['earlier_share_vs_float64']))
        return ok, rd
    return judge


def dense_operands(tf_model, tf_data) -> dict:
    """Rows 13 and 15-17's operands on the two-fly scene from tf_data:
    {'chol_solve': [(what, A, b)] of a default substep (its M, first Newton
    Hessian and damped Euler matrix), 'cho_solve_multi': [(L, R)] of the
    default and the bench noslip (M^-1 J_t^T, m 128 and 32), 'cho_solve':
    (L, g) of a bench substep 8 substeps in (where half the envs are in
    contact), 'line_search': [(what, (lim, con, sc, expand, ls))] of the
    default substep's first search (L 408, K 64, ls 8) and of that bench
    substep's (K 24, ls 6)}."""
    from flybody_tpu_torch.ops import cholesky as ch
    from flybody_tpu_torch.ops import linesearch as lsm
    from flybody_tpu_torch.physics import engine
    default, bench = engine.PRESETS['default'], engine.PRESETS['bench']
    calls = default['solver_iterations'] + 2
    with recorded(ch, 'chol_solve', 1, keep={0, 1, calls - 1}) as c17, \
            recorded(ch, 'cho_solve_multi', 1) as c16, \
            recorded(lsm, 'line_search', 1, keep={0}) as c13:
        engine.step(tf_model, tf_data, default)
    deeper = tf_data
    for _ in range(6):
        deeper = engine.step(tf_model, deeper, bench).strip()
    with recorded(ch, 'cho_solve', 1, keep={0}) as c15, \
            recorded(ch, 'cho_solve_multi', 1) as c16b, \
            recorded(lsm, 'line_search', 1, keep={0}) as c13b:
        engine.step(tf_model, deeper, bench)
    return {'chol_solve': [(what, *c17.kept[i]) for what, i in (
                ('M', 0), ('Newton Hessian', 1),
                ('M + dt damping', calls - 1))],
            'cho_solve_multi': [c16.args[0], c16b.args[0]],
            'cho_solve': c15.kept[0],
            'line_search': [('two-fly default', c13.kept[0]),
                            ('two-fly bench, 8 substeps in', c13b.kept[0])]}


def unpacked_operands(batch: int, seed: int) -> dict:
    """Rows 13-15's and K3's dense form's operands on
    tools/profile_engine.py's chain (the walking model's dense M, `batch`
    envs): {'chol': [(what, A)] of the capacitance (n 24) and M (n 108),
    'cho_solve': [(what, (L, b))] of the capacitance's solve (its factor,
    U t) and M's factor with qfrc_smooth, 'factor_solve': [(what, (part,
    A, b))] of the first fresh arrow Newton step (the Hessian, 1 + 3 SB
    right-hand sides) and of euler (the damped M, one right-hand side),
    'line_search': (lim, con, sc, expand, ls) of the first search (L 204,
    K 32), 'reuse': the arguments of the first reuse launch (row 10: dense
    M, K 32, 3 SB 24, L 204, ls 6, one iteration)}."""
    from flybody_tpu_torch.ops import arrow as ar
    from flybody_tpu_torch.ops import cholesky as ch
    from flybody_tpu_torch.ops import linesearch as lsm
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.tools import profile_engine as pe
    args = pe.parser().parse_args(['--batch', str(batch), '--seed',
                                   str(seed)])
    model, d0 = pe.setup(args)
    with recorded(ch, 'chol', 1, keep={0}) as c14, \
            recorded(ch, 'cho_solve', 1, keep={0}) as c15, \
            recorded(ar, 'factor_solve', 1, keep={0}) as k3, \
            recorded(lsm, 'line_search', 1, keep={0}) as c13, \
            recorded(nf, 'reuse', 1, keep={0}) as c10:
        d = pe.chain(model, d0, args)[0]
    M, b = d.qM.contiguous(), d.qfrc_smooth.contiguous()
    return {'chol': [('capacitance', c14.kept[0][0]), ('M', M)],
            'cho_solve': [('capacitance', c15.kept[0]),
                          ('M, qfrc_smooth', (ch.chol(M), b))],
            'factor_solve': [('Newton Hessian', k3.kept[0]),
                             ('euler', k3.args[-1])],
            'line_search': c13.kept[0],
            'reuse': c10.kept[0]}


def arrow_dense_edge_envs(part, A, b) -> tuple:
    """K3's dense operands with the first envs made edge cases: a NaN in
    one triangle of a limb block; a negative pivot of a limb block; a zero
    pivot of the root block; an asymmetric limb entry (the
    symmetrization's order shows); an infinite border entry; a NaN
    between two limbs, where no kernel reads."""
    A = A.clone()
    lo0, lo1 = part.los[0], part.los[1]
    A[0, lo0 + 2, lo0 + 1] = float('nan')
    A[1, lo0, lo0] = -1.0
    A[2, 0, 0] = 0.0
    A[3, lo0 + 3, lo0 + 1] += 1e-3 * A[3, lo0 + 3, lo0 + 3].abs()
    A[4, 2, lo1] = float('inf')
    A[5, lo0, lo1] = float('nan')
    return A, b


def ls_edge_envs(lim, con, sc, expand_iters) -> tuple:
    """Row 13's operands with the first envs made edge cases: every limit
    row inactive; a zero direction (jv, the slots' jv and both smooth
    terms 0); rows of +-0, +-inf and NaN, live and of zero weight; a
    zero-weight row with a NaN jv; a zero-weight row of finite operands
    whose products overflow (the kernel keeps it); a zero-weight row
    just inside the kept rule's bound (dropped)."""
    lim, con, sc = lim.clone(), con.clone(), sc.clone()
    lim[0, 2] = 0.0
    lim[1, 1] = 0.0
    con[1, 3:6] = 0.0
    sc[1] = 0.0
    inf, nan = float('inf'), float('nan')
    rows = torch.tensor([[-0.0, inf, 0.0, 1.0], [nan, -inf, 0.0, -0.0],
                         [0.0, -0.0, 1.0, inf], [inf, 1.0, -0.0, 0.0]],
                        device=lim.device)
    lim[2, :, :4] = rows.T
    lim[3, :, 0] = torch.tensor([-1.0, nan, 0.0, 2.0], device=lim.device)
    lim[4, :, 0] = torch.tensor([1e38, 1e38, 0.0, 1e30], device=lim.device)
    amax = 2.0 ** expand_iters
    lim[5, :, 0] = torch.tensor([-1e36, -1e36 / amax, 0.0, 4.0],
                                device=lim.device)
    return lim, con, sc


def cholesky_cases(ops, un, root: str):
    """Rows 14-17's cases (see the module's docstring) on dense_operands'
    `ops` and unpacked_operands' `un`; rows 16 and 17 with a judge."""
    from flybody_tpu_torch.ops import cholesky as ch
    pch = parent_module(root, 'cholesky')
    out = []
    for what, A, b in ops['chol_solve']:
        out.append((f'chol_solve (row 17)[{what}]', 'cholesky',
                    lambda A=A, b=b: pch.chol_solve(A, b),
                    lambda A=A, b=b: ch.chol_solve(A, b),
                    judged(CHOL_ENV_TOL, lambda A=A, b=b: ch.chol_solve_ref(
                        A.double(), b.double()))))
    for L, R in ops['cho_solve_multi']:
        out.append((f'cho_solve_multi (row 16)[m {R.shape[2]}]', 'cholesky',
                    lambda L=L, R=R: (pch.cho_solve_multi(L, R),),
                    lambda L=L, R=R: (ch.cho_solve_multi(L, R),),
                    judged(SUBST_REL_TOL, lambda L=L, R=R: (
                        ch.cho_solve_multi_ref(L.double(), R.double()),))))
    _, M, qfrc = ops['chol_solve'][0]
    for what, (L, g) in [('bench, 8 substeps in', ops['cho_solve']),
                         ('M, qfrc_smooth', (ch.chol_solve(M, qfrc)[0], qfrc))
                         ] + un['cho_solve']:
        out.append((f'cho_solve (row 15)[n {L.shape[1]}, {what}]', 'cholesky',
                    lambda L=L, g=g: (pch.cho_solve(L, g),),
                    lambda L=L, g=g: (ch.cho_solve(L, g),)))
    for what, A in un['chol'] + [('two-fly M', M)]:
        out.append((f'chol (row 14)[n {A.shape[1]}, {what}]', 'cholesky',
                    lambda A=A: (pch.chol(A),), lambda A=A: (ch.chol(A),)))
    return out


HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet), as chip_smoke.py
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores


def ls_bound_ms(L: int, K: int, batch: int, expand_iters: int,
                ls_iters: int) -> tuple:
    """(bound ms, 'bytes' or 'operations') of row 13 on `batch` searches:
    each reads 4 L + 10 K + 2 floats and writes one, and evaluates phi'
    expand_iters + 2 ls_iters + 1 times at 8 L + 60 K operations
    (PERF.md's kernel table)."""
    byts = 4 * (4 * L + 10 * K + 3) * batch
    ops = (expand_iters + 2 * ls_iters + 1) * (8 * L + 60 * K) * batch
    tb, to = byts / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return (tb, 'bytes') if tb >= to else (to, 'operations')


def arrow_ls_cases(ops, un, root: str):
    """K3's dense form's and row 13's cases (see the module's docstring)
    on dense_operands' `ops` and unpacked_operands' `un`; prints the share
    of limit rows the line search keeps (live_rows) on each path's
    operands."""
    from flybody_tpu_torch.ops import arrow as ar
    from flybody_tpu_torch.ops import linesearch as lsm
    par, pls = parent_module(root, 'arrow'), parent_module(root, 'linesearch')
    out = []
    k3 = list(un['factor_solve'])
    k3 += [(f'{what}, edge envs', (a[0],) + arrow_dense_edge_envs(*a))
           for what, a in un['factor_solve']]
    for what, (part, A, b) in k3:
        m = 1 if b.dim() == 2 else b.shape[2]
        out.append((f'arrow_factor_solve dense[m {m}, {what}]', 'arrow',
                    lambda p=part, A=A, b=b: par.factor_solve(p, A, b),
                    lambda p=part, A=A, b=b: ar.factor_solve(p, A, b)))
    ls = ops['line_search'] + [('unpacked chain', un['line_search'])]
    what, a = ls[0]
    ls.append((f'{what}, edge envs', ls_edge_envs(*a[:3], a[3]) + a[3:]))
    for what, a in ls:
        lim, con, e_it, l_it = a[0], a[1], a[3], a[4]
        bound = ls_bound_ms(lim.shape[2], con.shape[2], lim.shape[0], e_it,
                            l_it)
        print(f'line_search[{what}]: L {lim.shape[2]}, K {con.shape[2]}, '
              f'ls {l_it}; limit rows kept (live) '
              f'{lsm.live_rows(lim, e_it).double().mean().item():.4f}; '
              f'bound {bound[0]:.4f} ms ({bound[1]})')
        out.append((f'line_search (row 13)[{what}, L {lim.shape[2]}, '
                    f'K {con.shape[2]}, ls {l_it}]', 'linesearch',
                    lambda a=a: (pls.line_search(*a),),
                    lambda a=a: (lsm.line_search(*a),)))
    return out


def reuse_edge_envs(args) -> tuple:
    """Row 10's arguments (part, lim_dof, lim_sign, F, M, conJ, Z, U, LC,
    x, msm, jar_l, jar_c, lim_params, con_params, ls, n_iters) with the
    first envs made edge cases: no active contact, no active limit row and
    msm 0 (a zero reuse gradient, so a zero direction); no contact slot
    touching the root's columns; a NaN in one J row (slot 0's first
    tangent row, at a limb column)."""
    part = args[0]
    a = list(args)
    conJ, msm, lp, cp = (a[i].clone() for i in (5, 10, 13, 14))
    cp[0, 2] = 0.0
    lp[0, 0] = 0.0
    msm[0] = 0.0
    conJ[1, :, :, :part.nr] = 0.0
    conJ[2, 0, 1, part.los[3] + 1] = float('nan')
    a[5], a[10], a[13], a[14] = conJ, msm, lp, cp
    return tuple(a)


def ragged(args, extra: int) -> tuple:
    """The tensor arguments with their first `extra` envs appended (a batch
    that is no multiple of the kernel's grid)."""
    return tuple(torch.cat([t, t[:extra]]).contiguous()
                 if torch.is_tensor(t) and t.dim() > 1 else t for t in args)


def newton_cases(part, passes, un, root: str):
    """Rows 8, 9 (whole and block-full) and 10's cases (see the module's
    docstring): rows 8 and 9 on tools/profile_newton.py's forward passes
    (newton_operands), row 10 on unpacked_operands' `un`."""
    from flybody_tpu_torch.ops import arrow as ar
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.tools import profile_newton as pn
    pnf = parent_module(root, 'newton_fused')
    out = []
    for mode, (kern, args, ls, it) in pn.newton_operands(
            part, passes).items():
        name = kern.__name__
        row = 'row 8' if mode == 'block' else 'row 9'
        K = args[5 if mode == 'block' else 4].shape[1]
        out.append((f'{name} ({row})[{mode}, K {K}, ls {ls}, {it} '
                    f'iteration{"s" if it > 1 else ""}]', 'newton',
                    lambda n=name, a=args, ls=ls, it=it:
                    getattr(pnf, n)(*a, ls, it),
                    lambda n=name, a=args, ls=ls, it=it:
                    getattr(nf, n)(*a, ls, it)))
    r10 = un['reuse']
    p10, M = r10[0], r10[4]
    packed = r10[:4] + (ar.pack_sym_ref(p10, M).contiguous(),) + r10[5:]
    reuse = [('dense M, 1 iteration', r10),
             ('dense M, 3 iterations', r10[:-1] + (3,)),
             ('packed M, 1 iteration', packed),
             ('dense M, edge envs', reuse_edge_envs(r10)),
             ('packed M, 3 iterations, edge envs',
              reuse_edge_envs(packed[:-1] + (3,))),
             (f'dense M, ragged batch ({M.shape[0]} + 37)', ragged(r10, 37))]
    for what, a in reuse:
        out.append((f'reuse (row 10)[{what}]', 'newton',
                    lambda a=a: pnf.reuse(*a), lambda a=a: nf.reuse(*a)))
    return out


def collision_cases(model, d, root: str, stepped, tf_r5, seed: int):
    """Row 5's and row 7's cases (see the module's docstring); d: the walk
    state's forward pass."""
    from flybody_tpu_torch.ops import efc_stage as ef
    from flybody_tpu_torch.ops import narrowphase as nk
    from flybody_tpu_torch.physics import collision, solver
    pnk, pef = parent_module(root, 'narrowphase'), parent_module(
        root, 'efc_stage')
    out = []
    nargs = [(f'after a {p} step', r5)
             for p, (*_, r5, _) in stepped.items()]
    dense = (collision.analytic_segments(model.meta, False), d.geom_xpos,
             d.geom_xmat, model.geom_size)
    nargs += [('dense segments', dense), ('two_fly', tf_r5),
              ('edge envs', narrow_edge_envs(nargs[0][1])),
              ('dense segments, edge envs', narrow_edge_envs(dense))]
    for tag, a in nargs:
        out.append((f'narrowphase[{tag}]', 'narrowphase',
                    lambda a=a: pnk.narrowphase(*a),
                    lambda a=a: nk.narrowphase(*a)))

    def rows(mod, a):
        con_J, scal = mod.contact_rows(*a)
        return (con_J,) + tuple(scal)
    eargs = [(f'after a {p} step, C {r7[2].shape[1]}, K {r7[5]}', r7)
             for p, (*_, r7) in stepped.items()]
    con = collision.collide(model, d, compact=False)
    eargs.append(('dense, C 2048, K 64',
                  (model, d) + solver.contact_candidates(model, con, 64)
                  + (64,)))
    bench = stepped['bench'][4]
    edge = efc_edge_scores(bench, seed)
    C = edge[2].shape[1]
    eargs += [(f'edge scores, C {C}, K {k}', edge + (k,))
              for k in (1, 24, 64, C)]
    for tag, a in eargs:
        out.append((f'efc_contacts[{tag}]', 'efc_stage',
                    lambda a=a: rows(pef, a), lambda a=a: rows(ef, a)))
    return out


def cases(batch: int, seed: int, root: str):
    """[(name, lib name, earlier fn, this fn[, judge])], each fn() one
    launch; a judge (judged) replaces the bit-for-bit rule."""
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.ops import arrow as ar
    from flybody_tpu_torch.ops import force_stage as fs
    from flybody_tpu_torch.ops import mpr_kernel as mk
    from flybody_tpu_torch.ops import noslip_gs as ng
    from flybody_tpu_torch.ops import pos_stage as ps
    from flybody_tpu_torch.ops import sens_stage as ss
    from flybody_tpu_torch.physics import collision, kinematics
    from flybody_tpu_torch.tools import profile_newton as pn
    pfs, png = parent_module(root, 'force_stage'), parent_module(
        root, 'noslip_gs')
    pps, pmk = parent_module(root, 'pos_stage'), parent_module(
        root, 'mpr_kernel')
    par, pss = parent_module(root, 'arrow'), parent_module(root, 'sens_stage')
    model, part, passes = pn.walk_passes(batch, seed)
    dev, dt = model.device, model.dtype

    def fresh(variant=False, path=spec.WALK_IMITATION_NPZ):
        # Separate models: the packs are cached.
        arrays, meta = spec.read_npz(path)
        if variant:
            arrays, meta = fs.ellipsoid_variant(arrays, meta)
        return spec.from_numpy(arrays, meta, device=dev, dtype=dt)

    def operands(m, d, P):  # row 6's, on d's geometry
        d = kinematics.fwd_position_smooth(m, d)[0]
        return collision.merged_candidates(m, d, P)[:3]

    out = []
    tf_model, tf_data, tf_sens, tf_r5 = two_fly_state(batch // 2, seed)
    walk = passes['default'][0].qpos.contiguous()
    stepped = walk_states(batch, seed)
    out += collision_cases(model, passes['default'][0], root, stepped,
                           tf_r5, seed)
    qs = [('walk state', walk, spec.WALK_IMITATION_NPZ)]
    qs += [(f'walk_imitation after a {p} step', q, spec.WALK_IMITATION_NPZ)
           for p, (q, *_) in stepped.items()]
    qs += [('two_fly', tf_data.qpos.contiguous(), spec.TWO_FLY_NPZ),
           ('edge envs', pos_edge_envs(walk), spec.WALK_IMITATION_NPZ)]
    for tag, q, path in qs:
        old_m, new_m = fresh(path=path), fresh(path=path)
        out.append((f'pos_stage[{tag}]', 'pos_stage',
                    lambda m=old_m, q=q: pps.pos_stage(m, q),
                    lambda m=new_m, q=q: ps.pos_stage(m, q)))
    d = passes['default'][0]
    from flybody_tpu_torch.tools import profile_collide as pc
    cmodel, cd = pc.setup(pc.parser().parse_args(
        ['--batch', str(batch), '--seed', str(seed)]))
    out += mpr_pair_cases(
        [('walk state', model, kinematics.fwd_position_smooth(model, d)[0]),
         ('profile_collide state', cmodel, cd)], root)
    margs = [('P 128', operands(model, d, 128)),
             ('P 32', operands(model, d, 32)),
             ('two_fly, P 128', operands(tf_model, tf_data, 128))]
    margs.append(('P 32, edge candidates', mpr_edge_candidates(*margs[1][1])))
    for tag, a in margs:
        out.append((f'mpr_merged[{tag}]', 'mpr',
                    lambda a=a: pmk.mpr_merged(*a, 8),
                    lambda a=a: mk.mpr_merged(*a, 8)))
    fargs = pn.force_args(passes['default'][0])
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
    k3 = []
    for preset, (_, (a_free, euler), *_) in stepped.items():
        k3 += [(f'a_free after a {preset} step', a_free),
               (f'euler after a {preset} step', euler)]
    k3.append(('edge envs', (k3[0][1][0],) + arrow_edge_envs(*k3[0][1][1:])))
    for tag, (part3, A, b) in k3:
        out.append((f'arrow_factor_solve[{tag}]', 'arrow',
                    lambda p=part3, A=A, b=b: par.factor_solve(p, A, b),
                    lambda p=part3, A=A, b=b: ar.factor_solve(p, A, b)))
    part3, A, b = k3[0][1]
    F = ar.factor(part3, A)
    b4 = torch.stack([b, 2.0 * b, -b, b + 1.0], -1).contiguous()
    out += [('arrow_factor (row 18)', 'arrow',
             lambda: (par.factor(part3, A),), lambda: (ar.factor(part3, A),)),
            ('arrow_solve (row 19, m 4)', 'arrow',
             lambda: (par.solve(part3, F, b4),),
             lambda: (ar.solve(part3, F, b4),)),
            ('arrow_factor_solve[m 4]', 'arrow',
             lambda: par.factor_solve(part3, A, b4),
             lambda: ar.factor_solve(part3, A, b4))]
    sargs = [(f'after a {p} step', s, spec.WALK_IMITATION_NPZ)
             for p, (_, _, s, *_) in stepped.items()]
    sargs += [('two_fly', tf_sens, spec.TWO_FLY_NPZ),
              ('edge envs', sens_edge_envs(sargs[0][1]),
               spec.WALK_IMITATION_NPZ)]
    for tag, s, path in sargs:
        old_m, new_m = fresh(path=path), fresh(path=path)
        out.append((f'sens_stage[{tag}]', 'sens_stage',
                    lambda m=old_m, s=s: (pss.sens_stage(m, *s),),
                    lambda m=new_m, s=s: (ss.sens_stage(m, *s),)))
    ops = dense_operands(tf_model, tf_data)
    un = unpacked_operands(batch, seed)
    out += cholesky_cases(ops, un, root)
    out += arrow_ls_cases(ops, un, root)
    out += newton_cases(part, passes, un, root)
    return out


def run_case(name, lib, old, new, judge, earlier_lib, reps: int):
    """One case (see `cases`): (whether it passes, its report entry),
    printed; `earlier_lib` is the earlier tree's library `lib`."""
    from flybody_tpu_torch.tools import device_time
    from flybody_tpu_torch.tools.profile_engine import _time
    with library(lib, earlier_lib):
        ref = old()
    got = new()
    torch.cuda.synchronize()
    eq = [same(a, b) for a, b in zip(got, ref)]
    times = {'earlier': [], 'this': []}
    for who in ('earlier', 'this', 'this', 'earlier'):
        if who == 'earlier':
            with library(lib, earlier_lib):
                times[who].append(_time(old, reps, True) * 1e3)
        else:
            times[who].append(_time(new, reps, True) * 1e3)
    with library(lib, earlier_lib):
        dev_old = device_time.readings(old, reps)
    dev_new = device_time.readings(new, reps)
    for i, (a, b) in enumerate(zip(got, ref)):
        if not eq[i]:
            diff = (a.double() - b.double()).abs().nan_to_num(1e300)
            at = torch.nonzero(diff == diff.max())[0].tolist()
            print(f'  output {i}: {int((diff > 0).sum())} of '
                  f'{diff.numel()} entries differ, largest '
                  f'{float(diff.max()):.3e} at {tuple(at)}')
    nan = sum(int(torch.isnan(t).sum()) for t in got)
    entry = dict(bit_equal=eq, nan_entries=nan,
                 device=dict(earlier=dev_old, this=dev_new), **times)
    passes, judgement = all(eq), ''
    if judge:
        passes, rd = judge[0](got, ref)
        entry.update(judged=rd, passes=passes)
        judgement = ('; judged: ' + ', '.join(
            f'{k} {v:.4f}' if isinstance(v, float) else
            f'{k} {json.dumps(v)}' for k, v in rd.items())
            + f' -> {"pass" if passes else "FAIL"}')
    print(f'{name}: outputs bit for bit the earlier kernel\'s: {eq} '
          f'(NaN entries {nan}); ms earlier '
          f'{times["earlier"][0]:.3f} / {times["earlier"][1]:.3f}, '
          f'this {times["this"][0]:.3f} / {times["this"][1]:.3f}; '
          f'device ms earlier {device_time.fmt(dev_old["device_ms"])}, '
          f'this {device_time.fmt(dev_new["device_ms"])}; wrapper host ms '
          f'earlier '
          f'{dev_old["host_ms"]:.4f}, this {dev_new["host_ms"]:.4f}'
          + judgement, flush=True)
    return passes, entry


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
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as pool:  # this tree's kernels beside
        build = pool.submit(_cuda.build_all)  # the earlier ones
        libs = parent_libs(args.parent, KERNELS)
        build.result()
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(f'card: {card}')
    report, ok = dict(card=card, batch=args.batch, cases={}), True
    for name, lib, old, new, *judge in cases(args.batch, args.seed,
                                            args.parent):
        passes, report['cases'][name] = run_case(name, lib, old, new, judge,
                                                 libs[lib], args.reps)
        ok &= passes
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'kernel_ab.json'), 'w') as f:
        json.dump(report, f, indent=1)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
