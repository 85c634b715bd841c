"""flybody_tpu_torch on a GPU: each stage kernel against its plain version.

Marked `gpu`; skips without a CUDA device. This file imports no JAX, so it
also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(tests/conftest.py imports JAX.) The kernel check runs at chip_smoke.py's
batch and seed; the main path is chip_smoke.py's.
"""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def env():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from flybody_tpu_torch.envs import fly_envs
    return fly_envs.walk_imitation(device='cuda')


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card(env):
    """The twenty-one kernels (K1-K4, the narrowphase, the merged MPR, the
    contact rows, the Newton block, the whole Newton solve, the fused
    noslip; the dense collide's narrowphase, the per-type-pair MPR (row
    20) and the contact rows at C 2,048, and the block-full Newton block
    (row 9's other mode); on the two-fly scene's dense path the noslip
    sweeps, the line search and the three dense Cholesky kernels; on the
    walking model's unpacked M the dense factor (row 14), the arrow factor
    and substitution (rows 18, 19) and the Newton reuse kernel (row 10))
    against their plain versions (chip_smoke.py's kernel phases, which
    raise on a disagreement) at its batches and seed: the MPR, Newton,
    line-search and factor kernels' limits are set on the distribution
    over those batches."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from flybody_tpu_torch.tools import profile_engine
    kernels = chip_smoke.kernel_phase(env, chip_smoke.BATCH, chip_smoke.SEED,
                                      {})
    kernels += chip_smoke.dense_kernels(chip_smoke.TWO_FLY_BATCH,
                                        chip_smoke.SEED, {})
    args = profile_engine.parser().parse_args(
        ['--batch', str(chip_smoke.UNPACKED_BATCH)])
    kernels += chip_smoke.unpacked_kernels(
        env.model, args, chip_smoke.UNPACKED_BATCH, chip_smoke.SEED, {})
    assert sorted({k['name'] for k in kernels}) == sorted(chip_smoke.SOURCES)
    assert len(chip_smoke.SOURCES) == 21
    assert len(kernels) == 22  # row 16 at m 128 and at m 32


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(env):
    """No silent fallback: a CUDA tensor the kernel cannot take raises."""
    from flybody_tpu_torch.ops import pos_stage
    qpos = env.model.qpos0.expand(4, -1)  # stride 0: not contiguous
    with pytest.raises(ValueError, match='contiguous'):
        pos_stage.pos_stage(env.model, qpos)
    with pytest.raises(TypeError, match='float32'):
        pos_stage.pos_stage(env.model, qpos.double().contiguous())


@pytest.mark.gpu
def test_newton_block_refuses_what_its_kernel_does_not_take(env):
    """newton_block raises on a float64 or a non-contiguous CUDA operand
    instead of running its plain version."""
    import torch
    from flybody_tpu_torch.ops import arrow
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.physics import solver
    part = arrow.build_partition(env.model.meta)
    lim_dof, lim_sign, _ = solver.limit_tables(env.model.meta)
    B, K, SB3, L, nv = 2, 4, 6, len(lim_dof), part.nv
    dev = torch.device('cuda')
    Mp = arrow.pack_sym_ref(part, torch.eye(nv, device=dev).expand(B, nv,
                                                                    nv))

    def args(**over):
        a = dict(Hp=Mp.clone(), M=Mp.clone(),
                 conJ=torch.zeros(B, K, 3, nv, device=dev),
                 U=torch.zeros(B, SB3, nv, device=dev),
                 x=torch.zeros(B, nv, device=dev),
                 msm=torch.zeros(B, nv, device=dev),
                 jar_l=torch.zeros(B, L, device=dev),
                 jar_c=torch.zeros(B, K, 3, device=dev),
                 lim_params=torch.zeros(B, 2, L, device=dev),
                 con_params=torch.ones(B, 4, K, device=dev))
        a.update(over)
        return (part, lim_dof, lim_sign) + tuple(a.values()) + (8, 1)

    nf.newton_block(*args())  # the well-formed call launches
    with pytest.raises(TypeError, match='float32'):
        nf.newton_block(*args(x=torch.zeros(B, nv, device=dev,
                                            dtype=torch.float64)))
    with pytest.raises(ValueError, match='contiguous'):
        nf.newton_block(*args(U=torch.zeros(B, nv, SB3,
                                            device=dev).transpose(1, 2)))
    # The kernel copies each env's slabs in bulk: 16-byte aligned only.
    with pytest.raises(ValueError, match='aligned'):
        nf.newton_block(*args(x=torch.zeros(B * nv + 1,
                                            device=dev)[1:].view(B, nv)))


@pytest.mark.gpu
def test_last_slice_wrappers_refuse_what_their_kernels_do_not_take(env):
    """mpr_pair and newton_block_full raise on a float64 or a
    non-contiguous CUDA operand instead of running their plain versions,
    and mpr_pair on a type pair it has no kernel for."""
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.ops import arrow, mpr_kernel
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.physics import solver
    c = torch.zeros(4, 8, 12, device='cuda')
    prm = torch.ones(4, 8, 8, device='cuda')
    for types in mpr_kernel.PAIRS:  # every instantiation launches
        mpr_kernel.mpr_pair(*types, 8, c, c, prm)
    with pytest.raises(TypeError, match='float32'):
        mpr_kernel.mpr_pair(spec.GEOM_SPHERE, spec.GEOM_ELLIPSOID, 8,
                            c.double(), c, prm)
    with pytest.raises(ValueError, match='contiguous'):
        mpr_kernel.mpr_pair(spec.GEOM_SPHERE, spec.GEOM_ELLIPSOID, 8, c, c,
                            torch.ones(4, 8, 8, device='cuda')
                            .transpose(1, 2))
    with pytest.raises(NotImplementedError, match='type pair'):
        mpr_kernel.mpr_pair(spec.GEOM_SPHERE, spec.GEOM_CAPSULE, 8, c, c,
                            prm)
    part = arrow.build_partition(env.model.meta)
    lim_dof, lim_sign, _ = solver.limit_tables(env.model.meta)
    B, K, SB, L, nv = 2, 4, 2, len(lim_dof), part.nv
    dev = torch.device('cuda')
    Mp = arrow.pack_sym_ref(part, torch.eye(nv, device=dev).expand(B, nv,
                                                                    nv))

    def args(**over):
        a = dict(Mp=Mp.contiguous(),
                 conJ=torch.zeros(B, K, 3, nv, device=dev),
                 bsel=torch.zeros(B, SB, dtype=torch.int32, device=dev),
                 x=torch.zeros(B, nv, device=dev),
                 msm=torch.zeros(B, nv, device=dev),
                 jar_l=torch.zeros(B, L, device=dev),
                 jar_c=torch.zeros(B, K, 3, device=dev),
                 lim_params=torch.zeros(B, 2, L, device=dev),
                 con_params5=torch.ones(B, 5, K, device=dev))
        a.update(over)
        return (part, lim_dof, lim_sign) + tuple(a.values()) + (8, 1)

    nf.newton_block_full(*args())  # the well-formed call launches
    with pytest.raises(TypeError, match='float32'):
        nf.newton_block_full(*args(msm=torch.zeros(B, nv, device=dev,
                                                   dtype=torch.float64)))
    with pytest.raises(TypeError, match='int32'):
        nf.newton_block_full(*args(bsel=torch.zeros(B, SB, device=dev)))
    with pytest.raises(ValueError, match='contiguous'):
        nf.newton_block_full(*args(jar_c=torch.zeros(B, 3, K, device=dev)
                                   .transpose(1, 2)))
    with pytest.raises(ValueError, match='aligned'):
        nf.newton_block_full(*args(jar_l=torch.zeros(B * L + 1, device=dev)
                                   [1:].view(B, L)))


@pytest.mark.gpu
def test_unpacked_wrappers_refuse_what_their_kernels_do_not_take(env):
    """The arrow factor and substitution (rows 18, 19; K3's dense form),
    the dense factor (row 14) and the reuse kernel (row 10) raise on a
    float64 or a non-contiguous CUDA operand instead of running their
    plain versions."""
    from flybody_tpu_torch.ops import arrow, cholesky
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.physics import solver
    part = arrow.build_partition(env.model.meta)
    lim_dof, lim_sign, _ = solver.limit_tables(env.model.meta)
    B, K, SB3, L, nv = 2, 4, 6, len(lim_dof), part.nv
    dev = torch.device('cuda')
    A = torch.eye(nv, device=dev).expand(B, nv, nv).contiguous()
    b = torch.ones(B, nv, device=dev)
    F = arrow.factor(part, A)
    arrow.solve(part, F, b[..., None].expand(B, nv, 3).contiguous())
    arrow.factor_solve(part, A, b)
    with pytest.raises(TypeError, match='float32'):
        arrow.factor(part, A.double())
    with pytest.raises(ValueError, match='contiguous'):
        arrow.solve(part, F, b[..., None].expand(B, nv, 3))
    with pytest.raises(TypeError, match='float32'):
        arrow.factor_solve(part, A, b.double())
    cholesky.chol(A[:, :24, :24].contiguous())
    with pytest.raises(ValueError, match='contiguous'):
        cholesky.chol(A[:, :24, :24])

    def args(**over):
        a = dict(F=F, M=A, conJ=torch.zeros(B, K, 3, nv, device=dev),
                 Z=torch.zeros(B, nv, SB3, device=dev),
                 U=torch.zeros(B, SB3, nv, device=dev),
                 LC=torch.eye(SB3, device=dev).expand(B, SB3, SB3)
                 .contiguous(),
                 x=torch.zeros(B, nv, device=dev),
                 msm=torch.zeros(B, nv, device=dev),
                 jar_l=torch.zeros(B, L, device=dev),
                 jar_c=torch.zeros(B, K, 3, device=dev),
                 lim_params=torch.zeros(B, 2, L, device=dev),
                 con_params=torch.ones(B, 4, K, device=dev))
        a.update(over)
        return (part, lim_dof, lim_sign) + tuple(a.values()) + (8, 1)

    nf.reuse(*args())  # the well-formed call launches
    with pytest.raises(TypeError, match='float32'):
        nf.reuse(*args(M=A.double()))
    with pytest.raises(ValueError, match='contiguous'):
        nf.reuse(*args(Z=torch.zeros(B, SB3, nv, device=dev).transpose(1,
                                                                        2)))
    with pytest.raises(ValueError, match='aligned'):
        nf.reuse(*args(msm=torch.zeros(B * nv + 1, device=dev)[1:]
                       .view(B, nv)))


@pytest.mark.gpu
def test_newton_kernels_hold_on_ragged_batches(env):
    """Rows 8 and 9 (block-full and whole-solve modes) at batches 1, 133
    and 8,193, which leave the persistent grid a ragged tail: at 8,193
    envs each kernel against its plain version at 30 line-search steps
    (chip_smoke.NEWTON_ENV_SHARE of envs within NEWTON_ENV_TOL), and at
    1 and 133 envs exactly the 8,193-env launch's first envs (each env's
    arithmetic does not depend on the block that takes it). The whole
    solve also refuses a misaligned slab."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.tools import profile_newton
    plain = {nf.newton_block: nf.newton_block_ref,
             nf.newton_block_full: nf.newton_block_full_ref,
             nf.newton_solve: nf.newton_solve_ref}
    _, modes = profile_newton.phase_operands(8193, chip_smoke.SEED)
    for mode, (fn, args, _, it) in modes.items():
        full = fn(*args, 30, it)
        err = chip_smoke.env_err(full, plain[fn](*args, 30, it))
        assert chip_smoke.share(err) >= chip_smoke.NEWTON_ENV_SHARE, mode
        for n in (1, 133):
            sub = tuple(a[:n] if torch.is_tensor(a) and a.dim()
                        and a.shape[0] == 8193 else a for a in args)
            for o, f in zip(fn(*sub, 30, it), full):
                assert torch.equal(o, f[:n]), (mode, n)
    args = modes['whole'][1]
    bad = torch.zeros(args[6].numel() + 1, device='cuda')[1:].view(
        args[6].shape)
    with pytest.raises(ValueError, match='aligned'):
        nf.newton_solve(*args[:6], bad, *args[7:], 6, 1)


@pytest.mark.gpu
def test_newton_reuse_holds_on_ragged_batches_and_edge_envs(env):
    """Row 10 on tools/profile_engine.py's chain's first reuse launch
    (tools/kernel_ab.unpacked_operands) at 8,229 envs, a batch that leaves
    the persistent grid a ragged tail: with the dense M and with it packed
    (the JAX kernel's packed_m form), at 30 line-search steps, at one
    iteration against reuse_ref (chip_smoke.NEWTON_ENV_SHARE of the envs
    within NEWTON_ENV_TOL) and no further from reuse_ref at float64 than
    reuse_ref at float32 is (chip_smoke.newton_checks' rule), and at three
    iterations, where float32's roundings compound past NEWTON_ENV_TOL in a
    few percent of the envs, by that float64 rule; at 1 and 133 envs bit
    for bit the 8,229-env launch's first envs; on kernel_ab's edge envs (no
    active contact and a zero reuse gradient, no slot touching the root, a
    NaN in one J row) NaN where the plain version has it and the
    zero-gradient env's state where it was."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from flybody_tpu_torch.ops import arrow
    from flybody_tpu_torch.ops import newton_fused as nf
    from flybody_tpu_torch.tools import kernel_ab
    a = kernel_ab.unpacked_operands(8229, chip_smoke.SEED)['reuse'][:-2]
    packed = a[:4] + (arrow.pack_sym_ref(a[0], a[4]).contiguous(),) + a[5:]
    for ops in (a, packed):
        for it in (1, 3):
            full, ref = nf.reuse(*ops, 30, it), nf.reuse_ref(*ops, 30, it)
            r64 = nf.reuse_ref(*chip_smoke.f64(ops), 30, it)
            err = chip_smoke.env_err(full, ref)
            if it == 1:
                assert chip_smoke.share(err) >= chip_smoke.NEWTON_ENV_SHARE
            slack = max(chip_smoke.F64_SHARE_SLACK, 4 / len(err))
            assert (chip_smoke.share(chip_smoke.env_err(full, r64))
                    >= chip_smoke.share(chip_smoke.env_err(ref, r64))
                    - slack), (ops[4].dim(), it, chip_smoke.share(err))
            for n in (1, 133):
                sub = tuple(t[:n].contiguous() if torch.is_tensor(t)
                            and t.dim() > 1 else t for t in ops)
                for o, f in zip(nf.reuse(*sub, 30, it), full):
                    assert kernel_ab.same(o, f[:n]), (ops[4].dim(), it, n)
            e = kernel_ab.reuse_edge_envs(ops + (30, it))
            got, ref = nf.reuse(*e), nf.reuse_ref(*e)
            for g, r, x0 in zip(got, ref, e[9:13]):
                assert torch.equal(torch.isnan(g), torch.isnan(r))
                assert torch.equal(g[0], x0[0])


@pytest.mark.gpu
def test_force_stage_holds_on_ragged_batches(env):
    """K2 (a block an env) at batches 1, 133 and 8,193 of
    tools/profile_newton.py's walk state, on the walking model and on its
    ellipsoid-fluid variant: at 8,193 envs against its plain version
    (chip_smoke's per-index relative error 1e-4), at 1 and 133 envs
    exactly the 8,193-env launch's first envs."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from flybody_tpu_torch.model import spec
    from flybody_tpu_torch.ops import force_stage as fs
    from flybody_tpu_torch.tools import profile_newton
    model, _, passes = profile_newton.walk_passes(8193, chip_smoke.SEED)
    fargs = profile_newton.force_args(passes['default'][0])
    variant = spec.from_numpy(*fs.ellipsoid_variant(
        *spec.read_npz(spec.WALK_IMITATION_NPZ)), device='cuda',
        dtype=model.dtype)
    for m in (model, variant):
        full = fs.force_stage(m, *fargs)
        _, rel = chip_smoke.compare('force_stage', full,
                                    fs.force_stage_ref(m, *fargs), fs.NAMES)
        assert rel <= 1e-4
        for n in (1, 133):
            for o, f in zip(fs.force_stage(m, *(a[:n] for a in fargs)),
                            full):
                assert torch.equal(o, f[:n]), n


@pytest.mark.gpu
def test_noslip_holds_at_1_16_and_64_slots_with_edge_envs(env):
    """Row 11 on 133 envs of a default-preset forward pass at 1, 16 and 64
    slots, the first envs made edge cases (tools/kernel_ab.edge_envs: a
    NaN in the factor, a zero pivot, every slot listed, no slot listed, a
    NaN in an unlisted J_t row, an infinite unlisted force): non-finite
    entries where the plain version has them, the other envs against it
    at chip_smoke.NOSLIP_REL_TOL per index, and the env with no listed
    slot exactly x0 and ft0. The wrapper refuses a factor that is not
    16-byte aligned (the kernel copies it in bulk)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from flybody_tpu_torch.ops import noslip_gs as ng
    from flybody_tpu_torch.physics import solver
    from flybody_tpu_torch.tools import kernel_ab, profile_newton
    _, part, passes = profile_newton.walk_passes(133, chip_smoke.SEED)
    d, efc, f_c = passes['default']
    for K in (1, 16, 64):
        args = kernel_ab.edge_envs(
            solver.noslip_operands(d.qLD, efc, d.qacc, f_c, K))
        x, ft = ng.noslip_fused(part, *args, 3)
        xr, ftr = ng.noslip_fused_ref(part, *args, 3)
        for o, r in ((x, xr), (ft, ftr)):
            assert torch.equal(torch.isfinite(o), torch.isfinite(r)), K
        ok = torch.isfinite(xr).all(1) & torch.isfinite(ftr).flatten(1).all(1)
        assert int((~ok).sum()) >= 4, K
        _, rel = chip_smoke.compare(f'noslip_fused[{K} slots]',
                                    (x[ok], ft[ok]), (xr[ok], ftr[ok]),
                                    ('x', 'ft'))
        assert rel <= chip_smoke.NOSLIP_REL_TOL, K
        assert torch.equal(x[3], args[5][3]) and torch.equal(ft[3],
                                                             args[6][3])
    F = args[0]
    bad = torch.zeros(F.numel() + 1, device='cuda')[1:].view(F.shape)
    with pytest.raises(ValueError, match='aligned'):
        ng.noslip_fused(part, bad, *args[1:], 3)


@pytest.mark.gpu
def test_collision_wrappers_refuse_what_their_kernels_do_not_take(env):
    """narrowphase, mpr_merged and contact_rows raise on a float64 or a
    non-contiguous CUDA operand instead of running their plain versions."""
    from flybody_tpu_torch.ops import efc_stage, mpr_kernel, narrowphase
    from flybody_tpu_torch.physics import collision, kinematics, solver
    from flybody_tpu_torch.physics.state import make_data
    model = env.model
    d, _, _ = kinematics.fwd_position_smooth(model, make_data(model, 4))
    segs = collision.dense_segments(model.meta)
    narrowphase.narrowphase(segs, d.geom_xpos, d.geom_xmat, model.geom_size)
    with pytest.raises(TypeError, match='float32'):
        narrowphase.narrowphase(segs, d.geom_xpos.double(), d.geom_xmat,
                                model.geom_size)
    with pytest.raises(ValueError, match='contiguous'):
        narrowphase.narrowphase(segs, d.geom_xpos.transpose(0, 1)
                                .contiguous().transpose(0, 1), d.geom_xmat,
                                model.geom_size)
    c = torch.zeros(4, 8, 12, device='cuda')
    prm = torch.zeros(4, 8, 11, device='cuda')
    mpr_kernel.mpr_merged(c, c, prm, 8)
    with pytest.raises(TypeError, match='float32'):
        mpr_kernel.mpr_merged(c.double(), c, prm, 8)
    with pytest.raises(ValueError, match='contiguous'):
        mpr_kernel.mpr_merged(c, c, torch.zeros(4, 11, 8, device='cuda')
                              .transpose(1, 2), 8)
    con = collision.collide(model, d, 32, 16)
    cand = solver.contact_candidates(model, con)
    efc_stage.contact_rows(model, d, *cand, 24)
    with pytest.raises(TypeError, match='float32'):
        efc_stage.contact_rows(model, d, cand[0].double(), *cand[1:], 24)
    with pytest.raises(ValueError, match='contiguous'):
        efc_stage.contact_rows(model, d, cand[0], cand[1],
                               torch.stack([cand[2]] * 2, -1)[..., 0], 24)


@pytest.mark.gpu
def test_contact_selection_orders_ties_and_nan_as_a_stable_sort(env):
    """The contact-row kernel selects what collision.smallest (a stable
    sort) selects when scores tie, are -0.0 / +0.0, infinite or NaN: on
    the bench preset's compact candidates (C 222) and on the dense
    make_efc's (C 2,048), at K 1, 24, 64 and C."""
    from flybody_tpu_torch.ops import efc_stage
    from flybody_tpu_torch.physics import collision, kinematics, solver
    from flybody_tpu_torch.physics.state import make_data
    model = env.model
    d, _, _ = kinematics.fwd_position_smooth(model, make_data(model, 4))
    cands = (solver.contact_candidates(model,
                                       collision.collide(model, d, 32, 16)),
             solver.contact_candidates(
                 model, collision.collide(model, d, compact=False), 64))
    g = torch.Generator(device='cpu').manual_seed(0)
    choice = torch.tensor([0.0, -0.0, 1e-3, -1e-3, float('inf'),
                           float('-inf'), float('nan'), 1e10])
    for cand_b, cand_u, cand_g in cands:
        C = cand_b.shape[1]
        dist = choice[torch.randint(0, len(choice), (4, C), generator=g)]
        cand_b = cand_b.clone()
        cand_b[..., 0] = dist.cuda()
        cand_u = cand_u.clone()
        cand_u[..., 0] = 0.0
        for k in (1, 24, 64, C):
            got = efc_stage.contact_rows(model, d, cand_b, cand_u, cand_g, k)
            want = efc_stage.contact_rows_ref(model, d, cand_b, cand_u,
                                              cand_g, k)
            assert torch.equal(got[1][18], want[1][18]), (C, k)
    assert [c[0].shape[1] for c in cands] == [222, 2048]


@pytest.mark.gpu
def test_dense_wrappers_refuse_what_their_kernels_do_not_take(env):
    """chol_solve, cho_solve, cho_solve_multi, line_search and gs raise on
    a float64 or a non-contiguous CUDA operand instead of running their
    plain versions, and chol and cho_solve on n above MAX_N."""
    from flybody_tpu_torch.ops import cholesky, linesearch, noslip_gs
    dev = torch.device('cuda')
    B, n = 4, 24
    A = (torch.eye(n, device=dev) * 2.0).expand(B, n, n).contiguous()
    b = torch.ones(B, n, device=dev)
    L, _ = cholesky.chol_solve(A, b)  # the well-formed calls launch
    cholesky.cho_solve(L, b)
    cholesky.cho_solve_multi(L, torch.ones(B, n, 3, device=dev))
    with pytest.raises(TypeError, match='float32'):
        cholesky.chol_solve(A.double(), b.double())
    with pytest.raises(ValueError, match='contiguous'):
        cholesky.chol_solve(A.transpose(1, 2), b)
    with pytest.raises(TypeError, match='float32'):
        cholesky.cho_solve(L, b.double())
    with pytest.raises(ValueError, match='contiguous'):
        cholesky.cho_solve_multi(L, torch.ones(B, 3, n, device=dev)
                                 .transpose(1, 2))
    big = torch.eye(cholesky.MAX_N + 1, device=dev)[None].contiguous()
    with pytest.raises(RuntimeError, match='chol_f32'):
        cholesky.chol(big)
    with pytest.raises(RuntimeError, match='cho_solve_f32'):
        cholesky.cho_solve(big, big[:, 0].contiguous())
    lim = torch.zeros(B, 4, 8, device=dev)
    con = torch.zeros(B, 10, 5, device=dev)
    sc = torch.ones(B, 2, device=dev)
    linesearch.line_search(lim, con, sc, 6, 8)
    with pytest.raises(TypeError, match='float32'):
        linesearch.line_search(lim.double(), con, sc, 6, 8)
    with pytest.raises(ValueError, match='contiguous'):
        linesearch.line_search(lim, con, torch.ones(2, B, device=dev).t(),
                               6, 8)
    K, nv = 3, 20
    g = dict(Jt=torch.zeros(B, K, 2, nv, device=dev),
             Pt=torch.zeros(B, K, 2, nv, device=dev),
             Ainv=torch.zeros(B, K, 2, 2, device=dev),
             aref=torch.zeros(B, K, 2, device=dev),
             lim=torch.ones(B, K, device=dev),
             use=torch.ones(B, K, device=dev),
             x0=torch.zeros(B, nv, device=dev),
             ft0=torch.zeros(B, K, 2, device=dev))
    noslip_gs.gs(*g.values(), 3)
    with pytest.raises(TypeError, match='float32'):
        noslip_gs.gs(*dict(g, x0=g['x0'].double()).values(), 3)
    with pytest.raises(ValueError, match='contiguous'):
        noslip_gs.gs(*dict(g, Pt=torch.zeros(B, K, nv, 2, device=dev)
                           .transpose(2, 3)).values(), 3)


@pytest.mark.gpu
def test_pos_stage_and_mpr_hold_on_ragged_batches(env):
    """K1 (a block an env) at batches 1, 7 and 8,193 of
    tools/profile_newton.py's walk state and the merged MPR (row 6) at P 1,
    33 and 128 of its broadphase candidates: at 8,193
    envs against their plain versions (chip_smoke's per-index relative
    error 1e-4; row 6 through mpr_kernel.passes_gate), at 1
    and 7 envs exactly the 8,193-env launch's first envs; the pre-pass's
    order is the plain `type_order`."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from flybody_tpu_torch.ops import mpr_kernel as mk
    from flybody_tpu_torch.ops import pos_stage as ps
    from flybody_tpu_torch.physics import collision, kinematics
    from flybody_tpu_torch.tools import kernel_ab, profile_newton
    model, _, passes = profile_newton.walk_passes(8193, chip_smoke.SEED)
    d = passes['default'][0]
    qpos = d.qpos.contiguous()
    full = ps.pos_stage(model, qpos)
    _, rel = chip_smoke.compare('pos_stage', full,
                                ps.pos_stage_ref(model, qpos), ps.NAMES)
    assert rel <= 1e-4
    for n in (1, 7):
        for o, f in zip(ps.pos_stage(model, qpos[:n].contiguous()), full):
            assert torch.equal(o, f[:n]), n
    for P in (1, 33, 128):
        c1, c2, prm, _ = collision.merged_candidates(
            model, kinematics.fwd_position_smooth(model, d)[0], P)
        assert torch.equal(mk.mpr_order(prm).long(),
                           mk.type_order(prm).to(prm.device))
        ref = mk.mpr_merged_ref(c1, c2, prm, 8)
        f64 = mk.mpr_merged_ref(c1.double(), c2.double(), prm.double(), 8)
        out = mk.mpr_merged(c1, c2, prm, 8)
        rd = mk.gate_readings({'kernel': out, 'plain': ref}, f64)
        assert mk.passes_gate(rd, 'kernel'), (P, rd)
        for n in (1, 7):
            part = mk.mpr_merged(c1[:n].contiguous(), c2[:n].contiguous(),
                                 prm[:n].contiguous(), 8)
            for o, f in zip(part, out):
                assert kernel_ab.same(o, f[:n]), (P, n)


@pytest.mark.gpu
def test_mpr_uniform_and_mixed_blocks_match_one_candidate_at_a_time(env):
    """Row 6 on a block of 128 candidates of one type-pair key and a block
    of 128 cycling through every key (tools/kernel_ab.mpr_edge_candidates,
    with its edge candidates before them): each candidate's results are
    the bits of a launch on that candidate alone."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from flybody_tpu_torch.ops import mpr_kernel as mk
    from flybody_tpu_torch.physics import collision, kinematics
    from flybody_tpu_torch.tools import kernel_ab, profile_newton
    model, _, passes = profile_newton.walk_passes(16, chip_smoke.SEED)
    d = kinematics.fwd_position_smooth(model, passes['default'][0])[0]
    ops = kernel_ab.mpr_edge_candidates(
        *collision.merged_candidates(model, d, 32)[:3])
    c1, c2, prm = (t.reshape(1, -1, t.shape[-1])[:, :384].contiguous()
                   for t in ops)
    keys = mk.pair_keys(prm)[0]
    assert len(torch.unique(keys[128:256])) == 1
    assert len(torch.unique(keys[256:384])) >= 5
    alone = [mk.mpr_merged(c1[:, i:i + 1].contiguous(),
                           c2[:, i:i + 1].contiguous(),
                           prm[:, i:i + 1].contiguous(), 8)
             for i in range(384)]
    out = mk.mpr_merged(c1, c2, prm, 8)
    for i in range(384):
        for o, a in zip(out, alone[i]):
            assert kernel_ab.same(o[:, i:i + 1], a), i


@pytest.mark.gpu
def test_arrow_and_sens_stage_hold_on_ragged_and_misaligned_operands(env):
    """K3 (its packed one-right-hand-side kernel) on a default-preset
    forward pass's free-acceleration operands and K4 on its sensor
    operands (tools/profile_newton.py's walk state): at 8,193 envs against
    their plain versions (chip_smoke's gates: K3's residual ||M x - b|| /
    ||b|| and K4's per-index relative error, each 1e-4), at 1 and 133 envs
    exactly the 8,193-env launch's first envs, and with
    every operand moved off 16-byte alignment (element loads in place of
    the bulk copies) exactly the aligned launch."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from flybody_tpu_torch.ops import arrow as ar
    from flybody_tpu_torch.ops import sens_stage as ss
    from flybody_tpu_torch.tools import profile_newton
    model, part, passes = profile_newton.walk_passes(8193, chip_smoke.SEED)
    d, efc, f_c = passes['default']
    runs = (('arrow_factor_solve', lambda *a: ar.factor_solve(part, *a),
             lambda *a: ar.factor_solve_ref(part, *a),
             (d.qM.contiguous(), d.qfrc_smooth.contiguous()), ('F', 'x')),
            ('sens_stage', lambda *a: (ss.sens_stage(model, *a),),
             lambda *a: (ss.sens_stage_ref(model, *a),),
             ss.operands(d, efc, f_c), ('sensordata',)))
    for name, kern, plain, args, names in runs:
        full = kern(*args)
        if name == 'arrow_factor_solve':
            M, b = args
            res = ((ar.matvec_packed(part, M, full[1]) - b).norm(dim=-1)
                   / b.norm(dim=-1)).max().item()
            assert res <= 1e-4, res
        else:
            _, rel = chip_smoke.compare(name, full, plain(*args), names)
            assert rel <= 1e-4, name
        for n in (1, 133):
            for o, f in zip(kern(*(a[:n].contiguous() for a in args)), full):
                assert torch.equal(o, f[:n]), (name, n)
        for o, f in zip(kern(*(misaligned(a) for a in args)), full):
            assert torch.equal(o, f), name


def misaligned(x):
    """A copy of x that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 and y.is_contiguous()
    return y


@pytest.mark.gpu
def test_narrowphase_and_contact_rows_hold_on_ragged_and_misaligned_operands(
        env):
    """Row 5 on the compact and dense segment tables and row 7 on each
    preset's compact candidates and the dense make_efc's, of
    tools/profile_newton.py's walk state at 8,193 envs: against their
    plain versions (chip_smoke's gates: row 5 per slot within
    NARROW_REL_TOL, row 7 by efc_errors: slot and body ids exactly, every
    other field within EFC_REL_TOL), at 1 and 133 envs exactly the
    8,193-env launch's first envs, and with every operand moved off
    16-byte alignment exactly the aligned launch."""
    import dataclasses
    sys.path.insert(0, REPO)
    import chip_smoke
    from flybody_tpu_torch.ops import efc_stage as ef
    from flybody_tpu_torch.ops import narrowphase as nk
    from flybody_tpu_torch.physics import collision, engine, solver
    from flybody_tpu_torch.tools import profile_newton
    model, _, passes = profile_newton.walk_passes(8193, chip_smoke.SEED)
    d = passes['default'][0]
    for cc in (True, False):
        segs = collision.analytic_segments(model.meta, cc)
        args = (d.geom_xpos.contiguous(), d.geom_xmat.contiguous(),
                model.geom_size)
        full = nk.narrowphase(segs, *args)
        _, rel = chip_smoke.compare('narrowphase', full,
                                    nk.narrowphase_ref(segs, *args),
                                    ('dist', 'pos', 'normal'))
        assert rel <= chip_smoke.NARROW_REL_TOL, (cc, rel)
        for n in (1, 133):
            part = nk.narrowphase(segs, *(a[:n].contiguous()
                                          for a in args[:2]), args[2])
            for o, f in zip(part, full):
                assert torch.equal(o, f[:n]), (cc, n)
        moved = nk.narrowphase(segs, *(misaligned(a) for a in args))
        for o, f in zip(moved, full):
            assert torch.equal(o, f), cc
    runs = []
    for preset in ('default', 'bench'):
        cfg = engine.PRESETS[preset]
        con = collision.collide(model, d, cfg['mpr_top_p'], cfg['cc_top_p'])
        runs.append((solver.contact_candidates(model, con),
                     cfg['ncon_max']))
    runs.append((solver.contact_candidates(
        model, collision.collide(model, d, compact=False), 64), 64))
    for cand, K in runs:
        full = ef.contact_rows(model, d, *cand, K)
        chip_smoke.efc_errors(full, ef.contact_rows_ref(model, d, *cand, K),
                              f'C {cand[0].shape[1]}')
        flat = [full[0]] + full[1]
        for n in (1, 133):
            dn = d.index(slice(0, n))
            part = ef.contact_rows(model, dn, *(c[:n].contiguous()
                                                for c in cand), K)
            for o, f in zip([part[0]] + part[1], flat):
                assert torch.equal(o, f[:n]), (K, n)
        dm = dataclasses.replace(d, qvel=misaligned(d.qvel),
                                 cdof=misaligned(d.cdof))
        moved = ef.contact_rows(model, dm, *(misaligned(c) for c in cand), K)
        for o, f in zip([moved[0]] + moved[1], flat):
            assert torch.equal(o, f), K


@pytest.mark.gpu
def test_mpr_pair_holds_on_ragged_and_misaligned_operands(env):
    """Row 20 on the seven groups' candidates of tools/profile_newton.py's
    walk state at 8,193 envs: the seven together pass the gate of rows 6
    and 20 against the plain version (mpr_kernel.passes_gate); at 1 and
    133 envs each group is exactly the 8,193-env launch's first envs, and
    with every operand moved off 16-byte alignment (the kernel's
    element-load path) exactly the aligned launch."""
    from flybody_tpu_torch.ops import mpr_kernel as mk
    from flybody_tpu_torch.physics import kinematics
    from flybody_tpu_torch.tools import profile_collide, profile_newton
    model, _, passes = profile_newton.walk_passes(8193, 0)
    d = kinematics.fwd_position_smooth(model, passes['default'][0])[0]
    groups = profile_collide.mpr_groups(model, d)
    outs, refs, f64s = [], [], []
    for key, pol, pg in groups:
        full = mk.mpr_pair(*key, pol, *pg)
        outs.append(full)
        refs.append(mk.mpr_pair_ref(*key, pol, *pg))
        f64s.append(mk.mpr_pair_ref(*key, pol, *(t.double() for t in pg)))
        for n in (1, 133):
            part = mk.mpr_pair(*key, pol, *(t[:n].contiguous() for t in pg))
            for o, f in zip(part, full):
                assert torch.equal(o, f[:n]), (key, n)
        moved = mk.mpr_pair(*key, pol, *(misaligned(t) for t in pg))
        for o, f in zip(moved, full):
            assert torch.equal(o, f), key

    def cat(runs):
        return tuple(torch.cat([r[i] for r in runs], 1) for i in range(3))
    rd = mk.gate_readings({'kernel': cat(outs), 'plain': cat(refs)},
                          cat(f64s))
    assert mk.passes_gate(rd, 'kernel'), rd


def spd_batch(B, n, seed):
    """B random SPD matrices G G^T / n + I scaled by a diagonal spanning
    two decades, and b (B, n), on the card."""
    g = torch.Generator(device='cpu').manual_seed(seed)
    G = torch.randn(B, n, n, generator=g)
    A = G @ G.transpose(1, 2) / n + torch.eye(n)
    s = 10.0 ** (-2.0 * torch.rand(B, n, generator=g))
    A = A * s[:, :, None] * s[:, None, :]
    return A.cuda().contiguous(), torch.randn(B, n, generator=g).cuda()


def hold_beside(outs, refs, tol):
    """NaN and +-inf where the plain version has them, and every other
    entry within tol of the largest finite |ref| at its index on axis 1."""
    for o, r in zip(outs, refs):
        assert torch.equal(torch.isnan(o), torch.isnan(r))
        assert torch.equal(torch.isposinf(o), torch.isposinf(r))
        assert torch.equal(torch.isneginf(o), torch.isneginf(r))
        fin = torch.isfinite(r)
        o, r = torch.where(fin, o, 0.0), torch.where(fin, r, 0.0)
        if r.dim() == 2:
            o, r = o[..., None], r[..., None]
        scale = r.double().abs().amax(dim=(0, 2)).clamp(min=1e-30)
        err = ((o.double() - r.double()).abs() / scale[None, :, None]).max()
        assert err <= tol, float(err)


@pytest.mark.gpu
def test_cholesky_kernels_hold_on_ragged_batches_pivots_and_nan(env):
    """The factor (row 14), the one-right-hand-side solve (row 15), the
    fused factor+solve (row 17) and the many-right-hand-side solve (row 16)
    against their plain versions at ragged batches (1, 33 and 130 envs),
    n 1, 24, 37, 108, 216 and 300 (rows 17 and 16 to their largest n, 256
    and MULTI_ROWS) and (row 16) m 1, 32, 128 and 200, each entry within
    chip_smoke's CHOL_ENV_TOL / SUBST_REL_TOL of its index's scale; env 1
    with a pivot below zero and env 2 with a zero pivot (both clamped at
    1e-30) and env 3 with a NaN below the diagonal of A (and at 130 envs
    a zero right-hand side in env 2, -0 in env 5): NaN and +-inf exactly
    where the plain version has them. Rows 14 and 15 give the first
    design's outputs, as row 17 does: row 14's L is row 17's bit for bit,
    and row 15 on row 17's L gives its x. With every operand moved off
    16-byte alignment (element loads and stores in place of the bulk
    copies and 16-byte accesses) the outputs are the aligned launch's."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from flybody_tpu_torch.ops import cholesky as ch
    from flybody_tpu_torch.tools.kernel_ab import same
    for n in (1, 24, 37, 108, 216, 300):
        for B in (1, 33, 130):
            A, b = spd_batch(B, n, 100 * n + B)
            k = n // 2
            for e, d in ((1, -1.0), (2, 0.0)):
                if e < B:
                    A[e, k, :] = 0.0
                    A[e, :, k] = 0.0
                    A[e, k, k] = d
            if B > 3 and n > 1:
                A[3, n - 1, k // 2] = float('nan')
            if B > 5:  # zero right-hand sides: over a zero pivot, and -0
                b[2] = 0.0
                b[5] = -0.0
            L14, Lp = ch.chol(A), ch.chol_ref(A)
            hold_beside((L14,), (Lp,), chip_smoke.CHOL_ENV_TOL)
            assert (torch.triu(L14, 1) == 0).all()
            assert same(ch.chol(misaligned(A)), L14)
            x15 = ch.cho_solve(Lp, b)
            hold_beside((x15,), (ch.cho_solve_ref(Lp, b),),
                        chip_smoke.SUBST_REL_TOL)
            assert same(ch.cho_solve(misaligned(Lp), misaligned(b)), x15)
            if n > 256:
                continue
            L, x = ch.chol_solve(A, b)
            xp = ch.cho_solve_ref(Lp, b)
            hold_beside((L, x), (Lp, xp), chip_smoke.CHOL_ENV_TOL)
            assert (torch.triu(L, 1) == 0).all()
            assert same(L14, L) and same(ch.cho_solve(L, b), x)
            Lm, xm = ch.chol_solve(misaligned(A), misaligned(b))
            assert same(Lm, L) and same(xm, x)
            if n > ch.MULTI_ROWS:
                continue
            for m in (1, 32, 128, 200):
                g = torch.Generator(device='cpu').manual_seed(m)
                R = torch.randn(B, n, m, generator=g).cuda()
                X = ch.cho_solve_multi(Lp, R)
                hold_beside((X,), (ch.cho_solve_multi_ref(Lp, R),),
                            chip_smoke.SUBST_REL_TOL)
                assert same(ch.cho_solve_multi(misaligned(Lp), misaligned(R)),
                            X)


def dense_arrow(part, B, m, seed):
    """B dense SPD matrices with the partition's arrow sparsity, slightly
    out of symmetry in the limb and root blocks (the kernels symmetrize),
    junk between the limbs (never read), and right-hand sides (B, nv) or
    (B, nv, m), on the card."""
    g = torch.Generator(device='cpu').manual_seed(seed)
    nv, nr = part.nv, part.nr
    mask = torch.zeros(nv, nv)
    mask[:nr, :] = 1.0
    mask[:, :nr] = 1.0
    for lo, d in zip(part.los, part.ds):
        mask[lo:lo + d, lo:lo + d] = 1.0
    X = 0.2 * torch.randn(B, nv, nv, generator=g)
    A = (X @ X.transpose(1, 2) + 3.0 * torch.eye(nv)) * mask + 3.0 * torch.eye(
        nv)
    A = A + 1e-3 * torch.randn(B, nv, nv, generator=g) * mask * (
        1.0 - torch.eye(nv))
    A = A + 50.0 * (1.0 - mask) * torch.randn(B, nv, nv, generator=g)
    b = torch.randn(*((B, nv) if m == 1 else (B, nv, m)), generator=g)
    return A.cuda().contiguous(), b.cuda().contiguous()


# A partition off the register tile of K3's kernels (a 16-dof limb):
# arrow_kernel takes it on both the packed and the dense route.
WIDE = dict(los=(4, 20), ds=(16, 8), nr=4, nv=28, dmax=16, limb_of_body=())


@pytest.mark.gpu
def test_arrow_dense_form_holds_and_is_the_packed_form_bit_for_bit(env):
    """K3's dense form (arrow_dense_kernel; arrow_kernel off the register
    tile) at 1, 33 and 130 envs and m 1, 25 and 40 (a second pass of the
    lanes), on the walking partition and on a partition off the tile:
    within chip_smoke's CHOL_ENV_TOL of factor_solve_ref, and F and x bit
    for bit the packed form's on pack_dense(A) (the same symmetrized
    entries, the same order: arrow_fs1_kernel at m 1, arrow_kernel above);
    with A and b moved off 16-byte alignment (element copies in place of
    the bulk copies) the aligned launch's; on edge envs (a NaN in one
    triangle of a limb block, a negative limb pivot and a zero root pivot,
    both floored at 1e-30) the packed form's, NaN in the same places. The
    packed route off the tile (arrow_factor_solve1_f32 into arrow_kernel)
    holds against factor_solve_ref too."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from flybody_tpu_torch.ops import arrow as ar
    from flybody_tpu_torch.tools.kernel_ab import same
    walk = ar.build_partition(env.model.meta)
    for part in (walk, ar.Part(**WIDE)):
        for B in (1, 33, 130):
            for m in (1, 25, 40):
                A, b = dense_arrow(part, B, m, 7 * B + m + part.nv)
                F, x = ar.factor_solve(part, A, b)
                hold_beside((F, x), ar.factor_solve_ref(part, A, b),
                            chip_smoke.CHOL_ENV_TOL)
                Fp, xp = ar.factor_solve(part, ar.pack_dense(part, A)
                                         .contiguous(), b)
                assert same(F, Fp) and same(x, xp), (part.nv, B, m)
                Fm, xm = ar.factor_solve(part, misaligned(A), misaligned(b))
                assert same(Fm, F) and same(xm, x), (part.nv, B, m)
                if B > 3:
                    lo = part.los[0]
                    A[0, lo + 2, lo + 1] = float('nan')
                    A[1, lo, lo] = -1.0
                    A[2, 0, 0] = 0.0
                    F, x = ar.factor_solve(part, A, b)
                    Fp, xp = ar.factor_solve(part, ar.pack_dense(part, A)
                                             .contiguous(), b)
                    assert same(F, Fp) and same(x, xp), (part.nv, B, m)
                    assert torch.isnan(x[0]).any()
        A, b = dense_arrow(part, 33, 1, part.nv)
        Mp = ar.pack_dense(part, A).contiguous()
        hold_beside(ar.factor_solve(part, Mp, b),
                    ar.factor_solve_ref(part, Mp, b), chip_smoke.CHOL_ENV_TOL)


def ls_planes(B, L, K, seed):
    """Line-search planes as the dense path's (a tenth of the limit rows
    active), on the card."""
    g = torch.Generator(device='cpu').manual_seed(seed)
    act = (torch.rand(B, L, generator=g) < 0.1).float()
    lim = torch.stack([torch.randn(B, L, generator=g),
                       torch.randn(B, L, generator=g), act,
                       100.0 * torch.rand(B, L, generator=g)], 1)
    con = torch.cat([torch.randn(B, 6, K, generator=g),
                     0.2 + torch.rand(B, 1, K, generator=g),
                     (torch.rand(B, 1, K, generator=g) < 0.8).float(),
                     (torch.rand(B, 1, K, generator=g) < 0.7).float(),
                     100.0 * torch.rand(B, 1, K, generator=g)], 1)
    sc = torch.stack([-10.0 * torch.randn(B, generator=g).abs(),
                      5.0 * torch.randn(B, generator=g).abs() + 1.0], 1)
    return lim.cuda(), con.cuda(), sc.cuda()


@pytest.mark.gpu
def test_line_search_holds_and_skips_only_rows_of_zero_weight(env):
    """Row 13 at 1, 5 and 4,097 envs, at the staged kernel's widths (L 204
    and 408, K 24, 32 and 64) and off them (L 600; K 80: the first
    design's kernel): at 30 refinement steps within chip_smoke's line
    search limits of line_search_ref in LS_SHARE of the envs, the first
    envs of a batch bit for bit the smaller batch's, and alpha the same
    bits when the rows it skips (live_rows false) change their finite
    jar0 and jv; on kernel_ab's edge envs (every row inactive, a zero
    direction, rows of +-0, +-inf and NaN, a zero-weight row with a NaN jv
    or with overflowing products) NaN where the plain version has it."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from flybody_tpu_torch.ops import linesearch as lsm
    from flybody_tpu_torch.tools.kernel_ab import ls_edge_envs, same
    for L, K in ((204, 32), (408, 64), (408, 24), (600, 16), (100, 80)):
        for B in (1, 5, 4097):
            lim, con, sc = ls_planes(B, L, K, L + K + B)
            a = lsm.line_search(lim, con, sc, 6, 30)
            r = lsm.line_search_ref(lim, con, sc, 6, 30)
            assert chip_smoke.ls_share(a, r) >= chip_smoke.LS_SHARE, (L, K, B)
            if B > 1:
                assert same(lsm.line_search(lim[:1].contiguous(),
                                            con[:1].contiguous(),
                                            sc[:1].contiguous(), 6, 30),
                            a[:1])
            dead = ~lsm.live_rows(lim, 6)
            moved = lim.clone()
            moved[:, 0] = torch.where(dead, -2.0 * lim[:, 0] + 0.5, lim[:, 0])
            moved[:, 1] = torch.where(dead, 3.0 * lim[:, 1] - 1.0, lim[:, 1])
            assert same(lsm.line_search(moved, con, sc, 6, 8),
                        lsm.line_search(lim, con, sc, 6, 8)), (L, K, B)
        if B > 5:
            e = ls_edge_envs(lim, con, sc, 6)
            a = lsm.line_search(*e, 6, 8)
            r = lsm.line_search_ref(*e, 6, 8)
            assert torch.equal(torch.isnan(a), torch.isnan(r))
