"""The schedules of K3's dense form and of the line search (row 13) in
plain torch, on the CPU.

csrc/arrow.cu's arrow_dense_kernel takes a dense A (B, nv, nv): its
stage-in copies each limb row's run widened to 16-byte bounds (five lanes a
row, six rows a warp, 16-byte copies) and the root rows into a staging
area (`dense_stage`), then packs the limb blocks' rows, the borders (from
the root rows) and the root block's rows from it, a half-warp a row run
dealt round robin over the block's eight half-warps (`dense_extract`); the
limb blocks are symmetrized as the factor loads its columns, (D[i, j] +
D[j, i]) / 2, and the root block's lower triangle as it is packed. With m
> 1 right-hand
sides a lane takes a right-hand side and the limbs are dealt to the four
warps (`dense_warps`, the costliest first to the least loaded warp): the
forward rows, the root right-hand sides (a warp a root dof), the root solve
(a thread a right-hand side) and the back rows, each entry's terms in
arrow_solve's order. `stage_runs`, `pack_elements`, `dense_warps` and
`solve_multi` below are those schedules:

  (a) every live packed entry is read once, from the dense entry
      gather_dense reads, each staged run is 16-byte aligned, holds its
      row and has one owner lane a 16-byte piece; the staged packing
      equals `pack_dense` bit for bit at float32; every term of every
      entry of the solve comes in
      arrow_solve's order and every (limb, right-hand side) has one owner
      (a warp, a lane and a pass);
  (b) at float32 the schedule's F and x agree with factor_solve_ref to
      F32_TOL of each entry's scale;
  (c) at float64 they agree with the JAX package's factor_ref then
      solve_ref (its plain XLA path, the one factor_solve_batched's
      callers take with Pallas off) to 1e-12 of each entry's scale.

csrc/linesearch.cu's linesearch_kernel runs a warp an env: lane l sums its
limit rows l + 32 q in order, then its contact slots l + 32 u, and the
lanes by a butterfly (ls_alpha_warp's order), skipping the limit rows that
add +-0 at every step (`live_rows`, the kernel's ls_row_dead). `lane_sums`
and `alpha` below are that schedule:

  (d) each lane's float32 sums are the same bits with and without the
      skipped rows, at every step the search can take, NaN and infinities
      included; the kept rows are each lane's own in order;
  (e) at float32 (30 refinement steps, where the bracket collapses) alpha
      agrees with line_search_ref to LS_TOL; at float64 (6 steps, as
      tests/test_torch_dense.py) with the JAX package's alpha_ref to 1e-12
      of the largest step.

Sizes: the walking partition (nv 108) at m 1 and 25, a partition off the
register tile (a 16-dof limb, which arrow_kernel takes), and L 204 / 408
with K 24 / 32 / 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flybody_tpu.ops import arrow as jarrow
from flybody_tpu.ops import linesearch as jls
from flybody_tpu_torch.model import spec as tspec
from flybody_tpu_torch.ops import arrow as tarrow
from flybody_tpu_torch.ops import linesearch as tls

B = 3
WARPS = 4  # csrc/arrow.cu kFsThreads / 32
TILE_DM, TILE_NR = 14, 6  # its register tile (kTileDm, kTileNr)
TOL64 = 1e-12
# Float32: the schedules round each product-and-subtract once and the plain
# versions (torch's triangular solves) in their own order; on these
# well-conditioned operands they differ by a few float32 roundings of each
# entry's scale (tests/test_torch_chol_subst_schedule.py, same limit).
F32_TOL = 2e-5
# Float32 line searches at 30 steps: the lane order against torch.sum's
# moves alpha by a few roundings once the bracket has collapsed.
LS_TOL = 1e-5


def fma(acc, x, y):
    """acc + x y rounded once (fmaf); float32 through float64, whose
    product of two float32 values is exact."""
    if acc.dtype == torch.float32:
        return (acc.double() + x.double() * y.double()).float()
    return acc + x * y


def same(a, b) -> bool:
    """torch.equal with NaN in the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, torch.zeros_like(a), a),
        torch.where(nb, torch.zeros_like(b), b)))


def close(out, ref, what, tol):
    """Each entry within tol of the largest |ref| over the batch at its
    place (floored at 1e-6 of the largest overall)."""
    out, ref = torch.as_tensor(np.array(out)), torch.as_tensor(np.array(ref))
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert torch.isfinite(ref).all(), f'{what}: reference not finite'
    o, r = out.double(), ref.double()
    scale = r.abs().amax(0)
    scale = scale.clamp(min=1e-6 * float(scale.max()))
    err = float(((o - r).abs() / scale).max())
    assert err <= tol, f'{what}: {err:.3e} of the scale (limit {tol:.0e})'


# ------------------------------------------------------------- partitions

WIDE = tarrow.Part(los=(4, 20), ds=(16, 8), nr=4, nv=28, dmax=16,
                   limb_of_body=())


@pytest.fixture(scope='module')
def walk():
    return tarrow.build_partition(tspec.load(device='cpu').meta)


def fs1_lanes(part):
    """csrc/arrow.cu fs1_lanes: the thread of each limb's column 0 (the
    largest limbs first, each into the first warp with room), or None."""
    used, first = [0] * WARPS, [0] * len(part.ds)
    for l in sorted(range(len(part.ds)), key=lambda q: (-part.ds[q], q)):
        w = next((w for w in range(WARPS) if used[w] + part.ds[l] <= 32),
                 None)
        if w is None:
            return None
        first[l] = 32 * w + used[w]
        used[w] += part.ds[l]
    return first


def fs1_fits(part) -> bool:
    """Whether the register-tile kernels (fs1, dense) take the partition."""
    return (fs1_lanes(part) is not None and part.dmax <= TILE_DM
            and part.nr <= TILE_NR)


def dense_warps(part):
    """csrc/arrow.cu dense_warps: each limb's warp in the substitution."""
    load, sw = [0] * WARPS, [0] * len(part.ds)
    for l in sorted(range(len(part.ds)), key=lambda q: (-part.ds[q], q)):
        w = min(range(WARPS), key=lambda v: (load[v], v))
        sw[l] = w
        load[w] += part.ds[l] * (part.ds[l] + part.nr)
    return sw


def test_routes(walk):
    assert fs1_fits(walk)
    assert not fs1_fits(WIDE)  # a 16-dof limb: arrow_kernel takes it
    sw = dense_warps(walk)
    loads = [sum(d * (d + walk.nr) for d, w in zip(walk.ds, sw) if w == v)
             for v in range(WARPS)]
    costs = sorted((d * (d + walk.nr) for d in walk.ds), reverse=True)
    assert max(loads) <= sum(costs) / WARPS + costs[0]  # dealt, not heaped


# ------------------------------------------------------------- stage-in


def packed_index(part, blk, row, col):
    dm, nr = part.dmax, part.nr
    return (blk * (dm + nr) + row) * dm + col


def pack_elements(part):
    """dense_extract: {packed index: (dense index, row run)} of the raw
    entries it packs; run t goes to half-warp t mod 8 (a lane a float)."""
    nv, nr = part.nv, part.nr
    out, task = {}, 0
    for l, (lo, d) in enumerate(zip(part.los, part.ds)):
        for q in range(d + nr):
            for c in range(d):
                src = ((lo + q) * nv if q < d else (q - d) * nv) + lo + c
                dst = packed_index(part, l, q if q < d else part.dmax + q - d,
                                   c)
                assert dst not in out
                out[dst] = (src, task)
            task += 1
    for q in range(nr):
        for c in range(nr):
            out[packed_index(part, len(part.ds), q, c)] = (q * nv + c, task)
        task += 1
    return out


SLOT = 20  # csrc/arrow.cu kSlot: a staged limb row's floats


def stage_runs(part):
    """dense_stage: (first float, end float, owner lanes) of each limb
    row's staged run (widened to 16-byte bounds; limb row i, the i-th limb
    dof's, goes to warp (i mod 24) // 6, lanes 5 (i mod 6) + piece, pass i
    // 24, a 16-byte piece a lane), then the root rows' run."""
    nv, nr = part.nv, part.nr
    runs = []
    for lo, d in zip(part.los, part.ds):
        for q in range(d):
            i, off = len(runs), (lo + q) * nv + lo
            s0, s1 = off & ~3, (off + d + 3) & ~3
            owners = [((i % 24) // 6, 5 * (i % 6) + k, i // 24)
                      for k in range((s1 - s0) // 4)]
            runs.append((s0, s1, owners))
    runs.append((0, nr * nv, None))
    return runs


def gather_dense_source(part, blk, row, col):
    """The dense entries arrow.cu's gather_dense reads for a packed entry:
    (r, c) and, for a symmetrized one, (c, r); None for a constant."""
    nl, dm, nr, nv = len(part.ds), part.dmax, part.nr, part.nv
    if blk < nl:
        lo, d = part.los[blk], part.ds[blk]
        if row < dm:
            if row < d and col < d:
                return [(lo + row) * nv + lo + col, (lo + col) * nv + lo + row]
            return None
        return [(row - dm) * nv + lo + col] if col < d else None
    if row < nr and col < nr:
        return [row * nv + col, col * nv + row]
    return None


@pytest.mark.parametrize('name', ['walk', 'wide'])
def test_stage_reads_each_live_entry_once(walk, name):
    part = walk if name == 'walk' else WIDE
    el = pack_elements(part)
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    for blk in range(nl + 1):
        for row in range(dm + nr):
            for col in range(dm):
                src = gather_dense_source(part, blk, row, col)
                got = el.get(packed_index(part, blk, row, col))
                if src is None:
                    assert got is None
                else:  # the raw (r, c) entry; the factor adds (c, r)
                    assert got is not None and got[0] == src[0]
    runs = np.bincount([t % 8 for t in {t for _, t in el.values()}],
                       minlength=8)
    assert runs.max() - runs.min() <= 1  # round robin
    runs = stage_runs(part)
    assert len(runs) == part.nv - nr + 1
    owners = [o for _, _, own in runs[:-1] for o in own]
    assert len(set(owners)) == len(owners)  # one lane a piece
    assert all(w < 4 and lane < 30 for w, lane, _ in owners)
    row = 0
    for lo, d in zip(part.los, part.ds):
        for q in range(d):
            s0, s1, _ = runs[row]
            off = (lo + q) * part.nv + lo
            assert s0 % 4 == 0 and s1 % 4 == 0 and s1 - s0 <= SLOT
            assert s0 <= off and off + d <= s1 and off - s0 == off & 3
            row += 1


def dense_operands(part, seed, m, dtype):
    """B dense SPD matrices with the arrow sparsity, the limb blocks and
    the root block perturbed out of symmetry by 1e-3 of their diagonal
    (so the symmetrization's order shows) and junk between the limbs
    (never read), and right-hand sides (B, nv) or (B, nv, m)."""
    rng = np.random.RandomState(seed)
    nv, nr = part.nv, part.nr
    mask = np.zeros((nv, nv))
    mask[:nr, :] = mask[:, :nr] = 1
    for lo, d in zip(part.los, part.ds):
        mask[lo:lo + d, lo:lo + d] = 1
    X = rng.randn(B, nv, nv) * 0.2
    A = (X @ X.transpose(0, 2, 1) + 3.0 * np.eye(nv)) * mask + 3.0 * np.eye(
        nv)
    A = A + 1e-3 * rng.randn(B, nv, nv) * mask * (1 - np.eye(nv))
    A = A + 50.0 * (1 - mask) * rng.randn(B, nv, nv)
    b = rng.randn(B, nv) if m == 1 else rng.randn(B, nv, m)
    return torch.as_tensor(A, dtype=dtype), torch.as_tensor(b, dtype=dtype)


def staged_packing(part, A):
    """The dense form's packed matrix as its factor reads it: the raw
    entries (pack_elements), identity on padded diagonals, the limb
    blocks' lower triangles symmetrized as k3_limb_factor<kSym> loads
    them, the root block's as dense_extract packs it; upper triangles and
    the rest as the factor ignores them (zero)."""
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    flat = A.reshape(A.shape[0], -1)
    P = A.new_zeros((A.shape[0], (nl + 1) * (dm + nr) * dm))
    for dst, (src, _) in pack_elements(part).items():
        P[:, dst] = flat[:, src]
    P = P.reshape(-1, nl + 1, dm + nr, dm)
    for l, d in enumerate(part.ds):
        D = P[:, l, :dm].clone()
        for i in range(d):
            for j in range(i + 1):
                P[:, l, i, j] = 0.5 * (D[:, i, j] + D[:, j, i])
            P[:, l, i, i + 1:] = 0.0
        for i in range(d, dm):
            P[:, l, i, i] = 1.0
    R = P[:, nl, :nr, :nr].clone()
    P[:, nl, :nr, :nr] = torch.tril(0.5 * (R + R.transpose(1, 2)))
    return P


@pytest.mark.parametrize('name', ['walk', 'wide'])
def test_staged_packing_is_pack_dense_bit_for_bit(walk, name):
    part = walk if name == 'walk' else WIDE
    A, _ = dense_operands(part, 1, 1, torch.float32)
    got = staged_packing(part, A)
    ref = tarrow.pack_dense(part, A)
    nl, dm = len(part.ds), part.dmax
    ref[:, :nl, :dm] = torch.tril(ref[:, :nl, :dm])
    ref[:, nl] = torch.tril(ref[:, nl])
    assert torch.equal(got, ref)


# ------------------------------------------------------------- factor, solve


def factor(part, P):
    """The kernels' factor in place on a copy (k3_limb_factor,
    k3_root_factor: arrow_factor's column loop), each update rounded
    once."""
    F = P.clone()
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    for l, d in enumerate(part.ds):
        rows = list(range(d)) + list(range(dm, dm + nr))
        D = F[:, l]
        for k in range(d):
            inv = torch.rsqrt(torch.clamp(D[:, k, k], min=1e-30))
            low = [i for i in rows if i >= k]
            D[:, low, k] = D[:, low, k] * inv[:, None]
            for j in range(k + 1, d):
                tgt = [i for i in rows if i >= j]
                D[:, tgt, j] = fma(D[:, tgt, j], -D[:, tgt, k],
                                   D[:, j, k, None])
    S = F[:, nl, :nr, :nr].clone()
    for l, d in enumerate(part.ds):
        LB = F[:, l, dm:dm + nr, :d]
        for k in range(d):
            S = fma(S, -LB[:, :, None, k], LB[:, None, :, k])
    for k in range(nr):
        inv = torch.rsqrt(torch.clamp(S[:, k, k], min=1e-30))
        S[:, k:, k] = S[:, k:, k] * inv[:, None]
        for j in range(k + 1, nr):
            S[:, j:, j] = fma(S[:, j:, j], -S[:, j:, k], S[:, j, k, None])
    F[:, nl, :nr, :nr] = torch.tril(S)
    return F


def solve_multi(part, F, b, record=None):
    """The kernel's substitution (lanes over the right-hand sides, the
    limbs by warp): x, and into `record` each entry's terms in order."""
    nl, dm, nr = len(part.ds), part.dmax, part.nr
    X = (b[..., None] if b.dim() == 2 else b).clone()
    rec = record if record is not None else {}
    sw = dense_warps(part)

    def term(key, t):
        rec.setdefault(key, []).append(t)
    for w in range(WARPS):  # dm_forward
        for l in (l for l in range(nl) if sw[l] == w):
            lo, d, D = part.los[l], part.ds[l], F[:, l]
            for k in range(d):
                s = X[:, lo + k]
                for i in range(k):
                    s = fma(s, -D[:, k, i, None], X[:, lo + i])
                    term(('fwd', lo + k), i)
                X[:, lo + k] = s / D[:, k, k, None]
    for r in range(nr):  # dm_root: a warp a root dof
        s = X[:, r]
        for l, (lo, d) in enumerate(zip(part.los, part.ds)):
            for k in range(d):
                s = fma(s, -F[:, l, dm + r, k, None], X[:, lo + k])
                term(('root', r), (l, k))
        X[:, r] = s
    LR = F[:, nl]  # a thread a right-hand side
    for k in range(nr):
        s = X[:, k]
        for i in range(k):
            s = fma(s, -LR[:, k, i, None], X[:, i])
            term(('rootfwd', k), i)
        X[:, k] = s / LR[:, k, k, None]
    for k in range(nr - 1, -1, -1):
        s = X[:, k]
        for i in range(k + 1, nr):
            s = fma(s, -LR[:, i, k, None], X[:, i])
            term(('rootback', k), i)
        X[:, k] = s / LR[:, k, k, None]
    for w in range(WARPS):  # dm_back
        for l in (l for l in range(nl) if sw[l] == w):
            lo, d, D = part.los[l], part.ds[l], F[:, l]
            for a in range(d):
                s = X[:, lo + a]
                for r in range(nr):
                    s = fma(s, -D[:, dm + r, a, None], X[:, r])
                    term(('border', lo + a), r)
                X[:, lo + a] = s
            for k in range(d - 1, -1, -1):
                s = X[:, lo + k]
                for i in range(k + 1, d):
                    s = fma(s, -D[:, i, k, None], X[:, lo + i])
                    term(('back', lo + k), i)
                X[:, lo + k] = s / D[:, k, k, None]
    return X[..., 0] if b.dim() == 2 else X


def arrow_solve_order(part):
    """csrc/arrow.cuh arrow_solve's terms for each entry, in order."""
    nl, nr = len(part.ds), part.nr
    rec = {}
    for l, (lo, d) in enumerate(zip(part.los, part.ds)):
        for k in range(d):
            rec[('fwd', lo + k)] = list(range(k))
    for r in range(nr):
        rec[('root', r)] = [(l, k) for l in range(nl)
                            for k in range(part.ds[l])]
    for k in range(nr):
        rec[('rootfwd', k)] = list(range(k))
        rec[('rootback', k)] = list(range(k + 1, nr))
    for l, (lo, d) in enumerate(zip(part.los, part.ds)):
        for a in range(d):
            rec[('border', lo + a)] = list(range(nr))
            rec[('back', lo + a)] = list(range(a + 1, d))
    return {k: v for k, v in rec.items() if v}


@pytest.mark.parametrize('name', ['walk', 'wide'])
def test_solve_takes_arrow_solves_terms_in_order(walk, name):
    part = walk if name == 'walk' else WIDE
    A, b = dense_operands(part, 2, 25, torch.float32)
    F = factor(part, staged_packing(part, A))
    rec = {}
    solve_multi(part, F, b, rec)
    assert rec == arrow_solve_order(part)
    sw = dense_warps(part)  # one owner a (limb, right-hand side)
    for m in (1, 25, 40):
        owners = [(sw[l], j % 32, j // 32) for l in range(len(part.ds))
                  for j in range(m)]
        assert len(set((l, o) for l, o in zip(
            [l for l in range(len(part.ds)) for _ in range(m)], owners))
        ) == len(part.ds) * m


@pytest.mark.parametrize('name,m', [('walk', 1), ('walk', 25), ('wide', 25)])
def test_schedule_matches_plain_version_at_float32(walk, name, m):
    part = walk if name == 'walk' else WIDE
    A, b = dense_operands(part, 3 + m, m, torch.float32)
    F = factor(part, staged_packing(part, A))
    x = solve_multi(part, F, b)
    Fr, xr = tarrow.factor_solve_ref(part, A, b)
    close(F, Fr, 'F', F32_TOL)
    close(x, xr, 'x', F32_TOL)


@pytest.mark.parametrize('name,m', [('walk', 1), ('walk', 25), ('wide', 25)])
def test_schedule_matches_jax_at_float64(walk, name, m):
    part = walk if name == 'walk' else WIDE
    jp = jarrow.Part(*part)
    A, b = dense_operands(part, 5 + m, m, torch.float64)
    F = factor(part, staged_packing(part, A))
    x = solve_multi(part, F, b)

    def fs(a, r):
        f = jarrow.factor_ref(jp, a)
        return f, jarrow.solve_ref(jp, f, r)
    Fj, xj = jax.vmap(fs)(jnp.asarray(A.numpy()), jnp.asarray(b.numpy()))
    close(F, Fj, 'F', TOL64)
    close(x, xj, 'x', TOL64)


# ------------------------------------------------------------- row 13


def ls_operands(L, K, seed, dtype, edge=False):
    """Line-search planes as the dense path's: a tenth of the limit rows
    active, a few more of zero D; contact slots (mu 0.2-1.2, most
    frictional, 0.7 active); sm0 < 0 < smm. With edge, the first envs
    carry rows of +-0, +-inf and NaN of zero weight and live, a zero-weight
    row with a NaN jv, and a zero-weight row of huge finite operands."""
    rng = np.random.RandomState(seed)
    Bn = 8
    act = (rng.rand(Bn, L) < 0.1).astype(float)
    Dl = rng.rand(Bn, L) * 100.0 * (rng.rand(Bn, L) > 0.05)
    lim = np.stack([rng.randn(Bn, L), rng.randn(Bn, L), act, Dl], 1)
    con = np.concatenate([
        rng.randn(Bn, 3, K), rng.randn(Bn, 3, K), 0.2 + rng.rand(Bn, 1, K),
        (rng.rand(Bn, 1, K) < 0.8).astype(float),
        (rng.rand(Bn, 1, K) < 0.7).astype(float),
        rng.rand(Bn, 1, K) * 100.0], axis=1)
    sc = np.stack([-np.abs(rng.randn(Bn)) * 10.0,
                   np.abs(rng.randn(Bn)) * 5.0 + 1.0], axis=1)
    lim, con, sc = (torch.as_tensor(t, dtype=dtype) for t in (lim, con, sc))
    if edge:
        inf, nan = float('inf'), float('nan')
        lim[0, :, 0] = torch.tensor([-0.0, inf, 0.0, 1.0])
        lim[0, :, 33] = torch.tensor([nan, -inf, 0.0, -0.0])
        lim[1, :, 1] = torch.tensor([0.0, -0.0, 1.0, inf])
        lim[2, :, 2] = torch.tensor([-1.0, nan, 0.0, 2.0])
        lim[3, :, 3] = torch.tensor([1e38, 1e38, 0.0, 1e30])
        lim[4, :, 4] = torch.tensor([-1e30, -1e30, 0.0, 4.0])
    return lim, con, sc


def lim_terms(lim, a):
    """ls_lim_term: (ms, xs, mc, xc) of every limit row at steps a (B,)."""
    jl, vl, al, Dl = lim.unbind(1)
    jar = fma(jl, a[:, None].expand_as(vl), vl)
    act = torch.where(jar < 0, al, torch.zeros_like(al))
    f = (-Dl * jar) * act
    return -f, vl, (Dl * act) * vl, vl


def con_terms(con, a):
    """ls_con_term with ls_con's constants: (ms, xs, mc, xc) a slot."""
    n0, t10, t20, v0, v1, v2, mu, fric, act, D = con.unbind(1)
    a = a[:, None]
    amu = 1.0 / torch.clamp(mu, min=1e-6)
    den = 1.0 + amu * amu
    cc = 1.0 / den
    N, y1, y2 = n0 + a * v0, t10 + a * v1, t20 + a * v2
    T = torch.sqrt(y1 * y1 + y2 * y2)
    safeT = torch.clamp(T, min=1e-15)
    w = (N + amu * T) / den
    top, bottom = N >= mu * T, mu * N + T <= 0.0
    coef = 1.0 - amu * w / safeT
    zero = torch.zeros_like(N)
    r0 = torch.where(bottom, N, N - w)
    r1 = torch.where(bottom, y1, y1 * coef)
    r2 = torch.where(bottom, y2, y2 * coef)
    r0, r1, r2 = (torch.where(top, zero, r) for r in (r0, r1, r2))
    fp = fric > 0
    r0 = torch.where(fp, r0, torch.clamp(N, max=0.0))
    r1, r2 = torch.where(fp, r1, zero), torch.where(fp, r2, zero)
    dot = r0 * v0 + r1 * v1 + r2 * v2
    yv = (y1 / safeT) * v1 + (y2 / safeT) * v2
    vt2 = v1 * v1 + v2 * v2
    qdP = (cc * v0 * v0 + 2.0 * amu * cc * v0 * yv + amu * amu * cc * yv * yv
           + (amu * w / safeT) * (vt2 - yv * yv))
    q = torch.where(bottom, v0 * v0 + vt2, v0 * v0 + vt2 - qdP)
    q = torch.where(top, zero, q)
    q = torch.where(fp, q, (N < 0).to(N.dtype) * v0 * v0)
    Da = D * act
    return Da, dot, Da, q


def lane_sums(lim, con, a, keep):
    """Each lane's (s, c) (B, 32): its limit rows lane + 32 q in order
    (only where keep), then its slots lane + 32 u, a rounding a
    product-and-add."""
    Bn, L, K = lim.shape[0], lim.shape[2], con.shape[2]
    s = lim.new_zeros((Bn, 32))
    c = lim.new_zeros((Bn, 32))
    for terms, n, kept in ((lim_terms(lim, a), L, keep),
                           (con_terms(con, a), K, None)):
        ms, xs, mc, xc = terms
        for q in range(-(-n // 32)):
            i = torch.arange(32 * q, min(32 * q + 32, n))
            lane = i - 32 * q
            on = torch.ones_like(ms[:, i], dtype=torch.bool) if kept is None \
                else kept[:, i]
            s[:, lane] = torch.where(on, fma(s[:, lane], ms[:, i], xs[:, i]),
                                     s[:, lane])
            c[:, lane] = torch.where(on, fma(c[:, lane], mc[:, i], xc[:, i]),
                                     c[:, lane])
    return s, c


def warp_sum(v):
    """common.cuh warp_sum: the butterfly over the 32 lanes."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    return v[:, 0]


def alpha(lim, con, sc, expand, ls, keep):
    """ls_alpha_warp's search with lane_sums; alpha (B,)."""
    sm0, smm = sc[:, 0], sc[:, 1]

    def slope_curv(a):
        s, c = lane_sums(lim, con, a, keep)
        return (sm0 + a * smm) + warp_sum(s), torch.clamp(smm + warp_sum(c),
                                                          min=1e-15)
    hi = torch.ones_like(sm0)
    for _ in range(expand):
        s, _ = slope_curv(hi)
        hi = torch.where(s < 0, 2.0 * hi, hi)
    lo = torch.zeros_like(hi)
    for _ in range(ls):
        mid = 0.5 * (lo + hi)
        s, c = slope_curv(mid)
        cand = mid - s / c
        probe = torch.where((cand > lo) & (cand < hi), cand, mid)
        sp, _ = slope_curv(probe)
        lo, hi = torch.where(sp < 0, probe, lo), torch.where(sp < 0, hi, probe)
    s0, _ = slope_curv(torch.zeros_like(lo))
    return torch.where(s0 < 0, 0.5 * (lo + hi), torch.zeros_like(lo))


WIDTHS = [(204, 32), (204, 24), (408, 64), (408, 24)]


@pytest.mark.parametrize('L,K', WIDTHS)
def test_skipped_rows_leave_every_lane_sum_unchanged(L, K):
    lim, con, _ = ls_operands(L, K, L + K, torch.float32, edge=True)
    expand = 6
    keep = tls.live_rows(lim, expand)
    live = float(keep.double().mean())
    assert 0.05 < live < 0.2, live  # the active tenth and the edge rows
    assert keep[0, 0] and keep[0, 33] and keep[1, 1] and keep[2, 2]
    assert keep[3, 3] and not keep[4, 4]
    Bn = lim.shape[0]
    for a in (0.0, 0.37, 1.0, 2.0 ** expand):
        at = torch.full((Bn,), a)
        s, c = lane_sums(lim, con, at, None)
        sk, ck = lane_sums(lim, con, at, keep)
        assert same(s, sk) and same(c, ck), a
        assert torch.isnan(s[0]).any() and torch.isnan(s[2]).any()
    at = torch.rand(Bn, generator=torch.Generator().manual_seed(L)) * 64.0
    s, c = lane_sums(lim, con, at, None)
    sk, ck = lane_sums(lim, con, at, keep)
    assert same(s, sk) and same(c, ck)


@pytest.mark.parametrize('L,K', WIDTHS)
def test_search_matches_plain_version_at_float32(L, K):
    lim, con, sc = ls_operands(L, K, 2 * L + K, torch.float32)
    got = alpha(lim, con, sc, 6, 30, tls.live_rows(lim, 6))
    ref = tls.line_search_ref(lim, con, sc, 6, 30)
    assert (ref > 0).any()
    assert float((got - ref).abs().max()) <= LS_TOL * float(ref.abs().max())


@pytest.mark.parametrize('L,K', WIDTHS)
def test_search_matches_jax_at_float64(L, K):
    lim, con, sc = ls_operands(L, K, 3 * L + K, torch.float64)
    got = alpha(lim, con, sc, 6, 6, tls.live_rows(lim, 6))
    ref = jax.vmap(lambda l, c, s: jls.alpha_ref(l, c, s[:, None], 6, 6))(
        jnp.asarray(lim.numpy()), jnp.asarray(con.numpy()),
        jnp.asarray(sc.numpy()))
    ref = torch.as_tensor(np.array(ref))
    assert (ref > 0).any()
    assert float((got - ref).abs().max()) <= TOL64 * float(ref.abs().max())
