"""The MPR narrowphase: kernels 6 (merged) and 20 (per type pair).

Counterpart of flybody_tpu/ops/mpr_kernel.py: Minkowski Portal Refinement
at fixed trip counts (10 discovery and 24 refinement iterations, masked by
the done / separated flags, then `polish_iters` polish steps).

  * `mpr_merged` (kernel 6; the TPU's `make_mpr_merged_pe`,
    `_mpr_merged_pallas`): the broadphase-selected candidates of every
    mixed-type pair group at once, each pair with its own geom type codes;
    polish accepted on smooth (cylinder-free) pairs only. Plain version
    `mpr_merged_ref`. The kernel's lanes take the candidates in the stable
    order of their type-pair key (`pair_keys`) within windows of WINDOW
    candidates, from a pre-pass (`mpr_order` alone); `type_order` is that
    order in plain torch. Polish runs on smooth pairs only.
  * `mpr_pair` (kernel 20; the TPU's `make_mpr_pe`, `_mpr_pallas`): the
    candidates of ONE type pair, its supports fixed at compile time; polish
    accepted on every pair (no smooth mask, as the TPU kernel). Plain
    version `mpr_pair_ref`. The kernel has the seven convex pairs of the
    walking model (PAIRS) and raises on any other; it normalises by
    reciprocal square roots where the plain version and kernel 6 divide
    (csrc/mpr.cu), so it rounds otherwise and is held per near pair
    (`passes_gate`), not bit for bit. PHASES, `record_phases` and
    `pair_info` read its phase clocks and resources.

Operands, per env and candidate: c1, c2 (B, P, 12) [pos | row-major
xmat] of the two geoms; prm (B, P, 11) [size1 (3) | margin1 | size2 (3) |
margin2 | type1 | type2 | smooth], the JAX package's per-pair table
layout, of which `mpr_pair` takes the first 8 columns. Returns (dist (B,
P), normal (B, P, 3), pos (B, P, 3)). The wrappers launch csrc/mpr.cu on
CUDA tensors (float32, contiguous; anything else raises) and run the plain
versions (physics/mpr.mpr_penetration) on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from flybody_tpu_torch.model import spec as _s
from flybody_tpu_torch.ops import _cuda
from flybody_tpu_torch.physics import mpr as _mpr

launches = 0  # mpr_merged calls (each the pre-pass and the main kernel)
pair_launches = 0  # mpr_pair kernel launches
# Kernel 20's phases (csrc/mpr.cu PHASE marks), per candidate.
PHASES = ('load and seed portal', 'discovery', 'refinement', 'witness',
          'polish', 'store')
WINDOW = 8192  # candidates the pre-pass orders together (csrc/mpr.cu kWindow)
# The support branch of each geom type code (csrc/mpr.cu `branch`); any
# other code takes the ellipsoid's.
_BRANCH = {_s.GEOM_SPHERE: 0, _s.GEOM_CAPSULE: 1, _s.GEOM_CYLINDER: 2}
# The type pairs mpr_pair's kernel is instantiated for (csrc/mpr.cu).
PAIRS = ((_s.GEOM_SPHERE, _s.GEOM_ELLIPSOID),
         (_s.GEOM_SPHERE, _s.GEOM_CYLINDER),
         (_s.GEOM_CAPSULE, _s.GEOM_ELLIPSOID),
         (_s.GEOM_CAPSULE, _s.GEOM_CYLINDER),
         (_s.GEOM_ELLIPSOID, _s.GEOM_ELLIPSOID),
         (_s.GEOM_ELLIPSOID, _s.GEOM_CYLINDER),
         (_s.GEOM_CYLINDER, _s.GEOM_CYLINDER))


# The MPR kernels against their plain version, per candidate pair
# (chip_smoke.py and tools/kernel_ab.py; `agreement`, `passes_gate`). A
# pair agrees when its separated / touching classification does and, if
# it is nearer than NEAR in the reference, its dist agrees to DIST_ATOL and
# its normals' dot product is at least DOT (tests/test_ops.py's bounds for
# the TPU kernel). At least CLASS_SHARE of all pairs agree in
# classification and SHARE of the near pairs agree; and against the plain
# version at float64 the kernel misses at most F64_RATIO times as many
# near pairs as the plain float32 version does (plus 4). The limits lie
# between the kernels' readings and those of two wrong controls (the plain
# version with one refinement iteration fewer, and with the polish off),
# measured on an NVIDIA H100 (PERF.md section 6).
NEAR = 1e-3
DIST_ATOL = 1e-4
DOT = 0.999
CLASS_SHARE = 0.999
SHARE = 0.9992
F64_RATIO = 1.5


def agreement(out, ref) -> dict:
    """Per candidate pair, whether `out` (dist, normal, pos) agrees with
    `ref` (see NEAR): the share of all pairs with the same classification,
    the number of near pairs in `ref` and the share and number of them that
    agree, with quantiles of their dist error and 1 - dot."""
    d, n = out[0].double(), out[1].double()
    rd, rn = ref[0].double(), ref[1].double()
    same_class = (d == 1.0) == (rd == 1.0)
    near = (rd < NEAR) & (rd != 1.0)
    derr = (d - rd).abs()[near]
    ndev = (1.0 - (n * rn).sum(-1))[near]
    ok = same_class[near] & (derr <= DIST_ATOL) & (ndev <= 1.0 - DOT)
    q = torch.tensor([0.5, 0.99, 1.0], dtype=torch.float64, device=d.device)

    def quantiles(x):  # none without near pairs
        return torch.quantile(x, q).tolist() if x.numel() else [0.0] * 3
    return dict(class_share=same_class.double().mean().item(),
                near_pairs=int(near.sum()),
                near_share=ok.double().mean().item() if ok.numel() else 1.0,
                near_misses=int((~ok).sum()),
                near_dist_err_q50_q99_max=quantiles(derr),
                near_one_minus_dot_q50_q99_max=quantiles(ndev))


def gate_readings(runs: dict, f64) -> dict:
    """{name: agreement with runs['plain']} of every other run, and
    'near_misses_against_float64': {name: near misses against f64, the
    plain version at float64} of every run."""
    ref = runs['plain']
    rd = {name: agreement(o, ref) for name, o in runs.items()
          if name != 'plain'}
    rd['near_misses_against_float64'] = {
        name: agreement(o, f64)['near_misses'] for name, o in runs.items()}
    return rd


def passes_gate(rd, name) -> bool:
    """Whether run `name` of gate_readings `rd` passes the gate of rows 6
    and 20."""
    r, m64 = rd[name], rd['near_misses_against_float64']
    return (r['class_share'] >= CLASS_SHARE and r['near_share'] >= SHARE
            and m64[name] <= F64_RATIO * m64['plain'] + 4)


def mpr_merged_ref(c1, c2, prm, polish_iters: int,
                   refine_iters: int = _mpr.REFINE_ITERS):
    """The plain version (`refine_iters` other than 24 only for controls
    that are meant to disagree)."""
    mat_shape = c1.shape[:-1] + (3, 3)
    return _mpr.mpr_penetration(
        prm[..., 8], prm[..., 9], c1[..., :3], c1[..., 3:].reshape(mat_shape),
        prm[..., 0:3], c2[..., :3], c2[..., 3:].reshape(mat_shape),
        prm[..., 4:7], prm[..., 3], prm[..., 7], polish_iters=polish_iters,
        smooth_mask=prm[..., 10] > 0.5, refine_iters=refine_iters)


def pair_keys(prm) -> torch.Tensor:
    """Each merged candidate's order key, (B, P) int64 in [0, 32): both
    geoms' support branches and the smooth flag (csrc/mpr.cu `pair_key`)."""
    def branch(col):
        code = torch.round(prm[..., col]).long()
        out = torch.full_like(code, 3)
        for t, b in _BRANCH.items():
            out = torch.where(code == t, b, out)
        return out
    return (branch(8) * 4 + branch(9)) * 2 + (prm[..., 10] > 0.5).long()


def type_order(prm, window: int = WINDOW) -> torch.Tensor:
    """The kernel's lane order in plain torch: the flat candidate indices
    (B * P,) int64, each window of `window` consecutive candidates in the
    stable order of pair_keys."""
    keys = pair_keys(prm).flatten()
    n = keys.numel()
    win = torch.arange(n, device=keys.device) // window
    return torch.sort(win * 64 + keys, stable=True).indices


def uniform_share(prm, window: int = WINDOW) -> float:
    """The share of warps (32 lanes in lane order, the last one cut at the
    candidates' end) whose candidates share one pair key."""
    keys = pair_keys(prm).flatten()[type_order(prm, window)]
    n = keys.numel()
    pad = torch.cat([keys, keys[-1:].expand((-n) % 32)])
    w = pad.reshape(-1, 32)
    return float((w == w[:, :1]).all(1).double().mean())


def mpr_order(prm) -> torch.Tensor:
    """Kernel 6's pre-pass alone on a CUDA prm: the lane order (B * P,)
    int32 (type_order on CPU tensors, int64)."""
    if prm.device.type == 'cpu':
        return type_order(prm)
    B, P = prm.shape[:2]
    _cuda.check(prm, (B, P, 11), 'prm')
    order = torch.empty(B * P, dtype=torch.int32, device=prm.device)
    V = ctypes.c_void_p
    fn = _cuda.function('mpr', 'mpr_order_f32', [V, ctypes.c_int, V, V])
    _cuda.raise_on(fn(prm.data_ptr(), B * P, order.data_ptr(),
                      _cuda.stream()), 'mpr_order_f32')
    return order


def kernel_info(n: int) -> dict:
    """Registers a thread, shared memory a block, blocks an SM (the
    occupancy calculator) and grid blocks of kernel 6's main kernel for n
    candidates."""
    out = (ctypes.c_int * 4)()
    fn = _cuda.function('mpr', 'mpr_merged_info', [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int * 4)])
    _cuda.raise_on(fn(n, ctypes.byref(out)), 'mpr_merged_info')
    return _cuda.info_dict(out)


def pair_info(type1: int, type2: int, n: int) -> dict:
    """Registers a thread, shared memory a block, blocks an SM (the
    occupancy calculator) and grid blocks of kernel 20's kernel for a type
    pair and n candidates."""
    out = (ctypes.c_int * 4)()
    I = ctypes.c_int
    fn = _cuda.function('mpr', 'mpr_pair_info',
                        [I] * 3 + [ctypes.POINTER(ctypes.c_int * 4)])
    _cuda.raise_on(fn(type1, type2, n, ctypes.byref(out)), 'mpr_pair_info')
    return _cuda.info_dict(out)


def record_phases(fn, n: int, stride: int, device):
    """Runs fn() (kernel 20 launches on n candidates) with its phase
    clocks on: every stride-th candidate's cycles in each phase of PHASES,
    an int64 tensor (ceil(n / stride), len(PHASES)) on the CPU."""
    return _cuda.record_phases('mpr', 'mpr_pair_phase_clock', len(PHASES),
                               fn, n, stride, device)


def mpr_merged(c1, c2, prm, polish_iters: int):
    """Kernel 6 on CUDA tensors, `mpr_merged_ref` on CPU tensors."""
    if c1.device.type == 'cpu':
        return mpr_merged_ref(c1, c2, prm, polish_iters)
    global launches
    B, P = c1.shape[:2]
    _cuda.check(c1, (B, P, 12), 'c1')
    _cuda.check(c2, (B, P, 12), 'c2')
    _cuda.check(prm, (B, P, 11), 'prm')
    dist = torch.empty((B, P), dtype=torch.float32, device=c1.device)
    normal = torch.empty((B, P, 3), dtype=torch.float32, device=c1.device)
    pos = torch.empty_like(normal)
    order = torch.empty(B * P, dtype=torch.int32, device=c1.device)
    V, I = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function('mpr', 'mpr_merged_f32', [V] * 6 + [I] * 2 + [V] * 2)
    rc = fn(c1.data_ptr(), c2.data_ptr(), prm.data_ptr(), dist.data_ptr(),
            normal.data_ptr(), pos.data_ptr(), B * P, polish_iters,
            order.data_ptr(), _cuda.stream())
    _cuda.raise_on(rc, 'mpr_merged_f32')
    launches += 1
    return dist, normal, pos


def mpr_pair_ref(type1: int, type2: int, polish_iters: int, c1, c2, prm,
                 refine_iters: int = _mpr.REFINE_ITERS):
    """The plain version of kernel 20: mpr_penetration with the pair's
    type codes and no smooth mask (`refine_iters` other than 24 only for
    controls that are meant to disagree)."""
    mat_shape = c1.shape[:-1] + (3, 3)
    t1 = prm.new_full(prm.shape[:-1], float(type1))
    t2 = prm.new_full(prm.shape[:-1], float(type2))
    return _mpr.mpr_penetration(
        t1, t2, c1[..., :3], c1[..., 3:].reshape(mat_shape), prm[..., 0:3],
        c2[..., :3], c2[..., 3:].reshape(mat_shape), prm[..., 4:7],
        prm[..., 3], prm[..., 7], polish_iters=polish_iters,
        refine_iters=refine_iters)


def mpr_pair(type1: int, type2: int, polish_iters: int, c1, c2, prm):
    """Kernel 20 on CUDA tensors, `mpr_pair_ref` on CPU tensors. prm (B, P,
    8) [size1 | margin1 | size2 | margin2]."""
    if c1.device.type == 'cpu':
        return mpr_pair_ref(type1, type2, polish_iters, c1, c2, prm)
    global pair_launches
    if (type1, type2) not in PAIRS:
        raise NotImplementedError(f'mpr_pair kernel: type pair '
                                  f'{(type1, type2)}')
    B, P = c1.shape[:2]
    _cuda.check(c1, (B, P, 12), 'c1')
    _cuda.check(c2, (B, P, 12), 'c2')
    _cuda.check(prm, (B, P, 8), 'prm')
    dist = torch.empty((B, P), dtype=torch.float32, device=c1.device)
    normal = torch.empty((B, P, 3), dtype=torch.float32, device=c1.device)
    pos = torch.empty_like(normal)
    V, I = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function('mpr', 'mpr_pair_f32', [I, I] + [V] * 6 + [I] * 2
                        + [V])
    rc = fn(type1, type2, c1.data_ptr(), c2.data_ptr(), prm.data_ptr(),
            dist.data_ptr(), normal.data_ptr(), pos.data_ptr(), B * P,
            polish_iters, _cuda.stream())
    _cuda.raise_on(rc, 'mpr_pair_f32')
    pair_launches += 1
    return dist, normal, pos
