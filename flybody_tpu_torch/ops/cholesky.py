"""Dense batched Cholesky factor and substitutions: rows 14, 15, 16 and 17.

Counterpart of flybody_tpu/ops/cholesky.py, used by the dense path (scenes
without an arrow partition, such as several flies) and by the arrow Newton
step on an unpacked mass matrix (the Woodbury capacitance):

  * `chol(A)` (row 14, the TPU's `_chol_pallas`): the lower factor L of A
    (zeros above the diagonal);
  * `chol_solve(A, b)` (row 17, the TPU's `_chol_solve_pallas`): the
    lower factor L of A (zeros above the diagonal) and x with A x = b;
  * `cho_solve(L, b)` (row 15, `_solve_pallas`): x with L L^T x = b;
  * `cho_solve_multi(L, R)` (row 16, `_solve_multi_pallas`): X with
    L L^T X = R for R (B, n, m).

Shapes are batch-leading: A, L (B, n, n), b (B, n). CUDA tensors launch
csrc/cholesky.cu (float32, contiguous; anything else raises; rows 14 and
15 take n <= MAX_N, row 17 n <= 256, row 16 n <= MULTI_ROWS); CPU tensors
run the plain versions `*_ref`, which repeat the kernels' algorithm: a
column-by-column factor that reads the lower triangle and clamps each pivot
at 1e-30 (the TPU kernel's rsqrt(max(d, 1e-30))), forward substitution by
columns and backward substitution by dot products. Every factor sums in
the first design's order (four partial sums an entry, csrc/cholesky.cu):
row 14 a warp an env at n <= WARP_ROWS, else by panels of `PANEL` columns
as row 17 does (the triangle in shared memory at n <= SMEM_ROWS, else in a
workspace the wrapper allocates); rows 14, 15 and 17 give that design's
outputs bit for bit. Row 15 runs a warp an env, lane l owning rows l + 32
u, L staged whole at n <= WARP_ROWS, else streamed by TILE x TILE tiles;
row 16 sweeps by panels of `MULTI_PANEL` rows, each term a fused
multiply-add. No jitter is added here: callers add their own.
PHASES, `record_phases` and `kernel_info` read the four rows' phase clocks
and resources.
"""

from __future__ import annotations

import ctypes

import torch

from flybody_tpu_torch.ops import _cuda

PANEL = 16  # rows 14 and 17: panel width (csrc/cholesky.cu kNb)
MULTI_PANEL = 12  # row 16: panel height (kMultiNb)
MULTI_ROWS = 224  # row 16: the largest n (32 kMultiU)
MAX_N = 512  # rows 14 and 15: the largest n (kMaxN)
WARP_ROWS = 32  # rows 14 and 15: a warp an env up to this n
SMEM_ROWS = 256  # row 14: the triangle in shared memory up to this n
TILE = 32  # row 15 above WARP_ROWS: L's tiles are TILE x TILE (kTile)


def chol_threads(n: int) -> int:
    """Row 14: threads a block (a block an env) above WARP_ROWS."""
    return 32 if n <= 128 else 256


def multi_cols(m: int) -> int:
    """Row 16: right-hand sides a block (8 kTC)."""
    return 32 if m <= 32 else 64


# Phases of the clock instantiations (record_phases), in order: row 17's
# factor phase includes the forward substitution; row 14 has no
# substitution (zero cycles there).
PHASES = ('stage-in', 'factor / forward sweep',
          'substitution / backward sweep', 'store')

chol_launches = 0  # row 14
chol_solve_launches = 0  # row 17
cho_solve_launches = 0  # row 15
cho_solve_multi_launches = 0  # row 16


# ------------------------------------------------------ plain versions


def chol_ref(A):
    """Lower Cholesky factor of the lower triangle of A (B, n, n)."""
    n = A.shape[-1]
    W = torch.tril(A)
    L = torch.zeros_like(A)
    for k in range(n):
        d = W[:, k, k]
        inv = torch.rsqrt(torch.clamp(d, min=1e-30))
        c = W[:, k:, k] * inv[:, None]
        L[:, k:, k] = c
        W[:, k + 1:, k + 1:] -= c[:, 1:, None] * c[:, None, 1:]
    return L


def subst_ref(L, R):
    """X with L L^T X = R, for R (B, n, m)."""
    n = L.shape[-1]
    r = R.clone()
    y = torch.empty_like(R)
    for k in range(n):
        y[:, k] = r[:, k] / L[:, k, k, None]
        r[:, k + 1:] -= L[:, k + 1:, k, None] * y[:, k, None]
    x = torch.empty_like(R)
    for k in range(n - 1, -1, -1):
        s = torch.einsum('bj,bjm->bm', L[:, k + 1:, k], x[:, k + 1:])
        x[:, k] = (y[:, k] - s) / L[:, k, k, None]
    return x


def cho_solve_ref(L, b):
    """Plain version of row 15."""
    return subst_ref(L, b[..., None])[..., 0]


def cho_solve_multi_ref(L, R):
    """Plain version of row 16."""
    return subst_ref(L, R)


def chol_solve_ref(A, b):
    """Plain version of row 17: (L, x)."""
    L = chol_ref(A)
    return L, cho_solve_ref(L, b)


# ------------------------------------------------------------ kernels

_P, _I = ctypes.c_void_p, ctypes.c_int


def _check_square(A, what):
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f'{what}: expected (B, n, n), got {tuple(A.shape)}')
    _cuda.check(A, A.shape, what)
    return A.shape[0], A.shape[1]


def chol(A):
    """Row 14 on CUDA tensors, `chol_ref` on CPU tensors."""
    if A.device.type == 'cpu':
        return chol_ref(A)
    global chol_launches
    Bn, n = _check_square(A, 'A')
    L = torch.empty_like(A)
    W = None  # the factor's workspace where the triangle is too large for
    if n > SMEM_ROWS:  # shared memory: rows padded to 16 bytes
        W = torch.empty(Bn, n, (n + 3) // 4 * 4, device=A.device,
                        dtype=A.dtype)
    fn = _cuda.function('cholesky', 'chol_f32', [_P, _P, _P, _I, _I, _P])
    rc = fn(A.data_ptr(), L.data_ptr(), None if W is None else W.data_ptr(),
            Bn, n, _cuda.stream())
    _cuda.raise_on(rc, 'chol_f32')
    chol_launches += 1
    return L


def chol_solve(A, b):
    """Row 17 on CUDA tensors, `chol_solve_ref` on CPU tensors."""
    if A.device.type == 'cpu':
        return chol_solve_ref(A, b)
    global chol_solve_launches
    Bn, n = _check_square(A, 'A')
    _cuda.check(b, (Bn, n), 'b')
    L = torch.empty_like(A)
    x = torch.empty_like(b)
    fn = _cuda.function('cholesky', 'chol_solve_f32', [_P] * 4 + [_I, _I, _P])
    rc = fn(A.data_ptr(), b.data_ptr(), L.data_ptr(), x.data_ptr(), Bn, n,
            _cuda.stream())
    _cuda.raise_on(rc, 'chol_solve_f32')
    chol_solve_launches += 1
    return L, x


def cho_solve(L, b):
    """Row 15 on CUDA tensors, `cho_solve_ref` on CPU tensors."""
    if L.device.type == 'cpu':
        return cho_solve_ref(L, b)
    global cho_solve_launches
    Bn, n = _check_square(L, 'L')
    _cuda.check(b, (Bn, n), 'b')
    x = torch.empty_like(b)
    fn = _cuda.function('cholesky', 'cho_solve_f32', [_P] * 3 + [_I, _I, _P])
    rc = fn(L.data_ptr(), b.data_ptr(), x.data_ptr(), Bn, n, _cuda.stream())
    _cuda.raise_on(rc, 'cho_solve_f32')
    cho_solve_launches += 1
    return x


def cho_solve_multi(L, R):
    """Row 16 on CUDA tensors, `cho_solve_multi_ref` on CPU tensors."""
    if L.device.type == 'cpu':
        return cho_solve_multi_ref(L, R)
    global cho_solve_multi_launches
    Bn, n = _check_square(L, 'L')
    if R.dim() != 3:
        raise ValueError(f'R: expected (B, n, m), got {tuple(R.shape)}')
    _cuda.check(R, (Bn, n, R.shape[2]), 'R')
    X = torch.empty_like(R)
    fn = _cuda.function('cholesky', 'cho_solve_multi_f32',
                        [_P] * 3 + [_I, _I, _I, _P])
    rc = fn(L.data_ptr(), R.data_ptr(), X.data_ptr(), Bn, n, R.shape[2],
            _cuda.stream())
    _cuda.raise_on(rc, 'cho_solve_multi_f32')
    cho_solve_multi_launches += 1
    return X


def record_phases(fn, batch: int, stride: int, device):
    """Runs fn() (launches of rows 14-17 on `batch` envs) with their
    phase clocks on: every stride-th env's cycles in each phase of PHASES,
    an int64 tensor (ceil(batch / stride), len(PHASES)) on the CPU (row 16:
    summed over the env's blocks, one a chunk of multi_cols(m) columns)."""
    return _cuda.record_phases('cholesky', 'cholesky_phase_clock',
                               len(PHASES), fn, batch, stride, device)


def kernel_info(batch: int, n: int, m: int = 0, row: int | None = None
                ) -> dict:
    """Registers a thread, shared memory a block, blocks an SM and grid of
    row `row`'s kernel at n (14, 15, 16 or 17; by default row 17 for m 0,
    else row 16 with m right-hand sides)."""
    row = row or (16 if m else 17)
    out = (ctypes.c_int * 4)()
    fn = _cuda.function('cholesky', 'cholesky_info',
                        [_I] * 4 + [ctypes.POINTER(ctypes.c_int * 4)])
    _cuda.raise_on(fn(row, batch, n, m, ctypes.byref(out)), 'cholesky_info')
    return _cuda.info_dict(out)
