"""The Newton solve on the block-arrow Hessian: kernels 8, 9 and 10.

Counterpart of flybody_tpu/ops/newton_fused.py. The carried Newton state
is (x, msm = M (x - a_free), jar_l, jar_c); along an accepted step all
four update linearly. A block factors the packed Hessian once and runs n
iterations on it, with the cross-limb contact rows carried by a rank-3*SB
Woodbury correction H = A + U^T U:

  * `newton_block` (kernel 8, csrc/newton.cu; the TPU's `_block_fn`): one
    block from a Hessian assembled outside. Plain version
    `newton_block_ref` (the JAX package's `_ref_block`).
  * `newton_solve` (kernel 9 in its whole-solve mode, csrc/newton.cu; the
    TPU's `_block_full_fn(whole_solve=True)`): the whole solve when
    iterations <= refactor period: warmstart pick, init, float32 Hessian
    and Woodbury assembly, the block, final forces and qfrc. Plain version
    `newton_solve_ref` (`_ref_solve_full`).
  * `newton_block_full` (kernel 9 in its block-full mode, csrc/newton.cu;
    the TPU's `_block_full_fn(whole_solve=False)`,
    make_newton_block_full_pe): one block from the carried state with the
    whole solve's float32 Hessian and Woodbury assembly in the kernel.
    Plain version `newton_block_full_ref` (`_ref_block_full`).
  * `reuse` (kernel 10, csrc/newton.cu's `newton_reuse_kernel`, a kernel
    of its own beside the template of kernels 8 and 9; the TPU's
    `_fused_fn`, make_reuse_pe): n iterations with a factor kept from a
    fresh arrow step on an unpacked (dense) M: the packed factor F, the
    Woodbury operands Z and U and the capacitance factor LC come in; M is
    dense or packed. Plain version `reuse_ref` (`_ref_step_n`).

CUDA tensors launch the kernels (float32, contiguous; the operands the
kernels copy per env in bulk 16-byte aligned with each env's slab a
multiple of 16 bytes, `check_slabs`; anything else raises); CPU tensors
take the plain versions. The cone machinery and the
Hessian/Woodbury assembly shared with physics/solver.py live here.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from flybody_tpu_torch.ops import _cuda
from flybody_tpu_torch.ops import arrow as _ar
from flybody_tpu_torch.ops import linesearch as _ls

launches = 0  # newton_block kernel launches
solve_launches = 0  # newton_solve kernel launches
block_full_launches = 0  # newton_block_full kernel launches
reuse_launches = 0  # newton reuse kernel launches

# The phases whose clocks `record_phases` reads (csrc/newton.cu's PHASE
# marks); the last seven repeat in every Newton iteration. Kernel 10 has
# no assembly, factor or Z phase; its Ci overlaps its first J^T f and
# solve, or falls in the line search of the block's env before.
PHASES = ('stage-in', 'cone Hessians', 'assembly', 'Woodbury rows',
          'factor', 'Z = A^-1 U', 'capacitance + Ci', 'J^T f', 'solve',
          'Woodbury correction', 'M dx', 'J dx', 'line search', 'update',
          'write-out')
MODES = {'block': 0, 'whole': 1, 'reuse': 2, 'block_full': 3}


# ------------------------------------------------------ cone machinery


def cone_residual(jar, mu, frictional, active):
    """jar - proj(jar) onto {v_n >= mu ||v_t||}, per contact (..., 3)."""
    N, y = jar[..., 0], jar[..., 1:]
    T = torch.linalg.norm(y, dim=-1)
    a = 1.0 / torch.clamp(mu, min=1e-6)
    w = (N + a * T) / (1.0 + a * a)
    top = N >= mu * T
    bottom = mu * N + T <= 0.0
    safe_T = torch.clamp(T, min=1e-15)
    res = torch.cat([(N - w)[..., None],
                     y * (1.0 - a * w / safe_T)[..., None]], -1)
    res = torch.where(bottom[..., None], jar, res)
    res = torch.where(top[..., None], torch.zeros_like(jar), res)
    res_fl = torch.cat([torch.clamp(N, max=0.0)[..., None],
                        torch.zeros_like(y)], -1)
    res = torch.where(frictional[..., None] > 0, res, res_fl)
    return res * active[..., None]


def cone_hessian(jar, mu, frictional, active):
    """Per-contact 3x3 Hessian of 0.5 ||residual||^2."""
    N, y = jar[..., 0], jar[..., 1:]
    T = torch.linalg.norm(y, dim=-1)
    a = 1.0 / torch.clamp(mu, min=1e-6)
    safe_T = torch.clamp(T, min=1e-15)
    yhat = y / safe_T[..., None]
    w = (N + a * T) / (1.0 + a * a)
    top = N >= mu * T
    bottom = mu * N + T <= 0.0
    c = 1.0 / (1.0 + a * a)
    dP = jar.new_zeros(jar.shape + (3,))
    dP[..., 0, 0] = c
    dP[..., 0, 1:] = (a * c)[..., None] * yhat
    dP[..., 1:, 0] = (a * c)[..., None] * yhat
    outer = yhat[..., :, None] * yhat[..., None, :]
    I2 = torch.eye(2, dtype=jar.dtype, device=jar.device)
    dP[..., 1:, 1:] = ((a * a * c)[..., None, None] * outer
                       + (a * w / safe_T)[..., None, None] * (I2 - outer))
    I3 = torch.eye(3, dtype=jar.dtype, device=jar.device)
    H = torch.where(bottom[..., None, None], I3.expand_as(dP), I3 - dP)
    H = torch.where(top[..., None, None], torch.zeros_like(H), H)
    H_fl = torch.zeros_like(H)
    H_fl[..., 0, 0] = (N < 0).to(jar.dtype)
    H = torch.where((frictional > 0)[..., None, None], H, H_fl)
    return H * active[..., None, None]


def chol3_psd(W):
    """Closed-form lower Cholesky of PSD (..., 3, 3) blocks; zero pivots
    give zero rows."""
    a = torch.sqrt(torch.clamp(W[..., 0, 0], min=0.0))
    ia = torch.where(a > 1e-12, 1.0 / torch.clamp(a, min=1e-30),
                     torch.zeros_like(a))
    b = W[..., 1, 0] * ia
    c = W[..., 2, 0] * ia
    d = torch.sqrt(torch.clamp(W[..., 1, 1] - b * b, min=0.0))
    idd = torch.where(d > 1e-12, 1.0 / torch.clamp(d, min=1e-30),
                      torch.zeros_like(d))
    e = (W[..., 2, 1] - c * b) * idd
    f = torch.sqrt(torch.clamp(W[..., 2, 2] - c * c - e * e, min=0.0))
    z = torch.zeros_like(a)
    return torch.stack([torch.stack([a, z, z], -1),
                        torch.stack([b, d, z], -1),
                        torch.stack([c, e, f], -1)], -2)


def jv(J, x):
    """(B, K, 3, nv) x (B, nv) -> (B, K, 3)."""
    return torch.einsum('bkrv,bv->bkr', J, x)


def jtf(J, f):
    """(B, K, 3, nv)^T (B, K, 3) -> (B, nv)."""
    return torch.einsum('bkrv,bkr->bv', J, f)


def lim_scatter(nv, lim_dof, vals):
    """(B, L) limit-row values summed into their dofs, (B, nv)."""
    out = vals.new_zeros((vals.shape[0], nv))
    return out.index_add_(1, torch.as_tensor(lim_dof, device=vals.device),
                          vals)


# ------------------------------------------- Hessian and Woodbury rows


def assemble_hessian(part, M, conJ, lim_dof, hd, Wc, bf16: bool):
    """Packed Newton Hessian M + J^T Wc J + diag(S hd) + 1e-12, from the
    per-contact weighted cone Hessians Wc (B, K, 3, 3) and the limit
    diagonal weights hd (B, L). `bf16`: round the J^T (Wc J) operands to
    bfloat16 at float32, multiplying in float32, as the JAX package's
    split form does (solver.py:717-723); the whole-solve form assembles in
    float32 without rounding."""
    nv = part.nv
    hd_dof = lim_scatter(nv, lim_dof, hd)
    JH = torch.einsum('bkrs,bksv->bkrv', Wc, conJ)
    Bn, K = JH.shape[:2]
    J2 = conJ.reshape(Bn, 3 * K, nv)
    JHr = JH.reshape(Bn, 3 * K, nv)
    if bf16 and J2.dtype == torch.float32:
        # Round-trip through bf16 and multiply in f32 (a full-f32 product:
        # torch.backends.cuda.matmul.allow_tf32 must stay False, PyTorch's
        # default).
        J2 = J2.to(torch.bfloat16).to(torch.float32)
        JHr = JHr.to(torch.bfloat16).to(torch.float32)
    JTJH = J2.transpose(1, 2) @ JHr
    Hp = M + _ar.pack_sym_ref(part, JTJH, pad_identity=False)
    return _ar.add_diag_packed(part, Hp, hd_dof + 1e-12)


def woodbury_rows(conJ, bsel, jar_c, mu, frictional, D, act):
    """U (B, 3 SB, nv): the rows G^T V of the selected cross-limb slots
    bsel (B, SB), G the lower Cholesky of D * cone Hessian at jar_c with
    the break-active mask `act`."""
    Bn = conJ.shape[0]
    bi = torch.arange(Bn, device=conJ.device)[:, None]
    Wb = (cone_hessian(jar_c[bi, bsel], mu[bi, bsel], frictional[bi, bsel],
                       act[bi, bsel]) * D[bi, bsel][..., None, None])
    G = chol3_psd(Wb)
    U = torch.einsum('bsrc,bsrv->bscv', G, conJ[bi, bsel])
    return U.reshape(Bn, -1, conJ.shape[-1]).contiguous()


# ------------------------------------------------------ plain versions


def newton_step(part, lim_dof, lim_sign, ls_iters, F, M, conJ, Z, U, LC,
                st, lim_params, con_params):
    """One Newton iteration on a fixed factor (the JAX `_ref_step`).
    U (B, 3SB, nv) Woodbury rows, Z = A^-1 U^T (B, nv, 3SB), LC the lower
    Cholesky of I + U Z; M packed or dense."""
    x, msm, jar_l, jar_c = st
    sign = x.new_tensor(lim_sign)
    actl, Dl = lim_params[:, 0], lim_params[:, 1]
    mu, fric, actc, Dc = con_params.unbind(1)
    f_l = torch.where(jar_l < 0, -Dl * jar_l * actl, torch.zeros_like(jar_l))
    res = cone_residual(jar_c, mu, fric, torch.ones_like(mu))
    f_c = -(Dc * actc)[..., None] * res
    g = msm - lim_scatter(part.nv, lim_dof, f_l * sign) - jtf(conJ, f_c)
    t = _ar.solve_ref(part, F, g)
    w = torch.cholesky_solve(torch.einsum('bsv,bv->bs', U, t)[..., None],
                             LC)[..., 0]
    dx = -(t - torch.einsum('bvs,bs->bv', Z, w))
    mdx = _ar.matvec(part, M, dx)
    jv_c = jv(conJ, dx)
    jv_l = dx[:, lim_dof] * sign
    sm0 = torch.sum(msm * dx, -1)
    smm = torch.sum(dx * mdx, -1)
    lim = (jar_l, jv_l, actl, Dl)
    con = (jar_c[..., 0], jar_c[..., 1], jar_c[..., 2], jv_c[..., 0],
           jv_c[..., 1], jv_c[..., 2], mu, fric, actc, Dc)
    alpha = _ls.alpha_ref(lim, con, sm0, smm, 6, ls_iters)
    a = alpha[:, None]
    return (x + a * dx, msm + a * mdx, jar_l + a * jv_l,
            jar_c + alpha[:, None, None] * jv_c)


def newton_block_ref(part, lim_dof, lim_sign, Hp, M, conJ, U, x, msm,
                     jar_l, jar_c, lim_params, con_params, ls_iters: int,
                     n_iters: int):
    """Plain version of kernel 8: factor Hp, Z = A^-1 U^T, the capacitance
    Cholesky, then n_iters chained Newton steps. Shapes: Hp, M (B, nl+1,
    dm+nr, dm); conJ (B, K, 3, nv); U (B, 3SB, nv); x, msm (B, nv); jar_l
    (B, L); jar_c (B, K, 3); lim_params (B, 2, L) [active | D]; con_params
    (B, 4, K) [mu | frictional | active | D]. Returns (x, msm, jar_l,
    jar_c)."""
    F = _ar.factor_ref_p(part, Hp)
    Z = _ar.solve_ref(part, F, U.transpose(1, 2))
    eye = torch.eye(U.shape[1], dtype=U.dtype, device=U.device)
    LC = torch.linalg.cholesky(eye + U @ Z + 1e-10 * eye)
    st = (x, msm, jar_l, jar_c)
    for _ in range(n_iters):
        st = newton_step(part, lim_dof, lim_sign, ls_iters, F, M, conJ, Z,
                         U, LC, st, lim_params, con_params)
    return st


def reuse_ref(part, lim_dof, lim_sign, F, M, conJ, Z, U, LC, x, msm, jar_l,
              jar_c, lim_params, con_params, ls_iters: int, n_iters: int):
    """Plain version of kernel 10: n_iters chained Newton steps on the
    packed factor F with the Woodbury operands Z (B, nv, 3SB), U (B, 3SB,
    nv) and the capacitance factor LC (B, 3SB, 3SB); M dense (B, nv, nv)
    or packed. Returns (x, msm, jar_l, jar_c)."""
    st = (x, msm, jar_l, jar_c)
    for _ in range(n_iters):
        st = newton_step(part, lim_dof, lim_sign, ls_iters, F, M, conJ, Z,
                         U, LC, st, lim_params, con_params)
    return st


def primal_cost(part, lim_dof, lim_sign, Mp, conJ, a_free, lim_aref,
                con_aref, lim_params, con_params, x):
    """0.5 (x - a_free)^T M (x - a_free) + the constraint cost, per env;
    M packed or dense."""
    dx = x - a_free
    cost = 0.5 * torch.sum(dx * _ar.matvec(part, Mp, dx), -1)
    jl = x[:, lim_dof] * x.new_tensor(lim_sign) - lim_aref
    actl, Dl = lim_params[:, 0], lim_params[:, 1]
    cost = cost + 0.5 * torch.sum(Dl * actl * (jl < 0) * jl ** 2, -1)
    mu, fric, actc, Dc = con_params[:, :4].unbind(1)
    res = cone_residual(jv(conJ, x) - con_aref, mu, fric, actc)
    return cost + 0.5 * torch.sum(Dc[..., None] * res ** 2, (-2, -1))


def newton_block_full_ref(part, lim_dof, lim_sign, Mp, conJ, bsel, x, msm,
                          jar_l, jar_c, lim_params, con_params5,
                          ls_iters: int, n_iters: int):
    """Plain version of kernel 9's block-full mode (the JAX
    `_ref_block_full`): at the carried state, the packed Hessian M +
    J^T W J + the limit diagonal + 1e-12 in float32 without bf16 rounding,
    W the cone Hessians of the hess-active slots; the Woodbury rows of the
    selected cross-limb slots bsel (B, SB) at their active-and-breaking
    mask; then `newton_block_ref`. con_params5 (B, 5, K) [mu | frictional
    | active | D | hess_active]. Returns (x, msm, jar_l, jar_c)."""
    actl, Dl = lim_params[:, 0], lim_params[:, 1]
    mu, fric, actc, Dc, hact = con_params5.unbind(1)
    Wc = cone_hessian(jar_c, mu, fric, hact) * Dc[..., None, None]
    Hp = assemble_hessian(part, Mp, conJ, lim_dof, Dl * actl * (jar_l < 0),
                          Wc, bf16=False)
    U = woodbury_rows(conJ, bsel.long(), jar_c, mu, fric, Dc, actc - hact)
    return newton_block_ref(part, lim_dof, lim_sign, Hp, Mp, conJ, U, x, msm,
                            jar_l, jar_c, lim_params, con_params5[:, :4],
                            ls_iters, n_iters)


def newton_solve_ref(part, lim_dof, lim_sign, Mp, conJ, bsel, a_free, ws,
                     lim_aref, con_aref, lim_params, con_params5,
                     ls_iters: int, n_iters: int):
    """Plain version of kernel 9 (whole solve): the start point is the one
    of (ws, a_free) with the lower primal cost, then the block-full block
    (`newton_block_full_ref`, the JAX `_ref_solve_full`). bsel (B, SB)
    selected cross-limb slots; con_params5 (B, 5, K) [mu | frictional |
    active | D | hess_active]. Returns (qacc, qfrc, f_l, f_c)."""
    sign = a_free.new_tensor(lim_sign)
    actl, Dl = lim_params[:, 0], lim_params[:, 1]
    mu, fric, actc, Dc, _ = con_params5.unbind(1)
    args = (part, lim_dof, lim_sign, Mp, conJ, a_free, lim_aref, con_aref,
            lim_params, con_params5)
    use_ws = primal_cost(*args, ws) < primal_cost(*args, a_free)
    x0 = torch.where(use_ws[:, None], ws, a_free)
    msm0 = _ar.matvec_packed(part, Mp, x0 - a_free)
    jl0 = x0[:, lim_dof] * sign - lim_aref
    jc0 = jv(conJ, x0) - con_aref
    x, _, jar_l, jar_c = newton_block_full_ref(
        part, lim_dof, lim_sign, Mp, conJ, bsel, x0, msm0, jl0, jc0,
        lim_params, con_params5, ls_iters, n_iters)
    f_l = -Dl * jar_l * (actl * (jar_l < 0))
    f_c = -Dc[..., None] * cone_residual(jar_c, mu, fric, actc)
    qfrc = lim_scatter(part.nv, lim_dof, f_l * sign) + jtf(conJ, f_c)
    return x, qfrc, f_l, f_c


# ------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=16)
def _lim_tables_np(lim_dof: tuple, lim_sign: tuple, nv: int):
    dof_lim = np.full((nv, 2), -1, np.int32)
    for i, v in enumerate(lim_dof):
        slot = 0 if dof_lim[v, 0] < 0 else 1
        if dof_lim[v, slot] >= 0:
            raise ValueError('the Newton kernels take at most two limit '
                             'rows per dof')
        dof_lim[v, slot] = i
    return (np.asarray(lim_dof, np.int32), np.asarray(lim_sign, np.float32),
            dof_lim)


_dev_tables: dict = {}


def lim_tables(lim_dof, lim_sign, nv: int, device):
    """Device copies of the limit-row tables: dof (L,), sign (L,) and the
    rows of each dof (nv, 2), -1 for none."""
    key = (tuple(int(v) for v in lim_dof),
           tuple(float(s) for s in lim_sign), nv, str(device))
    if key not in _dev_tables:
        _dev_tables[key] = tuple(torch.as_tensor(a, device=device)
                                 for a in _lim_tables_np(*key[:3]))
    return _dev_tables[key]


_P = ctypes.c_void_p
_I = ctypes.c_int


def check_slabs(*named):
    """(tensor, name) pairs of the operands the kernels stage per env by
    bulk asynchronous copies: each must start 16-byte aligned and hold a
    multiple of 16 bytes an env. Raises ValueError otherwise (the kernels
    have no element-wise copy)."""
    for t, name in named:
        if t.data_ptr() % 16:
            raise ValueError(f'{name}: the kernel copies each env\'s slab '
                             f'in bulk; its storage must be 16-byte '
                             f'aligned (offset {t.data_ptr() % 16} B)')
        per_env = (t.numel() // max(t.shape[0], 1)) * t.element_size()
        if per_env % 16:
            raise ValueError(f'{name}: each env\'s slab must be a multiple '
                             f'of 16 bytes for the bulk copies, got '
                             f'{per_env} B')


def check_widths(part, SB3: int):
    """The partition and Woodbury widths the kernels' register tiles
    hold: limb blocks of at most 16 dofs, a root of at most 6, one block
    and the root within a warp's 32 lanes, at most 32 Woodbury rows."""
    if part.dmax > 16 or part.nr > 6 or part.dmax + part.nr > 32:
        raise ValueError(f'the Newton kernels take limb blocks of <= 16 '
                         f'dofs and a root of <= 6 (dmax {part.dmax}, nr '
                         f'{part.nr})')
    if not 1 <= SB3 <= 32:
        raise ValueError(f'the Newton kernels take 1 to 32 Woodbury rows, '
                         f'got {SB3}')


def newton_block(part, lim_dof, lim_sign, Hp, M, conJ, U, x, msm, jar_l,
                 jar_c, lim_params, con_params, ls_iters: int, n_iters: int):
    """Kernel 8 on CUDA tensors, `newton_block_ref` on CPU tensors (same
    arguments and results)."""
    if Hp.device.type == 'cpu':
        return newton_block_ref(part, lim_dof, lim_sign, Hp, M, conJ, U, x,
                                msm, jar_l, jar_c, lim_params, con_params,
                                ls_iters, n_iters)
    global launches
    nl, dm, nr, nv = len(part.ds), part.dmax, part.nr, part.nv
    Bn, K = conJ.shape[:2]
    SB3, L = U.shape[1], len(lim_dof)
    pk = (Bn, nl + 1, dm + nr, dm)
    for t, shape, name in ((Hp, pk, 'Hp'), (M, pk, 'M'),
                           (conJ, (Bn, K, 3, nv), 'conJ'),
                           (U, (Bn, SB3, nv), 'U'), (x, (Bn, nv), 'x'),
                           (msm, (Bn, nv), 'msm'), (jar_l, (Bn, L), 'jar_l'),
                           (jar_c, (Bn, K, 3), 'jar_c'),
                           (lim_params, (Bn, 2, L), 'lim_params'),
                           (con_params, (Bn, 4, K), 'con_params')):
        _cuda.check(t, shape, name)
    check_widths(part, SB3)
    check_slabs((Hp, 'Hp'), (U, 'U'), (x, 'x'),
                (msm, 'msm'), (jar_l, 'jar_l'), (jar_c, 'jar_c'),
                (lim_params, 'lim_params'), (con_params, 'con_params'))
    ldof, lsign, dlim = lim_tables(lim_dof, lim_sign, nv, Hp.device)
    outs = (torch.empty_like(x), torch.empty_like(msm),
            torch.empty_like(jar_l), torch.empty_like(jar_c))
    fn = _cuda.function('newton', 'newton_block_f32', [_P] * 14 + [
        _I, _I, _I, _I, _P, _P, _P, _I, _I, ctypes.POINTER(_ar.CPart), _P])
    rc = fn(*(t.data_ptr() for t in (Hp, M, conJ, U, x, msm, jar_l, jar_c,
                                     lim_params, con_params) + outs),
            Bn, K, SB3, L, ldof.data_ptr(), lsign.data_ptr(),
            dlim.data_ptr(), ls_iters, n_iters,
            ctypes.byref(_ar.c_part(part)), _cuda.stream())
    _cuda.raise_on(rc, 'newton_block_f32')
    launches += 1
    return outs


def newton_solve(part, lim_dof, lim_sign, Mp, conJ, bsel, a_free, ws,
                 lim_aref, con_aref, lim_params, con_params5, ls_iters: int,
                 n_iters: int):
    """Kernel 9 (whole solve) on CUDA tensors, `newton_solve_ref` on CPU
    tensors. bsel: int32 on the card."""
    if Mp.device.type == 'cpu':
        return newton_solve_ref(part, lim_dof, lim_sign, Mp, conJ, bsel,
                                a_free, ws, lim_aref, con_aref, lim_params,
                                con_params5, ls_iters, n_iters)
    global solve_launches
    nl, dm, nr, nv = len(part.ds), part.dmax, part.nr, part.nv
    Bn, K = conJ.shape[:2]
    SB, L = bsel.shape[1], len(lim_dof)
    for t, shape, name in ((Mp, (Bn, nl + 1, dm + nr, dm), 'Mp'),
                           (conJ, (Bn, K, 3, nv), 'conJ'),
                           (a_free, (Bn, nv), 'a_free'), (ws, (Bn, nv), 'ws'),
                           (lim_aref, (Bn, L), 'lim_aref'),
                           (con_aref, (Bn, K, 3), 'con_aref'),
                           (lim_params, (Bn, 2, L), 'lim_params'),
                           (con_params5, (Bn, 5, K), 'con_params5')):
        _cuda.check(t, shape, name)
    _cuda.check(bsel, (Bn, SB), 'bsel', dtype=torch.int32)
    check_widths(part, 3 * SB)
    check_slabs((Mp, 'Mp'), (a_free, 'a_free'), (ws, 'ws'),
                (lim_aref, 'lim_aref'), (con_aref, 'con_aref'),
                (lim_params, 'lim_params'), (con_params5, 'con_params5'))
    ldof, lsign, dlim = lim_tables(lim_dof, lim_sign, nv, Mp.device)
    outs = (torch.empty_like(a_free), torch.empty_like(a_free),
            torch.empty_like(lim_aref), torch.empty_like(con_aref))
    fn = _cuda.function('newton', 'newton_solve_f32', [_P] * 13 + [
        _I, _I, _I, _I, _P, _P, _P, _I, _I, ctypes.POINTER(_ar.CPart), _P])
    rc = fn(*(t.data_ptr() for t in (Mp, conJ, bsel, a_free, ws, lim_aref,
                                     con_aref, lim_params, con_params5)
              + outs),
            Bn, K, SB, L, ldof.data_ptr(), lsign.data_ptr(), dlim.data_ptr(),
            ls_iters, n_iters, ctypes.byref(_ar.c_part(part)),
            _cuda.stream())
    _cuda.raise_on(rc, 'newton_solve_f32')
    solve_launches += 1
    return outs


def newton_block_full(part, lim_dof, lim_sign, Mp, conJ, bsel, x, msm,
                      jar_l, jar_c, lim_params, con_params5, ls_iters: int,
                      n_iters: int):
    """Kernel 9's block-full mode on CUDA tensors, `newton_block_full_ref`
    on CPU tensors (same arguments and results). bsel: int32 on the
    card."""
    if Mp.device.type == 'cpu':
        return newton_block_full_ref(part, lim_dof, lim_sign, Mp, conJ, bsel,
                                     x, msm, jar_l, jar_c, lim_params,
                                     con_params5, ls_iters, n_iters)
    global block_full_launches
    nl, dm, nr, nv = len(part.ds), part.dmax, part.nr, part.nv
    Bn, K = conJ.shape[:2]
    SB, L = bsel.shape[1], len(lim_dof)
    for t, shape, name in ((Mp, (Bn, nl + 1, dm + nr, dm), 'Mp'),
                           (conJ, (Bn, K, 3, nv), 'conJ'),
                           (x, (Bn, nv), 'x'), (msm, (Bn, nv), 'msm'),
                           (jar_l, (Bn, L), 'jar_l'),
                           (jar_c, (Bn, K, 3), 'jar_c'),
                           (lim_params, (Bn, 2, L), 'lim_params'),
                           (con_params5, (Bn, 5, K), 'con_params5')):
        _cuda.check(t, shape, name)
    _cuda.check(bsel, (Bn, SB), 'bsel', dtype=torch.int32)
    check_widths(part, 3 * SB)
    check_slabs((Mp, 'Mp'), (x, 'x'), (msm, 'msm'),
                (jar_l, 'jar_l'), (jar_c, 'jar_c'),
                (lim_params, 'lim_params'), (con_params5, 'con_params5'))
    ldof, lsign, dlim = lim_tables(lim_dof, lim_sign, nv, Mp.device)
    outs = (torch.empty_like(x), torch.empty_like(msm),
            torch.empty_like(jar_l), torch.empty_like(jar_c))
    fn = _cuda.function('newton', 'newton_block_full_f32', [_P] * 13 + [
        _I, _I, _I, _I, _P, _P, _P, _I, _I, ctypes.POINTER(_ar.CPart), _P])
    rc = fn(*(t.data_ptr() for t in (Mp, conJ, bsel, x, msm, jar_l, jar_c,
                                     lim_params, con_params5) + outs),
            Bn, K, SB, L, ldof.data_ptr(), lsign.data_ptr(), dlim.data_ptr(),
            ls_iters, n_iters, ctypes.byref(_ar.c_part(part)),
            _cuda.stream())
    _cuda.raise_on(rc, 'newton_block_full_f32')
    block_full_launches += 1
    return outs


def reuse(part, lim_dof, lim_sign, F, M, conJ, Z, U, LC, x, msm, jar_l, jar_c,
          lim_params, con_params, ls_iters: int, n_iters: int):
    """Kernel 10 on CUDA tensors, `reuse_ref` on CPU tensors (same
    arguments and results)."""
    if F.device.type == 'cpu':
        return reuse_ref(part, lim_dof, lim_sign, F, M, conJ, Z, U, LC, x,
                         msm, jar_l, jar_c, lim_params, con_params, ls_iters,
                         n_iters)
    global reuse_launches
    nl, dm, nr, nv = len(part.ds), part.dmax, part.nr, part.nv
    Bn, K = conJ.shape[:2]
    SB3, L = U.shape[1], len(lim_dof)
    pk = (Bn, nl + 1, dm + nr, dm)
    dense = M.dim() == 3
    for t, shape, name in ((F, pk, 'F'),
                           (M, (Bn, nv, nv) if dense else pk, 'M'),
                           (conJ, (Bn, K, 3, nv), 'conJ'),
                           (Z, (Bn, nv, SB3), 'Z'), (U, (Bn, SB3, nv), 'U'),
                           (LC, (Bn, SB3, SB3), 'LC'), (x, (Bn, nv), 'x'),
                           (msm, (Bn, nv), 'msm'), (jar_l, (Bn, L), 'jar_l'),
                           (jar_c, (Bn, K, 3), 'jar_c'),
                           (lim_params, (Bn, 2, L), 'lim_params'),
                           (con_params, (Bn, 4, K), 'con_params')):
        _cuda.check(t, shape, name)
    check_widths(part, SB3)
    check_slabs((F, 'F'), (Z, 'Z'), (U, 'U'), (LC, 'LC'),
                (x, 'x'), (msm, 'msm'), (jar_l, 'jar_l'), (jar_c, 'jar_c'),
                (lim_params, 'lim_params'), (con_params, 'con_params'))
    ldof, lsign, dlim = lim_tables(lim_dof, lim_sign, nv, F.device)
    outs = (torch.empty_like(x), torch.empty_like(msm),
            torch.empty_like(jar_l), torch.empty_like(jar_c))
    fn = _cuda.function('newton', 'newton_reuse_f32', [_P] * 16 + [
        _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, ctypes.POINTER(_ar.CPart),
        _P])
    rc = fn(*(t.data_ptr() for t in (F, M, conJ, Z, U, LC, x, msm, jar_l,
                                     jar_c, lim_params, con_params) + outs),
            Bn, K, SB3, L, int(dense), ldof.data_ptr(), lsign.data_ptr(),
            dlim.data_ptr(), ls_iters, n_iters,
            ctypes.byref(_ar.c_part(part)), _cuda.stream())
    _cuda.raise_on(rc, 'newton_reuse_f32')
    reuse_launches += 1
    return outs


def record_phases(fn, batch: int, stride: int, device):
    """Runs fn() (Newton kernel launches on `batch` envs) with the phase
    clocks on: every stride-th env's cycles in each phase of PHASES, an
    int64 tensor (ceil(batch / stride), len(PHASES)) on the CPU, summed
    over the launches fn makes."""
    return _cuda.record_phases('newton', 'newton_phase_clock', len(PHASES),
                               fn, batch, stride, device)


def kernel_info(mode: str, part, batch: int, K: int, SB3: int,
                L: int) -> dict:
    """Registers a thread, shared memory a block, blocks an SM (the
    occupancy calculator) and grid blocks of a Newton mode's kernel at
    these widths."""
    out = (ctypes.c_int * 4)()
    fn = _cuda.function('newton', 'newton_info', [_I] * 5 + [
        ctypes.POINTER(_ar.CPart), ctypes.POINTER(ctypes.c_int * 4)])
    _cuda.raise_on(fn(MODES[mode], batch, K, SB3, L,
                      ctypes.byref(_ar.c_part(part)), ctypes.byref(out)),
                   'newton_info')
    return _cuda.info_dict(out)
