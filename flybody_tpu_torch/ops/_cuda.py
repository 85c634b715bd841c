"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain C
interface (`-gencode arch=compute_90a,code=sm_90a`), loaded with ctypes.
Libraries land in flybody_tpu_torch/_build/, named by a hash of the
sources so an edit rebuilds; nothing is built or imported until a kernel
is first launched, so the package imports on machines without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD = os.path.join(_PKG, '_build')
SOURCES = ('pos_stage', 'narrowphase', 'mpr', 'force_stage', 'efc_stage',
           'arrow', 'sens_stage', 'newton', 'noslip', 'cholesky',
           'linesearch', 'noslip_gs')

_libs: dict = {}
_fns: dict = {}
_lock = threading.Lock()


def nvcc() -> str:
    for cand in (os.environ.get('NVCC'), shutil.which('nvcc'),
                 '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (set NVCC or put nvcc on PATH)')


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source and of every
    header in csrc/ (so an edit to any header rebuilds)."""
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith('.cuh'))
    for fn in [f'{name}.cu'] + headers:
        with open(os.path.join(CSRC, fn), 'rb') as f:
            h.update(f.read())
    return os.path.join(BUILD, f'lib{name}_{h.hexdigest()[:12]}.so')


def _command(name: str, out: str) -> list[str]:
    return [nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
            '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
            '-Xptxas', '-v', '-o', out, os.path.join(CSRC, f'{name}.cu')]


def build_all(names=SOURCES) -> dict:
    """Compiles every missing library, one nvcc per source, all started
    together. Returns {name: ptxas report} for the sources it built."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if not os.path.exists(out):
            procs[name] = (out, subprocess.Popen(
                _command(name, out + '.tmp'), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (out, p) in procs.items():  # wait for every nvcc
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f'nvcc failed for {name}.cu:\n{log}')
            continue
        os.replace(out + '.tmp', out)
        reports[name] = log
    if failed:
        raise RuntimeError('\n'.join(failed))
    return reports


def lib(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all((name,))
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]


def function(name: str, symbol: str, argtypes):
    """The C entry `symbol` of library `name`, argtypes set, returning the
    cudaError_t of its launch as an int."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(lib(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(t: torch.Tensor, shape, what: str, dtype=torch.float32):
    """Kernel operands: CUDA, float32 (int32 for indices), contiguous, of
    the given shape."""
    if t.device.type != 'cuda':
        raise ValueError(f'{what}: expected a CUDA tensor, got {t.device}')
    if t.dtype != dtype:
        raise TypeError(f'{what}: the kernels take {dtype}, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{what}: expected shape {tuple(shape)}, got '
                         f'{tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{what}: expected a contiguous tensor')


def bulk_mask(tensors) -> int:
    """Bit i set when tensors[i] starts 16-byte aligned and holds a
    multiple of 16 bytes an env (its leading dimension): the terms of a 1-D
    bulk copy of one env's slab. Kernels move the others element by
    element."""
    m = 0
    for i, t in enumerate(tensors):
        per_env = (t.numel() // max(t.shape[0], 1)) * t.element_size()
        if t.data_ptr() % 16 == 0 and per_env % 16 == 0:
            m |= 1 << i
    return m


def record_phases(name: str, symbol: str, nphases: int, fn, batch: int,
                  stride: int, device) -> torch.Tensor:
    """Runs fn() (launches of library `name`'s kernel on `batch` envs)
    with its phase clocks on (C entry `symbol`): every stride-th env's
    cycles in each of the kernel's `nphases` phases, an int64 tensor
    (ceil(batch / stride), nphases) on the CPU, summed over the launches
    fn makes."""
    clk = torch.zeros(((batch + stride - 1) // stride, nphases),
                      dtype=torch.int64, device=device)
    on = function(name, symbol, [ctypes.c_void_p, ctypes.c_int])
    raise_on(on(clk.data_ptr(), stride), symbol)
    try:
        fn()
        torch.cuda.synchronize(device)
    finally:
        on(None, 1)
    return clk.cpu()


def info_dict(out) -> dict:
    """A kernel's resources from its C info entry's four ints."""
    return dict(registers=out[0], smem_bytes=out[1], blocks_per_sm=out[2],
                grid=out[3])


def raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with error {rc}')

