"""A kernel wrapper's time on the card apart from its host time.

    from flybody_tpu_torch.tools import device_time
    device_time.readings(lambda: narrowphase.narrowphase(*args), reps=20)

CUDA events around back-to-back wrapper calls (profile_engine._time) read
whichever is larger, the kernels or the wrapper's host work (its checks,
allocations and the ctypes call); events around one call read both.
`readings(fn, reps)` separates them, per call of fn():
  * `device_ms`: the device time of the hand kernels fn launched (those
    whose bare name is a __global__ function of csrc/*.cu,
    profile_step.kernel_name, so each is read by its exact name), from
    torch.profiler (CUPTI), summed over `reps` calls and divided by reps;
    `kernels` gives every kernel's, library kernels too (None where the
    profiler dropped kernels in three windows);
  * `queued_ms`: CUDA events around `reps` calls queued behind
    torch.cuda._sleep, so the host has enqueued them all before the card
    reaches the first (the gaps between back-to-back kernels included);
  * `host_ms`: the host clock around those calls: the wrapper's own time.
The card sleeps for SLEEP_MS, which must outlast the host's enqueueing; a
reading where it did not (a wrapper that synchronises, or a slow host) has
`queued_ms` None.
"""

from __future__ import annotations

import time

SLEEP_MS = 30.0  # the card's sleep ahead of the queued calls

_cycles_per_ms = None


def _sleep_cycles() -> int:
    """torch.cuda._sleep cycles that last about SLEEP_MS on this card
    (measured once)."""
    import torch
    global _cycles_per_ms
    if _cycles_per_ms is None:
        n = 10_000_000
        torch.cuda._sleep(n)  # warm-up
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(n)
        b.record()
        b.synchronize()
        _cycles_per_ms = n / a.elapsed_time(b)
    return int(SLEEP_MS * _cycles_per_ms)


def queued(fn, reps: int) -> tuple:
    """(queued_ms, host_ms) per call of fn (see the module's docstring)."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = _sleep_cycles()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3
    b.record()
    b.synchronize()
    dev = a.elapsed_time(b) / reps
    return (dev if host < 0.8 * SLEEP_MS else None), host / reps


def profiled(fn, reps: int, tries: int = 3) -> tuple:
    """(device ms a call of the hand kernels, {kernel name: device ms a
    call} of every kernel) fn launches, from torch.profiler. A window
    whose kernels are not a multiple of reps (the profiler dropped some)
    is taken again, up to `tries` times; then None, {}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from flybody_tpu_torch.tools import profile_step as ps
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels, count = {}, 0
        for e in prof.events():
            if ps._is_kernel(e):
                name = ps.kernel_name(e.name)
                kernels[name] = kernels.get(name, 0.0) + ps._device_us(
                    e, False) / 1e3 / reps
                count += 1
        if count and count % reps == 0:
            hand = [ms for name, ms in kernels.items()
                    if name in ps.csrc_kernels()]
            return sum(hand), kernels
    return None, {}


def readings(fn, reps: int = 20) -> dict:
    """device_ms, kernels, queued_ms and host_ms of fn (one wrapper call
    a call)."""
    dev, kernels = profiled(fn, reps)
    q, host = queued(fn, reps)
    return dict(device_ms=dev, kernels=kernels, queued_ms=q, host_ms=host)


def fmt(ms) -> str:
    return 'n/a' if ms is None else f'{ms:.4f}'


def line(r: dict) -> str:
    """The readings as a line's tail."""
    return (f'device {fmt(r["device_ms"])} ms (queued '
            f'{fmt(r["queued_ms"])}), wrapper host {r["host_ms"]:.4f} ms')
