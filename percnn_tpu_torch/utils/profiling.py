"""Profiling and timing: a device trace around a block, the round trip of a
trivial op, and a best-of-N timer.

Counterpart of percnn_tpu/utils/profiling.py.  ``trace`` wraps
``torch.profiler`` (CPU, and CUDA when a card is present: CUPTI records the
hand-written kernels too, ctypes launches included) and writes a Chrome
trace that Perfetto and chrome://tracing open.  ``Timer`` subtracts the
round trip of a trivial op from each call, as the JAX version does for its
remote device.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from percnn_tpu_torch._device import resolve_device

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(path: str):
    """Profile the block; on exit write ``{path}/trace.json``.  Yields the
    ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(path, exist_ok=True)
    prof.export_chrome_trace(os.path.join(path, TRACE_FILE))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_rtt(n: int = 5, *, device: str | torch.device = "cuda") -> float:
    """Seconds of the fastest of n round trips of a trivial op: its launch
    and a synchronise on the card, the op alone on the CPU."""
    dev = resolve_device(device)
    x = torch.zeros(8, device=dev)
    _ = x + 1
    _sync(dev)
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        _ = x + 1
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


class Timer:
    """Best-of-N wall timer with the round trip subtracted.

    >>> t = Timer(device="cuda")
    >>> per_call = t.time(lambda: fn(x), reps=3)   # seconds
    """

    def __init__(self, *, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.rtt = measure_rtt(device=self.device)

    def time(self, fn, *, reps: int = 3, inner: int = 1) -> float:
        """Seconds a call of fn over `inner` (the calls fn makes), the best
        of `reps`, after one warm-up; the clock is read after a synchronise."""
        fn()
        _sync(self.device)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            _sync(self.device)
            best = min(best, time.perf_counter() - t0)
        return max(best - self.rtt, 1e-9) / inner
