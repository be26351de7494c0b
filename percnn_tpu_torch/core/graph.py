"""Whole iterations as CUDA graphs: the port's counterpart of the JAX
package's ``jit`` of a ``lax.scan`` (percnn_tpu/core/train.py:182-201 and
:392-403, percnn_tpu/data/simulate.py:83-99).

``Replayer(step, device, graph)`` calls ``step``, a function of no
arguments that does one iteration in place over tensors whose addresses
never change, once per call.  On CUDA with ``graph`` set, its first call
runs the step eagerly on a side stream (the warm-up, a real iteration: the
kernels' first-use builds, cuDNN's algorithm choice and the caches the step
fills on first use happen there), its second captures the step into a
``torch.cuda.CUDAGraph`` on that stream and replays it, and every later
call replays the graph.  Anywhere else each call runs the step eagerly, so
the CPU runs the same step function.  A step that cannot be captured raises
at its capture; nothing falls back to the eager loop.

Under a process group (parallel/spmd.py) the step holds collectives: the
all-reduces and gathers of DTensor and the halo exchange's paired sends
and receives (ops/spmd_halo.py).  Each rank captures its own graph, NCCL's
kernels in it.  The warm-up iteration runs every collective of the step
once, so NCCL has made each communicator it needs (the point-to-point
pairs too, which it makes at their first send) before the capture, which
could not make one.  Every rank replays its graph once per call, as it
ran the step, so the ranks' collectives stay matched.

The kernels' launch and step counters and the halo exchange's send and
byte counters are Python attributes that their wrappers add to as they
launch or send.  A capture adds to them for work that has not run, and a
replay adds nothing, so the change over the capture is taken off and
added back once per replay: the counters count what ran, as in the eager
loop.
"""

from __future__ import annotations

import inspect
import time
from typing import Callable

import torch

from percnn_tpu_torch import _device

_COUNTER_ATTRS = ("launches", "steps", "launches_kxk", "steps_kxk")


def kernel_counters() -> list:
    """Every launch and step counter of the kernel wrappers, as
    (function, attribute) pairs."""
    from percnn_tpu_torch.ops.kernels import (backward2d, backward3d, batched2d, cell2d, cell3d,
                                              sharded_step2d)

    found = []
    for mod in (cell2d, cell3d, backward2d, backward3d, batched2d, sharded_step2d):
        for obj in vars(mod).values():
            if inspect.isfunction(obj) and obj.__module__ == mod.__name__:
                found += [(obj, a) for a in _COUNTER_ATTRS if isinstance(getattr(obj, a, None), int)]
    return found


def halo_counters() -> list:
    """The halo exchange's send and byte counters (ops/spmd_halo.py), as
    (module, attribute) pairs."""
    from percnn_tpu_torch.ops import spmd_halo

    return [(spmd_halo, "sends"), (spmd_halo, "bytes_sent")]


class Replayer:
    """Run `step` once per call: eagerly, or on CUDA with `graph` as a
    captured graph after one eager warm-up (the module docstring)."""

    def __init__(self, step: Callable[[], None], device: torch.device, graph: bool = True):
        self.step = step
        self.device = device
        self.graphed = graph and device.type == "cuda"
        self.stream = None
        self.graph = None
        self.deltas: list = []          # (function, attribute, change) of one replay
        self.capture_seconds = None     # host seconds of the capture

    def __call__(self) -> None:
        if not self.graphed:
            self.step()
        elif self.stream is None:
            self._warm_up()
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            for obj, attr, change in self.deltas:
                setattr(obj, attr, getattr(obj, attr) + change)

    def _warm_up(self) -> None:
        self.stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.step()
        current.wait_stream(self.stream)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        counters = kernel_counters() + halo_counters()
        before = [getattr(obj, attr) for obj, attr in counters]
        graph = torch.cuda.CUDAGraph()
        try:
            # On a rank of a process group the capture refuses only this
            # thread's calls that cannot be captured ("thread_local"), not
            # those of the threads ProcessGroupNCCL runs beside it, such as
            # its watchdog's event queries.  Every gspmd run of the port
            # has been captured so, on one card and on four; "global", the
            # default kept for one device, has captured the one-position
            # GS2D run as well, and no capture has been seen to fail in it.
            mode = "thread_local" if _device.in_group() else "global"
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode=mode):
                self.step()
        except RuntimeError as err:
            raise RuntimeError(
                "an iteration could not be captured into a CUDA graph (the op that "
                "failed is named below); a caller that must run this step eagerly "
                f"passes graph=False: {err}") from err
        self.deltas = []
        for (obj, attr), was in zip(counters, before):
            change = getattr(obj, attr) - was
            if change:
                setattr(obj, attr, was)
                self.deltas.append((obj, attr, change))
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0

    def close(self) -> None:
        """Free the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
