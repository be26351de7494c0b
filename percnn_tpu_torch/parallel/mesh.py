"""A device mesh for spatial decomposition: a named array of torch devices.

Counterpart of percnn_tpu/parallel/mesh.py.  ``factor_devices`` is its copy
(pure Python).  ``Mesh`` stands in for ``jax.sharding.Mesh``: ``devices``
is a numpy object array of ``torch.device`` in the mesh's shape, and
``mesh.shape[name]`` is the size of an axis, as in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from percnn_tpu_torch._device import resolve_device


def factor_devices(n: int, n_axes: int) -> tuple[int, ...]:
    """Factor n devices into n_axes near-equal factors (descending)."""
    dims = [1] * n_axes
    rem = n
    for i in range(n_axes - 1):
        target = round(rem ** (1.0 / (n_axes - i)))
        f = 1
        for d in range(target, 0, -1):
            if rem % d == 0:
                f = d
                break
        dims[i] = f
        rem //= f
    dims[-1] = rem
    return tuple(sorted(dims, reverse=True))


class Mesh:
    """Devices in a named grid: ``devices`` [*shape] of torch.device."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {devices.shape} needs {devices.ndim} axis "
                             f"names, got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """Axis name -> size, in the mesh's order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(axis_names: tuple[str, ...] = ("x", "y"), *,
              shape: tuple[int, ...] | None = None, devices=None) -> Mesh:
    """Build a Mesh over every CUDA device, or over the given devices.

    shape=None factors the device count across the axes.  A device may be
    given more than once: ``devices=["cpu"] * 8`` or
    ``[torch.device("cuda", 0)] * 4`` make a mesh of blocks that share one
    device, the port's counterpart of XLA's virtual host devices
    (``--xla_force_host_platform_device_count``), so a decomposition runs,
    exchanges included, where there is one card or none.  With no devices
    given and no CUDA device, it raises: there is no CPU fallback.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=, e.g. "
                               "['cpu'] * 4, to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [canonical_device(resolve_device(d)) for d in devices]
    n = len(devices)
    if shape is None:
        shape = factor_devices(n, len(axis_names))
    shape = tuple(shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.empty(shape, dtype=object)
    for idx, d in zip(np.ndindex(shape), devices):
        arr[idx] = d
    return Mesh(arr, axis_names)


def canonical_device(dev: torch.device) -> torch.device:
    """A CUDA device with its index (the current device's when unnamed)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
