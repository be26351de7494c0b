"""Weight initialisers with the reference's distributions (not its numbers).

Counterpart of percnn_tpu/core/init.py.  Weights are channels-last: conv
[*k, Cin, Cout], pointwise [Cin, Cout]; fans follow torch (fan_in = Cin *
prod(k), fan_out = Cout * prod(k)).  Draws come from an explicit CPU
``torch.Generator``, so they are the same on every device.
"""

from __future__ import annotations

import math

import torch


def _uniform(gen: torch.Generator, shape, lo: float, hi: float,
             dtype: torch.dtype) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype)


def _fans(shape) -> tuple[int, int]:
    receptive = 1
    for s in shape[:-2]:
        receptive *= s
    return shape[-2] * receptive, shape[-1] * receptive


def scaled_xavier_uniform(gen, shape, c: float = 1.0,
                          dtype=torch.float32) -> torch.Tensor:
    """c * XavierUniform: U(-b, b) * c with b = sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = _fans(shape)
    b = math.sqrt(6.0 / (fan_in + fan_out))
    return c * _uniform(gen, shape, -b, b, dtype)


def scaled_fanin_uniform(gen, shape, c: float = 1.0,
                         dtype=torch.float32) -> torch.Tensor:
    """U(-b, b) with b = c * sqrt(1 / fan), fan as torch computes it for an
    OIHW weight from the first dims (the forward-sim variant)."""
    fan = shape[-1] * shape[-2]
    for s in shape[:-3]:
        fan *= s
    b = c * math.sqrt(1.0 / fan)
    return _uniform(gen, shape, -b, b, dtype)


def uniform_symmetric(gen, shape=(), half_width: float = 1.0,
                      dtype=torch.float32) -> torch.Tensor:
    """U(-half_width, half_width)."""
    return _uniform(gen, shape, -half_width, half_width, dtype)
