"""Convolutions in the JAX package's channels-last layout.

Counterpart of percnn_tpu/ops/convs.py.  Activations are [..., *spatial, C]
and weights [*k, Cin, Cout], as there; PyTorch's own convolutions take
channels first, so the transposed conv permutes around the library call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pointwise_conv(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None) -> torch.Tensor:
    """1x1 conv: x [..., Cin] @ w [Cin, Cout] (+ b [Cout])."""
    y = torch.einsum("...i,io->...o", x, w)
    if b is not None:
        y = y + b
    return y


def conv_transpose_torch(x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor | None = None, *, stride: int = 2,
                         padding: int = 2, output_padding: int = 1) -> torch.Tensor:
    """2D transposed conv with ``ConvTranspose2d`` semantics, channels-last.

    x: [..., H, W, Cin]; w: [kh, kw, Cin, Cout].  PyTorch stores a
    transposed conv's weight as [Cin, Cout, kh, kw], so w is permuted to
    that.  out_size = (in - 1) * stride - 2 * padding + k + output_padding.
    """
    if w.ndim != 4:
        raise NotImplementedError("only the 2D transposed conv is ported so far")
    lead = x.shape[:-3]
    xb = x.reshape((-1,) + tuple(x.shape[-3:])).movedim(-1, 1)
    y = F.conv_transpose2d(xb, w.permute(2, 3, 0, 1), b, stride=stride,
                           padding=padding, output_padding=output_padding)
    y = y.movedim(1, -1)
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))
