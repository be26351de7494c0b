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
    """2D or 3D transposed conv with ``ConvTranspose{2,3}d`` semantics,
    channels-last.

    x: [..., *spatial, Cin]; w: [*k, Cin, Cout] with one k per spatial axis.
    PyTorch stores a transposed conv's weight as [Cin, Cout, *k], so w is
    permuted to that.  out_size = (in - 1) * stride - 2 * padding + k +
    output_padding.
    """
    nd = w.ndim - 2
    if nd not in (2, 3):
        raise ValueError(f"transposed conv takes a 2D or 3D kernel, got weight "
                         f"{tuple(w.shape)}")
    conv = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    lead = x.shape[:-1 - nd]
    xb = x.reshape((-1,) + tuple(x.shape[-1 - nd:])).movedim(-1, 1)
    y = conv(xb, w.permute(nd, nd + 1, *range(nd)), b, stride=stride,
             padding=padding, output_padding=output_padding)
    y = y.movedim(1, -1)
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))
