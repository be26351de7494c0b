"""Convolutions in the JAX package's channels-last layout.

Counterpart of percnn_tpu/ops/convs.py.  Activations are [..., *spatial, C]
and weights [*k, Cin, Cout], as there; PyTorch's own convolutions take
channels first, so the convs permute around the library call.  The k x k
convs run in full float32 (``full_f32``): cuDNN would take them to TF32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from percnn_tpu_torch._device import full_f32

_CONV = {2: F.conv2d, 3: F.conv3d}


def pointwise_conv(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None) -> torch.Tensor:
    """1x1 conv: x [..., Cin] @ w [Cin, Cout] (+ b [Cout])."""
    y = torch.einsum("...i,io->...o", x, w)
    if b is not None:
        y = y + b
    return y


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
          wrap: bool) -> torch.Tensor:
    """VALID cross-correlation of channels-last x [..., *spatial, Cin] with
    w [*k, Cin, Cout], stride 1; with `wrap`, x is first wrap-padded by
    (k//2, (k-1)//2) per spatial dim."""
    nd = w.ndim - 2
    if nd not in _CONV:
        raise ValueError(f"the convs take a 2D or 3D kernel, got weight {tuple(w.shape)}")
    lead = tuple(x.shape[:-1 - nd])
    xb = x.reshape((-1,) + tuple(x.shape[-1 - nd:])).movedim(-1, 1)
    if wrap:
        pads = []
        for k in reversed(w.shape[:nd]):   # F.pad lists the last dim first
            pads += [k // 2, (k - 1) // 2]
        xb = F.pad(xb, pads, mode="circular")
    with full_f32():
        y = _CONV[nd](xb, w.permute(nd + 1, nd, *range(nd)), b)
    y = y.movedim(1, -1)
    return y.reshape(lead + tuple(y.shape[1:]))


def conv_nd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """VALID 2D or 3D conv, channels-last: x [..., *spatial, Cin],
    w [*k, Cin, Cout], stride 1."""
    return _conv(x, w, b, wrap=False)


def conv_nd_periodic(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None) -> torch.Tensor:
    """'Same'-size conv on a periodic grid: wrap-pad by (k//2, (k-1)//2) per
    spatial dim, then a VALID conv."""
    return _conv(x, w, b, wrap=True)


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
