"""Convolutions in the JAX package's channels-last layout.

Counterpart of percnn_tpu/ops/convs.py.  Activations are [..., *spatial, C]
and weights [*k, Cin, Cout], as there; PyTorch's own convolutions take
channels first, so the convs permute around the library call.  The k x k
convs run in full float32 (``full_f32``): cuDNN would take them to TF32.
The weight gradient of the 2D convs (the k x k Pi branches, periodic or
VALID) is one FFMA matrix product of the output cotangent with the im2col
stack of the input (``_Conv2d``), not cuDNN's weight-grad convolution.
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


class _Conv2d(torch.autograd.Function):
    """VALID conv2d of a (wrap-padded or haloed) batch xb [N, Cin, H+k-1, W+k-1] with
    w [Cout, Cin, kh, kw]: cuDNN's forward, and a backward whose weight
    gradient is one full-f32 matmul of the cotangent [Cout, N*L] with the
    im2col stack [N*L, Cin*kh*kw] of xb (L = H*W).

    cuDNN chooses its weight-grad algorithm itself, and on an H100 the one
    it chose for the 5x5 branches rounded the sum over N*L terms to 2.2e-4
    of the f64 gradient, where FFMA gives under 1e-6 (PERF.md, ROADMAP.md
    C2).  The input gradient stays cuDNN's.  The backward is written with
    differentiable ops, so a second derivative still works.
    """

    @staticmethod
    def forward(ctx, xb, w, b):
        ctx.save_for_backward(xb, w)
        ctx.has_bias = b is not None
        with full_f32():
            return F.conv2d(xb, w, b)

    @staticmethod
    def backward(ctx, gy):
        xb, w = ctx.saved_tensors
        gx = gw = gb = None
        with full_f32():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(xb.shape, w, gy)
            if ctx.needs_input_grad[1]:
                cols = F.unfold(xb, tuple(w.shape[2:]))             # [N, Cin*kh*kw, L]
                gw = (gy.flatten(2).transpose(0, 1).flatten(1)       # [Cout, N*L]
                      @ cols.transpose(1, 2).flatten(0, 1)).reshape(w.shape)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = gy.sum((0, 2, 3))
        return gx, gw, gb


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
    wt = w.permute(nd + 1, nd, *range(nd))
    if nd == 2:
        y = _Conv2d.apply(xb, wt, b)
    else:
        with full_f32():
            y = _CONV[nd](xb, wt, b)
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
