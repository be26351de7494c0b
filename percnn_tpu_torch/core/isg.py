"""Initial-state generator (ISG): transposed-conv upsampler, low-res IC -> grid.

Counterpart of percnn_tpu/core/isg.py.  GS2D's ISG is ConvT(2->8, k5, s2),
sigmoid, ConvT(8->8, k5, s2), then a 1x1 conv 8->2: 4x upsampling.  GS3D's
is the same in 3D with strides (2, 1): 2x.  Every ConvT stage has k=5,
padding=2 and output_padding=stride-1, so a stride-1 stage keeps the size.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from percnn_tpu_torch._device import resolve_device
from percnn_tpu_torch.core.init import _uniform
from percnn_tpu_torch.ops.convs import conv_transpose_torch, pointwise_conv


@dataclasses.dataclass(frozen=True)
class ISGConfig:
    ndim: int = 2
    channels: int = 2
    hidden: int = 8
    strides: tuple = (2, 2)      # per-ConvT-stage stride
    activation: str = "sigmoid"  # 'sigmoid' | 'tanh'

    @property
    def n_stages(self) -> int:
        return len(self.strides)

    @property
    def scale(self) -> int:
        return math.prod(self.strides)


def init_isg(gen: torch.Generator, cfg: ISGConfig, dtype=torch.float32, *,
             device: str | torch.device = "cuda") -> dict:
    """PyTorch's default init, U(-b, b) with b = 1/sqrt(fan_in), drawn from
    `gen` (a CPU generator).

    PyTorch computes a ConvTranspose weight's fan_in from its dim 1 times
    the receptive field; that weight is [Cin, Cout, *k], so fan_in is
    Cout * 5^ndim, not Cin * 5^ndim.
    """
    dev = resolve_device(device)
    params = {}
    cin = cfg.channels
    ks = (5,) * cfg.ndim
    for i in range(cfg.n_stages):
        cout = cfg.hidden
        b = 1.0 / math.sqrt(cout * 5 ** cfg.ndim)
        params[f"up{i}_w"] = _uniform(gen, ks + (cin, cout), -b, b, dtype)
        params[f"up{i}_b"] = _uniform(gen, (cout,), -b, b, dtype)
        cin = cout
    b = 1.0 / math.sqrt(cin)
    params["out_w"] = _uniform(gen, (cin, cfg.channels), -b, b, dtype)
    params["out_b"] = _uniform(gen, (cfg.channels,), -b, b, dtype)
    return {k: v.to(dev) for k, v in params.items()}


def isg_apply(params: dict, h_low: torch.Tensor, cfg: ISGConfig) -> torch.Tensor:
    """[..., *low, C] -> [..., *high, C], high = low * prod(strides).

    The activation follows the first ConvT stage only."""
    act = torch.sigmoid if cfg.activation == "sigmoid" else torch.tanh
    x = h_low
    for i, stride in enumerate(cfg.strides):
        x = conv_transpose_torch(x, params[f"up{i}_w"], params[f"up{i}_b"],
                                 stride=stride, padding=2,
                                 output_padding=stride - 1)
        if i == 0:
            x = act(x)
    return pointwise_conv(x, params["out_w"], params["out_b"])
