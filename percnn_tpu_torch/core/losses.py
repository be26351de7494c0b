"""Composite training losses: data, IC and physics residual.

Counterpart of percnn_tpu/core/losses.py:
- data loss: MSE on a time/space-strided subsample of the rollout against
  the noisy measurements, the trailing val_frac of the sampled snapshots
  held out as a validation split;
- IC loss: MSE(ISG(IC_low), torch-convention interpolation of IC_low to the
  solver grid);
- physics loss: mean squared PDE residual over the rollout.
"""

from __future__ import annotations

import dataclasses

import torch

from percnn_tpu_torch.ops.interp import resize_align_corners
from percnn_tpu_torch.pde.systems import PDESystem, physics_residual


def mse(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    d = a if b is None else a - b
    return torch.mean(d * d)


@dataclasses.dataclass(frozen=True)
class DataLossConfig:
    """Strides that pick the supervised rollout entries (GS 2D:
    rollout[0:-1:20, ::4, ::4] against truth[::20, ::4, ::4]); the trailing
    val_frac of the sampled snapshots form the holdout."""

    time_stride: int = 20
    space_stride: int = 4
    val_frac: float = 0.1
    drop_last_frame: bool = True  # the reference slices [0:-1:stride]


def subsample(rollout: torch.Tensor, cfg: DataLossConfig, ndim: int) -> torch.Tensor:
    """[T, *spatial, C] -> strided [Ts, *spatial_s, C]."""
    t_sl = slice(0, -1 if cfg.drop_last_frame else None, cfg.time_stride)
    idx = (t_sl,) + (slice(None, None, cfg.space_stride),) * ndim
    return rollout[idx]


def data_loss(rollout: torch.Tensor, measurement: torch.Tensor,
              cfg: DataLossConfig, ndim: int):
    """Returns (train_mse, val_mse); `measurement` is already at the
    subsampled resolution [Ts, *spatial_s, C]."""
    pred = subsample(rollout, cfg, ndim)
    ts = pred.shape[0]
    n_val = max(1, int(round(ts * cfg.val_frac))) if cfg.val_frac > 0 else 0
    # the val split never takes every snapshot (an empty train mean is nan)
    n_val = min(n_val, ts - 1)
    n_train = ts - n_val
    train = mse(pred[:n_train], measurement[:n_train])
    val = (mse(pred[n_train:], measurement[n_train:]) if n_val
           else torch.zeros((), dtype=rollout.dtype, device=rollout.device))
    return train, val


def ic_target(ic_low: torch.Tensor, target_sizes, ndim: int, method: str, *,
              align_corners: bool = False,
              periodic_extend: bool = False) -> torch.Tensor:
    """Interpolation target of the IC loss, in the reference's conventions:
    GS 2D bicubic align_corners=False; GS 3D trilinear align_corners=False;
    Burgers/LO wrap-extend the low grid by one cell per axis, bicubic
    align_corners=True to (n+1), then crop the extra row/col."""
    if periodic_extend:
        low = ic_low
        axes = range(ic_low.ndim - 1 - ndim, ic_low.ndim - 1)
        for ax in axes:
            low = torch.cat([low, low.narrow(ax, 0, 1)], dim=ax)
        big = tuple(s + 1 for s in target_sizes)
        t = resize_align_corners(low, big, method=method, align_corners=True)
        for ax, n in zip(axes, target_sizes):
            t = t.narrow(ax, 0, n)
        return t
    return resize_align_corners(ic_low, target_sizes, method=method,
                                align_corners=align_corners)


def ic_loss(isg_out: torch.Tensor, ic_low: torch.Tensor, ndim: int, method: str,
            *, align_corners: bool = False,
            periodic_extend: bool = False) -> torch.Tensor:
    """MSE(ISG(low), interpolation of low to the solver grid)."""
    target_sizes = tuple(isg_out.shape[-1 - ndim: -1])
    target = ic_target(ic_low, target_sizes, ndim, method,
                       align_corners=align_corners, periodic_extend=periodic_extend)
    return mse(isg_out, target)


def phys_loss(system: PDESystem, rollout: torch.Tensor, dt: float,
              dx: float) -> torch.Tensor:
    r = physics_residual(system, rollout, dt, dx)
    return mse(r[..., 0]) + mse(r[..., 1])
