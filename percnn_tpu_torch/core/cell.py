"""The Pi-block recurrent cell: one forward-Euler step of
    h_next = h + dt * (D_eff * Lap(h) + Pi(h)).

Counterpart of percnn_tpu/core/cell.py.  Pi is N parallel conv branches
(1x1, or k x k with periodic padding as in the 5x5 Burgers and
lambda-omega Stage-1 cells), multiplied elementwise, then aggregated by a
1x1 conv; the diffusion coefficients are raw or bounded as
mu_up * sigmoid(c).  The state is channels-last [..., *spatial, channels].
``pi_cell_step_valid`` is the same step on a block with a halo, the local
update of a domain-decomposed rollout (parallel/sharded.py).
"""

from __future__ import annotations

import dataclasses

import torch

from percnn_tpu_torch._device import resolve_device
from percnn_tpu_torch.core.init import (
    scaled_fanin_uniform,
    scaled_xavier_uniform,
    uniform_symmetric,
)
from percnn_tpu_torch.ops.convs import conv_nd, conv_nd_periodic, pointwise_conv
from percnn_tpu_torch.ops.stencils import STENCIL_HALO, interior, laplacian, laplacian_valid


@dataclasses.dataclass(frozen=True)
class PiCellConfig:
    """Static configuration of a Pi-block cell (fields as in percnn_tpu)."""

    ndim: int = 2                 # spatial dims (2 or 3)
    channels: int = 2             # state channels (u, v)
    hidden: int = 8               # Pi hidden channels C
    kernel_size: int = 1          # Pi branch kernel (1 or 5)
    n_branches: int = 3           # parallel branches (polynomial order)
    dt: float = 0.5
    dx: float = 0.01
    diffusion: str = "sigmoid"    # 'sigmoid' (mu_up*sigmoid(c)) | 'raw'
    mu_up: float = 3.99e-5        # diffusion upper bound (sigmoid mode)
    diff_init: float | None = None  # raw mode: constant init; sigmoid mode:
                                  # None => U(-1,1) logits
    init: str = "xavier"          # 'xavier' | 'fanin'
    init_scale: float = 0.02      # the reference's c constant

    @property
    def spatial_axes(self) -> tuple:
        # axes of [..., *spatial, C]
        return tuple(range(-1 - self.ndim, -1))


def init_pi_cell(gen: torch.Generator, cfg: PiCellConfig, dtype=torch.float32,
                 *, device: str | torch.device = "cuda") -> dict:
    """Cell parameters drawn from `gen` (a CPU generator), on `device`.

    Layout as percnn_tpu's: diff [channels]; pi, one dict per state channel,
    with w0..w{N-1} [C_in, hidden] (or [*k, C_in, hidden]), b0.. [hidden],
    w_out [hidden, 1], b_out [1].
    """
    dev = resolve_device(device)
    if cfg.diff_init is not None:
        diff = torch.full((cfg.channels,), cfg.diff_init, dtype=dtype)
    else:
        diff = uniform_symmetric(gen, (cfg.channels,), 1.0, dtype)
    init_fn = scaled_xavier_uniform if cfg.init == "xavier" else scaled_fanin_uniform
    shape = ((cfg.channels, cfg.hidden) if cfg.kernel_size == 1 else
             (cfg.kernel_size,) * cfg.ndim + (cfg.channels, cfg.hidden))
    pi = []
    for _ in range(cfg.channels):
        branch = {}
        for i in range(cfg.n_branches):
            branch[f"w{i}"] = init_fn(gen, shape, cfg.init_scale, dtype)
            branch[f"b{i}"] = torch.zeros((cfg.hidden,), dtype=dtype)
        branch["w_out"] = init_fn(gen, (cfg.hidden, 1), cfg.init_scale, dtype)
        branch["b_out"] = torch.zeros((1,), dtype=dtype)
        pi.append({k: v.to(dev) for k, v in branch.items()})
    return {"diff": diff.to(dev), "pi": pi}


def effective_diffusion(params: dict, cfg: PiCellConfig) -> torch.Tensor:
    """[channels] diffusion coefficients after reparametrisation."""
    if cfg.diffusion == "raw":
        return params["diff"]
    return cfg.mu_up * torch.sigmoid(params["diff"])


def pi_block(branch: dict, h: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """Pi nonlinearity for one output channel: [..., C] -> [..., 1]."""
    conv = pointwise_conv if cfg.kernel_size == 1 else conv_nd_periodic
    prod = None
    for i in range(cfg.n_branches):
        y = conv(h, branch[f"w{i}"], branch[f"b{i}"])
        prod = y if prod is None else prod * y
    return pointwise_conv(prod, branch["w_out"], branch["b_out"])


def pi_rhs(params: dict, h: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """dh/dt = D_eff * Lap(h) + Pi(h), per channel."""
    lap = laplacian(h, cfg.dx, dims=[a % h.ndim for a in cfg.spatial_axes])
    nonlin = torch.cat(
        [pi_block(params["pi"][c], h, cfg) for c in range(cfg.channels)], dim=-1)
    return effective_diffusion(params, cfg) * lap + nonlin


def pi_cell_step(params: dict, h: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """One forward-Euler step."""
    return h + cfg.dt * pi_rhs(params, h, cfg)


def pi_cell_step_valid(params: dict, xp: torch.Tensor, cfg: PiCellConfig, *,
                       halo: int = STENCIL_HALO) -> torch.Tensor:
    """One Euler step from a block extended by `halo` cells on each side of
    each spatial dim, [..., *(spatial + 2 halo), C], to its interior
    [..., *spatial, C]: no periodic wrap, every stencil and conv VALID.

    The local update under domain decomposition: the halo was filled from
    the neighbouring blocks (parallel/halo.py), so the global periodic
    boundary lives in the exchange, not here.  A k x k cell's branch convs
    read ``halo - k // 2`` cells in from the block's edge.  Autograd through
    this step is also the backward of the kernel step
    (ops/kernels/sharded_step2d.py): its cotangent of `xp` covers the halo,
    and the exchange carries that part back to the neighbours.
    """
    nd = cfg.ndim
    dims = tuple(range(xp.ndim - 1 - nd, xp.ndim - 1))
    centre = interior(xp, dims, halo)
    lap = laplacian_valid(xp, cfg.dx, dims, halo)
    if cfg.kernel_size == 1:
        nonlin = torch.cat([pi_block(params["pi"][c], centre, cfg)
                            for c in range(cfg.channels)], dim=-1)
    else:
        cut = halo - cfg.kernel_size // 2
        xk = interior(xp, dims, cut) if cut else xp
        outs = []
        for c in range(cfg.channels):
            br = params["pi"][c]
            prod = None
            for i in range(cfg.n_branches):
                y = conv_nd(xk, br[f"w{i}"], br[f"b{i}"])
                prod = y if prod is None else prod * y
            outs.append(pointwise_conv(prod, br["w_out"], br["b_out"]))
        nonlin = torch.cat(outs, dim=-1)
    return centre + cfg.dt * (effective_diffusion(params, cfg) * lap + nonlin)
