"""Governing systems as declarative specs: ``rhs(h, dx) -> dh/dt``.

Counterpart of percnn_tpu/pde/systems.py, with the same coefficients:

- lambda-omega 2D: f_u = 0.1 Lap u + (1-u^2-v^2) u + (u^2+v^2) v,
                   f_v = 0.1 Lap v - (u^2+v^2) u + (1-u^2-v^2) v;
- Gray-Scott 2D:   Du = 2e-5, Dv = Du/4, f = 1/25, k = 3/50;
- Gray-Scott 3D:   Du = 0.2, Dv = 0.1, f = 0.025, k = 0.055;
- Burgers 2D:      nu = 1/200; f_u = nu Lap u - u u_x - v u_y,
                   f_v = nu Lap v - u v_x - v v_y.

The rhs serves both the RK4 truth generator (data/simulate.py) and the
physics residual.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from percnn_tpu_torch.ops.stencils import grad_x, grad_y, laplacian, time_derivative_fwd


@dataclasses.dataclass(frozen=True)
class PDESystem:
    name: str
    ndim: int
    rhs: Callable  # (h [..., *spatial, 2], dx) -> dh/dt, same shape


def _stack_channels(fu: torch.Tensor, fv: torch.Tensor) -> torch.Tensor:
    """[..., 2] from the two channels' fields.  The new dim is given as a
    positive index: PyTorch 2.11's DTensor stack misplaces a cut for
    dim=-1 (the gspmd route's physics residual on a 2 x 2 mesh)."""
    return torch.stack([fu, fv], dim=fu.ndim)


def _lo_rhs(h: torch.Tensor, dx: float) -> torch.Tensor:
    lap = laplacian(h, dx, dims=(h.ndim - 3, h.ndim - 2))
    u, v = h[..., 0], h[..., 1]
    a2 = u * u + v * v
    fu = 0.1 * lap[..., 0] + (1.0 - a2) * u + a2 * v
    fv = 0.1 * lap[..., 1] - a2 * u + (1.0 - a2) * v
    return _stack_channels(fu, fv)


def _gs2d_rhs(h: torch.Tensor, dx: float) -> torch.Tensor:
    Du, Dv, f, k = 2e-5, 2e-5 / 4, 1.0 / 25.0, 3.0 / 50.0
    lap = laplacian(h, dx, dims=(h.ndim - 3, h.ndim - 2))
    u, v = h[..., 0], h[..., 1]
    uvv = u * v * v
    fu = Du * lap[..., 0] - uvv + f * (1.0 - u)
    fv = Dv * lap[..., 1] + uvv - (f + k) * v
    return _stack_channels(fu, fv)


def _gs3d_rhs(h: torch.Tensor, dx: float) -> torch.Tensor:
    Du, Dv, f, k = 0.2, 0.1, 0.025, 0.055
    lap = laplacian(h, dx, dims=(h.ndim - 4, h.ndim - 3, h.ndim - 2))
    u, v = h[..., 0], h[..., 1]
    uvv = u * v * v
    fu = Du * lap[..., 0] - uvv + f * (1.0 - u)
    fv = Dv * lap[..., 1] + uvv - (f + k) * v
    return _stack_channels(fu, fv)


def _burgers_rhs(h: torch.Tensor, dx: float) -> torch.Tensor:
    nu = 1.0 / 200.0
    lap = laplacian(h, dx, dims=(h.ndim - 3, h.ndim - 2))
    u, v = h[..., 0], h[..., 1]
    ux = grad_x(h[..., 0:1], dx)[..., 0]
    uy = grad_y(h[..., 0:1], dx)[..., 0]
    vx = grad_x(h[..., 1:2], dx)[..., 0]
    vy = grad_y(h[..., 1:2], dx)[..., 0]
    fu = nu * lap[..., 0] - u * ux - v * uy
    fv = nu * lap[..., 1] - u * vx - v * vy
    return _stack_channels(fu, fv)


PDE_SYSTEMS = {
    "lambda_omega": PDESystem("lambda_omega", 2, _lo_rhs),
    "gray_scott_2d": PDESystem("gray_scott_2d", 2, _gs2d_rhs),
    "gray_scott_3d": PDESystem("gray_scott_3d", 3, _gs3d_rhs),
    "burgers": PDESystem("burgers", 2, _burgers_rhs),
}


def physics_residual(system: PDESystem, rollout: torch.Tensor, dt: float,
                     dx: float) -> torch.Tensor:
    """PDE residual over a rollout [T, *spatial, C]:
    r[i] = rhs(U[i]) - (U[i+1] - U[i]) / dt for i in [0, T-2)."""
    return system.rhs(rollout[:-2], dx) - time_derivative_fwd(rollout, dt)
