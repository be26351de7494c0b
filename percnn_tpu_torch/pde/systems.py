"""Governing systems as declarative specs: ``rhs(h, dx) -> dh/dt``.

Counterpart of percnn_tpu/pde/systems.py.  Gray-Scott 2D (Du = 2e-5,
Dv = Du/4, f = 1/25, k = 3/50) and Gray-Scott 3D (Du = 0.2, Dv = 0.1,
f = 0.025, k = 0.055) are ported; lambda-omega and Burgers come with the
slices that run them.  The rhs serves both the RK4
truth generator (data/simulate.py) and the physics residual.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from percnn_tpu_torch.ops.stencils import laplacian, time_derivative_fwd


@dataclasses.dataclass(frozen=True)
class PDESystem:
    name: str
    ndim: int
    rhs: Callable  # (h [..., *spatial, 2], dx) -> dh/dt, same shape


def _gs2d_rhs(h: torch.Tensor, dx: float) -> torch.Tensor:
    Du, Dv, f, k = 2e-5, 2e-5 / 4, 1.0 / 25.0, 3.0 / 50.0
    lap = laplacian(h, dx, dims=(h.ndim - 3, h.ndim - 2))
    u, v = h[..., 0], h[..., 1]
    uvv = u * v * v
    fu = Du * lap[..., 0] - uvv + f * (1.0 - u)
    fv = Dv * lap[..., 1] + uvv - (f + k) * v
    return torch.stack([fu, fv], dim=-1)


def _gs3d_rhs(h: torch.Tensor, dx: float) -> torch.Tensor:
    Du, Dv, f, k = 0.2, 0.1, 0.025, 0.055
    lap = laplacian(h, dx, dims=(h.ndim - 4, h.ndim - 3, h.ndim - 2))
    u, v = h[..., 0], h[..., 1]
    uvv = u * v * v
    fu = Du * lap[..., 0] - uvv + f * (1.0 - u)
    fv = Dv * lap[..., 1] + uvv - (f + k) * v
    return torch.stack([fu, fv], dim=-1)


class _Systems(dict):
    """The ported systems by name; a known system that is not ported yet
    raises NotImplementedError rather than KeyError."""

    _QUEUED = {"lambda_omega": "the lambda-omega slice",
               "burgers": "the Burgers slice"}

    def __missing__(self, name):
        if name in self._QUEUED:
            raise NotImplementedError(
                f"PDE system {name!r} is not ported yet (comes with {self._QUEUED[name]})")
        raise KeyError(name)


PDE_SYSTEMS = _Systems(gray_scott_2d=PDESystem("gray_scott_2d", 2, _gs2d_rhs),
                       gray_scott_3d=PDESystem("gray_scott_3d", 3, _gs3d_rhs))


def physics_residual(system: PDESystem, rollout: torch.Tensor, dt: float,
                     dx: float) -> torch.Tensor:
    """PDE residual over a rollout [T, *spatial, C]:
    r[i] = rhs(U[i]) - (U[i+1] - U[i]) / dt for i in [0, T-2)."""
    return system.rhs(rollout[:-2], dx) - time_derivative_fwd(rollout, dt)
