"""Finite-difference stencils on periodic grids, as sums of rolled copies,
and on haloed blocks, as sums of shifted slices.

Counterpart of percnn_tpu/ops/stencils.py: the 4th-order Laplacian is the
5-point cross per axis with coefficients [-1/12, 4/3, -5/2, 4/3, -1/12]
over dx^2, the first derivative [1/12, -2/3, 0, 2/3, -1/12] over dx, and
``torch.roll`` supplies the periodic boundary.  The ``*_valid`` variants
take a block extended by a halo on each listed dim (parallel/halo.py fills
it from the neighbouring blocks) and return its interior: they never wrap.
"""

from __future__ import annotations

from typing import Sequence

import torch

# 1D second-derivative cross-section of the 4th-order Laplacian, offsets -2..2.
LAP_CROSS_1D = (-1.0 / 12.0, 4.0 / 3.0, -5.0 / 2.0, 4.0 / 3.0, -1.0 / 12.0)

# 4th-order central first derivative, offsets -2..2.
FD1_CENTRAL_1D = (1.0 / 12.0, -2.0 / 3.0, 0.0, 2.0 / 3.0, -1.0 / 12.0)

# Cells a 5-point stencil reads on each side: the halo a block needs.
STENCIL_HALO = 2


def _shifted_sum(u: torch.Tensor, coeffs: Sequence[float], dim: int) -> torch.Tensor:
    """sum_k coeffs[k] * u[i + k - r] along `dim` (periodic)."""
    r = len(coeffs) // 2
    out = None
    for k, c in enumerate(coeffs):
        if c == 0.0:
            continue
        off = k - r
        term = u if off == 0 else torch.roll(u, -off, dims=dim)
        term = term * c
        out = term if out is None else out + term
    return out


def laplacian(u: torch.Tensor, dx: float, dims: Sequence[int]) -> torch.Tensor:
    """4th-order Laplacian over `dims` on a periodic grid."""
    acc = None
    for d in dims:
        t = _shifted_sum(u, LAP_CROSS_1D, d)
        acc = t if acc is None else acc + t
    return acc / (dx * dx)


def laplacian_2d(u: torch.Tensor, dx: float) -> torch.Tensor:
    """Laplacian over the (H, W) dims of [..., H, W, C]."""
    return laplacian(u, dx, dims=(u.ndim - 3, u.ndim - 2))


def grad_axis(u: torch.Tensor, dx: float, dim: int) -> torch.Tensor:
    """4th-order central first derivative along one periodic dim."""
    return _shifted_sum(u, FD1_CENTRAL_1D, dim) / dx


def grad_x(u: torch.Tensor, dx: float) -> torch.Tensor:
    """d/dx, x being the width dim (the last spatial dim) of [..., H, W, C]."""
    return grad_axis(u, dx, u.ndim - 2)


def grad_y(u: torch.Tensor, dx: float) -> torch.Tensor:
    """d/dy, y being the height dim of [..., H, W, C]."""
    return grad_axis(u, dx, u.ndim - 3)


def periodic_pad(u: torch.Tensor, width: int, dims: Sequence[int]) -> torch.Tensor:
    """Wrap-pad `u` by `width` cells on both sides of each dim in `dims`."""
    for d in dims:
        n = u.shape[d]
        u = torch.cat([u.narrow(d, n - width, width), u, u.narrow(d, 0, width)], dim=d)
    return u


# Valid-region variants: the input is a block extended by `halo` cells on
# each side of each dim in `dims`; the output is trimmed by `halo` there.


def _valid_slice(x: torch.Tensor, offs: dict, dims: Sequence[int], halo: int) -> torch.Tensor:
    """The interior of x along `dims`, shifted by offs[d] cells along d."""
    sl = [slice(None)] * x.ndim
    for d in dims:
        off = offs.get(d, 0)
        sl[d] = slice(halo + off, x.shape[d] - halo + off)
    return x[tuple(sl)]


def laplacian_valid(xp: torch.Tensor, dx: float, dims: Sequence[int],
                    halo: int = STENCIL_HALO) -> torch.Tensor:
    """4th-order Laplacian of a haloed block over `dims`, trimmed by `halo`."""
    r = len(LAP_CROSS_1D) // 2
    acc = None
    for d in dims:
        for k, c in enumerate(LAP_CROSS_1D):
            t = c * _valid_slice(xp, {d: k - r}, dims, halo)
            acc = t if acc is None else acc + t
    return acc / (dx * dx)


def grad_axis_valid(xp: torch.Tensor, dx: float, dim: int, dims: Sequence[int],
                    halo: int = STENCIL_HALO) -> torch.Tensor:
    """4th-order first derivative along `dim` of a haloed block, trimmed by
    `halo` on each of `dims`."""
    r = len(FD1_CENTRAL_1D) // 2
    acc = None
    for k, c in enumerate(FD1_CENTRAL_1D):
        if c == 0.0:
            continue
        t = c * _valid_slice(xp, {dim: k - r}, dims, halo)
        acc = t if acc is None else acc + t
    return acc / dx


def interior(xp: torch.Tensor, dims: Sequence[int], halo: int = STENCIL_HALO) -> torch.Tensor:
    """The centre of a haloed block: trimmed by `halo` on each of `dims`."""
    return _valid_slice(xp, {}, dims, halo)


def time_derivative_fwd(seq: torch.Tensor, dt: float) -> torch.Tensor:
    """Forward difference in time, aligned with the physics residual:
    out[i] = (seq[i+1] - seq[i]) / dt for i in [0, T-2), so [T, ...] ->
    [T-2, ...], matching spatial terms taken on frames [0:T-2]."""
    return (seq[1:-1] - seq[:-2]) / dt
