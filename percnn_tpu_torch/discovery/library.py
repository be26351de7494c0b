"""Candidate-library design matrix from a reconstructed rollout.

Counterpart of percnn_tpu/discovery/library.py (the reference Stage-2 flow,
PDE_FIND_u.py:217-263): take a window of the Stage-1 high-res
reconstruction, evaluate the derivative dict with the same 4th-order
periodic stencils, form the 70 columns of
{poly(u,v)} x {1, u_x, u_y, v_x, v_y, lap_u, lap_v}, flatten space-time, and
randomly subsample rows.  Terms come from the explicit TERM_REGISTRY, so the
70-column ordering is testable (must_have=5 still means 'ones*lap_u').

The matrices are float64 numpy for the host lstsq solver, as in the
reference, with the derivatives taken by numpy roll-sums in f64.
"""

from __future__ import annotations

import numpy as np
import torch

from percnn_tpu_torch._device import resolve_device
from percnn_tpu_torch.ops.stencils import FD1_CENTRAL_1D, LAP_CROSS_1D
from percnn_tpu_torch.pde.systems import PDESystem, physics_residual
from percnn_tpu_torch.pde.terms import TERM_REGISTRY, gen_library


def _np_shift_sum(u: np.ndarray, coeffs, axis: int) -> np.ndarray:
    r = len(coeffs) // 2
    out = np.zeros_like(u)
    for k, c in enumerate(coeffs):
        if c:
            out += c * np.roll(u, -(k - r), axis=axis)
    return out


def _eval_grads_np(h: np.ndarray, dx: float) -> dict:
    """f64 numpy twin of pde.terms.eval_grads for [T, H, W, 2] windows."""
    u, v = h[..., 0], h[..., 1]
    lap = (_np_shift_sum(h, LAP_CROSS_1D, 1) + _np_shift_sum(h, LAP_CROSS_1D, 2)) / (dx * dx)
    gx = lambda f: _np_shift_sum(f, FD1_CENTRAL_1D, 2) / dx
    gy = lambda f: _np_shift_sum(f, FD1_CENTRAL_1D, 1) / dx
    return {
        "ones": np.ones_like(u),
        "u": u, "v": v,
        "u_x": gx(u), "u_y": gy(u), "v_x": gx(v), "v_y": gy(v),
        "lap_u": lap[..., 0], "lap_v": lap[..., 1],
    }


def reconstruction_residual_mse(rollout, system: PDESystem, dt: float, dx: float, *,
                                device: str | torch.device = "cuda") -> tuple:
    """Physics-residual MSE of a reconstruction [T, *spatial, 2] per channel,
    on `device` in the rollout's dtype: the Stage-2 entry diagnostic
    (reference get_residual_mse, Stage-2/derivatives.py)."""
    dev = resolve_device(device)
    r = physics_residual(system, torch.as_tensor(np.asarray(rollout), device=dev), dt, dx)
    return float(torch.mean(r[..., 0] ** 2)), float(torch.mean(r[..., 1] ** 2))


def build_design_matrix(
    rollout: np.ndarray,
    dt: float,
    dx: float,
    *,
    frames: slice = slice(50, 150),
    subsample: float = 0.2,
    seed: int = 0,
    library: list[str] | None = None,
):
    """rollout: [T, H, W, 2] -> (R [n, 70], Ut [n, 1], Vt [n, 1], names).

    Spatial terms are evaluated on frames [0:-2] of the window and u_t/v_t
    with the forward difference on the same alignment, matching the
    reference's staggered residual (derivatives.py:129-199).
    """
    names = library if library is not None else gen_library()
    win = np.asarray(rollout[frames], np.float64)
    grads = _eval_grads_np(win[:-2], dx)
    dhdt = (win[1:-1] - win[:-2]) / dt
    cols = [np.asarray(TERM_REGISTRY[n](win[:-2], grads)).reshape(-1) for n in names]
    R = np.stack(cols, axis=1).astype(np.float64)
    Ut = np.asarray(dhdt[..., 0]).reshape(-1, 1).astype(np.float64)
    Vt = np.asarray(dhdt[..., 1]).reshape(-1, 1).astype(np.float64)
    if subsample is not None and subsample < 1.0:
        rng = np.random.RandomState(seed)
        idx = rng.choice(R.shape[0], int(R.shape[0] * subsample), replace=False)
        R, Ut, Vt = R[idx], Ut[idx], Vt[idx]
    return R, Ut, Vt, names
