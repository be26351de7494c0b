"""Separable resampling with torch's ``F.interpolate`` conventions: cubic
(Keys, A = -0.75, border taps clamped) and linear, both ``align_corners``
conventions.

Counterpart of percnn_tpu/ops/interp.py.  Per axis, a dense [out, in]
matrix is built with numpy and applied with ``torch.tensordot``; the
builders are copies of the JAX package's, so both packages resample with
the same matrices.  Each matrix is kept on the device, once per shape,
dtype and device, so a training iteration copies nothing from the host
(and can be captured into a CUDA graph).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_A = -0.75  # torch's cubic coefficient


def _cubic_w(t: np.ndarray) -> np.ndarray:
    """4-tap Keys cubic weights at fractional offset t in [0, 1)."""
    w0 = ((_A * (t + 1) - 5 * _A) * (t + 1) + 8 * _A) * (t + 1) - 4 * _A
    w1 = ((_A + 2) * t - (_A + 3)) * t * t + 1
    s = 1 - t
    w2 = ((_A + 2) * s - (_A + 3)) * s * s + 1
    w3 = 1.0 - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], axis=-1)  # [out, 4]


@functools.lru_cache(maxsize=64)
def _axis_matrix(n_in: int, n_out: int, method: str,
                 align_corners: bool = True) -> np.ndarray:
    """Dense [n_out, n_in] resampling matrix (torch grid conventions).

    Cached per shape: the IC loss resamples the same grid every training
    step.  The cached array is read-only."""
    M = np.zeros((n_out, n_in), dtype=np.float64)
    if n_out == 1 and align_corners:
        M[0, 0] = 1.0
        M.flags.writeable = False
        return M
    if align_corners:
        src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    else:
        src = (np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5
        # torch clamps the source coordinate at 0 for linear modes
        if method == "linear":
            src = np.maximum(src, 0.0)
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    if method == "linear":
        taps = np.stack([i0, i0 + 1], axis=-1)
        wts = np.stack([1 - t, t], axis=-1)
    elif method == "cubic":
        taps = np.stack([i0 - 1, i0, i0 + 1, i0 + 2], axis=-1)
        wts = _cubic_w(t)
    else:
        raise ValueError(f"unknown method {method!r}")
    taps = np.clip(taps, 0, n_in - 1)
    for j in range(n_out):
        for tap, w in zip(taps[j], wts[j]):
            M[j, tap] += w
    M.flags.writeable = False
    return M


@functools.lru_cache(maxsize=64)
def _axis_matrix_on(n_in: int, n_out: int, method: str, align_corners: bool,
                    dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """_axis_matrix as a tensor on `device`; made outside inference mode, so
    a matrix first made by an evaluation can be saved for a backward."""
    with torch.inference_mode(False):
        return torch.tensor(_axis_matrix(n_in, n_out, method, align_corners),
                            dtype=dtype, device=device)


def resize_align_corners(x: torch.Tensor, sizes, *, method: str = "cubic",
                         align_corners: bool = True,
                         channel_last: bool = True) -> torch.Tensor:
    """Resize the spatial axes of x to `sizes` with torch semantics.

    x: [..., s1, ..., sn, C] if channel_last else [..., s1, ..., sn].
    `method`: 'cubic' or 'linear'; `align_corners`: torch's flag (False =
    half-pixel centres, the F.interpolate default).
    """
    nd = len(sizes)
    off = 1 if channel_last else 0
    axes = list(range(x.ndim - nd - off, x.ndim - off))
    for ax, n_out in zip(axes, sizes):
        n_in = x.shape[ax]
        if n_in == n_out:
            continue
        M = _axis_matrix_on(n_in, n_out, method, align_corners, x.dtype, x.device)
        x = torch.movedim(torch.tensordot(M, torch.movedim(x, ax, 0), dims=([1], [0])), 0, ax)
    return x
