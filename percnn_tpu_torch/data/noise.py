"""Measurement-noise injection matching the reference ``add_noise``:
per-channel Gaussian noise with std = pct * std(channel), fixed seed 66.
A copy of percnn_tpu/data/noise.py."""

from __future__ import annotations

import numpy as np


def add_noise(truth: np.ndarray, pct: float, seed: int = 66) -> np.ndarray:
    """truth: [T, *spatial, C]; returns truth + N(0, (pct*std_c)^2) per
    channel c."""
    if pct == 0.0:
        return truth.copy()
    rng = np.random.RandomState(seed)
    out = truth.copy()
    for c in range(truth.shape[-1]):
        std = truth[..., c].std()
        out[..., c] += rng.standard_normal(truth[..., c].shape) * (pct * std)
    return out
