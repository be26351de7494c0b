"""Initial conditions of the reference systems (the part serving needs).

A copy of ``default_ic`` from percnn_tpu/data/simulate.py for the Gray-Scott
2D system; the RK4 truth generator comes with training.
"""

from __future__ import annotations

import numpy as np


def default_ic(system: str, n: int, seed: int = 66) -> np.ndarray:
    """Canonical initial condition per system, [*spatial, 2] float64."""
    rng = np.random.RandomState(seed)
    if system == "gray_scott_2d":
        # u=1, v=0 background with a perturbed centre square + noise
        u = np.ones((n, n))
        v = np.zeros((n, n))
        q = n // 5
        c = slice(n // 2 - q // 2, n // 2 + q // 2)
        u[c, c] = 0.5 + 0.1 * rng.rand(*u[c, c].shape)
        v[c, c] = 0.25 + 0.1 * rng.rand(*v[c, c].shape)
        return np.stack([u, v], axis=-1)
    raise NotImplementedError(f"default_ic for {system!r} is not ported yet")
