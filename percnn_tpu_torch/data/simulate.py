"""Ground-truth generation: initial conditions and the f64 RK4 integrator.

Counterpart of ``default_ic`` and ``simulate`` in
percnn_tpu/data/simulate.py, for all four systems; each IC draws the same
numbers from ``np.random.RandomState(seed)`` in the same order, so the two
packages start from the same field to the bit.  The JAX package integrates
on the host; here the RK4 runs as tensor ops on ``device`` (the card by
default), since the GS2D truth is 2500 frames of 4 substeps each, the GS3D
truth 1000 frames of a 48^3 grid and the Burgers truth 1200 frames.
"""

from __future__ import annotations

import numpy as np
import torch

from percnn_tpu_torch._device import resolve_device
from percnn_tpu_torch.pde.systems import PDE_SYSTEMS


def default_ic(system: str, n: int, seed: int = 66) -> np.ndarray:
    """Canonical initial condition per system, [*spatial, 2] float64."""
    rng = np.random.RandomState(seed)
    if system == "lambda_omega":
        # the one-armed spiral seed on [-10, 10]^2
        x = np.linspace(-10.0, 10.0, n, endpoint=False)
        X, Y = np.meshgrid(x, x, indexing="ij")
        r = np.sqrt(X**2 + Y**2) + 1e-9
        theta = np.arctan2(Y, X)
        u = np.tanh(r) * np.cos(theta - r)
        v = np.tanh(r) * np.sin(theta - r)
        return np.stack([u, v], axis=-1)
    if system == "gray_scott_2d":
        # u=1, v=0 background with a perturbed centre square + noise
        u = np.ones((n, n))
        v = np.zeros((n, n))
        q = n // 5
        c = slice(n // 2 - q // 2, n // 2 + q // 2)
        u[c, c] = 0.5 + 0.1 * rng.rand(*u[c, c].shape)
        v[c, c] = 0.25 + 0.1 * rng.rand(*v[c, c].shape)
        return np.stack([u, v], axis=-1)
    if system == "gray_scott_3d":
        u = np.ones((n, n, n))
        v = np.zeros((n, n, n))
        q = max(2, n // 6)
        c = slice(n // 2 - q // 2, n // 2 + q // 2)
        u[c, c, c] = 0.5 + 0.1 * rng.rand(*u[c, c, c].shape)
        v[c, c, c] = 0.25 + 0.1 * rng.rand(*v[c, c, c].shape)
        return np.stack([u, v], axis=-1)
    if system == "burgers":
        # a smooth zero-mean periodic field from low-wavenumber Fourier
        # modes, scaled to max |f| = 1, for each of u and v
        def field():
            k = 4
            coef = rng.randn(2 * k + 1, 2 * k + 1) + 1j * rng.randn(2 * k + 1, 2 * k + 1)
            x = np.linspace(0, 1, n, endpoint=False)
            X, Y = np.meshgrid(x, x, indexing="ij")
            f = np.zeros((n, n))
            for i in range(-k, k + 1):
                for j in range(-k, k + 1):
                    a = coef[i + k, j + k]
                    f += (a.real * np.cos(2 * np.pi * (i * X + j * Y))
                          - a.imag * np.sin(2 * np.pi * (i * X + j * Y)))
            f -= f.mean()
            return f / np.abs(f).max()

        return np.stack([field(), field()], axis=-1)
    raise KeyError(system)


def simulate(system: str, h0: np.ndarray, n_steps: int, dt: float, dx: float, *,
             oversample: int = 4, dtype=torch.float64,
             device: str | torch.device = "cuda") -> np.ndarray:
    """Integrate `system` from h0 for n_steps steps of dt, by RK4 at
    dt/oversample; returns [n_steps+1, *spatial, 2] on the host (frame 0 =
    h0), in `dtype`."""
    dev = resolve_device(device)
    rhs = PDE_SYSTEMS[system].rhs
    dts = dt / oversample
    h = torch.as_tensor(np.asarray(h0), dtype=dtype, device=dev)
    frames = torch.empty((n_steps + 1,) + tuple(h.shape), dtype=dtype, device=dev)
    frames[0] = h
    with torch.no_grad():
        for t in range(n_steps):
            for _ in range(oversample):
                k1 = rhs(h, dx)
                k2 = rhs(h + 0.5 * dts * k1, dx)
                k3 = rhs(h + 0.5 * dts * k2, dx)
                k4 = rhs(h + dts * k3, dx)
                h = h + (dts / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            frames[t + 1] = h
    return frames.cpu().numpy()
