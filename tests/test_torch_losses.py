"""percnn_tpu_torch losses, interpolation, PDE residual and the time
derivative against the JAX package, on seeded numpy inputs.

Tolerances: the resampling matrices are the same f64 numbers in both
packages, applied in f32, so results agree to f32 rounding (rtol 1e-5,
atol 1e-6); f64 residuals agree to 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from percnn_tpu.core import losses as jlosses
from percnn_tpu.ops.interp import resize_align_corners as j_resize
from percnn_tpu.ops.stencils import time_derivative_fwd as j_time_derivative_fwd
from percnn_tpu.pde.systems import PDE_SYSTEMS as J_PDE_SYSTEMS

from percnn_tpu_torch.core import losses
from percnn_tpu_torch.ops.interp import resize_align_corners
from percnn_tpu_torch.ops.stencils import time_derivative_fwd
from percnn_tpu_torch.pde.systems import PDE_SYSTEMS

RTOL, ATOL = 1e-5, 1e-6


def _rand(shape, seed, dtype=np.float32, scale=1.0, shift=0.0):
    return (shift + scale * np.random.RandomState(seed).standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("method", ["cubic", "linear"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("sizes", [(24, 20), (5, 3)])
def test_resize_matches_jax(method, align_corners, sizes):
    x = _rand((2, 8, 6, 2), 0)
    want = np.asarray(j_resize(jnp.asarray(x), sizes, method=method, align_corners=align_corners))
    got = resize_align_corners(torch.from_numpy(x), sizes, method=method,
                               align_corners=align_corners).numpy()
    assert got.shape == want.shape == (2,) + sizes + (2,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bicubic_matches_f_interpolate():
    """A cross-check against torch itself, in the convention GS2D trains with
    (bicubic, align_corners=False)."""
    align_corners = False
    x = _rand((1, 7, 9, 2), 1)
    got = resize_align_corners(torch.from_numpy(x), (28, 36), method="cubic",
                               align_corners=align_corners)
    want = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(28, 36),
                         mode="bicubic", align_corners=align_corners).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method,align_corners,periodic_extend",
                         [("cubic", False, False), ("linear", False, False),
                          ("cubic", True, True)])
def test_ic_target_and_loss_match_jax(method, align_corners, periodic_extend):
    low = _rand((1, 8, 8, 2), 2, scale=0.2, shift=0.5)
    out = _rand((1, 32, 32, 2), 3, scale=0.2, shift=0.5)
    kw = dict(align_corners=align_corners, periodic_extend=periodic_extend)
    want_t = np.asarray(jlosses.ic_target(jnp.asarray(low), (32, 32), 2, method, **kw))
    got_t = losses.ic_target(torch.from_numpy(low), (32, 32), 2, method, **kw).numpy()
    assert got_t.shape == want_t.shape == (1, 32, 32, 2)
    np.testing.assert_allclose(got_t, want_t, rtol=RTOL, atol=ATOL)
    want = float(jlosses.ic_loss(jnp.asarray(out), jnp.asarray(low), 2, method, **kw))
    got = float(losses.ic_loss(torch.from_numpy(out), torch.from_numpy(low), 2, method, **kw))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("time_stride,val_frac,drop_last", [(4, 0.1, True), (3, 0.0, False),
                                                           (20, 0.5, True)])
def test_data_loss_matches_jax(time_stride, val_frac, drop_last):
    jcfg = jlosses.DataLossConfig(time_stride=time_stride, space_stride=4, val_frac=val_frac,
                                  drop_last_frame=drop_last)
    cfg = losses.DataLossConfig(time_stride=time_stride, space_stride=4, val_frac=val_frac,
                                drop_last_frame=drop_last)
    roll = _rand((41, 16, 16, 2), 4)
    meas = np.array(jlosses.subsample(jnp.asarray(_rand((41, 16, 16, 2), 5)), jcfg, 2))
    want = [float(v) for v in jlosses.data_loss(jnp.asarray(roll), jnp.asarray(meas), jcfg, 2)]
    got = [float(v) for v in losses.data_loss(torch.from_numpy(roll), torch.from_numpy(meas),
                                              cfg, 2)]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)
    assert losses.subsample(torch.from_numpy(roll), cfg, 2).shape == meas.shape


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_phys_loss_and_residual_match_jax(dtype, rtol):
    roll = _rand((7, 12, 16, 2), 6, dtype=dtype, scale=0.1, shift=0.4)
    want_r = np.asarray(jlosses.physics_residual(J_PDE_SYSTEMS["gray_scott_2d"],
                                                 jnp.asarray(roll), 0.5, 0.01))
    got_r = losses.physics_residual(PDE_SYSTEMS["gray_scott_2d"], torch.from_numpy(roll),
                                    0.5, 0.01).numpy()
    assert got_r.shape == want_r.shape == (5, 12, 16, 2)
    scale = np.abs(want_r).max()
    np.testing.assert_allclose(got_r, want_r, rtol=rtol, atol=rtol * scale)
    want = float(jlosses.phys_loss(J_PDE_SYSTEMS["gray_scott_2d"], jnp.asarray(roll), 0.5, 0.01))
    got = float(losses.phys_loss(PDE_SYSTEMS["gray_scott_2d"], torch.from_numpy(roll), 0.5, 0.01))
    np.testing.assert_allclose(got, want, rtol=10 * rtol)


def test_time_derivative_fwd_matches_jax():
    seq = _rand((9, 4, 5, 2), 7, dtype=np.float64)
    want = np.asarray(j_time_derivative_fwd(jnp.asarray(seq), 0.25))
    got = time_derivative_fwd(torch.from_numpy(seq), 0.25).numpy()
    assert got.shape == want.shape == (7, 4, 5, 2)
    np.testing.assert_allclose(got, want, rtol=1e-14)


def test_mse_matches_jax():
    a, b = _rand((3, 5, 2), 8), _rand((3, 5, 2), 9)
    np.testing.assert_allclose(float(losses.mse(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jlosses.mse(jnp.asarray(a), jnp.asarray(b))), rtol=RTOL)
    np.testing.assert_allclose(float(losses.mse(torch.from_numpy(a))),
                               float(jlosses.mse(jnp.asarray(a))), rtol=RTOL)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_gs3d_phys_loss_and_residual_match_jax(dtype, rtol):
    """Gray-Scott 3D (Du 0.2, Dv 0.1, f 0.025, k 0.055) over a 6 x 8 x 7 grid."""
    roll = _rand((6, 6, 8, 7, 2), 10, dtype=dtype, scale=0.1, shift=0.4)
    system = J_PDE_SYSTEMS["gray_scott_3d"]
    want_r = np.asarray(jlosses.physics_residual(system, jnp.asarray(roll), 0.5, 100 / 48))
    got_r = losses.physics_residual(PDE_SYSTEMS["gray_scott_3d"], torch.from_numpy(roll),
                                    0.5, 100 / 48).numpy()
    assert PDE_SYSTEMS["gray_scott_3d"].ndim == system.ndim == 3
    assert got_r.shape == want_r.shape == (4, 6, 8, 7, 2)
    scale = np.abs(want_r).max()
    np.testing.assert_allclose(got_r, want_r, rtol=rtol, atol=rtol * scale)
    want = float(jlosses.phys_loss(system, jnp.asarray(roll), 0.5, 100 / 48))
    got = float(losses.phys_loss(PDE_SYSTEMS["gray_scott_3d"], torch.from_numpy(roll), 0.5,
                                 100 / 48))
    np.testing.assert_allclose(got, want, rtol=10 * rtol)


def test_unknown_system_raises():
    with pytest.raises(KeyError):
        PDE_SYSTEMS["no_such_system"]
