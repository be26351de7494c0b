"""percnn_tpu_torch.data.simulate against the JAX package's RK4 truth
generator, and the dataset cache the two packages share."""

import dataclasses

import numpy as np
import pytest

from percnn_tpu.data.simulate import default_ic as j_default_ic, simulate as j_simulate
from percnn_tpu.experiments import runner as jrunner
from percnn_tpu.experiments.configs import GS2D_RECON as J_GS2D_RECON

from percnn_tpu_torch.data.simulate import default_ic, simulate
from percnn_tpu_torch.experiments import runner
from percnn_tpu_torch.experiments.configs import GS2D_RECON


def test_simulate_gs2d_matches_jax_f64():
    """16 x 16, 5 frames of 4 RK4 substeps in f64: the same arithmetic, so
    the frames agree to f64 rounding (atol 1e-12)."""
    h0 = default_ic("gray_scott_2d", 16, seed=3)
    np.testing.assert_array_equal(h0, j_default_ic("gray_scott_2d", 16, seed=3))
    want = j_simulate("gray_scott_2d", h0, 5, 0.5, 0.01)
    got = simulate("gray_scott_2d", h0, 5, 0.5, 0.01, device="cpu")
    assert got.dtype == np.float64 and got.shape == want.shape == (6, 16, 16, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert not np.allclose(got[-1], got[0])


@pytest.mark.parametrize("oversample", [1, 2])
def test_simulate_oversample_matches_jax(oversample):
    h0 = default_ic("gray_scott_2d", 12, seed=4)
    want = j_simulate("gray_scott_2d", h0, 3, 1.0, 0.01, oversample=oversample)
    got = simulate("gray_scott_2d", h0, 3, 1.0, 0.01, oversample=oversample, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_make_dataset_cache_is_shared(tmp_path):
    """The port writes the cache file the JAX package reads, and the reverse."""
    exp = dataclasses.replace(GS2D_RECON, grid=16, train_steps=4, infer_steps=4)
    jexp = dataclasses.replace(J_GS2D_RECON, grid=16, train_steps=4, infer_steps=4)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    truth = runner.make_dataset(exp, cache_dir=port_dir, device="cpu")
    assert truth.shape == (5, 16, 16, 2)
    np.testing.assert_array_equal(jrunner.make_dataset(jexp, cache_dir=port_dir), truth)
    jtruth = jrunner.make_dataset(jexp, cache_dir=jax_dir)
    np.testing.assert_allclose(truth, jtruth, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(runner.make_dataset(exp, cache_dir=jax_dir, device="cpu"),
                                  jtruth)


def test_make_dataset_rebuilds_a_half_written_cache(tmp_path):
    exp = dataclasses.replace(GS2D_RECON, grid=12, train_steps=3, infer_steps=3)
    cache_dir = tmp_path / "cache"
    truth = runner.make_dataset(exp, cache_dir=str(cache_dir), device="cpu")
    (path,) = cache_dir.iterdir()
    path.write_bytes(b"not a zip file")
    np.testing.assert_array_equal(runner.make_dataset(exp, cache_dir=str(cache_dir),
                                                      device="cpu"), truth)
