"""percnn_tpu_torch.ops.kernels.cell2d on the CPU: packing, the plain
versions against percnn_tpu's Pallas kernels in interpret mode, and the
dispatch rule (a CUDA tensor never reaches the plain version).

The CUDA kernels themselves run only on the card: ``python3 chip_smoke.py``
holds them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.ops.pallas import cell2d as jcell2d

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step
from percnn_tpu_torch.core.rollout import rollout
from percnn_tpu_torch.ops.kernels import _build, cell2d

CFGS = {
    "gs2d": dict(ndim=2, hidden=8, kernel_size=1, dt=0.5, dx=0.01,
                 diffusion="sigmoid", mu_up=3.99e-5, init_scale=0.02),
    "lo": dict(ndim=2, hidden=4, kernel_size=1, dt=0.0125, dx=0.2,
               diffusion="raw", diff_init=0.2, init="fanin", init_scale=0.5),
}


def _pair(name, seed=0):
    jcfg = JPiCellConfig(**CFGS[name])
    jp = j_init_pi_cell(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, PiCellConfig(**CFGS[name]), tp


def _h0(shape, seed=1):
    return (0.3 * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("name,n", [("gs2d", 164), ("lo", 2 + 2 * (3 * 12 + 5))])
def test_pack_pi_params_matches_jax_layout(name, n):
    jcfg, jp, cfg, tp = _pair(name)
    want = np.asarray(jcell2d.pack_pi_params_2d(jp, jcfg))
    got = cell2d.pack_pi_params_2d(tp, cfg).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (n,)
    # weights element for element; the two diffusion entries through sigmoid
    np.testing.assert_array_equal(got[2:], want[2:])
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,shape,steps", [("gs2d", (20, 24), 7), ("lo", (25, 32), 4)])
def test_fused_rollout_matches_pallas(name, shape, steps):
    jcfg, jp, cfg, tp = _pair(name)
    h0 = _h0(shape + (2,))
    want = np.asarray(jcell2d.fused_rollout_2d(jp, jnp.asarray(h0), jcfg, steps,
                                               interpret=True))
    got = cell2d.fused_rollout_2d(tp, torch.from_numpy(h0), cfg, steps).numpy()
    assert got.shape == want.shape == (steps + 1,) + shape + (2,)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_fused_final_matches_pallas():
    jcfg, jp, cfg, tp = _pair("gs2d", seed=2)
    h0 = _h0((16, 20, 2), seed=3)
    want = np.asarray(jcell2d.fused_rollout_final_2d(jp, jnp.asarray(h0), jcfg, 9,
                                                     interpret=True))
    got = cell2d.fused_rollout_final_2d(tp, torch.from_numpy(h0), cfg, 9).numpy()
    assert got.shape == (16, 20, 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(CFGS))
def test_plain_versions_agree_with_cell_step(name):
    """The plain versions, read from the packed vector, equal the port's own
    step-by-step rollout; the final state equals the last frame."""
    _, _, cfg, tp = _pair(name, seed=4)
    h0 = torch.from_numpy(_h0((12, 10, 2), seed=5))
    packed = cell2d.pack_pi_params_2d(tp, cfg)
    frames = cell2d.fused_rollout_2d_plain(packed, h0, cfg, 5)
    want = rollout(lambda h: pi_cell_step(tp, h, cfg), h0, 5)
    np.testing.assert_allclose(frames.numpy(), want.numpy(), rtol=2e-4, atol=1e-5)
    final = cell2d.fused_rollout_final_2d_plain(packed, h0, cfg, 5)
    torch.testing.assert_close(final, frames[-1], rtol=0, atol=0)
    assert cell2d.fused_rollout_final_2d(tp, h0, cfg, 0).equal(h0)
    assert cell2d.fused_rollout_2d(tp, h0, cfg, 0).shape == (1, 12, 10, 2)


def test_cpu_path_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(cell2d.fused_rollout_2d, "launches", 0)
    monkeypatch.setattr(cell2d.fused_rollout_final_2d, "launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    _, _, cfg, tp = _pair("gs2d")
    h0 = torch.from_numpy(_h0((8, 8, 2)))
    cell2d.fused_rollout_2d(tp, h0, cfg, 3)
    cell2d.fused_rollout_final_2d(tp, h0, cfg, 3)
    assert cell2d.fused_rollout_2d.launches == 0
    assert cell2d.fused_rollout_final_2d.launches == 0


@pytest.mark.parametrize("wrapper", ["fused_rollout_2d", "fused_rollout_final_2d"])
def test_non_cpu_tensor_never_reaches_plain(monkeypatch, wrapper):
    """A tensor that is not on the CPU goes to the kernel: when the kernel
    cannot be loaded, the error propagates; nothing falls back."""
    def fail_plain(*args, **kwargs):
        raise AssertionError("the plain version was reached")

    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    monkeypatch.setattr(cell2d, "fused_rollout_2d_plain", fail_plain)
    monkeypatch.setattr(cell2d, "fused_rollout_final_2d_plain", fail_plain)
    monkeypatch.setattr(_build, "load_library", fail_load)
    _, _, cfg, tp = _pair("gs2d")
    meta = params_from_numpy(tp, device="meta")
    h0 = torch.empty((8, 8, 2), device="meta")
    with pytest.raises(RuntimeError, match="loader disabled"):
        getattr(cell2d, wrapper)(meta, h0, cfg, 3)


def test_kernel_inputs_are_checked():
    _, _, cfg, tp = _pair("gs2d")
    packed = cell2d.pack_pi_params_2d(tp, cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cell2d._launch_args(packed, torch.zeros(8, 8, 2), cfg, 3)

