"""percnn_tpu_torch serving path on the CPU against percnn_tpu's: the whole
ISG -> fused rollout callable, the runner's inference, and the rule that
entry points run on CUDA unless told device="cpu"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.core.isg import ISGConfig as JISGConfig, init_isg as j_init_isg
from percnn_tpu.experiments import runner as jrunner
from percnn_tpu.experiments.configs import GS2D_RECON as J_GS2D_RECON
from percnn_tpu.serving import build_serving_fn as j_build_serving_fn

from percnn_tpu_torch import bridge
from percnn_tpu_torch.core.cell import (
    PiCellConfig,
    SymbolicCellConfig,
    init_pi_cell,
    init_symbolic_cell,
)
from percnn_tpu_torch.core.isg import ISGConfig, init_isg
from percnn_tpu_torch.experiments import runner
from percnn_tpu_torch.experiments.configs import GS2D_RECON
from percnn_tpu_torch.serving import build_serving_fn

CELL = dict(ndim=2, hidden=8, kernel_size=1, dt=0.5, dx=0.01,
            diffusion="sigmoid", mu_up=3.99e-5, init_scale=0.02)
# a 5x5 cell (the Burgers Stage-1 model's form, narrow)
CELL5 = dict(ndim=2, hidden=3, kernel_size=5, dt=0.05, dx=0.2, diffusion="sigmoid",
             mu_up=0.2, init_scale=0.3)
ISG = dict(ndim=2, hidden=8, strides=(2, 2), activation="sigmoid")


def _model(seed=0, cell=CELL):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jm = {"cell": j_init_pi_cell(k1, JPiCellConfig(**cell)),
          "isg": j_init_isg(k2, JISGConfig(**ISG))}
    return jm, jax.tree_util.tree_map(np.asarray, jm)


def _ic_low(seed=1, n=8):
    rng = np.random.RandomState(seed)
    return rng.uniform(0.0, 1.0, (n, n, 2)).astype(np.float32)


@pytest.mark.parametrize("final_only, cell, n_low, steps", [
    pytest.param(False, CELL, 8, 6, id="False"),
    pytest.param(True, CELL, 8, 6, id="True"),
    pytest.param(True, CELL5, 4, 3, id="True-k5"),
])
def test_serving_matches_jax(final_only, cell, n_low, steps):
    jm, nm = _model(cell=cell)
    x = _ic_low(n=n_low)
    want = np.asarray(j_build_serving_fn(
        jm, JPiCellConfig(**cell), steps, isg_cfg=JISGConfig(**ISG),
        final_only=final_only, use_pallas=True)(jnp.asarray(x)))
    fn = build_serving_fn(nm, PiCellConfig(**cell), steps, isg_cfg=ISGConfig(**ISG),
                          final_only=final_only, device="cpu")
    got = fn(x)
    n = 4 * n_low
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == ((n, n, 2) if final_only else (steps + 1, n, n, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


def test_serving_without_isg_matches_jax():
    jm, nm = _model(seed=2)
    h0 = _ic_low(seed=3)
    want = np.asarray(j_build_serving_fn(jm["cell"], JPiCellConfig(**CELL), 4,
                                         use_pallas=True)(jnp.asarray(h0)))
    got = build_serving_fn(nm["cell"], PiCellConfig(**CELL), 4, device="cpu")(h0)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


def test_inference_rollout_matches_jax():
    import dataclasses

    jexp = dataclasses.replace(J_GS2D_RECON, grid=32)
    exp = dataclasses.replace(GS2D_RECON, grid=32)
    jm, nm = _model(seed=4)
    x = _ic_low(seed=5)
    prob = jrunner.Problem(jexp, None, None, jnp.asarray(x)[None], None)
    want = np.asarray(jrunner.inference_rollout(jm, prob, 5))
    params = bridge.params_from_numpy(nm, device="cpu")
    got = runner.inference_rollout(params, exp, x, 5, device="cpu")
    assert got.shape == (6, 32, 32, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


def test_init_model_layout_matches_jax():
    params = runner.init_model(GS2D_RECON, torch.Generator().manual_seed(0), device="cpu")
    want = jrunner.init_model(J_GS2D_RECON, jax.random.PRNGKey(0))
    ours = bridge.params_to_numpy(params)
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, want)))
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32


_ENTRY_POINTS = {
    "params_from_numpy": lambda dev: bridge.params_from_numpy({"w": np.zeros(2)}, **dev),
    "init_pi_cell": lambda dev: init_pi_cell(torch.Generator(), PiCellConfig(), **dev),
    "init_isg": lambda dev: init_isg(torch.Generator(), ISGConfig(), **dev),
    "init_model": lambda dev: runner.init_model(GS2D_RECON, torch.Generator(), **dev),
    "build_serving_fn": lambda dev: build_serving_fn(
        _model()[1], PiCellConfig(**CELL), 2, isg_cfg=ISGConfig(**ISG), **dev),
    "inference_rollout": lambda dev: runner.inference_rollout(
        bridge.params_from_numpy(_model()[1], device="cpu"), GS2D_RECON,
        _ic_low(), 2, **dev),
    "build_serving_fn[symbolic]": lambda dev: build_serving_fn(
        {"nu": np.full(2, 0.1, np.float32), "coef": [np.ones(1, np.float32)] * 2},
        SymbolicCellConfig(terms=(("u",), ("v",))), 2, **dev),
    "init_symbolic_cell": lambda dev: init_symbolic_cell(
        torch.Generator(), SymbolicCellConfig(terms=(("u",), ("v",))), **dev),
}


@pytest.mark.parametrize("name", list(_ENTRY_POINTS))
def test_entry_points_need_cuda_unless_told_cpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[name]({})
    _ENTRY_POINTS[name]({"device": "cpu"})
