"""The port's utilities against percnn_tpu's: parameter summaries
(utils/params.py), the numerical checks (utils/debug.py), the profiling
helpers on the CPU (utils/profiling.py) and ops/stencils.laplacian_3d."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.core.isg import ISGConfig as JISGConfig, init_isg as j_init_isg
from percnn_tpu.ops.stencils import laplacian_3d as j_laplacian_3d
from percnn_tpu.utils.debug import assert_all_finite as j_assert_all_finite
from percnn_tpu.utils.params import count_parameters as j_count
from percnn_tpu.utils.params import summary_parameters as j_summary

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step
from percnn_tpu_torch.ops.stencils import laplacian_3d
from percnn_tpu_torch.utils import count_parameters, summary_parameters
from percnn_tpu_torch.utils.debug import assert_all_finite, checked, nan_guard
from percnn_tpu_torch.utils.profiling import TRACE_FILE, Timer, measure_rtt, trace

CELL = dict(ndim=2, hidden=8, kernel_size=1, dt=0.5, dx=0.01, diffusion="sigmoid",
            mu_up=3.99e-5)


@functools.lru_cache(maxsize=None)
def _jax_model(ndim=2, k=1):
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return {"cell": j_init_pi_cell(k1, JPiCellConfig(**{**CELL, "ndim": ndim,
                                                        "kernel_size": k})),
            "isg": j_init_isg(k2, JISGConfig(ndim=ndim, hidden=4, strides=(2, 1)))}


@pytest.mark.parametrize("ndim, k", [(2, 1), (2, 5), (3, 1)])
@pytest.mark.parametrize("leaves", ["numpy", "tensor"])
def test_summary_equals_jax(ndim, k, leaves):
    jm = _jax_model(ndim, k)
    nm = jax.tree_util.tree_map(np.asarray, jm)
    tree = nm if leaves == "numpy" else params_from_numpy(nm, device="cpu")
    assert summary_parameters(tree) == j_summary(jm)
    assert count_parameters(tree) == j_count(jm)


def test_summary_skips_none_as_jax_does():
    tree = {"a": np.zeros((2, 3)), "b": None, "c": [np.zeros(4), None]}
    assert summary_parameters(tree) == j_summary(tree)
    assert count_parameters(tree) == 10


def test_checked_names_the_op_that_made_a_nan():
    def fn(x):
        y = x * 2.0
        z = torch.sqrt(y - 1.0)      # a NaN where y < 1
        return {"z": z * 3.0, "y": y}

    err, out = checked(fn)(torch.tensor([0.25, 2.0]))
    assert "aten.sqrt" in err.get()
    with pytest.raises(FloatingPointError, match="aten.sqrt"):
        err.throw()
    assert torch.isnan(out["z"][0])
    ok, out = checked(fn)(torch.tensor([1.0, 2.0]))
    assert ok.get() is None
    ok.throw()


def test_checked_finds_a_nan_at_the_outputs():
    """A value made outside the dispatcher (here: written through numpy, as
    a ctypes kernel writes) is reported at fn's output."""
    def fn(x):
        y = x + 1.0
        y.numpy()[0] = np.nan
        return (x, [y])

    err, _ = checked(fn)(torch.tensor([1.0, 2.0]))
    assert "output[1][0]" in err.get()


def test_checked_on_a_cell_step():
    cfg = PiCellConfig(**CELL)
    jm = _jax_model()
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jm["cell"]), device="cpu")
    h = torch.rand(8, 8, 2, generator=torch.Generator().manual_seed(0))
    err, out = checked(lambda h: pi_cell_step(p, h, cfg))(h)
    assert err.get() is None and out.shape == h.shape
    h[0, 0, 0] = float("inf")
    err, _ = checked(lambda h: pi_cell_step(p, h, cfg))(h)
    assert err.get() is not None


def test_assert_all_finite_message_equals_jax():
    tree = {"cell": {"diff": np.array([1.0, np.nan]), "pi": [{"w0": np.ones(3)}]}}
    with pytest.raises(FloatingPointError) as got:
        assert_all_finite(params_from_numpy(tree, device="cpu"), "params")
    with pytest.raises(FloatingPointError) as want:
        j_assert_all_finite(tree, "params")
    assert str(got.value) == str(want.value)
    assert_all_finite({"a": torch.ones(2), "b": None})


def test_nan_guard():
    x = torch.tensor([1.0, float("nan"), float("inf"), -float("inf")])
    assert torch.equal(nan_guard(x, -1.0), torch.tensor([1.0, -1.0, -1.0, -1.0]))
    assert torch.equal(nan_guard(x)[1:], torch.zeros(3))


def test_profiling_on_the_cpu(tmp_path):
    path = str(tmp_path / "t.trace")
    with trace(path) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    with open(os.path.join(path, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert 0.0 < measure_rtt(3, device="cpu") < 1.0
    t = Timer(device="cpu")
    assert 0.0 < t.time(lambda: torch.ones(8) + 1, reps=3) < 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Timer()


def test_laplacian_3d_matches_jax():
    rng = np.random.RandomState(0)
    u = rng.standard_normal((2, 6, 7, 8, 2))
    want = np.asarray(j_laplacian_3d(jnp.asarray(u), 0.37))
    got = laplacian_3d(torch.as_tensor(u), 0.37).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
