"""percnn_tpu_torch: parameter bridge, checkpoint reader, configs and data
copies against the JAX package."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.core.checkpoint import save_checkpoint
from percnn_tpu.core.isg import ISGConfig as JISGConfig, init_isg as j_init_isg
from percnn_tpu.data.noise import add_noise as j_add_noise
from percnn_tpu.data.simulate import default_ic as j_default_ic
from percnn_tpu.experiments.configs import GS2D_RECON as J_GS2D_RECON

from percnn_tpu_torch.bridge import params_from_numpy, params_to_numpy, unflatten_dotted
from percnn_tpu_torch.core.checkpoint import load_checkpoint_tree
from percnn_tpu_torch.data.noise import add_noise
from percnn_tpu_torch.data.simulate import default_ic
from percnn_tpu_torch.experiments.configs import GS2D_RECON

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pt_gs2d.npz")
J_CELL = JPiCellConfig(ndim=2, hidden=8, kernel_size=1, dt=0.5, dx=0.01,
                       diffusion="sigmoid", mu_up=3.99e-5)
J_ISG = JISGConfig(ndim=2, hidden=8, strides=(2, 2), activation="sigmoid")


def _jax_model(seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {"cell": j_init_pi_cell(k1, J_CELL), "isg": j_init_isg(k2, J_ISG)}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("dtype", [None, torch.float64])
def test_bridge_round_trip(dtype):
    tree = _numpy(_jax_model())
    params = params_from_numpy(tree, device="cpu", dtype=dtype)
    assert isinstance(params["cell"]["pi"], list)
    leaf = params["cell"]["pi"][1]["w_out"]
    assert isinstance(leaf, torch.Tensor) and leaf.shape == (8, 1)
    assert leaf.dtype == (dtype or torch.float32)
    back = params_to_numpy(params)
    if dtype is None:
        _assert_trees_equal(back, tree)
    else:
        _assert_trees_equal(back, jax.tree_util.tree_map(
            lambda x: x.astype(np.float64), tree))


def test_unflatten_dotted_reads_golden():
    with np.load(GOLDEN) as z:
        cell = unflatten_dotted(z, "cell.")
        isg = unflatten_dotted(z, "isg.")
        assert unflatten_dotted(z, "nope.") is None
        # the layout of the JAX package's trees, key for key and shape for shape
        want = _numpy(_jax_model())
        assert (jax.tree_util.tree_structure(cell)
                == jax.tree_util.tree_structure(want["cell"]))
        assert (jax.tree_util.tree_structure(isg)
                == jax.tree_util.tree_structure(want["isg"]))
        for path, leaf in jax.tree_util.tree_flatten_with_path(cell)[0]:
            key = "cell." + ".".join(str(getattr(p, "key", getattr(p, "idx", None)))
                                     for p in path)
            np.testing.assert_array_equal(leaf, z[key])
        np.testing.assert_array_equal(isg["up1_w"], z["isg.up1_w"])


def test_checkpoint_reader_loads_jax_checkpoint(tmp_path):
    tree = _jax_model(seed=3)
    path = str(tmp_path / "model.ckpt.npz")
    save_checkpoint(path, tree, meta={"iteration": 7, "stage": 2})
    got, meta = load_checkpoint_tree(path)
    assert meta == {"iteration": 7, "stage": 2}
    _assert_trees_equal(got, _numpy(tree))
    params = params_from_numpy(got, device="cpu")
    assert params["cell"]["pi"][0]["w0"].shape == (2, 8)


def test_checkpoint_reader_named_fields(tmp_path):
    """NamedTuple fields (optimizer state) come back as dict keys."""
    import optax

    params = {"w": jnp.arange(3.0, dtype=jnp.float32)}
    state = optax.adam(1e-3).init(params)
    path = str(tmp_path / "opt.npz")
    save_checkpoint(path, {"params": params, "opt": state})
    got, _ = load_checkpoint_tree(path)
    np.testing.assert_array_equal(got["params"]["w"], [0.0, 1.0, 2.0])
    assert set(got["opt"][0]) == {"count", "mu", "nu"}
    np.testing.assert_array_equal(got["opt"][0]["mu"]["w"], np.zeros(3, np.float32))


def test_gs2d_config_matches_jax():
    assert dataclasses.asdict(GS2D_RECON) == dataclasses.asdict(J_GS2D_RECON)
    assert GS2D_RECON.isg.scale == J_GS2D_RECON.isg.scale == 4
    assert GS2D_RECON.cell.spatial_axes == J_GS2D_RECON.cell.spatial_axes


@pytest.mark.parametrize("seed", [66, 3])
def test_default_ic_and_noise_match_jax(seed):
    ic = default_ic("gray_scott_2d", 20, seed=seed)
    np.testing.assert_array_equal(ic, j_default_ic("gray_scott_2d", 20, seed=seed))
    np.testing.assert_array_equal(add_noise(ic[None], 0.1, seed=seed),
                                  j_add_noise(ic[None], 0.1, seed=seed))


def test_checkpoint_reader_rejects_unparseable_keypath(tmp_path):
    path = str(tmp_path / "bad.npz")
    np.savez(path, leaf_0=np.zeros(2), __paths__=np.asarray('["[<flat index 0>]"]'),
             __meta__=np.asarray("{}"))
    with pytest.raises(ValueError, match="unparseable"):
        load_checkpoint_tree(path)
