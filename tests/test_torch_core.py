"""percnn_tpu_torch: stencils, convs, Pi cell, ISG, rollout and init against
the JAX package, and the committed GS2D golden.

Inputs come from a seeded numpy RandomState, cast explicitly (x64 is on in
the test session), and go through both packages as numpy arrays.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core import cell as jcell
from percnn_tpu.core import isg as jisg
from percnn_tpu.core.rollout import rollout as j_rollout, rollout_final as j_rollout_final
from percnn_tpu.ops import convs as jconvs
from percnn_tpu.ops.stencils import laplacian_2d as j_laplacian_2d

from percnn_tpu_torch.bridge import params_from_numpy, unflatten_dotted
from percnn_tpu_torch.core.cell import (
    PiCellConfig, effective_diffusion, init_pi_cell, pi_cell_step,
)
from percnn_tpu_torch.core.isg import ISGConfig, init_isg, isg_apply
from percnn_tpu_torch.core.rollout import rollout, rollout_final
from percnn_tpu_torch.ops.convs import conv_transpose_torch, pointwise_conv
from percnn_tpu_torch.ops.kernels.cell2d import fused_rollout_2d
from percnn_tpu_torch.ops.stencils import laplacian_2d

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pt_gs2d.npz")
RTOL, ATOL = 2e-4, 1e-5   # the JAX package's forward kernel-vs-jnp bar

CELL_CFGS = {
    "gs2d": dict(ndim=2, hidden=8, kernel_size=1, dt=0.5, dx=0.01,
                 diffusion="sigmoid", mu_up=3.99e-5, init_scale=0.02),
    "lo": dict(ndim=2, hidden=4, kernel_size=1, dt=0.0125, dx=0.2,
               diffusion="raw", diff_init=0.2, init="fanin", init_scale=0.5),
}


def _rand(shape, seed, dtype=np.float32, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(dtype)


def _cell_pair(name, seed=0, scale=None):
    """The same cell params in both packages (JAX init, moved over as numpy)."""
    kw = dict(CELL_CFGS[name])
    if scale is not None:
        kw["init_scale"] = scale
    jcfg = jcell.PiCellConfig(**kw)
    jp = jcell.init_pi_cell(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, PiCellConfig(**kw), tp


@pytest.mark.parametrize("shape", [(16, 20, 2), (3, 12, 8, 2)])
@pytest.mark.parametrize("dtype,tol", [(np.float32, (RTOL, ATOL)),
                                       (np.float64, (1e-10, 1e-10))])
def test_laplacian_2d_matches_jax(shape, dtype, tol):
    u = _rand(shape, 0, dtype)
    want = np.asarray(j_laplacian_2d(jnp.asarray(u), 0.2))
    got = laplacian_2d(torch.from_numpy(u), 0.2).numpy()
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])


def test_pointwise_conv_matches_jax():
    x, w, b = _rand((2, 6, 7, 3), 1), _rand((3, 5), 2), _rand((5,), 3)
    want = np.asarray(jconvs.pointwise_conv(*map(jnp.asarray, (x, w, b))))
    got = pointwise_conv(*map(torch.from_numpy, (x, w, b))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_transpose_matches_jax(stride):
    x, w, b = _rand((2, 6, 5, 3), 4), _rand((5, 5, 3, 4), 5), _rand((4,), 6)
    kw = dict(stride=stride, padding=2, output_padding=stride - 1)
    want = np.asarray(jconvs.conv_transpose_torch(*map(jnp.asarray, (x, w, b)), **kw))
    got = conv_transpose_torch(*map(torch.from_numpy, (x, w, b)), **kw).numpy()
    assert got.shape == want.shape == (2, 6 * stride, 5 * stride, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(CELL_CFGS))
def test_pi_cell_step_matches_jax(name):
    jcfg, jp, cfg, tp = _cell_pair(name, scale=0.5)
    h = _rand((12, 16, 2), 7, scale=0.3)
    want = np.asarray(jcell.pi_cell_step(jp, jnp.asarray(h), jcfg))
    got = pi_cell_step(tp, torch.from_numpy(h), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(effective_diffusion(tp, cfg).numpy(),
                               np.asarray(jcell.effective_diffusion(jp, jcfg)),
                               rtol=1e-6)


def test_rollout_matches_jax():
    jcfg, jp, cfg, tp = _cell_pair("lo", scale=0.5)
    h0 = _rand((10, 12, 2), 8, scale=0.3)
    want = np.asarray(j_rollout(lambda h: jcell.pi_cell_step(jp, h, jcfg),
                                jnp.asarray(h0), 6, remat=False))
    got = rollout(lambda h: pi_cell_step(tp, h, cfg), torch.from_numpy(h0), 6).numpy()
    assert got.shape == (7, 10, 12, 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    want_last = np.asarray(j_rollout_final(lambda h: jcell.pi_cell_step(jp, h, jcfg),
                                           jnp.asarray(h0), 6))
    got_last = rollout_final(lambda h: pi_cell_step(tp, h, cfg),
                             torch.from_numpy(h0), 6).numpy()
    np.testing.assert_allclose(got_last, want_last, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("strides,act", [((2, 2), "sigmoid"), ((2,), "tanh")])
def test_isg_apply_matches_jax(strides, act):
    jcfg = jisg.ISGConfig(ndim=2, hidden=8, strides=strides, activation=act)
    jp = jisg.init_isg(jax.random.PRNGKey(2), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = _rand((1, 8, 6, 2), 9)
    want = np.asarray(jisg.isg_apply(jp, jnp.asarray(x), jcfg))
    got = isg_apply(tp, torch.from_numpy(x),
                    ISGConfig(ndim=2, hidden=8, strides=strides, activation=act)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("path", ["pi_cell_step", "fused_rollout_2d"])
def test_golden_rollout(path):
    """The reference's trained GS2D cell reproduces its torch frames, at the
    bar of tests/test_pt_import.py (2e-5 * t in f32)."""
    with np.load(GOLDEN) as z:
        frames = z["frames"]
        params = params_from_numpy(unflatten_dotted(z, "cell."), device="cpu")
    cfg = PiCellConfig(ndim=2, hidden=8, kernel_size=1, dt=0.5, dx=0.01,
                       diffusion="sigmoid", mu_up=3.99e-5)
    h0 = torch.from_numpy(frames[0])
    n = frames.shape[0] - 1
    if path == "pi_cell_step":
        got = rollout(lambda h: pi_cell_step(params, h, cfg), h0, n).numpy()
    else:
        got = fused_rollout_2d(params, h0, cfg, n).numpy()
    for t in range(1, n + 1):
        err = np.abs(got[t] - frames[t]).max()
        assert err < 2e-5 * t, f"step {t}: max |diff| {err}"


def test_golden_isg():
    with np.load(GOLDEN) as z:
        params = params_from_numpy(unflatten_dotted(z, "isg."), device="cpu")
        got = isg_apply(params, torch.from_numpy(z["isg_in"]),
                        ISGConfig(ndim=2, hidden=8, strides=(2, 2))).numpy()
        np.testing.assert_allclose(got, z["isg_out"], atol=2e-6, rtol=1e-5)


def test_init_distributions_match_jax():
    """The same bounds as the JAX initialisers (the draws differ): scaled
    Xavier and fan-in uniform for the cell, PyTorch's ConvT fan-in rule
    (Cout * k^2) for the ISG."""
    gen = torch.Generator().manual_seed(0)
    for name in CELL_CFGS:
        cfg = PiCellConfig(**{**CELL_CFGS[name], "hidden": 64})
        p = init_pi_cell(gen, cfg, device="cpu")
        jp = jcell.init_pi_cell(jax.random.PRNGKey(0), jcell.PiCellConfig(
            **{**CELL_CFGS[name], "hidden": 64}))
        for key in ("w0", "w_out"):
            ours = p["pi"][0][key].abs().max().item()
            theirs = float(jnp.abs(jp["pi"][0][key]).max())
            assert p["pi"][0][key].shape == jp["pi"][0][key].shape
            assert ours == pytest.approx(theirs, rel=0.1), (name, key)
        assert float(p["pi"][0]["b0"].abs().max()) == 0.0
        if cfg.diff_init is None:
            assert float(p["diff"].abs().max()) < 1.0
        else:
            np.testing.assert_array_equal(p["diff"].numpy(),
                                          np.full(2, cfg.diff_init, np.float32))
    isg = init_isg(gen, ISGConfig(ndim=2, hidden=64, strides=(2, 2)), device="cpu")
    b = 1.0 / math.sqrt(64 * 25)
    for key in ("up0_w", "up1_w"):
        w = isg[key]
        assert float(w.abs().max()) <= b
        assert float(w.abs().max()) > 0.95 * b
        assert abs(float(w.std()) - b / math.sqrt(3)) < 0.05 * b
