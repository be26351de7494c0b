"""percnn_tpu_torch.ops.kernels.cell3d and the 3D ISG on the CPU: the expanded
packing, the plain rollout against percnn_tpu's Pallas kernel in interpret
mode, the committed GS3D golden, the 3D transposed conv, and the dispatch
rule (a CUDA tensor never reaches the plain version).

rollout3d_kernel itself runs only on the card: ``python3 chip_smoke.py``
holds it against the plain version there.  Bars: the forward bar of
tests/test_pallas.py (rtol 2e-4, atol 1e-5); the golden bars of
tests/test_pt_import.py (rollout 2e-5 * t in f32, ISG atol 2e-6).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core import isg as jisg
from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.ops import convs as jconvs
from percnn_tpu.ops.pallas import cell3d as jcell3d

from percnn_tpu_torch.bridge import params_from_numpy, unflatten_dotted
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step
from percnn_tpu_torch.core.isg import ISGConfig, isg_apply
from percnn_tpu_torch.core.rollout import rollout
from percnn_tpu_torch.ops.convs import conv_transpose_torch
from percnn_tpu_torch.ops.kernels import _build, cell3d

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pt_gs3d.npz")
GS3D_CELL = dict(ndim=3, hidden=2, kernel_size=1, dt=0.5, dx=100 / 48,
                 diffusion="sigmoid", mu_up=0.274)
CFGS = {
    "c2": dict(ndim=3, hidden=2, kernel_size=1, dt=0.5, dx=2.08,
               diffusion="sigmoid", mu_up=0.274, init_scale=0.01),
    "c8": dict(ndim=3, hidden=8, kernel_size=1, dt=0.5, dx=2.08,
               diffusion="sigmoid", mu_up=0.274, init_scale=0.01),
}


def _pair(name, seed=0):
    jcfg = JPiCellConfig(**CFGS[name])
    jp = j_init_pi_cell(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, PiCellConfig(**CFGS[name]), tp


def _h0(shape, seed=1):
    return (0.3 * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("name", list(CFGS))
def test_pack_pi_expanded_matches_jax(name):
    jcfg, jp, cfg, tp = _pair(name)
    want = np.asarray(jcell3d.pack_pi_expanded_3d(jp, jcfg))
    got = cell3d.pack_pi_expanded_3d(tp, cfg).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (24,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9 * np.abs(want).max())
    # the literal pack is the 2D layout: 44 floats for hidden 2
    assert cell3d.pack_pi_params_3d(tp, cfg).shape == ((44,) if name == "c2" else (164,))


@pytest.mark.parametrize("final_only", [False, True], ids=["frames", "final"])
@pytest.mark.parametrize("name", list(CFGS))
def test_fused_rollout_matches_pallas(name, final_only):
    """8 x 8 x 16, T = 5: the plain version against _rollout3d_kernel in
    interpret mode (expanded form, as JAX runs it by default)."""
    jcfg, jp, cfg, tp = _pair(name, seed=2)
    h0 = _h0((8, 8, 16, 2), seed=3)
    want = np.asarray(jcell3d.fused_rollout_3d(jp, jnp.asarray(h0), jcfg, 5,
                                               final_only=final_only, interpret=True))
    got = cell3d.fused_rollout_3d(tp, torch.from_numpy(h0), cfg, 5, final_only=final_only)
    assert got.shape == want.shape == ((8, 8, 16, 2) if final_only else (6, 8, 8, 16, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(CFGS))
def test_plain_rollout_agrees_with_cell_step(name):
    """The expanded plain version equals the port's own step-by-step rollout
    on a shape the TPU kernel does not take (5 x 6 x 7); the final state is
    the last frame; zero steps return h0."""
    _, _, cfg, tp = _pair(name, seed=4)
    h0 = torch.from_numpy(_h0((5, 6, 7, 2), seed=5))
    frames = cell3d.fused_rollout_3d(tp, h0, cfg, 4)
    want = rollout(lambda h: pi_cell_step(tp, h, cfg), h0, 4)
    np.testing.assert_allclose(frames.numpy(), want.numpy(), rtol=2e-4, atol=1e-5)
    final = cell3d.fused_rollout_3d(tp, h0, cfg, 4, final_only=True)
    torch.testing.assert_close(final, frames[-1], rtol=0, atol=0)
    assert cell3d.fused_rollout_3d(tp, h0, cfg, 0, final_only=True).equal(h0)
    assert cell3d.fused_rollout_3d(tp, h0, cfg, 0).shape == (1, 5, 6, 7, 2)


def _golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("path", ["pi_cell_step", "fused_rollout_3d"])
def test_golden_rollout(path):
    """The reference's trained GS3D cell reproduces its torch frames at 24^3,
    at the bar of tests/test_pt_import.py (2e-5 * t in f32)."""
    z = _golden()
    params = params_from_numpy(unflatten_dotted(z, "cell."), device="cpu")
    cfg = PiCellConfig(**GS3D_CELL)
    frames = z["frames"]
    h0 = torch.from_numpy(frames[0])
    n = frames.shape[0] - 1
    if path == "pi_cell_step":
        got = rollout(lambda h: pi_cell_step(params, h, cfg), h0, n).numpy()
    else:
        got = cell3d.fused_rollout_3d(params, h0, cfg, n).numpy()
    for t in range(1, n + 1):
        err = np.abs(got[t] - frames[t]).max()
        assert err < 2e-5 * t, f"step {t}: max |diff| {err}"


def test_golden_isg():
    """12^3 -> 24^3 through ConvT(s2), sigmoid, ConvT(s1), 1x1."""
    z = _golden()
    params = params_from_numpy(unflatten_dotted(z, "isg."), device="cpu")
    got = isg_apply(params, torch.from_numpy(z["isg_in"]),
                    ISGConfig(ndim=3, hidden=8, strides=(2, 1))).numpy()
    assert got.shape == z["isg_out"].shape == (24, 24, 24, 2)
    np.testing.assert_allclose(got, z["isg_out"], atol=2e-6, rtol=1e-5)


def _rand(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_transpose_3d_matches_jax(stride):
    x, w, b = _rand((2, 4, 5, 3, 3), 4), _rand((5, 5, 5, 3, 4), 5), _rand((4,), 6)
    kw = dict(stride=stride, padding=2, output_padding=stride - 1)
    want = np.asarray(jconvs.conv_transpose_torch(*map(jnp.asarray, (x, w, b)), **kw))
    got = conv_transpose_torch(*map(torch.from_numpy, (x, w, b)), **kw).numpy()
    assert got.shape == want.shape == (2, 4 * stride, 5 * stride, 3 * stride, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_isg_3d_matches_jax():
    jcfg = jisg.ISGConfig(ndim=3, hidden=8, strides=(2, 1), activation="sigmoid")
    jp = jisg.init_isg(jax.random.PRNGKey(2), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = _rand((1, 5, 6, 4, 2), 9)
    want = np.asarray(jisg.isg_apply(jp, jnp.asarray(x), jcfg))
    got = isg_apply(tp, torch.from_numpy(x), ISGConfig(ndim=3, hidden=8, strides=(2, 1))).numpy()
    assert got.shape == want.shape == (1, 10, 12, 8, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cpu_path_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(cell3d.fused_rollout_3d, "launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    _, _, cfg, tp = _pair("c2")
    h0 = torch.from_numpy(_h0((6, 6, 6, 2)))
    cell3d.fused_rollout_3d(tp, h0, cfg, 3)
    cell3d.fused_rollout_3d(tp, h0, cfg, 3, final_only=True)
    assert cell3d.fused_rollout_3d.launches == 0


@pytest.mark.parametrize("final_only", [False, True], ids=["frames", "final"])
def test_non_cpu_tensor_never_reaches_plain(monkeypatch, final_only):
    """A tensor that is not on the CPU goes to the kernel: when the kernel
    cannot be loaded, the error propagates; nothing falls back."""
    def fail_plain(*args, **kwargs):
        raise AssertionError("the plain version was reached")

    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    monkeypatch.setattr(cell3d, "fused_rollout_3d_plain", fail_plain)
    monkeypatch.setattr(_build, "load_library", fail_load)
    _, _, cfg, tp = _pair("c2")
    meta = params_from_numpy(tp, device="meta")
    with pytest.raises(RuntimeError, match="loader disabled"):
        cell3d.fused_rollout_3d(meta, torch.empty((6, 6, 6, 2), device="meta"), cfg, 3,
                                final_only=final_only)


def test_kernel_inputs_are_checked():
    _, _, cfg, tp = _pair("c2")
    e = cell3d.pack_pi_expanded_3d(tp, cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cell3d._check_inputs(e, torch.zeros(6, 6, 6, 2), 3)


@pytest.mark.parametrize("change", [dict(kernel_size=5), dict(n_branches=2), dict(ndim=2)])
def test_unfusable_cells_raise(change):
    cfg = PiCellConfig(**{**CFGS["c2"], **change})
    with pytest.raises(NotImplementedError, match="3D"):
        cell3d.fused_rollout_3d({}, torch.zeros(6, 6, 6, 2), cfg, 1)
