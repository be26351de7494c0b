"""The k x k Pi cell of percnn_tpu_torch on the CPU, against the JAX package:
the periodic conv and the stencils it needs, the 5x5 cell step, the branch
matrix, the plain version of rollout2d_kxk_kernel against percnn_tpu's
``_rollout_kernel_mxu`` in interpret mode, the committed Burgers Stage-1
golden, and the dispatch rule (a CUDA tensor never reaches the plain
version).

rollout2d_kxk_kernel itself runs only on the card: ``python3 chip_smoke.py``
holds it against the plain version there.  Bars: the forward rtol 2e-4 /
atol 1e-5 (tests/test_pallas.py); the golden 2e-5 * t and the ISG atol 2e-6
(tests/test_pt_import.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.core.cell import pi_cell_step as j_pi_cell_step
from percnn_tpu.ops import convs as jconvs
from percnn_tpu.ops import stencils as jstencils
from percnn_tpu.ops.pallas import cell2d as jcell2d

from percnn_tpu_torch.bridge import params_from_numpy, unflatten_dotted
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step
from percnn_tpu_torch.core.isg import ISGConfig, isg_apply
from percnn_tpu_torch.core.rollout import rollout
from percnn_tpu_torch.ops import convs, stencils
from percnn_tpu_torch.ops.kernels import _build, cell2d
from percnn_tpu_torch.serving import build_serving_fn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pt_burgers_s1.npz")

CFGS = {
    "k5": dict(ndim=2, hidden=3, kernel_size=5, dt=0.05, dx=0.2, diffusion="sigmoid",
               mu_up=0.2, init_scale=0.3),
    "k3": dict(ndim=2, hidden=2, kernel_size=3, n_branches=2, dt=0.02, dx=0.1,
               diffusion="raw", diff_init=0.01, init_scale=0.4),
    "burgers": dict(ndim=2, hidden=16, kernel_size=5, dt=0.00025, dx=0.01,
                    diffusion="sigmoid", mu_up=0.01),
}


def _pair(name, seed=0):
    jcfg = JPiCellConfig(**CFGS[name])
    jp = j_init_pi_cell(jax.random.PRNGKey(seed), jcfg)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, PiCellConfig(**CFGS[name]), params_from_numpy(npp, device="cpu")


def _rand(shape, seed, scale=1.0, dtype=np.float32):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("wshape,xshape", [
    ((5, 5, 2, 4), (3, 10, 12, 2)),   # the Burgers branch, batched over time
    ((3, 3, 2, 3), (9, 7, 2)),
    ((4, 3, 2, 2), (8, 9, 2)),        # even: wrap-pad (2, 1)
    ((3, 3, 3, 2, 2), (6, 5, 7, 2)),  # 3D
])
def test_conv_nd_periodic_matches_jax(wshape, xshape):
    x, w, b = _rand(xshape, 0), _rand(wshape, 1), _rand(wshape[-1:], 2)
    want = np.asarray(jconvs.conv_nd_periodic(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = convs.conv_nd_periodic(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert got.shape == want.shape == xshape[:-1] + wshape[-1:]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    valid = convs.conv_nd(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(valid.numpy(), np.asarray(jconvs.conv_nd(jnp.asarray(x),
                                                                        jnp.asarray(w))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6), (np.float64, 1e-12)])
def test_grad_and_pad_stencils_match_jax(dtype, rtol):
    x = _rand((2, 9, 11, 2), 3, dtype=dtype)
    for fn in ("grad_x", "grad_y"):
        want = np.asarray(getattr(jstencils, fn)(jnp.asarray(x), 0.1))
        got = getattr(stencils, fn)(torch.from_numpy(x), 0.1).numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())
    np.testing.assert_array_equal(stencils.periodic_pad(torch.from_numpy(x), 2, (1, 2)).numpy(),
                                  np.asarray(jstencils.periodic_pad(jnp.asarray(x), 2, (1, 2))))


@pytest.mark.parametrize("name", ["k5", "k3"])
def test_kxk_cell_step_matches_jax(name):
    jcfg, jp, cfg, tp = _pair(name, seed=1)
    h = _rand((2, 10, 12, 2), 4, scale=0.5)
    want = np.asarray(j_pi_cell_step(jp, jnp.asarray(h), jcfg))
    got = pi_cell_step(tp, torch.from_numpy(h), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["k5", "k3"])
def test_pack_pi_matrix_matches_jax_layout(name):
    jcfg, jp, cfg, tp = _pair(name, seed=2)
    want = np.asarray(jcell2d.pack_pi_matrix_2d(jp, jcfg))
    got = cell2d.pack_pi_matrix_2d(tp, cfg).numpy()
    assert got.shape == want.shape == (cell2d.mxu_rows(cfg),
                                       -(-cell2d.n_taps(cfg) // 8) * 8)
    assert cell2d.n_taps(cfg) == jcell2d.n_taps(jcfg)
    np.testing.assert_array_equal(got, want)
    tail = cell2d.pi_tail_2d(tp, cfg)
    C = cfg.hidden
    for o in range(2):
        np.testing.assert_array_equal(tail[2 + o * C: 2 + (o + 1) * C].numpy(),
                                      tp["pi"][o]["w_out"].numpy().reshape(-1))
        assert float(tail[2 + 2 * C + o]) == float(tp["pi"][o]["b_out"][0])


@pytest.mark.parametrize("name,shape,steps", [("k5", (8, 10), 3), ("k3", (9, 7), 4)])
def test_fused_rollout_kxk_matches_pallas(name, shape, steps):
    jcfg, jp, cfg, tp = _pair(name, seed=3)
    h0 = _rand(shape + (2,), 5, scale=0.5)
    want = np.asarray(jcell2d.fused_rollout_2d(jp, jnp.asarray(h0), jcfg, steps,
                                               interpret=True))
    got = cell2d.fused_rollout_2d(tp, torch.from_numpy(h0), cfg, steps).numpy()
    assert got.shape == want.shape == (steps + 1,) + shape + (2,)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["k5", "k3"])
def test_plain_kxk_agrees_with_cell_step(name):
    """The plain version, from the matrix and the tail, equals the port's own
    rollout of pi_cell_step (conv_nd_periodic branches)."""
    _, _, cfg, tp = _pair(name, seed=4)
    h0 = torch.from_numpy(_rand((11, 6, 2), 6, scale=0.5))
    frames = cell2d.fused_rollout_kxk_2d(tp, h0, cfg, 5)
    want = rollout(lambda h: pi_cell_step(tp, h, cfg), h0, 5)
    np.testing.assert_allclose(frames.numpy(), want.numpy(), rtol=2e-4, atol=1e-5)
    assert cell2d.fused_rollout_2d(tp, h0, cfg, 0).equal(h0[None])


def _golden():
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    model = {"cell": unflatten_dotted(golden, "cell."), "isg": unflatten_dotted(golden, "isg.")}
    return golden, params_from_numpy(model, device="cpu", dtype=torch.float32)


def test_golden_burgers_isg_and_frames():
    """tests/golden/pt_burgers_s1.npz (the reference's trained Burgers
    Stage-1 model): the ISG at atol 2e-6, and the 8 frames at 2e-5 * t
    through the eager cell step, the fused rollout (its plain version here)
    and the frames-serving entry point."""
    golden, model = _golden()
    cfg = PiCellConfig(**CFGS["burgers"])
    isg_cfg = ISGConfig(ndim=2, hidden=16, strides=(2,), activation="tanh")
    with torch.no_grad():
        out = isg_apply(model["isg"], torch.from_numpy(golden["isg_in"]), isg_cfg)
    np.testing.assert_allclose(out.numpy(), golden["isg_out"], rtol=1e-5, atol=2e-6)
    frames = golden["frames"]
    n = frames.shape[0] - 1
    h0 = torch.from_numpy(frames[0])
    eager = rollout(lambda h: pi_cell_step(model["cell"], h, cfg), h0, n, remat=False)
    fused = cell2d.fused_rollout_2d(model["cell"], h0, cfg, n)
    served = build_serving_fn(model["cell"], cfg, n, device="cpu")(frames[0])
    for got in (eager, fused, served):
        err = np.abs(got.detach().numpy() - frames).reshape(n + 1, -1).max(axis=1)
        assert (err[1:] < 2e-5 * np.arange(1, n + 1)).all(), err


def test_cpu_path_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(cell2d.fused_rollout_kxk_2d, "launches", 0)
    monkeypatch.setattr(cell2d.fused_rollout_2d, "launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    _, _, cfg, tp = _pair("k5")
    cell2d.fused_rollout_2d(tp, torch.from_numpy(_rand((8, 8, 2), 7)), cfg, 3)
    assert cell2d.fused_rollout_kxk_2d.launches == 0
    assert cell2d.fused_rollout_2d.launches == 0


def test_non_cpu_tensor_never_reaches_plain(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel: when the kernel
    cannot be loaded, the error propagates; nothing falls back."""
    def fail_plain(*args, **kwargs):
        raise AssertionError("the plain version was reached")

    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    monkeypatch.setattr(cell2d, "fused_rollout_kxk_2d_plain", fail_plain)
    monkeypatch.setattr(_build, "load_library", fail_load)
    monkeypatch.setattr(cell2d, "_check_kxk_inputs", lambda *args: None)
    _, _, cfg, tp = _pair("k5")
    meta = params_from_numpy(tp, device="meta")
    with pytest.raises(RuntimeError, match="loader disabled"):
        cell2d.fused_rollout_2d(meta, torch.empty((8, 8, 2), device="meta"), cfg, 3)


def test_kernel_inputs_are_checked():
    _, _, cfg, tp = _pair("k5")
    wmat = cell2d.pack_pi_matrix_2d(tp, cfg)
    tail = cell2d.pi_tail_2d(tp, cfg)
    h0 = torch.zeros(8, 8, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cell2d._rollout_kxk_cuda(wmat, tail, h0, cfg, 3)
    big = PiCellConfig(**{**CFGS["k5"], "hidden": 200})
    assert cell2d._kxk_smem_bytes(big) > cell2d._MAX_SMEM


@pytest.mark.parametrize("kernel_size", [2, 7])
def test_kernel_size_outside_the_kernels_raises(kernel_size):
    cfg = PiCellConfig(**{**CFGS["k5"], "kernel_size": kernel_size})
    with pytest.raises(NotImplementedError, match="odd kernel_size <= 5"):
        cell2d.fused_rollout_2d({}, torch.zeros(8, 8, 2), cfg, 1)


def test_final_state_of_kxk_cell_matches_pallas():
    """The final state of a 5x5 cell (on the card the final-state mode of
    rollout2d_kxk_persistent_kernel, or final2d_kernel's k > 1 contract)
    against percnn_tpu's fused_rollout_final_2d in interpret mode, and
    final-state serving against the last served frame."""
    jcfg, jp, cfg, tp = _pair("k5")
    h0 = _rand((8, 10, 2), 21, scale=0.3)
    want = np.asarray(jcell2d.fused_rollout_final_2d(jp, jnp.asarray(h0), jcfg, 3,
                                                     interpret=True))
    got = cell2d.fused_rollout_final_2d(tp, torch.from_numpy(h0), cfg, 3)
    assert got.shape == (8, 10, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)
    final = build_serving_fn(tp, cfg, 3, final_only=True, device="cpu")(h0)
    frames = build_serving_fn(tp, cfg, 3, device="cpu")(h0)
    np.testing.assert_allclose(final.numpy(), frames[-1].numpy(), rtol=2e-4, atol=1e-5)
