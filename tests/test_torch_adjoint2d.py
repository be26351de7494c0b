"""The streaming k x k adjoints of percnn_tpu_torch on the CPU, against the
JAX package: the plain sweeps of adj2d_kernel at k = 5 (row 4) and of
adj2d_ys_kernel (row 5) against percnn_tpu's ``_phase1_kernel`` and
``_phase1_ys_kernel`` in interpret mode, ``_precompute_ys`` against its JAX
counterpart, ``fused_rollout_tp_2d`` on each route of the MXU switches
against percnn_tpu's ``fused_rollout_tp_2d`` under the same switches, and
the dispatch rule (a CUDA tensor never reaches a plain version).

The kernels themselves run only on the card: ``python3 chip_smoke.py``
holds them against these plain versions there.  Bars: the JAX package's own
(tests/test_pallas.py), rtol 2e-4 / atol 2e-6 for gradients and adjoints.
Every JAX kernel call here has one shape (8 x 10, T = 3, the cell below),
so interpret mode compiles each kernel once in this file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.core.cell import pi_cell_step as j_pi_cell_step
from percnn_tpu.core.rollout import rollout as j_rollout
from percnn_tpu.ops.pallas import backward2d as jbackward2d
from percnn_tpu.ops.pallas import cell2d as jcell2d

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.ops.kernels import _build, backward2d, cell2d

RTOL, ATOL = 2e-4, 2e-6
H, W, T = 8, 10, 3
KW = dict(ndim=2, hidden=3, kernel_size=5, dt=0.05, dx=0.2, diffusion="sigmoid",
          mu_up=0.2, init_scale=0.3)


def _pair(seed):
    jcfg = JPiCellConfig(**KW)
    jp = j_init_pi_cell(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, PiCellConfig(**KW), jax.tree_util.tree_map(np.asarray, jp)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def _jax_inputs(frames, fbar):
    """percnn_tpu's sweep inputs: the step inputs h_0..h_{T-1} and the
    cotangents of frames 1..T, padded to its [T, 2, Hp, Wp] layout."""
    frames_pad = jnp.stack([jcell2d.pad_state_2d(jnp.asarray(f)) for f in frames[:-1]])
    hp, wp = frames_pad.shape[2], frames_pad.shape[3]
    fbar_pad = jnp.zeros((T, 2, hp, wp), jnp.float32).at[:, :, 2:2 + H, 2:2 + W].set(
        jnp.moveaxis(jnp.asarray(fbar[1:]), -1, 1))
    return frames_pad, fbar_pad


def _unpad(gins_j, g0_j):
    return (np.asarray(jcell2d.unpad_frames_2d(gins_j, H, W)),
            np.moveaxis(np.asarray(g0_j)[:, 2:2 + H, 2:2 + W], 0, -1))


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max())


def test_adjoint_sweep_matches_pallas_phase1():
    """Row 4 at k = 5: g_ins and g0 of the plain sweep, its activations
    recomputed from the frames, against _fused_phase1 (interpret mode)."""
    jcfg, jp, cfg, npp = _pair(1)
    frames = _rand((T + 1, H, W, 2), 2, scale=0.3, shift=0.5)
    fbar = _rand((T + 1, H, W, 2), 3)
    gins_j, g0_j = _unpad(*jbackward2d._fused_phase1(
        jcell2d.pack_pi_params_2d(jp, jcfg), *_jax_inputs(frames, fbar), cfg=jcfg,
        n_steps=T, H=H, W=W, interpret=True))
    packed = cell2d.pack_pi_params_2d(params_from_numpy(npp, device="cpu"), cfg)
    g_ins, g0 = backward2d.fused_phase1_2d(packed, torch.from_numpy(frames),
                                           torch.from_numpy(fbar), cfg)
    assert g_ins.shape == (T, H, W, 2) and g0.shape == (H, W, 2)
    _assert_close(g_ins.numpy(), gins_j)
    _assert_close(g0.numpy(), g0_j)


def test_precompute_ys_matches_jax():
    jcfg, jp, cfg, npp = _pair(4)
    h_prev = _rand((T, H, W, 2), 5, scale=0.3, shift=0.5)
    want = np.asarray(jbackward2d._precompute_ys(jp, jnp.asarray(h_prev), jcfg)[1])
    got = backward2d._precompute_ys(params_from_numpy(npp, device="cpu"),
                                    torch.from_numpy(h_prev), cfg)
    assert got.shape == want.shape == (T, cell2d.mxu_rows(cfg), H, W) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


def test_ys_sweep_matches_pallas_phase1_ys():
    """Row 5: the plain sweep reading the activations, against
    _fused_phase1_ys (interpret mode) on the same ys."""
    jcfg, jp, cfg, npp = _pair(6)
    frames = _rand((T + 1, H, W, 2), 7, scale=0.3, shift=0.5)
    fbar = _rand((T + 1, H, W, 2), 8)
    ys = np.array(jbackward2d._precompute_ys(jp, jnp.asarray(frames[:-1]), jcfg)[1])
    gins_j, g0_j = _unpad(*jbackward2d._fused_phase1_ys(
        jcell2d.pack_pi_params_2d(jp, jcfg), *_jax_inputs(frames, fbar), jnp.asarray(ys),
        cfg=jcfg, n_steps=T, H=H, W=W, interpret=True))
    packed = cell2d.pack_pi_params_2d(params_from_numpy(npp, device="cpu"), cfg)
    g_ins, g0 = backward2d.fused_phase1_ys_2d(packed, torch.from_numpy(fbar),
                                              torch.from_numpy(ys), cfg)
    _assert_close(g_ins.numpy(), gins_j)
    _assert_close(g0.numpy(), g0_j)
    # the two plain sweeps are one computation: the activations only move
    g_ins4, g04 = backward2d.fused_phase1_2d_plain(packed, torch.from_numpy(frames),
                                                   torch.from_numpy(fbar), cfg)
    np.testing.assert_allclose(g_ins.numpy(), g_ins4.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g0.numpy(), g04.numpy(), rtol=1e-5, atol=1e-6)


# (cell2d.MXU_FWD_ENABLED, backward2d.MXU_BWD_ENABLED, backward2d.YS_PATH_ENABLED)
# -> the port's backward route; percnn_tpu takes the same under the same switches
# (the 'mxu' route under the default switches is test_torch_backward_kxk.py's)
ROUTES = {
    "mxu_off": ((False, False, True), "ys"),
    "ys_off": ((False, False, False), "adjoint"),
    "vpu_fwd_mxu_bwd_off": ((False, True, False), "adjoint"),
    "mxu_fwd_ys": ((True, False, True), "ys"),
}


def _switch(monkeypatch, flags):
    fwd, bwd, ys = flags
    for mod, name, value in ((cell2d, "MXU_FWD_ENABLED", fwd), (jcell2d, "MXU_FWD_ENABLED", fwd),
                             (backward2d, "MXU_BWD_ENABLED", bwd),
                             (jbackward2d, "MXU_BWD_ENABLED", bwd),
                             (backward2d, "YS_PATH_ENABLED", ys),
                             (jbackward2d, "YS_PATH_ENABLED", ys)):
        monkeypatch.setattr(mod, name, value)


@pytest.mark.parametrize("route", list(ROUTES))
def test_fused_gradients_match_jax_on_each_route(monkeypatch, route):
    """The frames and the gradients (every cell leaf and h0) of the port's
    fused_rollout_tp_2d against percnn_tpu's under the same switches, and
    against jax.grad through the jnp rollout."""
    flags, want_route = ROUTES[route]
    _switch(monkeypatch, flags)
    jcfg, jp, cfg, npp = _pair(9)
    assert backward2d.backward_route(cfg, T, H, W) == want_route
    h0 = _rand((H, W, 2), 10, scale=0.3)
    tgt = _rand((T + 1, H, W, 2), 11)

    def loss(fr, t):
        return ((fr - t) ** 2).sum() + (fr[1] * fr[2]).sum()

    tp = params_from_numpy(npp, device="cpu")
    leaves = backward2d._cell_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    th0 = torch.from_numpy(h0).requires_grad_(True)
    frames = backward2d.fused_rollout_tp_2d(tp, th0, cfg, T, pgrad_chunk=2)
    grads = torch.autograd.grad(loss(frames, torch.from_numpy(tgt)), leaves + [th0])
    np.testing.assert_allclose(
        frames.detach().numpy(),
        np.asarray(jbackward2d.fused_rollout_tp_2d(jp, jnp.asarray(h0), jcfg, T)),
        rtol=2e-4, atol=1e-5)
    for roll in (lambda p, h: jbackward2d.fused_rollout_tp_2d(p, h, jcfg, T, 2),
                 lambda p, h: j_rollout(lambda x: j_pi_cell_step(p, x, jcfg), h, T, remat=False)):
        jg_p, jg_h = jax.grad(lambda p, h: loss(roll(p, h), jnp.asarray(tgt)),
                              argnums=(0, 1))(jp, jnp.asarray(h0))
        want = [np.asarray(jg_p["diff"])] + [np.asarray(jg_p["pi"][o][k]) for o in range(2)
                                             for k in sorted(jg_p["pi"][o])] + [np.asarray(jg_h)]
        for got, w in zip(grads, want):
            assert got.shape == w.shape
            np.testing.assert_allclose(got.numpy(), w, rtol=RTOL, atol=ATOL)


def test_ys_budget_picks_the_adjoint_route(monkeypatch):
    """Over the 8 GiB of activations the backward takes adj2d_kernel, as
    percnn_tpu's _ys_path_ok decides."""
    cfg = PiCellConfig(**KW)
    jcfg = JPiCellConfig(**KW)
    for n_steps, H_, W_ in ((200, 100, 100), (20000, 128, 128), (4000, 512, 512)):
        assert backward2d._ys_path_ok(cfg, n_steps, H_, W_) == \
            jbackward2d._ys_path_ok(jcfg, n_steps, H_, W_)
    assert backward2d.backward_route(cfg, 200, 100, 100) == "mxu"
    assert backward2d.backward_route(cfg, 4000, 512, 512) == "adjoint"
    monkeypatch.setattr(backward2d, "MXU_BWD_ENABLED", False)
    assert backward2d.backward_route(cfg, 200, 100, 100) == "ys"
    assert backward2d.backward_route(PiCellConfig(**{**KW, "kernel_size": 1}), 5, 8, 8) == \
        "adjoint"


def test_cpu_path_launches_no_kernel(monkeypatch):
    for fn in (backward2d.fused_phase1_2d, backward2d.fused_phase1_ys_2d,
               backward2d.fused_rollout_tp_2d):
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(cell2d.fused_rollout_2d, "launches_kxk", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    _switch(monkeypatch, (False, False, True))
    _, _, cfg, npp = _pair(12)
    tp = params_from_numpy(npp, device="cpu")
    for t in backward2d._cell_leaves(tp):
        t.requires_grad_(True)
    h0 = torch.from_numpy(_rand((H, W, 2), 13, scale=0.3))
    backward2d.fused_rollout_tp_2d(tp, h0, cfg, T).square().sum().backward()
    monkeypatch.setattr(backward2d, "YS_PATH_ENABLED", False)
    backward2d.fused_rollout_tp_2d(tp, h0, cfg, T).square().sum().backward()
    assert tp["pi"][1]["w2"].grad is not None
    assert (backward2d.fused_phase1_2d.launches, backward2d.fused_phase1_ys_2d.launches,
            backward2d.fused_rollout_tp_2d.launches, cell2d.fused_rollout_2d.launches_kxk) == \
        (0, 0, 0, 0)


def test_non_cpu_tensor_never_reaches_plain(monkeypatch):
    """A tensor that is not on the CPU goes to the kernels: when they cannot
    be loaded, the error propagates; nothing falls back."""
    def fail_plain(*args, **kwargs):
        raise AssertionError("a plain version was reached")

    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    for name in ("fused_phase1_2d_plain", "fused_phase1_ys_2d_plain", "fused_rollout_2d_plain"):
        monkeypatch.setattr(backward2d, name, fail_plain)
    monkeypatch.setattr(cell2d, "fused_rollout_2d_plain", fail_plain)
    monkeypatch.setattr(cell2d, "fused_rollout_final_2d_plain", fail_plain)
    monkeypatch.setattr(_build, "load_library", fail_load)
    _switch(monkeypatch, (False, False, True))
    _, _, cfg, npp = _pair(0)
    meta = params_from_numpy(npp, device="meta", dtype=torch.float32)
    packed = cell2d.pack_pi_params_2d(meta, cfg)
    frames = torch.empty((T + 1, H, W, 2), device="meta")
    ys = torch.empty((T, cell2d.mxu_rows(cfg), H, W), device="meta")
    for call in (lambda: backward2d.fused_phase1_2d(packed, frames, frames, cfg),
                 lambda: backward2d.fused_phase1_ys_2d(packed, frames, ys, cfg),
                 lambda: backward2d.fused_rollout_tp_2d(meta, frames[0], cfg, T),
                 lambda: cell2d.fused_rollout_2d(meta, frames[0], cfg, T),
                 lambda: cell2d.fused_rollout_final_2d(meta, frames[0], cfg, T)):
        with pytest.raises((RuntimeError, ValueError), match="loader disabled|CUDA tensors"):
            call()


def test_kernel_inputs_are_checked():
    _, _, cfg, npp = _pair(0)
    packed = cell2d.pack_pi_params_2d(params_from_numpy(npp, device="cpu"), cfg)
    frames = torch.zeros((T + 1, H, W, 2))
    ys = torch.zeros((T, cell2d.mxu_rows(cfg), H, W))
    with pytest.raises(ValueError, match="CUDA tensors"):
        backward2d._phase1_cuda(packed, frames, frames, cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        backward2d._phase1_ys_cuda(packed, frames, ys, cfg)
