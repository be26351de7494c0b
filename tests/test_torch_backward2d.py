"""percnn_tpu_torch.ops.kernels.backward2d on the CPU: the plain reverse sweep
against percnn_tpu's Pallas pg kernel in interpret mode, the differentiable
rollout's gradients against jax.grad and against torch autograd, and the
dispatch rule (a CUDA tensor never reaches the plain version).

pg2d_kernel itself runs only on the card: ``python3 chip_smoke.py`` holds it
against the plain version there.  Gradient bars are the JAX package's own
(tests/test_pallas.py): rtol 2e-4, atol 2e-6.
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
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step
from percnn_tpu_torch.core.rollout import rollout
from percnn_tpu_torch.ops.kernels import _build, backward2d, cell2d

RTOL, ATOL = 2e-4, 2e-6

CFGS = {
    "gs2d": dict(ndim=2, hidden=8, kernel_size=1, dt=0.5, dx=0.01,
                 diffusion="sigmoid", mu_up=3.99e-5, init_scale=0.02),
    "sigmoid": dict(ndim=2, hidden=4, kernel_size=1, dt=0.05, dx=0.2,
                    diffusion="sigmoid", mu_up=0.1, init_scale=0.3),
    "raw": dict(ndim=2, hidden=4, kernel_size=1, dt=0.05, dx=0.2,
                diffusion="raw", mu_up=0.1, diff_init=0.05, init_scale=0.3),
    "h3": dict(ndim=2, hidden=3, kernel_size=1, dt=0.05, dx=0.2,
               diffusion="sigmoid", mu_up=0.1, init_scale=0.3),
}


def _pair(name, seed):
    jcfg = JPiCellConfig(**CFGS[name])
    jp = j_init_pi_cell(jax.random.PRNGKey(seed), jcfg)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, PiCellConfig(**CFGS[name]), npp


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def _leaves(p):
    return [p["diff"]] + [p["pi"][o][k] for o in range(2) for k in sorted(p["pi"][o])]


def _trainable(npp):
    tp = params_from_numpy(npp, device="cpu", dtype=torch.float32)
    for t in _leaves(tp):
        t.requires_grad_(True)
    return tp


def _jleaves(g):
    return [np.asarray(g["diff"])] + [np.asarray(g["pi"][o][k]) for o in range(2)
                                      for k in sorted(g["pi"][o])]


def test_pg_layout_matches_jax():
    for name in CFGS:
        jcfg = JPiCellConfig(**CFGS[name])
        assert backward2d._pg_layout(PiCellConfig(**CFGS[name])) == jbackward2d._pg_layout(jcfg)
    assert backward2d._pg_layout(PiCellConfig(**CFGS["gs2d"]))["A"] == 164


@pytest.mark.parametrize("name,shape,steps", [("gs2d", (16, 12), 6), ("sigmoid", (10, 12), 5)])
def test_plain_sweep_matches_pallas_pg(name, shape, steps):
    """g0 and the [A, H, W] accumulators of the plain sweep against
    _fused_phase1_pg (interpret mode) on the same frames and cotangents."""
    jcfg, jp, cfg, npp = _pair(name, seed=3)
    H, W = shape
    frames = _rand((steps + 1, H, W, 2), 4, scale=0.3) + 0.5
    fbar = _rand((steps + 1, H, W, 2), 5)
    packed_j = jcell2d.pack_pi_params_2d(jp, jcfg)
    frames_prev_pad = jnp.stack([jcell2d.pad_state_2d(jnp.asarray(f)) for f in frames[:-1]])
    hp, wp = frames_prev_pad.shape[2], frames_prev_pad.shape[3]
    fbar_pad = jnp.zeros((steps, 2, hp, wp), jnp.float32).at[
        :, :, 2:2 + H, 2:2 + W].set(jnp.moveaxis(jnp.asarray(fbar[1:]), -1, 1))
    g0_pad, acc_j = jbackward2d._fused_phase1_pg(
        packed_j, frames_prev_pad, fbar_pad, cfg=jcfg, n_steps=steps, H=H, W=W,
        interpret=True)
    g0_j = np.moveaxis(np.asarray(g0_pad)[:, 2:2 + H, 2:2 + W], 0, -1)

    packed = cell2d.pack_pi_params_2d(params_from_numpy(npp, device="cpu"), cfg)
    g0, acc = backward2d.fused_phase1_pg_2d_plain(
        packed, torch.from_numpy(frames), torch.from_numpy(fbar), cfg)
    assert g0.shape == (H, W, 2) and acc.shape == (164 if name == "gs2d" else 84, H, W)
    np.testing.assert_allclose(g0.numpy(), g0_j, rtol=RTOL, atol=ATOL)
    scale = np.abs(np.asarray(acc_j)).max()
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), rtol=RTOL, atol=ATOL * scale)


def _loss_last(fr, tgt):
    return ((fr - tgt) ** 2).mean()


def _loss_frames(fr, tgt):
    return (fr[::2] ** 2).mean() + (fr[1] * fr[3]).sum()


# the cases of tests/test_pallas.py: both diffusion modes with an MSE on every
# frame, and cotangents that reach intermediate frames only
CASES = {
    "sigmoid": ("sigmoid", (10, 12), 6, _loss_last, 3),
    "raw": ("raw", (10, 12), 6, _loss_last, 3),
    "intermediate": ("h3", (8, 8), 5, _loss_frames, 6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_pg_gradients_match_jax(case):
    name, shape, steps, loss, seed = CASES[case]
    jcfg, jp, cfg, npp = _pair(name, seed)
    h0 = _rand(shape + (2,), seed + 1, scale=0.3)
    tgt = _rand((steps + 1,) + shape + (2,), seed + 2)

    def j_loss(p, h):
        return loss(jbackward2d.fused_rollout_tp_2d_pg(p, h, jcfg, steps), jnp.asarray(tgt))

    jl = float(j_loss(jp, jnp.asarray(h0)))
    jg_p, jg_h = jax.grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(h0))

    tp = _trainable(npp)
    th0 = torch.from_numpy(h0).requires_grad_(True)
    tl = loss(backward2d.fused_rollout_tp_2d_pg(tp, th0, cfg, steps), torch.from_numpy(tgt))
    grads = torch.autograd.grad(tl, _leaves(tp) + [th0])
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-5)
    for got, want in zip(grads, _jleaves(jg_p) + [np.asarray(jg_h)]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("case", ["sigmoid", "intermediate"])
def test_fused_pg_gradients_match_autograd_rollout(case, remat):
    """The Function's gradients equal torch autograd through the port's own
    rollout of pi_cell_step, with checkpointed segments and without."""
    name, shape, steps, loss, seed = CASES[case]
    _, _, cfg, npp = _pair(name, seed)
    h0 = _rand(shape + (2,), seed + 1, scale=0.3)
    tgt = torch.from_numpy(_rand((steps + 1,) + shape + (2,), seed + 2))
    tp = _trainable(npp)
    th0 = torch.from_numpy(h0).requires_grad_(True)
    g1 = torch.autograd.grad(loss(backward2d.fused_rollout_tp_2d_pg(tp, th0, cfg, steps), tgt),
                             _leaves(tp) + [th0])
    ref = rollout(lambda h: pi_cell_step(tp, h, cfg), th0, steps, remat=remat)
    g2 = torch.autograd.grad(loss(ref, tgt), _leaves(tp) + [th0])
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_jax_rollout_and_fused_pg_agree_on_frames():
    jcfg, jp, cfg, npp = _pair("gs2d", seed=7)
    h0 = _rand((12, 12, 2), 8, scale=0.3) + 0.5
    want = np.asarray(j_rollout(lambda h: j_pi_cell_step(jp, h, jcfg), jnp.asarray(h0), 5,
                                remat=False))
    got = backward2d.fused_rollout_tp_2d_pg(params_from_numpy(npp, device="cpu"),
                                            torch.from_numpy(h0), cfg, 5)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4, atol=1e-5)


def test_double_backward_raises():
    _, _, cfg, npp = _pair("sigmoid", seed=1)
    tp = _trainable(npp)
    h0 = torch.from_numpy(_rand((6, 6, 2), 2, scale=0.3))
    (g,) = torch.autograd.grad(backward2d.fused_rollout_tp_2d_pg(tp, h0, cfg, 3).square().sum(),
                               [tp["diff"]], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        g.sum().backward()


def test_cpu_path_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(backward2d.fused_rollout_tp_2d_pg, "launches", 0)
    monkeypatch.setattr(cell2d.fused_rollout_2d, "launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    _, _, cfg, npp = _pair("sigmoid", seed=2)
    tp = _trainable(npp)
    h0 = torch.from_numpy(_rand((8, 8, 2), 3, scale=0.3))
    backward2d.fused_rollout_tp_2d_pg(tp, h0, cfg, 4).square().sum().backward()
    assert tp["diff"].grad is not None
    assert backward2d.fused_rollout_tp_2d_pg.launches == 0
    assert cell2d.fused_rollout_2d.launches == 0


def test_non_cpu_tensor_never_reaches_plain(monkeypatch):
    """A tensor that is not on the CPU goes to the kernels: when they cannot
    be loaded, the error propagates; nothing falls back."""
    def fail_plain(*args, **kwargs):
        raise AssertionError("a plain version was reached")

    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    monkeypatch.setattr(backward2d, "fused_phase1_pg_2d_plain", fail_plain)
    monkeypatch.setattr(backward2d, "fused_rollout_2d_plain", fail_plain)
    monkeypatch.setattr(_build, "load_library", fail_load)
    _, _, cfg, npp = _pair("gs2d", seed=0)
    meta = params_from_numpy(npp, device="meta", dtype=torch.float32)
    packed = cell2d.pack_pi_params_2d(meta, cfg)
    frames = torch.empty((4, 8, 8, 2), device="meta")
    with pytest.raises(RuntimeError, match="loader disabled"):
        backward2d.fused_phase1_pg_2d(packed, frames, torch.empty_like(frames), cfg)
    with pytest.raises(RuntimeError, match="loader disabled"):
        backward2d.fused_rollout_tp_2d_pg(meta, torch.empty((8, 8, 2), device="meta"), cfg, 3)


def test_kernel_inputs_are_checked():
    _, _, cfg, npp = _pair("gs2d", seed=0)
    packed = cell2d.pack_pi_params_2d(params_from_numpy(npp, device="cpu"), cfg)
    frames = torch.zeros((4, 8, 8, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        backward2d._check_pg_inputs(packed, frames, frames, cfg)


def test_k5_cell_is_not_ported():
    cfg = PiCellConfig(ndim=2, hidden=4, kernel_size=5)
    with pytest.raises(NotImplementedError, match="kernel_size=5"):
        backward2d.fused_rollout_tp_2d_pg({}, torch.zeros(8, 8, 2), cfg, 1)
