"""percnn_tpu_torch.ops.kernels.backward3d on the CPU: the plain reverse sweep
against percnn_tpu's Pallas pg kernel in interpret mode, the differentiable
rollout's gradients against jax.grad and against torch autograd, and the
dispatch rule (a CUDA tensor never reaches the plain version).

pg3d_kernel itself runs only on the card: ``python3 chip_smoke.py`` holds it
against the plain version there.  Gradient bars are the JAX package's own
(tests/test_pallas.py): rtol 2e-4, atol 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.ops.pallas import backward3d as jbackward3d
from percnn_tpu.ops.pallas import cell3d as jcell3d

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step
from percnn_tpu_torch.core.rollout import rollout
from percnn_tpu_torch.ops.kernels import _build, backward2d, backward3d, cell3d

RTOL, ATOL = 2e-4, 2e-6

# the setup of tests/test_pallas.py's 3D pg test, and the GS3D cell
CFGS = {
    "pallas": dict(ndim=3, hidden=2, kernel_size=1, dt=0.05, dx=2.08,
                   diffusion="sigmoid", mu_up=0.3, init_scale=0.3),
    "gs3d": dict(ndim=3, hidden=2, kernel_size=1, dt=0.5, dx=100 / 48,
                 diffusion="sigmoid", mu_up=0.274, init_scale=0.01),
    "raw": dict(ndim=3, hidden=3, kernel_size=1, dt=0.05, dx=2.08,
                diffusion="raw", diff_init=0.2, init_scale=0.3),
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


def test_pg_layout_is_shared_with_jax():
    jcfg = JPiCellConfig(**CFGS["gs3d"])
    cfg = PiCellConfig(**CFGS["gs3d"])
    assert backward2d._pg_layout(cfg) == jbackward3d._pg_layout(jcfg)
    assert backward2d._pg_layout(cfg)["A"] == 44


@pytest.mark.parametrize("name,seed", [("pallas", 11), ("gs3d", 3)])
def test_plain_sweep_matches_pallas_pg(name, seed):
    """g0 and the [A, D, H, W] accumulators of the plain sweep against
    _fused_phase1_pg_3d (interpret mode, flat [D, H*W] layout) on the same
    frames and cotangents, 8 x 8 x 16, T = 4."""
    jcfg, jp, cfg, npp = _pair(name, seed)
    D, H, W, steps = 8, 8, 16, 4
    frames = _rand((steps + 1, D, H, W, 2), seed + 1, scale=0.3) + 0.5
    fbar = _rand((steps + 1, D, H, W, 2), seed + 2)

    def flat(a):
        return jnp.moveaxis(jnp.asarray(a), -1, 1).reshape(a.shape[0], 2, D, H * W)

    g0_j, acc_j = jbackward3d._fused_phase1_pg_3d(
        jcell3d.pack_pi_params_3d(jp, jcfg), flat(frames[:-1]), flat(fbar[1:]), cfg=jcfg,
        n_steps=steps, D=D, H=H, W=W, interpret=True)
    g0_j = np.moveaxis(np.asarray(g0_j).reshape(2, D, H, W), 0, -1)
    acc_j = np.asarray(acc_j).reshape(-1, D, H, W)

    packed = cell3d.pack_pi_params_3d(params_from_numpy(npp, device="cpu"), cfg)
    g0, acc = backward3d.fused_phase1_pg_3d_plain(
        packed, torch.from_numpy(frames), torch.from_numpy(fbar), cfg)
    assert g0.shape == (D, H, W, 2) and acc.shape == acc_j.shape == (44, D, H, W)
    np.testing.assert_allclose(g0.numpy(), g0_j, rtol=RTOL, atol=ATOL * np.abs(g0_j).max())
    scale = np.abs(acc_j).max()
    np.testing.assert_allclose(acc.numpy(), acc_j, rtol=RTOL, atol=ATOL * scale)


def _loss_all(fr, tgt):
    return ((fr - tgt) ** 2).mean()


def _loss_frames(fr, tgt):
    return (fr[::2] ** 2).mean() + (fr[1] * fr[3]).sum()


# the case of tests/test_pallas.py (MSE on every frame), cotangents that reach
# intermediate frames only, and raw diffusion with hidden 3
CASES = {
    "pallas": ("pallas", (8, 8, 16), 4, _loss_all, 11),
    "intermediate": ("gs3d", (8, 8, 16), 5, _loss_frames, 6),
    "raw": ("raw", (5, 6, 7), 4, _loss_all, 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_pg_gradients_match_jax(case):
    """Loss and gradients (every cell leaf and dh0) of the port's Function
    against jax.grad through percnn_tpu's fused_rollout_tp_3d_pg; the raw
    case's 5 x 6 x 7 grid is one the TPU kernel refuses, so JAX's side is
    its jnp rollout there."""
    name, shape, steps, loss, seed = CASES[case]
    jcfg, jp, cfg, npp = _pair(name, seed)
    h0 = _rand(shape + (2,), seed + 1, scale=0.3)
    tgt = _rand((steps + 1,) + shape + (2,), seed + 2)

    if case == "raw":
        from percnn_tpu.core.cell import pi_cell_step as j_step
        from percnn_tpu.core.rollout import rollout as j_rollout

        def j_frames(p, h):
            return j_rollout(lambda x: j_step(p, x, jcfg), h, steps, remat=False)
    else:
        def j_frames(p, h):
            return jbackward3d.fused_rollout_tp_3d_pg(p, h, jcfg, steps)

    def j_loss(p, h):
        return loss(j_frames(p, h), jnp.asarray(tgt))

    jl = float(j_loss(jp, jnp.asarray(h0)))
    jg_p, jg_h = jax.grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(h0))

    tp = _trainable(npp)
    th0 = torch.from_numpy(h0).requires_grad_(True)
    tl = loss(backward3d.fused_rollout_tp_3d_pg(tp, th0, cfg, steps), torch.from_numpy(tgt))
    grads = torch.autograd.grad(tl, _leaves(tp) + [th0])
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-5)
    for got, want in zip(grads, _jleaves(jg_p) + [np.asarray(jg_h)]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("remat", [True, False])
def test_fused_pg_gradients_match_autograd_rollout(remat):
    """The Function's gradients equal torch autograd through the port's own
    rollout of pi_cell_step, with checkpointed segments and without."""
    name, shape, steps, loss, seed = CASES["intermediate"]
    _, _, cfg, npp = _pair(name, seed)
    h0 = _rand(shape + (2,), seed + 1, scale=0.3)
    tgt = torch.from_numpy(_rand((steps + 1,) + shape + (2,), seed + 2))
    tp = _trainable(npp)
    th0 = torch.from_numpy(h0).requires_grad_(True)
    g1 = torch.autograd.grad(loss(backward3d.fused_rollout_tp_3d_pg(tp, th0, cfg, steps), tgt),
                             _leaves(tp) + [th0])
    ref = rollout(lambda h: pi_cell_step(tp, h, cfg), th0, steps, remat=remat)
    g2 = torch.autograd.grad(loss(ref, tgt), _leaves(tp) + [th0])
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_double_backward_raises():
    _, _, cfg, npp = _pair("pallas", seed=1)
    tp = _trainable(npp)
    h0 = torch.from_numpy(_rand((5, 5, 6, 2), 2, scale=0.3))
    (g,) = torch.autograd.grad(backward3d.fused_rollout_tp_3d_pg(tp, h0, cfg, 3).square().sum(),
                               [tp["diff"]], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        g.sum().backward()


def test_cpu_path_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(backward3d.fused_rollout_tp_3d_pg, "launches", 0)
    monkeypatch.setattr(cell3d.fused_rollout_3d, "launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    _, _, cfg, npp = _pair("pallas", seed=2)
    tp = _trainable(npp)
    h0 = torch.from_numpy(_rand((6, 6, 6, 2), 3, scale=0.3))
    backward3d.fused_rollout_tp_3d_pg(tp, h0, cfg, 4).square().sum().backward()
    assert tp["diff"].grad is not None
    assert backward3d.fused_rollout_tp_3d_pg.launches == 0
    assert cell3d.fused_rollout_3d.launches == 0


def test_non_cpu_tensor_never_reaches_plain(monkeypatch):
    """A tensor that is not on the CPU goes to the kernels: when they cannot
    be loaded, the error propagates; nothing falls back."""
    def fail_plain(*args, **kwargs):
        raise AssertionError("a plain version was reached")

    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    monkeypatch.setattr(backward3d, "fused_phase1_pg_3d_plain", fail_plain)
    monkeypatch.setattr(backward3d, "fused_rollout_3d_plain", fail_plain)
    monkeypatch.setattr(_build, "load_library", fail_load)
    _, _, cfg, npp = _pair("gs3d", seed=0)
    meta = params_from_numpy(npp, device="meta", dtype=torch.float32)
    packed = cell3d.pack_pi_params_3d(meta, cfg)
    frames = torch.empty((4, 6, 6, 6, 2), device="meta")
    with pytest.raises(RuntimeError, match="loader disabled"):
        backward3d.fused_phase1_pg_3d(packed, frames, torch.empty_like(frames), cfg)
    with pytest.raises(RuntimeError, match="loader disabled"):
        backward3d.fused_rollout_tp_3d_pg(meta, torch.empty((6, 6, 6, 2), device="meta"),
                                          cfg, 3)


def test_kernel_inputs_are_checked():
    _, _, cfg, npp = _pair("gs3d", seed=0)
    packed = cell3d.pack_pi_params_3d(params_from_numpy(npp, device="cpu"), cfg)
    frames = torch.zeros((4, 6, 6, 6, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        backward3d._check_pg_inputs(packed, frames, frames, cfg)
