"""The two-phase backward, the tap-by-tap k x k forward and the fallback
slice as a whole, in percnn_tpu_torch on the CPU against the JAX package:

- the periodic conv's weight gradient (one FFMA matmul with the im2col
  stack) against torch autograd through F.conv2d in f64;
- ``chunked_param_grads`` and ``rollout_tp`` against percnn_tpu's, and
  against jax.grad through the jnp rollout;
- rollout2d_kernel's and final2d_kernel's k = 5 contract (the plain
  versions) against percnn_tpu's ``_rollout_kernel`` and ``_final_kernel``
  in interpret mode, the MXU_FWD_ENABLED switch and PERCNN_DISABLE_MXU;
- final-state serving of a 5x5 cell against percnn_tpu's;
- a shrunk run_experiment(BURGERS_STAGE1) with the MXU switches off
  against the same run with them on.

Bars: forward rtol 2e-4 / atol 1e-5, gradients rtol 2e-4 / atol 2e-6 (the
JAX package's own, tests/test_pallas.py); the two routes of the whole run
within 1e-4, the bar of the card against the CPU.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.core.cell import pi_cell_step as j_pi_cell_step
from percnn_tpu.core import rollout as jrollout
from percnn_tpu.ops.pallas import cell2d as jcell2d
from percnn_tpu.serving import build_serving_fn as j_build_serving_fn

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core import checkpoint
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step
from percnn_tpu_torch.core.rollout import chunked_param_grads, rollout_tp
from percnn_tpu_torch.experiments import configs, runner
from percnn_tpu_torch.ops.convs import conv_nd_periodic
from percnn_tpu_torch.ops.kernels import backward2d, cell2d
from percnn_tpu_torch.serving import build_serving_fn

RTOL, ATOL = 2e-4, 2e-6
CFGS = {
    "k5": dict(ndim=2, hidden=3, kernel_size=5, dt=0.05, dx=0.2, diffusion="sigmoid",
               mu_up=0.2, init_scale=0.3),
    "k1": dict(ndim=2, hidden=4, kernel_size=1, dt=0.5, dx=0.05, diffusion="raw",
               diff_init=1e-4, init_scale=0.3),
}
H, W = 8, 10


def _pair(name, seed):
    jcfg = JPiCellConfig(**CFGS[name])
    jp = j_init_pi_cell(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, PiCellConfig(**CFGS[name]), jax.tree_util.tree_map(np.asarray, jp)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def _leaves(g):
    return [g["diff"]] + [g["pi"][o][k] for o in range(2) for k in sorted(g["pi"][o])]


@pytest.mark.parametrize("k,lead", [(5, (3,)), (3, (2, 4)), (5, ())])
def test_periodic_conv_weight_grad_matches_autograd_f64(k, lead):
    """The backward of conv_nd_periodic's 2D case (cuDNN's input gradient,
    the weight gradient as one matmul with the im2col stack) against torch
    autograd through F.conv2d of the wrap-padded input, in f64."""
    rng = np.random.RandomState(k)
    x = torch.from_numpy(rng.standard_normal(lead + (9, 7, 2))).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((k, k, 2, 4))).requires_grad_(True)
    b = torch.from_numpy(rng.standard_normal(4)).requires_grad_(True)
    gy = torch.from_numpy(rng.standard_normal(lead + (9, 7, 4)))
    y = conv_nd_periodic(x, w, b)
    got = torch.autograd.grad(y, (x, w, b), gy)
    xb = F.pad(x.reshape(-1, 9, 7, 2).movedim(-1, 1), [k // 2, (k - 1) // 2] * 2,
               mode="circular")
    y_ref = F.conv2d(xb, w.permute(3, 2, 0, 1), b).movedim(1, -1).reshape(y.shape)
    want = torch.autograd.grad(y_ref, (x, w, b), gy)
    torch.testing.assert_close(y, y_ref, rtol=1e-10, atol=0)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name,chunk", [("k5", 2), ("k1", 64)])
def test_chunked_param_grads_matches_jax(name, chunk):
    """Phase 2 alone on random steps and cotangents: a chunk that leaves a
    ragged last batch, and one chunk for every step."""
    jcfg, jp, cfg, npp = _pair(name, 1)
    n = 5
    h_prev, g_ins = _rand((n, H, W, 2), 2, scale=0.3, shift=0.4), _rand((n, H, W, 2), 3)
    want = jrollout.chunked_param_grads(lambda p, h: j_pi_cell_step(p, h, jcfg), jp,
                                        jnp.asarray(h_prev), jnp.asarray(g_ins), n, chunk)
    got = chunked_param_grads(lambda p, h: pi_cell_step(p, h, cfg),
                              params_from_numpy(npp, device="cpu"), torch.from_numpy(h_prev),
                              torch.from_numpy(g_ins), n, chunk)
    for a, b in zip(_leaves(got), _leaves(jax.tree_util.tree_map(np.asarray, want))):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL * np.abs(b).max())


@pytest.mark.parametrize("name", ["k5", "k1"])
def test_rollout_tp_gradients_match_jax(name):
    """rollout_tp's gradients (every cell leaf and h0) against percnn_tpu's
    rollout_tp and against jax.grad through the jnp rollout."""
    jcfg, jp, cfg, npp = _pair(name, 4)
    T = 4
    h0 = _rand((H, W, 2), 5, scale=0.3, shift=0.4)
    tgt = _rand((T + 1, H, W, 2), 6)

    def loss(fr, t):
        return ((fr - t) ** 2).sum() + (fr[1] * fr[3]).sum()

    tp = params_from_numpy(npp, device="cpu")
    for t in _leaves(tp):
        t.requires_grad_(True)
    th0 = torch.from_numpy(h0).requires_grad_(True)
    frames = rollout_tp(lambda p, h: pi_cell_step(p, h, cfg), tp, th0, T, pgrad_chunk=3)
    assert frames.shape == (T + 1, H, W, 2) and frames[0].equal(th0.detach())
    grads = torch.autograd.grad(loss(frames, torch.from_numpy(tgt)), _leaves(tp) + [th0])
    step = lambda p, h: j_pi_cell_step(p, h, jcfg)   # noqa: E731
    for roll in (lambda p, h: jrollout.rollout_tp(step, p, h, T, 3),
                 lambda p, h: jrollout.rollout(lambda x: step(p, x), h, T, remat=False)):
        jg_p, jg_h = jax.grad(lambda p, h: loss(roll(p, h), jnp.asarray(tgt)),
                              argnums=(0, 1))(jp, jnp.asarray(h0))
        want = [np.asarray(x) for x in _leaves(jg_p)] + [np.asarray(jg_h)]
        for got, w in zip(grads, want):
            assert got.shape == w.shape
            np.testing.assert_allclose(got.numpy(), w, rtol=RTOL, atol=ATOL)


def test_rollout_tp_zero_steps_and_no_grad():
    _, _, cfg, npp = _pair("k1", 7)
    tp = params_from_numpy(npp, device="cpu")
    h0 = torch.from_numpy(_rand((H, W, 2), 8)).requires_grad_(True)
    step = lambda p, h: pi_cell_step(p, h, cfg)   # noqa: E731
    frames = rollout_tp(step, tp, h0, 0)
    assert frames.shape == (1, H, W, 2)
    (g,) = torch.autograd.grad(frames.sum(), h0)
    assert g.equal(torch.ones_like(h0))
    with torch.no_grad():
        assert rollout_tp(step, tp, h0, 3).grad_fn is None


def test_vpu_kxk_rollout_and_final_match_pallas(monkeypatch):
    """rollout2d_kernel's and final2d_kernel's k = 5 contract: the plain
    versions from the packed vector against percnn_tpu's _rollout_kernel
    (its MXU switch off) and _final_kernel in interpret mode, and against
    the branch-matrix route."""
    jcfg, jp, cfg, npp = _pair("k5", 9)
    tp = params_from_numpy(npp, device="cpu")
    h0 = _rand((H, W, 2), 10, scale=0.3)
    T = 3
    monkeypatch.setattr(jcell2d, "MXU_FWD_ENABLED", False)
    want = np.asarray(jcell2d.fused_rollout_2d(jp, jnp.asarray(h0), jcfg, T, interpret=True))
    want_final = np.asarray(jcell2d.fused_rollout_final_2d(jp, jnp.asarray(h0), jcfg, T,
                                                           interpret=True))
    monkeypatch.setattr(cell2d, "MXU_FWD_ENABLED", False)

    def no_matrix(*args):
        raise AssertionError("the MXU switch is off: the branch-matrix route was taken")

    with monkeypatch.context() as m:
        m.setattr(cell2d, "fused_rollout_kxk_2d_plain", no_matrix)
        got = cell2d.fused_rollout_2d(tp, torch.from_numpy(h0), cfg, T)
        got_final = cell2d.fused_rollout_final_2d(tp, torch.from_numpy(h0), cfg, T)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got_final.numpy(), want_final, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(got_final, got[-1], rtol=0, atol=0)
    monkeypatch.setattr(cell2d, "MXU_FWD_ENABLED", True)
    matrix = cell2d.fused_rollout_2d(tp, torch.from_numpy(h0), cfg, T)
    np.testing.assert_allclose(matrix.numpy(), got.numpy(), rtol=2e-4, atol=1e-5)


def test_disable_mxu_env_sets_the_switches():
    """PERCNN_DISABLE_MXU=1 in the environment turns both switches off at
    import, as in percnn_tpu; without it both are on."""
    code = ("from percnn_tpu_torch.ops.kernels import backward2d, cell2d; "
            "print(cell2d.MXU_FWD_ENABLED, backward2d.MXU_BWD_ENABLED)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for value, want in (("1", "False False"), ("", "True True")):
        env = {**os.environ, "PERCNN_DISABLE_MXU": value}
        out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                             capture_output=True, text=True, check=True).stdout
        assert out.split() == want.split()


def test_final_state_serving_of_5x5_cell_matches_jax():
    jcfg, jp, cfg, npp = _pair("k5", 11)
    x = _rand((H, W, 2), 12, scale=0.3)
    want = np.asarray(j_build_serving_fn(jp, jcfg, 3, final_only=True, use_pallas=True)(
        jnp.asarray(x)))
    got = build_serving_fn(npp, cfg, 3, final_only=True, device="cpu")(x)
    assert got.shape == (H, W, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


def _small_burgers():
    """BURGERS_STAGE1 at 16 x 16, hidden 3, ISG hidden 4, T = 10, 4 iterations."""
    base = configs.BURGERS_STAGE1
    return dataclasses.replace(
        base, grid=16, train_steps=10, infer_steps=16, isg_pretrain_iters=0,
        cell=dataclasses.replace(base.cell, hidden=3),
        isg=dataclasses.replace(base.isg, hidden=4),
        data=dataclasses.replace(base.data, time_stride=2, space_stride=2),
        train=dataclasses.replace(base.train, n_iters=4, steps_per_call=2, log_every=100))


def test_burgers_run_with_mxu_off_matches_mxu_on(monkeypatch, tmp_path):
    """The whole slice: run_experiment(BURGERS_STAGE1) shrunk, with
    MXU_FWD_ENABLED = MXU_BWD_ENABLED = False (rollout2d_kernel's k = 5
    contract, _precompute_ys and adj2d_ys_kernel), against the same run
    with the switches on; then with YS_PATH_ENABLED off too (adj2d_kernel
    and chunked_param_grads)."""
    exp = _small_burgers()
    results = {}
    for label, flags in (("on", (True, True, True)), ("off", (False, False, True)),
                         ("ys_off", (False, False, False))):
        monkeypatch.setattr(cell2d, "MXU_FWD_ENABLED", flags[0])
        monkeypatch.setattr(backward2d, "MXU_BWD_ENABLED", flags[1])
        monkeypatch.setattr(backward2d, "YS_PATH_ENABLED", flags[2])
        results[label] = runner.run_experiment(exp, out_dir=str(tmp_path / label), cache_dir=None,
                                               isg_pretrain_override=3, device="cpu")
    on = results["on"]
    assert len(on["history"]) == 4 and np.isfinite(on["history"]).all()
    for label in ("off", "ys_off"):
        res = results[label]
        np.testing.assert_allclose(res["history"], on["history"], rtol=1e-4)
        np.testing.assert_allclose(res["rel_l2"], on["rel_l2"], rtol=1e-4)
        for (path, a), (_, b) in zip(checkpoint.flatten_with_paths(res["params"]),
                                     checkpoint.flatten_with_paths(on["params"])):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{label} {path}")
