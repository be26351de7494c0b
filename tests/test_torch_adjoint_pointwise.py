"""The streaming 1x1 adjoints of percnn_tpu_torch on the CPU, against the
JAX package: the plain sweeps of adj2d_kernel at k = 1 (row 4) and of
adj3d_kernel (row 9) against percnn_tpu's ``_phase1_kernel`` and
``_phase1_kernel3d`` in interpret mode, ``fused_rollout_tp_3d`` against
percnn_tpu's and against torch autograd, ``forward_rollout(bptt='fused' |
'two_phase')`` of a GS3D model against percnn_tpu's, and the dispatch rule
(a CUDA tensor never reaches a plain version).

The kernels themselves run only on the card: ``python3 chip_smoke.py``
holds them against these plain versions there.  Bars: the JAX package's own
(tests/test_pallas.py), rtol 2e-4 / atol 2e-6.  The JAX 3D kernels need
D % 8 == 0 and H * W % 128 == 0: 8 x 16 x 8 for the kernels, 16^3 for the
GS3D model; each JAX kernel sees one shape in this file.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.experiments import runner as jrunner
from percnn_tpu.experiments.configs import GS3D_RECON as J_GS3D_RECON
from percnn_tpu.ops.pallas import backward2d as jbackward2d
from percnn_tpu.ops.pallas import backward3d as jbackward3d
from percnn_tpu.ops.pallas import cell2d as jcell2d
from percnn_tpu.ops.pallas import cell3d as jcell3d

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core import checkpoint
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step
from percnn_tpu_torch.core.rollout import rollout
from percnn_tpu_torch.experiments import runner
from percnn_tpu_torch.experiments.configs import GS3D_RECON
from percnn_tpu_torch.ops.kernels import _build, backward2d, backward3d, cell2d, cell3d

RTOL, ATOL = 2e-4, 2e-6
T = 3
KW2 = dict(ndim=2, hidden=4, kernel_size=1, dt=0.5, dx=0.05, diffusion="sigmoid",
           mu_up=3.99e-4, init_scale=0.3)
KW3 = dict(ndim=3, hidden=2, kernel_size=1, dt=0.05, dx=2.08, diffusion="sigmoid",
           mu_up=0.3, init_scale=0.3)
D3, H3, W3 = 8, 16, 8


def _pair(kw, seed):
    jcfg = JPiCellConfig(**kw)
    jp = j_init_pi_cell(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, PiCellConfig(**kw), jax.tree_util.tree_map(np.asarray, jp)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max())


def _jleaves(g):
    return [np.asarray(g["diff"])] + [np.asarray(g["pi"][o][k]) for o in range(2)
                                      for k in sorted(g["pi"][o])]


def test_adjoint_sweep_2d_matches_pallas_phase1():
    """Row 4 at k = 1: g_ins and g0 against _fused_phase1 (interpret mode)."""
    jcfg, jp, cfg, npp = _pair(KW2, 1)
    H, W = 12, 16
    frames = _rand((T + 1, H, W, 2), 2, scale=0.3, shift=0.5)
    fbar = _rand((T + 1, H, W, 2), 3)
    frames_pad = jnp.stack([jcell2d.pad_state_2d(jnp.asarray(f)) for f in frames[:-1]])
    fbar_pad = jnp.zeros((T,) + frames_pad.shape[1:], jnp.float32).at[
        :, :, 2:2 + H, 2:2 + W].set(jnp.moveaxis(jnp.asarray(fbar[1:]), -1, 1))
    gins_j, g0_j = jbackward2d._fused_phase1(jcell2d.pack_pi_params_2d(jp, jcfg), frames_pad,
                                             fbar_pad, cfg=jcfg, n_steps=T, H=H, W=W,
                                             interpret=True)
    packed = cell2d.pack_pi_params_2d(params_from_numpy(npp, device="cpu"), cfg)
    g_ins, g0 = backward2d.fused_phase1_2d(packed, torch.from_numpy(frames),
                                           torch.from_numpy(fbar), cfg)
    _assert_close(g_ins.numpy(), np.asarray(jcell2d.unpad_frames_2d(gins_j, H, W)))
    _assert_close(g0.numpy(), np.moveaxis(np.asarray(g0_j)[:, 2:2 + H, 2:2 + W], 0, -1))


def _flat3(a):
    return jnp.moveaxis(jnp.asarray(a), -1, 1).reshape(a.shape[0], 2, D3, H3 * W3)


def _unflat3(a):
    return np.moveaxis(np.asarray(a).reshape(-1, 2, D3, H3, W3), 1, -1)


def test_adjoint_sweep_3d_matches_pallas_phase1_3d():
    """Row 9: g_ins and g0 against _fused_phase1_3d (interpret mode, flat
    [D, H*W] layout)."""
    jcfg, jp, cfg, npp = _pair(KW3, 4)
    frames = _rand((T + 1, D3, H3, W3, 2), 5, scale=0.3, shift=0.5)
    fbar = _rand((T + 1, D3, H3, W3, 2), 6)
    gins_j, g0_j = jbackward3d._fused_phase1_3d(
        jcell3d.pack_pi_params_3d(jp, jcfg), _flat3(frames[:-1]), _flat3(fbar[1:]), cfg=jcfg,
        n_steps=T, D=D3, H=H3, W=W3, interpret=True)
    packed = cell3d.pack_pi_params_3d(params_from_numpy(npp, device="cpu"), cfg)
    g_ins, g0 = backward3d.fused_phase1_3d(packed, torch.from_numpy(frames),
                                           torch.from_numpy(fbar), cfg)
    assert g_ins.shape == (T, D3, H3, W3, 2) and g0.shape == (D3, H3, W3, 2)
    _assert_close(g_ins.numpy(), _unflat3(gins_j))
    _assert_close(g0.numpy(), _unflat3(g0_j)[0])


def _trainable(npp):
    tp = params_from_numpy(npp, device="cpu", dtype=torch.float32)
    for t in backward2d._cell_leaves(tp):
        t.requires_grad_(True)
    return tp


def test_fused_3d_gradients_match_jax():
    """fused_rollout_tp_3d's frames and gradients (every cell leaf and h0)
    against percnn_tpu's fused_rollout_tp_3d."""
    jcfg, jp, cfg, npp = _pair(KW3, 7)
    h0 = _rand((D3, H3, W3, 2), 8, scale=0.2, shift=0.5)
    tgt = _rand((T + 1, D3, H3, W3, 2), 9)

    def loss(fr, t):
        return ((fr - t) ** 2).mean() + (fr[1] * fr[2]).mean()

    tp = _trainable(npp)
    th0 = torch.from_numpy(h0).requires_grad_(True)
    frames = backward3d.fused_rollout_tp_3d(tp, th0, cfg, T, pgrad_chunk=2)
    assert type(frames.grad_fn).__name__.startswith("FusedRolloutTP3d")
    grads = torch.autograd.grad(loss(frames, torch.from_numpy(tgt)),
                                backward2d._cell_leaves(tp) + [th0])
    jframes = jbackward3d.fused_rollout_tp_3d(jp, jnp.asarray(h0), jcfg, T)
    np.testing.assert_allclose(frames.detach().numpy(), np.asarray(jframes), rtol=2e-4,
                               atol=1e-5)
    jg_p, jg_h = jax.grad(
        lambda p, h: loss(jbackward3d.fused_rollout_tp_3d(p, h, jcfg, T, 2), jnp.asarray(tgt)),
        argnums=(0, 1))(jp, jnp.asarray(h0))
    for got, want in zip(grads, _jleaves(jg_p) + [np.asarray(jg_h)]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,chunk", [((5, 6, 7), 16), ((6, 5, 5), 1)])
def test_fused_3d_gradients_match_autograd_rollout(shape, chunk):
    """Any D, H, W >= 5, and any chunk of the parameter gradients: the
    Function equals torch autograd through the port's own rollout."""
    _, _, cfg, npp = _pair({**KW3, "diffusion": "raw", "diff_init": 0.2, "hidden": 3}, 10)
    tp = _trainable(npp)
    th0 = torch.from_numpy(_rand(shape + (2,), 11, scale=0.2, shift=0.5)).requires_grad_(True)
    leaves = backward2d._cell_leaves(tp) + [th0]
    tgt = torch.from_numpy(_rand((5,) + shape + (2,), 12))
    g1 = torch.autograd.grad(((backward3d.fused_rollout_tp_3d(tp, th0, cfg, 4, chunk) - tgt)
                              ** 2).sum(), leaves)
    g2 = torch.autograd.grad(((rollout(lambda h: pi_cell_step(tp, h, cfg), th0, 4) - tgt)
                              ** 2).sum(), leaves)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def _small3d(base):
    """GS3D at 16^3 (ISG 8^3 -> 16^3, the JAX fused kernels' alignment), T = 4."""
    return dataclasses.replace(
        base, grid=16, train_steps=4, infer_steps=4, curriculum=(), isg_pretrain_iters=0,
        data=dataclasses.replace(base.data, time_stride=2, space_stride=2))


@pytest.mark.parametrize("bptt,fn", [("fused", "FusedRolloutTP3d"), ("two_phase", "_RolloutTP")])
def test_forward_rollout_3d_matches_jax(bptt, fn):
    """forward_rollout of a GS3D model (ISG, then the cell) on the 'fused'
    and 'two_phase' routes: the frames against 'remat', and the gradient of
    every leaf against percnn_tpu's forward_rollout on the same route."""
    exp, jexp = _small3d(GS3D_RECON), _small3d(J_GS3D_RECON)
    truth = (np.random.default_rng(0).standard_normal((5, 16, 16, 16, 2)) * 0.1
             + 0.4).astype(np.float32)
    prob, jprob = runner.setup_problem(exp, truth, device="cpu"), jrunner.setup_problem(jexp,
                                                                                        truth)
    jp = jrunner.init_model(jexp, jax.random.PRNGKey(13))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    leaves = [leaf for _, leaf in checkpoint.flatten_with_paths(tp)]
    for t in leaves:
        t.requires_grad_(True)
    frames = runner.forward_rollout(tp, prob, 4, bptt=bptt, device="cpu")
    assert type(frames.grad_fn).__name__.startswith(fn)
    plain = runner.forward_rollout(tp, prob, 4, bptt="remat", device="cpu")
    np.testing.assert_allclose(frames.detach().numpy(), plain.detach().numpy(), rtol=2e-4,
                               atol=1e-5)
    grads = torch.autograd.grad(frames.square().mean(), leaves)
    jg = jax.grad(lambda p: jnp.mean(jrunner.forward_rollout(p, jprob, 4, bptt=bptt) ** 2))(jp)
    jleaves = [leaf for _, leaf in checkpoint.flatten_with_paths(
        jax.tree_util.tree_map(np.asarray, jg))]
    assert len(grads) == len(jleaves)
    for got, want in zip(grads, jleaves):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_cpu_path_launches_no_kernel(monkeypatch):
    for fn in (backward2d.fused_phase1_2d, backward3d.fused_phase1_3d):
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(cell2d.fused_rollout_2d, "launches", 0)
    monkeypatch.setattr(cell3d.fused_rollout_3d, "launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    for kw, shape in ((KW2, (8, 9)), (KW3, (5, 6, 5))):
        _, _, cfg, npp = _pair(kw, 14)
        tp = _trainable(npp)
        h0 = torch.from_numpy(_rand(shape + (2,), 15, scale=0.2, shift=0.5))
        fused = backward2d.fused_rollout_tp_2d if cfg.ndim == 2 else backward3d.fused_rollout_tp_3d
        fused(tp, h0, cfg, T).square().sum().backward()
        assert tp["pi"][1]["w2"].grad is not None
    assert (backward2d.fused_phase1_2d.launches, backward3d.fused_phase1_3d.launches,
            cell2d.fused_rollout_2d.launches, cell3d.fused_rollout_3d.launches) == (0, 0, 0, 0)


def test_non_cpu_tensor_never_reaches_plain(monkeypatch):
    """A tensor that is not on the CPU goes to the kernels: when they cannot
    be loaded, the error propagates; nothing falls back."""
    def fail_plain(*args, **kwargs):
        raise AssertionError("a plain version was reached")

    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    for mod, name in ((backward2d, "fused_phase1_2d_plain"), (backward2d, "fused_rollout_2d_plain"),
                      (backward3d, "fused_phase1_3d_plain"), (backward3d, "fused_rollout_3d_plain")):
        monkeypatch.setattr(mod, name, fail_plain)
    monkeypatch.setattr(_build, "load_library", fail_load)
    for kw, shape, fused, sweep in (
            (KW2, (8, 9), backward2d.fused_rollout_tp_2d, backward2d.fused_phase1_2d),
            (KW3, (5, 6, 5), backward3d.fused_rollout_tp_3d, backward3d.fused_phase1_3d)):
        _, _, cfg, npp = _pair(kw, 0)
        meta = params_from_numpy(npp, device="meta", dtype=torch.float32)
        packed = cell2d.pack_pi_params_2d(meta, cfg)
        frames = torch.empty((T + 1,) + shape + (2,), device="meta")
        for call in (lambda: sweep(packed, frames, frames, cfg),
                     lambda: fused(meta, frames[0], cfg, T)):
            with pytest.raises((RuntimeError, ValueError), match="loader disabled|CUDA tensors"):
                call()


def test_kernel_inputs_are_checked():
    _, _, cfg, npp = _pair(KW3, 0)
    packed = cell3d.pack_pi_params_3d(params_from_numpy(npp, device="cpu"), cfg)
    frames = torch.zeros((T + 1, 5, 6, 5, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        backward3d._phase1_cuda(packed, frames, frames, cfg)
