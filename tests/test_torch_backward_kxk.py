"""The backward of the k x k rollout in percnn_tpu_torch on the CPU: the plain
reverse sweep (g_ins, g0, ys) against percnn_tpu's ``_phase1_mxu_kernel``
in interpret mode, the parameter-gradient contractions against percnn_tpu's
``_param_grads_direct``, the differentiable rollout's gradients against
``fused_rollout_tp_2d`` and against jax.grad through the jnp rollout, and
the dispatch rule (a CUDA tensor never reaches the plain version).

adj2d_kxk_kernel itself runs only on the card: ``python3 chip_smoke.py``
holds it against the plain sweep there.  Bars: the JAX package's own
(tests/test_pallas.py), rtol 2e-4 / atol 2e-6.  Every JAX kernel call here
has one shape (8 x 10, T = 3, the cell below), so interpret mode compiles
each kernel once.  The raw-diffusion case is in test_torch_burgers.py.
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
H, W, T = 8, 10, 3

CFGS = {
    "sigmoid": dict(ndim=2, hidden=3, kernel_size=5, dt=0.05, dx=0.2, diffusion="sigmoid",
                    mu_up=0.2, init_scale=0.3),
    "k3": dict(ndim=2, hidden=2, kernel_size=3, n_branches=2, dt=0.02, dx=0.1,
               diffusion="raw", diff_init=0.01, init_scale=0.4),
}


def _pair(name, seed):
    jcfg = JPiCellConfig(**CFGS[name])
    jp = j_init_pi_cell(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, PiCellConfig(**CFGS[name]), jax.tree_util.tree_map(np.asarray, jp)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def _trainable(npp):
    tp = params_from_numpy(npp, device="cpu", dtype=torch.float32)
    for t in backward2d._cell_leaves(tp):
        t.requires_grad_(True)
    return tp


def _jleaves(g):
    return [np.asarray(g["diff"])] + [np.asarray(g["pi"][o][k]) for o in range(2)
                                      for k in sorted(g["pi"][o])]


def test_pack_adjoint_matrix_matches_jax():
    jcfg, jp, cfg, npp = _pair("sigmoid", 0)
    wmat = cell2d.pack_pi_matrix_2d(params_from_numpy(npp, device="cpu"), cfg)
    want = np.asarray(jbackward2d.pack_adjoint_matrix_2d(jcell2d.pack_pi_matrix_2d(jp, jcfg),
                                                         jcfg))
    got = backward2d.pack_adjoint_matrix_2d(wmat, cfg).numpy()
    assert got.shape == want.shape == (56, 2 * 3 * 3)
    np.testing.assert_array_equal(got, want)


def test_plain_sweep_matches_pallas_mxu():
    """g_ins, g0 and ys of the plain sweep against _fused_phase1_mxu
    (interpret mode) on the same frames and cotangents."""
    jcfg, jp, cfg, npp = _pair("sigmoid", 1)
    frames = _rand((T + 1, H, W, 2), 2, scale=0.3, shift=0.5)
    fbar = _rand((T + 1, H, W, 2), 3)
    wmat_j = jcell2d.pack_pi_matrix_2d(jp, jcfg)
    frames_pad = jnp.stack([jcell2d.pad_state_2d(jnp.asarray(f)) for f in frames[:-1]])
    hp, wp = frames_pad.shape[2], frames_pad.shape[3]
    fbar_pad = jnp.zeros((T, 2, hp, wp), jnp.float32).at[:, :, 2:2 + H, 2:2 + W].set(
        jnp.moveaxis(jnp.asarray(fbar[1:]), -1, 1))
    gins_j, g0_j, ys_j = jbackward2d._fused_phase1_mxu(
        jcell2d.pack_pi_params_2d(jp, jcfg), wmat_j,
        jbackward2d.pack_adjoint_matrix_2d(wmat_j, jcfg), frames_pad, fbar_pad,
        cfg=jcfg, n_steps=T, H=H, W=W, interpret=True)

    tp = params_from_numpy(npp, device="cpu")
    wmat = cell2d.pack_pi_matrix_2d(tp, cfg)
    tail = cell2d.pi_tail_2d(tp, cfg)
    g_ins, g0, ys = backward2d.fused_phase1_kxk_2d(wmat, tail, torch.from_numpy(frames),
                                                   torch.from_numpy(fbar), cfg)
    assert g_ins.shape == (T, H, W, 2) and g0.shape == (H, W, 2)
    assert ys.shape == (T, cell2d.mxu_rows(cfg), H, W)
    np.testing.assert_allclose(g_ins.numpy(), np.asarray(jcell2d.unpad_frames_2d(gins_j, H, W)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g0.numpy(), np.moveaxis(np.asarray(g0_j)[:, 2:2 + H, 2:2 + W],
                                                       0, -1), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j)[:, :, :H, :W], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("diffusion", ["sigmoid", "raw"])
def test_param_grads_direct_matches_jax(diffusion):
    """The time-batched contractions alone, on random steps, cotangents and
    activations: the branch weights' and biases' gradients as one batched
    matmul, the sigmoid chain rule of diff."""
    kw = {**CFGS["sigmoid"], "diffusion": diffusion, "diff_init": 0.1 if diffusion == "raw"
          else None}
    jcfg = JPiCellConfig(**kw)
    jp = j_init_pi_cell(jax.random.PRNGKey(4), jcfg)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    cfg = PiCellConfig(**kw)
    h_prev, g_ins = _rand((T, H, W, 2), 5, shift=0.3), _rand((T, H, W, 2), 6)
    ys = _rand((T, cell2d.mxu_rows(cfg), H, W), 7)
    C = cfg.hidden
    ys_j = [[jnp.moveaxis(jnp.asarray(ys[:, (o * 3 + i) * C:(o * 3 + i + 1) * C]), 1, -1)
             for i in range(3)] for o in range(2)]
    want = jbackward2d._param_grads_direct(jp, jnp.asarray(h_prev), jnp.asarray(g_ins), ys_j,
                                           jcfg)
    got = backward2d._param_grads_stream(params_from_numpy(npp, device="cpu"),
                                         torch.from_numpy(h_prev), torch.from_numpy(g_ins),
                                         torch.from_numpy(ys), cfg)
    for a, b in zip(backward2d._cell_leaves(got), _jleaves(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL * np.abs(b).max())


def _loss_all(fr, tgt):
    return ((fr - tgt) ** 2).sum()


def _loss_frames(fr, tgt):
    return (fr[::2] ** 2).sum() + (fr[1] * fr[3]).sum()


@pytest.mark.parametrize("loss", [_loss_all, _loss_frames])
def test_fused_gradients_match_jax(loss):
    """The Function's gradients (every cell leaf and h0) against
    percnn_tpu's fused_rollout_tp_2d and against jax.grad through the jnp
    rollout of pi_cell_step."""
    jcfg, jp, cfg, npp = _pair("sigmoid", 8)
    h0 = _rand((H, W, 2), 9, scale=0.3)
    tgt = _rand((T + 1, H, W, 2), 10)

    def j_fused(p, h):
        return loss(jbackward2d.fused_rollout_tp_2d(p, h, jcfg, T), jnp.asarray(tgt))

    def j_jnp(p, h):
        return loss(j_rollout(lambda x: j_pi_cell_step(p, x, jcfg), h, T, remat=False),
                    jnp.asarray(tgt))

    tp = _trainable(npp)
    th0 = torch.from_numpy(h0).requires_grad_(True)
    tl = loss(backward2d.fused_rollout_tp_2d(tp, th0, cfg, T), torch.from_numpy(tgt))
    grads = torch.autograd.grad(tl, backward2d._cell_leaves(tp) + [th0])
    for j_loss in (j_fused, j_jnp):
        np.testing.assert_allclose(float(tl.detach()), float(j_loss(jp, jnp.asarray(h0))),
                                   rtol=1e-5)
        jg_p, jg_h = jax.grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(h0))
        for got, want in zip(grads, _jleaves(jg_p) + [np.asarray(jg_h)]):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", ["sigmoid", "k3"])
def test_fused_gradients_match_autograd_rollout(name, remat):
    """The Function's gradients equal torch autograd through the port's own
    rollout of pi_cell_step (conv_nd_periodic branches)."""
    _, _, cfg, npp = _pair(name, 11)
    h0 = _rand((9, 7, 2), 12, scale=0.4)
    tgt = torch.from_numpy(_rand((5, 9, 7, 2), 13))
    tp = _trainable(npp)
    th0 = torch.from_numpy(h0).requires_grad_(True)
    leaves = backward2d._cell_leaves(tp) + [th0]
    g1 = torch.autograd.grad(_loss_frames(backward2d.fused_rollout_tp_2d(tp, th0, cfg, 4), tgt),
                             leaves)
    ref = rollout(lambda h: pi_cell_step(tp, h, cfg), th0, 4, remat=remat)
    g2 = torch.autograd.grad(_loss_frames(ref, tgt), leaves)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_double_backward_raises():
    _, _, cfg, npp = _pair("sigmoid", 14)
    tp = _trainable(npp)
    h0 = torch.from_numpy(_rand((6, 6, 2), 15, scale=0.3))
    (g,) = torch.autograd.grad(backward2d.fused_rollout_tp_2d(tp, h0, cfg, 2).square().sum(),
                               [tp["diff"]], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        g.sum().backward()


def test_cpu_path_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(backward2d.fused_rollout_tp_2d, "launches", 0)
    monkeypatch.setattr(cell2d.fused_rollout_kxk_2d, "launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    _, _, cfg, npp = _pair("sigmoid", 16)
    tp = _trainable(npp)
    h0 = torch.from_numpy(_rand((8, 8, 2), 17, scale=0.3))
    backward2d.fused_rollout_tp_2d(tp, h0, cfg, 3).square().sum().backward()
    assert tp["pi"][1]["w2"].grad is not None
    assert backward2d.fused_rollout_tp_2d.launches == 0
    assert cell2d.fused_rollout_kxk_2d.launches == 0


def test_non_cpu_tensor_never_reaches_plain(monkeypatch):
    """A tensor that is not on the CPU goes to the kernels: when they cannot
    be loaded, the error propagates; nothing falls back."""
    def fail_plain(*args, **kwargs):
        raise AssertionError("a plain version was reached")

    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    monkeypatch.setattr(backward2d, "fused_phase1_kxk_2d_plain", fail_plain)
    monkeypatch.setattr(backward2d, "fused_rollout_kxk_2d_plain", fail_plain)
    monkeypatch.setattr(_build, "load_library", fail_load)
    monkeypatch.setattr(backward2d, "_check_kxk_inputs", lambda *args: None)
    monkeypatch.setattr(cell2d, "_check_kxk_inputs", lambda *args: None)
    _, _, cfg, npp = _pair("sigmoid", 0)
    meta = params_from_numpy(npp, device="meta", dtype=torch.float32)
    wmat = cell2d.pack_pi_matrix_2d(meta, cfg)
    tail = cell2d.pi_tail_2d(meta, cfg)
    frames = torch.empty((4, 8, 8, 2), device="meta")
    with pytest.raises(RuntimeError, match="loader disabled"):
        backward2d.fused_phase1_kxk_2d(wmat, tail, frames, torch.empty_like(frames), cfg)
    with pytest.raises(RuntimeError, match="loader disabled"):
        backward2d.fused_rollout_tp_2d(meta, torch.empty((8, 8, 2), device="meta"), cfg, 3)


def test_kernel_inputs_are_checked():
    _, _, cfg, npp = _pair("sigmoid", 0)
    tp = params_from_numpy(npp, device="cpu")
    wmat = cell2d.pack_pi_matrix_2d(tp, cfg)
    tail = cell2d.pi_tail_2d(tp, cfg)
    frames = torch.zeros((4, 8, 8, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        backward2d._phase1_kxk_cuda(wmat, tail, frames, frames, cfg)


def test_1x1_cell_is_queued():
    """fused_rollout_tp_2d of a 1x1 cell (rollout2d_kernel, adj2d_kernel and
    chunked_param_grads): its gradients against percnn_tpu's
    fused_rollout_tp_2d at k = 1."""
    kw = dict(ndim=2, hidden=4, kernel_size=1, dt=0.05, dx=0.2, diffusion="sigmoid",
              mu_up=0.2, init_scale=0.3)
    jcfg, cfg = JPiCellConfig(**kw), PiCellConfig(**kw)
    jp = j_init_pi_cell(jax.random.PRNGKey(18), jcfg)
    h0 = _rand((H, W, 2), 19, scale=0.3, shift=0.5)
    tgt = _rand((T + 1, H, W, 2), 20)
    tp = _trainable(jax.tree_util.tree_map(np.asarray, jp))
    th0 = torch.from_numpy(h0).requires_grad_(True)
    grads = torch.autograd.grad(_loss_all(backward2d.fused_rollout_tp_2d(tp, th0, cfg, T),
                                          torch.from_numpy(tgt)),
                                backward2d._cell_leaves(tp) + [th0])
    jg_p, jg_h = jax.grad(
        lambda p, h: _loss_all(jbackward2d.fused_rollout_tp_2d(p, h, jcfg, T), jnp.asarray(tgt)),
        argnums=(0, 1))(jp, jnp.asarray(h0))
    for got, want in zip(grads, _jleaves(jg_p) + [np.asarray(jg_h)]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
