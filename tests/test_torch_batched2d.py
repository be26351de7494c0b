"""percnn_tpu_torch.ops.kernels.batched2d on the CPU at k = 1: the
member-batched differentiable rollouts against percnn_tpu's
``fused_rollout_tp_2d_batched`` and ``fused_rollout_tp_2d_batched_pg`` (its
(M, T)-grid Pallas kernels in interpret mode), each member against the
port's single-member rollouts, the guards, and the dispatch rule (a CUDA
tensor never reaches the plain version).

The kernels themselves (rollout2d_batched_kernel, adj2d_batched_kernel,
pg2d_batched_kernel) run only on the card: ``python3 chip_smoke.py`` holds
them against their plain versions there.  Bars are the JAX package's own
(tests/test_pallas.py): forward rtol 2e-4 / atol 1e-5, gradients rtol 2e-4 /
atol 2e-6.  One shape in this file (M = 2, 16 x 16, T = 6), so each Pallas
kernel compiles once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.ops.pallas import batched2d as jbatched2d

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.ops.kernels import _build, backward2d, batched2d, cell2d

M, N, T = 2, 16, 6
CFG = dict(ndim=2, hidden=4, kernel_size=1, dt=0.05, dx=0.2, diffusion="sigmoid",
           mu_up=0.1, init_scale=0.3)
ROUTES = {"batched": (jbatched2d.fused_rollout_tp_2d_batched,
                      batched2d.fused_rollout_tp_2d_batched, backward2d.fused_rollout_tp_2d),
          "batched_pg": (jbatched2d.fused_rollout_tp_2d_batched_pg,
                         batched2d.fused_rollout_tp_2d_batched_pg,
                         backward2d.fused_rollout_tp_2d_pg)}


def _stacked_params():
    """Per-member percnn_tpu inits (seeds 3, 4), stacked: (jax tree, numpy tree)."""
    members = [j_init_pi_cell(jax.random.PRNGKey(3 + m), JPiCellConfig(**CFG)) for m in range(M)]
    jp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs).astype(jnp.float32), *members)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def _leaves(p):
    return [p["diff"]] + [p["pi"][o][k] for o in range(2) for k in sorted(p["pi"][o])]


def _trainable(npp):
    tp = params_from_numpy(npp, device="cpu", dtype=torch.float32)
    for t in _leaves(tp):
        t.requires_grad_(True)
    return tp


@pytest.fixture(scope="module")
def setup():
    jp, npp = _stacked_params()
    h0 = _rand((M, N, N, 2), 5, scale=0.3)
    cot = _rand((M, T + 1, N, N, 2), 6)
    return jp, npp, h0, cot


@pytest.mark.parametrize("route", list(ROUTES))
def test_batched_rollout_matches_jax(setup, route):
    """Frames, and the gradients of <frames, cot> for every leaf and h0,
    against percnn_tpu's member-batched Pallas kernels."""
    jp, npp, h0, cot = setup
    jfn, fn, _ = ROUTES[route]
    cfg, jcfg = PiCellConfig(**CFG), JPiCellConfig(**CFG)

    def jloss(p, x):
        return jnp.sum(jfn(p, x, jcfg, T) * cot)

    jframes = np.asarray(jfn(jp, jnp.asarray(h0), jcfg, T))
    jg_p, jg_h0 = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(h0))
    tp = _trainable(npp)
    x = torch.from_numpy(h0).requires_grad_(True)
    frames = fn(tp, x, cfg, T)
    assert frames.shape == (M, T + 1, N, N, 2) and frames.dtype == torch.float32
    np.testing.assert_allclose(frames.detach().numpy(), jframes, rtol=2e-4, atol=1e-5)
    grads = torch.autograd.grad((frames * torch.from_numpy(cot)).sum(), _leaves(tp) + [x])
    want = [np.asarray(w) for w in _leaves(jg_p)] + [np.asarray(jg_h0)]
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("route", list(ROUTES))
def test_each_member_is_the_single_member_rollout(setup, route):
    """Member m of the batched rollout is the port's single-member fused
    rollout of member m: frames, and each member's gradients."""
    _, npp, h0, cot = setup
    _, fn, single = ROUTES[route]
    cfg = PiCellConfig(**CFG)
    tp = _trainable(npp)
    x = torch.from_numpy(h0).requires_grad_(True)
    frames = fn(tp, x, cfg, T)
    grads = torch.autograd.grad((frames * torch.from_numpy(cot)).sum(), _leaves(tp) + [x])
    for m in range(M):
        tm = _trainable(jax.tree_util.tree_map(lambda a: a[m], npp))
        xm = torch.from_numpy(h0[m]).requires_grad_(True)
        fm = single(tm, xm, cfg, T)
        np.testing.assert_allclose(frames[m].detach().numpy(), fm.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
        gm = torch.autograd.grad((fm * torch.from_numpy(cot[m])).sum(), _leaves(tm) + [xm])
        for got, w in zip(grads, gm):
            np.testing.assert_allclose(got[m].numpy(), w.numpy(), rtol=1e-5, atol=1e-7)


def test_packed_rows_are_the_single_packs(setup):
    _, npp, _, _ = setup
    cfg = PiCellConfig(**CFG)
    tp = params_from_numpy(npp, device="cpu")
    packed = batched2d.pack_pi_params_2d_batched(tp, cfg)
    assert packed.shape == (M, 2 + 2 * cell2d._param_block(cfg))
    for m in range(M):
        single = cell2d.pack_pi_params_2d(params_from_numpy(
            jax.tree_util.tree_map(lambda a: a[m], npp), device="cpu"), cfg)
        np.testing.assert_array_equal(packed[m].numpy(), single.numpy())


@pytest.mark.parametrize("kw, pg_only", [
    (dict(kernel_size=2), False),
    (dict(kernel_size=7), False),
    (dict(channels=3), False),
    (dict(kernel_size=3), True),
    (dict(ndim=3), True),
])
def test_guards_raise_as_jax(kw, pg_only):
    """percnn_tpu's guards: _check_fusable (odd kernel_size <= 5, two
    channels) on both routes; the pg route takes ndim 2, kernel_size 1 only."""
    cfg_kw = {**CFG, **kw}
    jcfg, cfg = JPiCellConfig(**cfg_kw), PiCellConfig(**cfg_kw)
    h0 = np.zeros((M, 8, 8, 2), np.float32)
    pairs = [ROUTES["batched_pg"][:2]] if pg_only else [r[:2] for r in ROUTES.values()]
    for jfn, fn in pairs:
        with pytest.raises(NotImplementedError):
            jfn({}, jnp.asarray(h0), jcfg, 2)
        with pytest.raises(NotImplementedError):
            fn({}, torch.from_numpy(h0), cfg, 2)


def test_cpu_path_launches_no_kernel(monkeypatch, setup):
    _, npp, h0, _ = setup
    for fn in (batched2d.fused_rollout_2d_batched, batched2d.fused_phase1_2d_batched):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_kxk", 0)
    monkeypatch.setattr(batched2d.fused_phase1_pg_2d_batched, "launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    cfg = PiCellConfig(**CFG)
    for route in ROUTES.values():
        tp = _trainable(npp)
        route[1](tp, torch.from_numpy(h0), cfg, 3).square().sum().backward()
        assert tp["diff"].grad is not None
    assert batched2d.fused_rollout_2d_batched.launches == 0
    assert batched2d.fused_phase1_2d_batched.launches == 0
    assert batched2d.fused_phase1_pg_2d_batched.launches == 0


def test_non_cpu_tensor_never_reaches_plain(monkeypatch, setup):
    """A tensor that is not on the CPU goes to the kernels: when they cannot
    be loaded, the error propagates; nothing falls back."""
    _, npp, _, _ = setup

    def fail_plain(*args, **kwargs):
        raise AssertionError("a plain version was reached")

    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    for name in ("fused_rollout_2d_batched_plain", "fused_phase1_2d_batched_plain",
                 "fused_phase1_pg_2d_batched_plain"):
        monkeypatch.setattr(batched2d, name, fail_plain)
    monkeypatch.setattr(_build, "load_library", fail_load)
    cfg = PiCellConfig(**CFG)
    meta = params_from_numpy(npp, device="meta", dtype=torch.float32)
    packed = batched2d.pack_pi_params_2d_batched(meta, cfg)
    frames = torch.empty((M, 4, 8, 8, 2), device="meta")
    for call in (lambda: batched2d.fused_rollout_2d_batched(packed, frames[:, 0], cfg, 3),
                 lambda: batched2d.fused_phase1_2d_batched(packed, frames, frames, cfg),
                 lambda: batched2d.fused_phase1_pg_2d_batched(packed, frames, frames, cfg),
                 lambda: batched2d.fused_rollout_tp_2d_batched(meta, frames[:, 0], cfg, 3),
                 lambda: batched2d.fused_rollout_tp_2d_batched_pg(meta, frames[:, 0], cfg, 3)):
        with pytest.raises(RuntimeError, match="loader disabled"):
            call()


def test_kernel_inputs_are_checked(setup):
    _, npp, _, _ = setup
    cfg = PiCellConfig(**CFG)
    packed = batched2d.pack_pi_params_2d_batched(params_from_numpy(npp, device="cpu"), cfg)
    frames = torch.zeros((M, 4, 8, 8, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        batched2d._check_inputs("pg2d_batched_kernel", packed, frames, cfg)
