"""FORWARD_SIM_LO in percnn_tpu_torch on the CPU against percnn_tpu: the five
configs as dataclasses, the reference's trained forward-sim cell against the
committed golden ``tests/golden/pt_lo_forward.npz`` (64 x 64, 8 steps, f64),
the physics loss and its gradient in f64, the route ``bptt="auto"`` takes,
and a shrunk run of the experiment against the JAX package's.

Bars: the golden 5e-10 * t (the f64 golden bar); the loss and gradients in
f64 rtol 1e-10; the shrunk run's f64 loss history rtol 1e-8 after Adam
steps.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.experiments import configs as jconfigs
from percnn_tpu.experiments import runner as jrunner

from percnn_tpu_torch.bridge import params_from_numpy, unflatten_dotted
from percnn_tpu_torch.core.cell import pi_cell_step
from percnn_tpu_torch.experiments import EXPERIMENTS, FORWARD_SIM_LO, runner


@pytest.fixture(autouse=True)
def _figures_skipped(monkeypatch):
    """run_experiment's figures (tested in test_torch_viz.py) are skipped
    here, as where matplotlib is not installed: neither package's runs draw."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pt_lo_forward.npz")


@pytest.mark.parametrize("name", list(jconfigs.EXPERIMENTS))
def test_configs_equal_jax(name):
    assert list(EXPERIMENTS) == list(jconfigs.EXPERIMENTS)
    assert dataclasses.asdict(EXPERIMENTS[name]) == dataclasses.asdict(jconfigs.EXPERIMENTS[name])


def test_golden_lo_forward_rollout():
    """The reference's trained forward-sim cell, eager in f64: step by step
    and through runner.inference_rollout (an f64 request takes no kernel)."""
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    cell = params_from_numpy(unflatten_dotted(golden, "cell."), device="cpu",
                             dtype=torch.float64)
    frames = golden["frames"]
    cfg = dataclasses.replace(FORWARD_SIM_LO.cell, dt=float(golden["dt"]), dx=float(golden["dx"]))
    assert cfg == FORWARD_SIM_LO.cell
    h = torch.from_numpy(frames[0])
    for t in range(1, frames.shape[0]):
        h = pi_cell_step(cell, h, cfg)
        err = float((h - torch.from_numpy(frames[t])).abs().max())
        assert err < 5e-10 * t, f"step {t}: max |diff| {err}"
    got = runner.inference_rollout({"cell": cell}, FORWARD_SIM_LO, frames[0],
                                   frames.shape[0] - 1, device="cpu")
    assert got.dtype == torch.float64
    for t in range(1, frames.shape[0]):
        assert float((got[t] - torch.from_numpy(frames[t])).abs().max()) < 5e-10 * t


def _small(base, grid=16, steps=8):
    return dataclasses.replace(
        base, grid=grid, train_steps=steps, infer_steps=2 * steps,
        train=dataclasses.replace(base.train, n_iters=4, steps_per_call=2, log_every=100))


def _setup(dtype=np.float64, seed=0):
    exp, jexp = _small(FORWARD_SIM_LO), _small(jconfigs.FORWARD_SIM_LO)
    rng = np.random.default_rng(seed)
    truth = (rng.standard_normal((exp.train_steps + 1, exp.grid, exp.grid, 2)) * 0.3
             ).astype(dtype)
    jdtype = jnp.float64 if dtype == np.float64 else jnp.float32
    jprob = jrunner.setup_problem(jexp, truth, jdtype)
    prob = runner.setup_problem(exp, truth, torch.float64 if dtype == np.float64
                                else torch.float32, device="cpu")
    jp = jrunner.init_model(jexp, jax.random.PRNGKey(seed), jdtype)
    return exp, prob, jprob, jp


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("bptt", ["auto", "two_phase", "remat"])
def test_physics_loss_and_gradient_match_jax_f64(bptt):
    exp, prob, jprob, jp = _setup()
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for t in _leaves(tp):
        t.requires_grad_(True)
    total, aux = runner.build_loss_fn(prob, exp.train_steps, bptt=bptt)(tp)
    jtotal, jaux = jrunner.build_loss_fn(jprob, exp.train_steps, bptt="two_phase")(jp)
    assert total.dtype == torch.float64 and set(aux) == set(jaux) == {"phy", "val"}
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-10)
    grads = torch.autograd.grad(total, _leaves(tp))
    jg = jax.grad(lambda p: jrunner.build_loss_fn(jprob, exp.train_steps)(p)[0])(jp)
    for got, want in zip(grads, _leaves(jax.tree_util.tree_map(np.asarray, jg))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("dtype,route", [(np.float64, "_RolloutTP"),
                                         (np.float32, "FusedRolloutTP2dPG")])
def test_auto_route(dtype, route):
    """"auto" maps the f64 state to "two_phase" (core.rollout.rollout_tp), as
    percnn_tpu does; an f32 state of the same cell takes the fused pg
    route."""
    exp, prob, _, jp = _setup(dtype)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for t in _leaves(tp):
        t.requires_grad_(True)
    frames = runner.forward_rollout(tp, prob, 4, device="cpu")
    assert type(frames.grad_fn).__name__.startswith(route), type(frames.grad_fn).__name__


def test_shrunk_run_matches_jax(tmp_path):
    """run_experiment(FORWARD_SIM_LO) shrunk to 16 x 16, T = 8, 4 iterations,
    in f64, from the same parameters: the loss history against the JAX
    package's, a finite evaluation and the closed-form Pi expressions."""
    exp, jexp = _small(FORWARD_SIM_LO), _small(jconfigs.FORWARD_SIM_LO)
    jres = jrunner.run_experiment(jexp, out_dir=str(tmp_path / "jax"), cache_dir=None,
                                  dtype=jnp.float64, seed=0)
    jp0 = jrunner.init_model(jexp, jax.random.PRNGKey(0), jnp.float64)
    orig = runner.init_model
    try:
        runner.init_model = lambda *a, **k: params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp0), device="cpu")
        res = runner.run_experiment(exp, out_dir=str(tmp_path / "port"), cache_dir=None,
                                    dtype=torch.float64, seed=0, device="cpu")
    finally:
        runner.init_model = orig
    np.testing.assert_allclose(res["history"], jres["history"], rtol=1e-8)
    assert np.isfinite(res["rel_l2"]) and not res["diverged"]
    np.testing.assert_allclose(res["rel_l2"], jres["rel_l2"], rtol=1e-6)
    assert res["frames"].dtype == np.float64 and res["frames"].shape[0] == exp.infer_steps + 1
    assert len(res["pi_expressions"]) == 2 and all("u" in e for e in res["pi_expressions"])
