"""An f64 run's inference and candidate selection stay in f64: the port's
``inference_rollout`` and ``select_stable_candidate`` against percnn_tpu's
f64 jnp scan on a GS2D model (C = 8, 1x1 cell, 4x ISG, 32 x 32), and an f32
input still through the fused rollout.

The models are made by percnn_tpu's init in f64 and carried across as
numpy; the truth behind the measurements is seeded numpy noise (the probe
only reads its noisy subsample).  Bar: 5e-10 * t on frame t (1 at t = 0,
the ISG output), the f64 bar of the port's parity tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core import checkpoint as jcheckpoint
from percnn_tpu.experiments import runner as jrunner
from percnn_tpu.experiments.configs import GS2D_RECON as J_GS2D_RECON

from percnn_tpu_torch import bridge
from percnn_tpu_torch.core import checkpoint
from percnn_tpu_torch.experiments import runner
from percnn_tpu_torch.experiments.configs import GS2D_RECON

STEPS = 20


def _exp(base):
    return dataclasses.replace(
        base, grid=32, train_steps=STEPS, infer_steps=STEPS, curriculum=(),
        data=dataclasses.replace(base.data, time_stride=10))


def _truth(seed=0):
    rng = np.random.RandomState(seed)
    return 0.5 + 0.1 * rng.standard_normal((STEPS + 1, 32, 32, 2))


def _jmodel(seed):
    return jax.tree_util.tree_map(
        np.asarray, jrunner.init_model(_exp(J_GS2D_RECON), jax.random.PRNGKey(seed),
                                       jnp.float64))


def _problems(truth):
    jprob = jrunner.setup_problem(_exp(J_GS2D_RECON), truth, jnp.float64)
    prob = runner.setup_problem(_exp(GS2D_RECON), truth, torch.float64, device="cpu")
    return jprob, prob


def _hold_frames(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == np.float64 and got.shape == want.shape
    for t in range(want.shape[0]):
        err = float(np.abs(got[t] - want[t]).max())
        assert err <= 5e-10 * max(t, 1), f"frame {t}: max |diff| {err}"


def test_f64_inference_rollout_matches_jax_scan():
    jm = _jmodel(0)
    jprob, prob = _problems(_truth())
    want = np.asarray(jrunner.inference_rollout(
        jax.tree_util.tree_map(jnp.asarray, jm), jprob, STEPS))
    params = bridge.params_from_numpy(jm, device="cpu")
    x = prob.ic_low[0]
    assert x.dtype == torch.float64
    got = runner.inference_rollout(params, _exp(GS2D_RECON), x, STEPS, device="cpu")
    _hold_frames(got.numpy(), want)
    # a numpy f64 request is an f64 input too
    got_np = runner.inference_rollout(params, _exp(GS2D_RECON), x.numpy(), STEPS, device="cpu")
    assert got_np.dtype == torch.float64 and got_np.equal(got)


def test_f32_inference_rollout_takes_the_fused_rollout(monkeypatch):
    calls = []
    fused = runner.fused_rollout_2d

    def spy(*args, **kwargs):
        calls.append(args[1].dtype)
        return fused(*args, **kwargs)

    monkeypatch.setattr(runner, "fused_rollout_2d", spy)
    params = bridge.params_from_numpy(_jmodel(0), device="cpu", dtype=torch.float32)
    x = _problems(_truth())[1].ic_low[0].to(torch.float32)
    frames = runner.inference_rollout(params, _exp(GS2D_RECON), x, 4, device="cpu")
    assert calls == [torch.float32] and frames.dtype == torch.float32
    runner.inference_rollout(params, _exp(GS2D_RECON), x.double(), 4, device="cpu")
    assert calls == [torch.float32]   # the f64 input did not reach the kernel wrapper


def test_f64_select_stable_candidate_matches_jax(tmp_path):
    """'best' in memory, 'latest' and 'stable' written in f64: the port
    loads them in f64, scores them with its f64 probe, and picks what
    percnn_tpu picks; the chosen model's rollout matches the jnp scan."""
    truth = _truth(1)
    jprob, prob = _problems(truth)
    models = {"best": _jmodel(0), "latest": _jmodel(1), "stable": _jmodel(2)}
    # the ISG of the checkpointed ones is the best model's, so only the
    # cells differ between the candidates
    for tag in ("latest", "stable"):
        models[tag]["isg"] = models["best"]["isg"]
    for tag, suffix in (("latest", ""), ("stable", ".stable")):
        checkpoint.save_checkpoint(str(tmp_path / f"port.npz{suffix}"),
                                   {"params": models[tag]})
        jcheckpoint.save_checkpoint(str(tmp_path / f"jax.npz{suffix}"),
                                    {"params": models[tag]})
    jprobe = jrunner.make_stability_probe(jprob, STEPS)
    jchosen, jrep = jrunner.select_stable_candidate(
        jax.tree_util.tree_map(jnp.asarray, models["best"]), jprob, str(tmp_path / "jax.npz"),
        jprobe)
    probe = runner.make_stability_probe(prob, STEPS)
    chosen, rep = runner.select_stable_candidate(
        bridge.params_from_numpy(models["best"], device="cpu"), str(tmp_path / "port.npz"),
        probe)
    assert rep["candidate"] == jrep["candidate"]
    assert sorted(rep["probe_scores"]) == sorted(jrep["probe_scores"]) == [
        "best", "latest", "stable"]
    for tag, score in jrep["probe_scores"].items():
        np.testing.assert_allclose(rep["probe_scores"][tag], score, rtol=1e-9)
    leaves = [t for _, t in checkpoint.flatten_with_paths(chosen)]
    assert all(t.dtype == torch.float64 for t in leaves)
    want = np.asarray(jrunner.inference_rollout(
        jax.tree_util.tree_map(jnp.asarray, jchosen), jprob, STEPS))
    got = runner.inference_rollout(chosen, _exp(GS2D_RECON), prob.ic_low[0], STEPS,
                                   device="cpu")
    _hold_frames(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_checkpointed_candidate_keeps_its_saved_dtype(tmp_path, dtype):
    tree = {"w": np.arange(3, dtype=np.float32 if dtype == torch.float32 else np.float64)}
    checkpoint.save_checkpoint(str(tmp_path / "c.npz"), {"params": tree})
    seen = []

    def probe(p):
        seen.append(p["w"].dtype)
        return 1.0

    runner.select_stable_candidate({"w": torch.zeros(3, dtype=dtype)}, str(tmp_path / "c.npz"),
                                   probe)
    assert seen == [dtype, dtype]
