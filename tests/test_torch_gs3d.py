"""The GS3D path of percnn_tpu_torch on the CPU against percnn_tpu: the
config, the initial condition and the f64 RK4 truth, the trilinear IC
target, the composite loss and its gradients over the whole model, the
stability probe, inference and serving, and run_experiment(GS3D_RECON)
shrunk, with the probe on.

Bars: the truth agrees to f64 rounding (atol 1e-12); the loss terms share
the forward's bar (rtol 2e-4); gradients the fused kernels' (rtol 2e-4,
atol 2e-6); rollouts rtol 2e-4 / atol 1e-5; trajectories under Adam rtol
1e-4.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core import losses as jlosses
from percnn_tpu.data.simulate import default_ic as j_default_ic, simulate as j_simulate
from percnn_tpu.experiments import runner as jrunner
from percnn_tpu.experiments.configs import GS3D_RECON as J_GS3D_RECON
from percnn_tpu.serving import build_serving_fn as j_build_serving_fn

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core import checkpoint, losses
from percnn_tpu_torch.data.simulate import default_ic, simulate
from percnn_tpu_torch.experiments import runner
from percnn_tpu_torch.experiments.configs import GS3D_RECON
from percnn_tpu_torch.serving import build_serving_fn


@pytest.fixture(autouse=True)
def _figures_skipped(monkeypatch):
    """run_experiment's figures (tested in test_torch_viz.py) are skipped
    here, as where matplotlib is not installed: neither package's runs draw."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_gs3d_config_matches_jax():
    assert dataclasses.asdict(GS3D_RECON) == dataclasses.asdict(J_GS3D_RECON)
    assert GS3D_RECON.isg.scale == J_GS3D_RECON.isg.scale == 2


@pytest.mark.parametrize("n,seed", [(12, 66), (16, 3)])
def test_default_ic_matches_jax(n, seed):
    ic = default_ic("gray_scott_3d", n, seed=seed)
    assert ic.shape == (n, n, n, 2) and ic.dtype == np.float64
    np.testing.assert_array_equal(ic, j_default_ic("gray_scott_3d", n, seed=seed))


def test_simulate_gs3d_matches_jax_f64():
    """12^3, 3 frames of 4 RK4 substeps at GS3D's dt and dx, in f64."""
    h0 = default_ic("gray_scott_3d", 12, seed=5)
    want = j_simulate("gray_scott_3d", h0, 3, 0.5, 100 / 48)
    got = simulate("gray_scott_3d", h0, 3, 0.5, 100 / 48, device="cpu")
    assert got.dtype == np.float64 and got.shape == want.shape == (4, 12, 12, 12, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert not np.allclose(got[-1], got[0])


def test_trilinear_ic_target_and_loss_match_jax():
    """GS3D's IC target: trilinear, align_corners=False, 12^3 -> 24^3."""
    rng = np.random.RandomState(2)
    low = (0.5 + 0.2 * rng.standard_normal((1, 12, 12, 12, 2))).astype(np.float32)
    out = (0.5 + 0.2 * rng.standard_normal((1, 24, 24, 24, 2))).astype(np.float32)
    want_t = np.asarray(jlosses.ic_target(jnp.asarray(low), (24, 24, 24), 3, "linear"))
    got_t = losses.ic_target(torch.from_numpy(low), (24, 24, 24), 3, "linear").numpy()
    np.testing.assert_allclose(got_t, want_t, rtol=1e-5, atol=1e-6)
    want = float(jlosses.ic_loss(jnp.asarray(out), jnp.asarray(low), 3, "linear"))
    got = float(losses.ic_loss(torch.from_numpy(out), torch.from_numpy(low), 3, "linear"))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _small(base):
    """12^3 (ISG 6^3 -> 12^3), T = 6, measurements every 3 frames."""
    return dataclasses.replace(
        base, grid=12, train_steps=6, infer_steps=6, curriculum=(), isg_pretrain_iters=0,
        data=dataclasses.replace(base.data, time_stride=3, space_stride=2),
        train=dataclasses.replace(base.train, n_iters=4, steps_per_call=2, log_every=100))


EXP, JEXP = _small(GS3D_RECON), _small(J_GS3D_RECON)


def _truth():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((7, 12, 12, 12, 2)) * 0.1 + 0.3).astype(np.float32)


def _problems():
    truth = _truth()
    return jrunner.setup_problem(JEXP, truth), runner.setup_problem(EXP, truth, device="cpu")


def _params(seed=0):
    jp = jrunner.init_model(JEXP, jax.random.PRNGKey(seed))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _flat(tree):
    return [leaf for _, leaf in checkpoint.flatten_with_paths(tree)]


def test_build_loss_fn_matches_jax():
    jprob, prob = _problems()
    jp, npp = _params()
    jtotal, jaux = jrunner.build_loss_fn(jprob, 6)(jp)
    total, aux = runner.build_loss_fn(prob, 6)(params_from_numpy(npp, device="cpu"))
    assert sorted(aux) == sorted(jaux) == ["data", "ic", "phy", "val"]
    np.testing.assert_allclose(float(total), float(jtotal), rtol=2e-4)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=2e-4, atol=1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("bptt", ["auto", "remat"])
def test_loss_gradients_match_jax(bptt):
    """Gradients of the total over every leaf of the model, cell and ISG:
    through the fused 3D Function ('auto') and through checkpointed
    autograd ('remat')."""
    jprob, prob = _problems()
    jp, npp = _params(seed=1)
    jg = jax.grad(lambda p: jrunner.build_loss_fn(jprob, 6)(p)[0])(jp)
    tp = params_from_numpy(npp, device="cpu")
    leaves = _flat(tp)
    for t in leaves:
        t.requires_grad_(True)
    total, _ = runner.build_loss_fn(prob, 6, bptt=bptt)(tp)
    grads = torch.autograd.grad(total, leaves)
    jleaves = _flat(jax.tree_util.tree_map(np.asarray, jg))
    assert len(grads) == len(jleaves) == 1 + 2 * 8 + 6
    for (path, _), got, want in zip(checkpoint.flatten_with_paths(tp), grads, jleaves):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-6, err_msg=path)


def test_forward_rollout_picks_the_fused_3d_function():
    _, prob = _problems()
    _, npp = _params()
    tp = params_from_numpy(npp, device="cpu")
    for t in _flat(tp):
        t.requires_grad_(True)
    fused = runner.forward_rollout(tp, prob, 4, device="cpu")
    assert "FusedRolloutTP3dPG" in type(fused.grad_fn).__name__
    plain = runner.forward_rollout(tp, prob, 4, bptt="remat", device="cpu")
    np.testing.assert_allclose(fused.detach().numpy(), plain.detach().numpy(),
                               rtol=2e-4, atol=1e-5)


def test_inference_and_probe_match_jax():
    """inference_rollout (fused 3D rollout from the ISG output) and the
    stability probe's score, against JAX's on the same model; 16^3 so that
    JAX takes its Pallas kernel (interpret mode)."""
    jexp = dataclasses.replace(JEXP, grid=16, infer_steps=5, train_steps=5)
    exp = dataclasses.replace(EXP, grid=16, infer_steps=5, train_steps=5)
    truth = (np.random.default_rng(1).standard_normal((6, 16, 16, 16, 2)) * 0.1
             + 0.3).astype(np.float32)
    jprob = jrunner.setup_problem(jexp, truth)
    prob = runner.setup_problem(exp, truth, device="cpu")
    jp = jrunner.init_model(jexp, jax.random.PRNGKey(4))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    want = np.asarray(jrunner.inference_rollout(jp, jprob, 5))
    got = runner.inference_rollout(tp, exp, prob.ic_low[0], 5, device="cpu")
    assert got.shape == want.shape == (6, 16, 16, 16, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)
    j_score = jrunner.make_stability_probe(jprob, 5)(jp)
    score = runner.make_stability_probe(prob, 5)(tp)
    np.testing.assert_allclose(score, j_score, rtol=2e-4)


@pytest.mark.parametrize("final_only", [False, True], ids=["frames", "final"])
def test_serving_matches_jax(final_only):
    """build_serving_fn for a 3D model: the ISG 6^3 -> 12^3, then 6 steps;
    JAX serves 3D with its jnp rollout."""
    jp, npp = _params(seed=2)
    x = np.random.RandomState(3).uniform(0.0, 1.0, (6, 6, 6, 2)).astype(np.float32)
    want = np.asarray(j_build_serving_fn(jp, JEXP.cell, 6, isg_cfg=JEXP.isg,
                                         final_only=final_only)(jnp.asarray(x)))
    got = build_serving_fn(npp, EXP.cell, 6, isg_cfg=EXP.isg, final_only=final_only,
                           device="cpu")(x)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == ((12, 12, 12, 2) if final_only else (7, 12, 12, 12, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


def _smoke(base):
    """tests/test_train.py:259's GS3D run: 16^3, T = 20, 30 iterations, 60
    ISG pretrain iterations, 5% noise; here with the probe every 10."""
    return dataclasses.replace(
        base, grid=16, train_steps=20, infer_steps=20, curriculum=(),
        data=dataclasses.replace(base.data, time_stride=5, space_stride=2),
        train=dataclasses.replace(base.train, n_iters=30, log_every=20, probe_every=10),
        isg_pretrain_iters=60, noise_pct=0.05)


def test_run_experiment_gs3d_matches_jax(tmp_path, monkeypatch):
    """Both runners from the same init, the robustness family and the probe
    on: the truth, the histories, the candidate and its probe scores, and the
    evaluation agree."""
    exp, jexp = _smoke(GS3D_RECON), _smoke(J_GS3D_RECON)
    jinit = jax.tree_util.tree_map(np.asarray, jrunner.init_model(jexp, jax.random.PRNGKey(0)))
    monkeypatch.setattr(runner, "init_model",
                        lambda exp, gen, dtype=torch.float32, device="cuda":
                        params_from_numpy(jinit, device=device, dtype=dtype))
    jres = jrunner.run_experiment(jexp, out_dir=str(tmp_path / "jax"), cache_dir=None, seed=0)
    res = runner.run_experiment(exp, out_dir=str(tmp_path / "port"), cache_dir=None, seed=0,
                                device="cpu")
    hist = np.asarray(res["history"])
    assert len(hist) == 30 and np.isfinite(hist).all() and hist[-1] < hist[0]
    np.testing.assert_allclose(hist, jres["history"], rtol=1e-4)
    assert res["frames"].shape == (21, 16, 16, 16, 2) and not res["diverged"]
    assert res["candidate"] == jres["candidate"]
    for k, s in jres["probe_scores"].items():
        np.testing.assert_allclose(res["probe_scores"][k], s, rtol=1e-3)
    np.testing.assert_allclose(res["rel_l2"], jres["rel_l2"], rtol=1e-3)
    _, meta = checkpoint.load_checkpoint_tree(str(tmp_path / "port" / "gs3d_recon.ckpt.npz"))
    assert meta["iteration"] == 30 and meta["stage"] == 0
    assert set(res["seconds"]) >= {"truth", "isg_pretrain", "stages", "select", "evaluate"}
