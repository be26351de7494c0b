"""percnn_tpu_torch training path on the CPU against the JAX package: the
composite loss and its gradients over the whole model, the trainer's loss
trajectory, the ISG pretrain, checkpoints read across packages, a small
end-to-end run, and the rule that entry points run on CUDA unless told
device="cpu".

Bars: the loss terms share the forward's (rtol 2e-4); gradients the JAX
package's fused-kernel bar (rtol 2e-4, atol 2e-6); trajectories under Adam
rtol 1e-4.
"""

import dataclasses
import functools
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core import checkpoint as jcheckpoint
from percnn_tpu.core import train as jtrain
from percnn_tpu.experiments import runner as jrunner
from percnn_tpu.experiments.configs import GS2D_RECON as J_GS2D_RECON

from percnn_tpu_torch.bridge import params_from_numpy, params_to_numpy
from percnn_tpu_torch.core import checkpoint
from percnn_tpu_torch.core.train import TrainConfig, pretrain_isg, train
from percnn_tpu_torch.data.simulate import simulate
from percnn_tpu_torch.experiments import runner
from percnn_tpu_torch.experiments.ensemble import run_ensemble
from percnn_tpu_torch.experiments.configs import GS2D_RECON
from percnn_tpu_torch.parallel import make_mesh
from percnn_tpu_torch.data.io import save_npz
from percnn_tpu_torch.discovery.library import reconstruction_residual_mse
from percnn_tpu_torch.experiments import pipeline, stage3
from percnn_tpu_torch.experiments.stage3 import run_stage3
from percnn_tpu_torch.pde.systems import PDE_SYSTEMS
from percnn_tpu_torch.pde.terms import gen_library


@pytest.fixture(autouse=True)
def _figures_skipped(monkeypatch):
    """run_experiment's figures (tested in test_torch_viz.py) are skipped
    here, as where matplotlib is not installed: neither package's runs draw."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def _small(base):
    """The small GS2D problem of tests/test_train.py (16 x 16, hidden 4, T = 8)."""
    return dataclasses.replace(
        base, grid=16, train_steps=8, infer_steps=8, curriculum=(), isg_pretrain_iters=0,
        cell=dataclasses.replace(base.cell, hidden=4),
        data=dataclasses.replace(base.data, time_stride=4, space_stride=4),
        train=dataclasses.replace(base.train, n_iters=4, steps_per_call=2, log_every=100))


EXP, JEXP = _small(GS2D_RECON), _small(J_GS2D_RECON)


def _truth():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((9, 16, 16, 2)) * 0.1 + 0.3).astype(np.float32)


def _problems(exp=EXP, jexp=JEXP):
    truth = _truth()
    return jrunner.setup_problem(jexp, truth), runner.setup_problem(exp, truth, device="cpu")


def _params(seed=0, jexp=JEXP):
    jp = jrunner.init_model(jexp, jax.random.PRNGKey(seed))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _flat(tree):
    return [leaf for _, leaf in checkpoint.flatten_with_paths(tree)]


def test_build_loss_fn_matches_jax():
    jprob, prob = _problems()
    jp, npp = _params()
    jtotal, jaux = jrunner.build_loss_fn(jprob, 8)(jp)
    total, aux = runner.build_loss_fn(prob, 8)(params_from_numpy(npp, device="cpu"))
    assert sorted(aux) == sorted(jaux) == ["data", "ic", "phy", "val"]
    np.testing.assert_allclose(float(total), float(jtotal), rtol=2e-4)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=2e-4, err_msg=k)
    assert not aux["phy"].requires_grad  # 'phy' has no weight: a metric only


@pytest.mark.parametrize("bptt", ["auto", "remat"])
def test_loss_gradients_match_jax(bptt):
    """Gradients of the total over every leaf of the model, cell and ISG:
    through the fused Function ('auto') and through checkpointed autograd."""
    jprob, prob = _problems()
    jp, npp = _params(seed=1)
    jg = jax.grad(lambda p: jrunner.build_loss_fn(jprob, 8)(p)[0])(jp)
    tp = params_from_numpy(npp, device="cpu")
    leaves = _flat(tp)
    for t in leaves:
        t.requires_grad_(True)
    total, _ = runner.build_loss_fn(prob, 8, bptt=bptt)(tp)
    grads = torch.autograd.grad(total, leaves)
    jleaves = _flat(jax.tree_util.tree_map(np.asarray, jg))
    assert len(grads) == len(jleaves) == 1 + 2 * 8 + 6
    for (path, _), got, want in zip(checkpoint.flatten_with_paths(tp), grads, jleaves):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-6, err_msg=path)


def test_train_history_matches_jax():
    jprob, prob = _problems()
    jp, npp = _params(seed=2)
    _, jhist = jtrain.train(jrunner.build_loss_fn(jprob, 8), jp, JEXP.train)
    params, hist = train(runner.build_loss_fn(prob, 8), npp, EXP.train, device="cpu")
    assert len(hist) == len(jhist) == 4
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    assert params["cell"]["diff"].device.type == "cpu"


def test_train_schedule_matches_optax():
    """Adam and the StepLR staircase alone, on a quadratic: 60 steps over
    three lr steps follow optax's trajectory."""
    target = np.array([1.0, -2.0, 3.0], np.float32)

    def jloss(p):
        l = jnp.sum((p["w"] - target) ** 2)
        return l, {"val": l}

    def loss(p):
        l = torch.sum((p["w"] - torch.from_numpy(target)) ** 2)
        return l, {"val": l}

    kw = dict(n_iters=60, lr=0.1, lr_step=20, lr_gamma=0.5, steps_per_call=7)
    _, jhist = jtrain.train(jloss, {"w": jnp.zeros(3, jnp.float32)}, jtrain.TrainConfig(**kw))
    params, hist = train(loss, {"w": np.zeros(3, np.float32)}, TrainConfig(**kw), device="cpu")
    np.testing.assert_allclose(hist, jhist, rtol=1e-5, atol=1e-7)


def test_pretrain_isg_matches_jax():
    jprob, prob = _problems()
    jp, npp = _params(seed=3)
    jisg = jtrain.pretrain_isg(jrunner.build_isg_pretrain_loss(jprob), jp["isg"], n_iters=6,
                               steps_per_call=4)
    isg = pretrain_isg(runner.build_isg_pretrain_loss(prob), npp["isg"], n_iters=6,
                       steps_per_call=4, device="cpu")
    for k in jisg:
        np.testing.assert_allclose(isg[k].numpy(), np.asarray(jisg[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_train_resume_continues_the_trajectory(tmp_path):
    """A run cut at iteration 4 and resumed from its checkpoint (params and
    Adam moments) continues as the uninterrupted run does."""
    _, prob = _problems()
    _, npp = _params(seed=4)
    lf = runner.build_loss_fn(prob, 8)
    cfg = dataclasses.replace(EXP.train, n_iters=6, ckpt_path=str(tmp_path / "c.npz"),
                              ckpt_every=2)
    _, straight = train(lf, npp, dataclasses.replace(cfg, ckpt_path=None), device="cpu")
    train(lf, npp, dataclasses.replace(cfg, n_iters=4), extra_meta={"stage": 1}, device="cpu")
    assert checkpoint.peek_meta(cfg.ckpt_path) == {"iteration": 4, "lr_scale": 1.0,
                                                   "best_val": None, "stage": 1}
    _, rest = train(lf, npp, cfg, resume=True, device="cpu")
    assert len(rest) == 2
    np.testing.assert_allclose(rest, straight[4:], rtol=1e-6)


def test_best_key_keeps_the_best_iterate(tmp_path):
    def loss(p):
        w = p["w"]
        return -torch.sum(w), {"data": torch.sum((w - 2.0) ** 2)}

    cfg = TrainConfig(n_iters=400, lr=0.02, best_key="data", steps_per_call=10,
                      ckpt_path=str(tmp_path / "bk.npz"), ckpt_every=1000)
    params, _ = train(loss, {"w": np.zeros(2, np.float32)}, cfg, device="cpu")
    assert np.all(np.abs(params["w"].numpy() - 2.0) < 0.3)
    best, _ = checkpoint.load_checkpoint_tree(cfg.ckpt_path + ".best")
    np.testing.assert_array_equal(best["params"]["w"], params["w"].numpy())


def test_checkpoints_read_across_packages(tmp_path):
    _, npp = _params(seed=5)
    tp = params_from_numpy(npp, device="cpu")
    port_path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(port_path, {"params": tp, "opt_state": {"step": np.float32(3)}},
                               {"iteration": 3})
    tree, meta = jcheckpoint.load_checkpoint_tree(port_path)
    assert meta == {"iteration": 3} and float(tree["opt_state"]["step"]) == 3.0
    for a, b in zip(_flat(tree["params"]), _flat(npp)):
        np.testing.assert_array_equal(a, b)
    # the JAX package's template loader reads a port parameter file
    like = jax.tree_util.tree_map(jnp.zeros_like, _params(seed=6)[0])
    got, _ = jcheckpoint.load_checkpoint(port_path, {"params": like})
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]), jax.tree_util.tree_leaves(npp)):
        np.testing.assert_array_equal(np.asarray(a), b)

    # and the reverse: the JAX package's trainer checkpoint, optax state included
    jprob, _ = _problems()
    jp, _ = _params(seed=7)
    jax_path = str(tmp_path / "jax.npz")
    jtrain.train(jrunner.build_loss_fn(jprob, 8), jp,
                 dataclasses.replace(JEXP.train, n_iters=2, ckpt_path=jax_path))
    jtree, _ = jcheckpoint.load_checkpoint_tree(jax_path)
    tree, meta = checkpoint.load_checkpoint_tree(jax_path)
    assert meta["iteration"] == 2
    for a, b in zip(_flat(tree["params"]), _flat(jtree["params"])):
        np.testing.assert_array_equal(a, b)
    loaded, _ = checkpoint.load_checkpoint(jax_path, {"params": tp})
    assert loaded["params"]["cell"]["pi"][1]["w2"].dtype == torch.float32
    np.testing.assert_array_equal(params_to_numpy(loaded["params"])["isg"]["up0_w"],
                                  jtree["params"]["isg"]["up0_w"])


def test_run_experiment_trains_on_cpu(tmp_path):
    """16 x 16, hidden 4, T = 8, 20 iterations: the loss falls and the
    evaluation is finite."""
    exp = dataclasses.replace(EXP, train=dataclasses.replace(EXP.train, n_iters=20,
                                                             steps_per_call=5))
    res = runner.run_experiment(exp, out_dir=str(tmp_path), cache_dir=None,
                                isg_pretrain_override=20, device="cpu")
    hist = res["history"]
    assert len(hist) == 20 and np.isfinite(hist).all()
    assert hist[-1] < hist[0]
    assert np.isfinite(res["rel_l2"]) and not res["diverged"]
    assert res["frames"].shape == (9, 16, 16, 2) and res["stable_frames"] == 9
    assert res["final_stage_min_loss"] == min(hist)
    tree, meta = checkpoint.load_checkpoint_tree(str(tmp_path / f"{exp.name}.ckpt.npz"))
    assert meta["iteration"] == 20 and meta["stage"] == 0
    np.testing.assert_array_equal(tree["params"]["cell"]["diff"],
                                  res["params"]["cell"]["diff"].numpy())


def test_run_experiment_resume_reenters_the_curriculum(tmp_path):
    exp = dataclasses.replace(EXP, curriculum=(4,), train=dataclasses.replace(
        EXP.train, n_iters=8, steps_per_call=2))
    runner.run_experiment(exp, out_dir=str(tmp_path), cache_dir=None,
                          isg_pretrain_override=2, device="cpu")
    res = runner.run_experiment(exp, out_dir=str(tmp_path), cache_dir=None, resume=True,
                                device="cpu")
    assert res["history"] == []  # both stages were complete
    assert np.isfinite(res["rel_l2"])


def test_forward_rollout_dispatch():
    _, prob = _problems()
    _, npp = _params()
    tp = params_from_numpy(npp, device="cpu")
    for t in _flat(tp):
        t.requires_grad_(True)
    fused = runner.forward_rollout(tp, prob, 4, device="cpu")
    assert fused.grad_fn is not None and "FusedRolloutTP2dPG" in type(fused.grad_fn).__name__
    plain = runner.forward_rollout(tp, prob, 4, bptt="remat", device="cpu")
    np.testing.assert_allclose(fused.detach().numpy(), plain.detach().numpy(),
                               rtol=2e-4, atol=1e-5)
    # 'fused' (rollout2d_kernel, adj2d_kernel, chunked_param_grads) and
    # 'two_phase' (rollout_tp) of the 1x1 cell: the frames, and the gradient
    # of every leaf against percnn_tpu's forward_rollout on the same route
    jprob, _ = _problems()
    jp, _ = _params()
    for bptt, fn in (("fused", "FusedRolloutTP2d"), ("two_phase", "_RolloutTP")):
        frames = runner.forward_rollout(tp, prob, 4, bptt=bptt, device="cpu")
        assert type(frames.grad_fn).__name__.startswith(fn)
        np.testing.assert_allclose(frames.detach().numpy(), plain.detach().numpy(),
                                   rtol=2e-4, atol=1e-5)
        grads = torch.autograd.grad(frames.square().mean(), _flat(tp))
        jg = jax.grad(lambda p: jnp.mean(jrunner.forward_rollout(p, jprob, 4, bptt=bptt) ** 2))(jp)
        for got, want in zip(grads, _flat(jax.tree_util.tree_map(np.asarray, jg))):
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-6)


_ENTRY_POINTS = {
    "simulate": lambda dev: simulate("gray_scott_2d", np.full((8, 8, 2), 0.5), 1, 0.5, 0.01,
                                     **dev),
    "make_dataset": lambda dev: runner.make_dataset(
        dataclasses.replace(EXP, grid=8, train_steps=1, infer_steps=1), **dev),
    "train": lambda dev: train(lambda p: (p["w"].square().sum(), {}),
                               {"w": np.ones(1, np.float32)}, TrainConfig(n_iters=1), **dev),
    "pretrain_isg": lambda dev: pretrain_isg(lambda p: p["w"].square().sum(),
                                             {"w": np.ones(1, np.float32)}, n_iters=1, **dev),
    "forward_rollout": lambda dev: runner.forward_rollout(
        params_from_numpy(_params()[1], device="cpu"), _problems()[1], 2, **dev),
    "run_experiment": lambda dev: runner.run_experiment(
        dataclasses.replace(EXP, grid=12, train_steps=4, infer_steps=4, train=dataclasses.replace(
            EXP.train, n_iters=1)), out_dir=dev.pop("out_dir"), cache_dir=None,
        isg_pretrain_override=1, **dev),
    "make_mesh": lambda dev: make_mesh(("x", "y"), devices=[dev["device"]] if dev else None),
    "run_experiment_mesh": lambda dev: runner.run_experiment(
        dataclasses.replace(EXP, grid=12, train_steps=4, infer_steps=4, train=dataclasses.replace(
            EXP.train, n_iters=1)), out_dir=dev.pop("out_dir"), cache_dir=None,
        isg_pretrain_override=1, mesh=make_mesh(("x", "y"), shape=(2, 2),
                                                devices=[dev.get("device", "cuda")] * 4), **dev),
    "run_ensemble": lambda dev: run_ensemble(
        dataclasses.replace(EXP, grid=12, train_steps=4, infer_steps=4, train=dataclasses.replace(
            EXP.train, n_iters=1)), 2, out_dir=dev.pop("out_dir"), cache_dir=None,
        isg_pretrain_override=1, bptt="batched_pg", **dev),
    "reconstruction_residual_mse": lambda dev: reconstruction_residual_mse(
        np.full((4, 8, 8, 2), 0.5), PDE_SYSTEMS["lambda_omega"], 0.0125, 0.2, **dev),
    "run_stage3": lambda dev: run_stage3(
        dataclasses.replace(stage3.burgers_stage3(_tiny_burgers()),
                            train=TrainConfig(n_iters=1, log_every=100)),
        np.full((5, 8, 8, 2), 0.5), out_dir=dev.pop("out_dir"), isg_pretrain_iters=1, **dev),
    "run_discovery_pipeline": lambda dev: _short_stage3(pipeline.run_discovery_pipeline)(
        _tiny_burgers(), out_dir=dev["out_dir"], cache_dir=None, stage3_iters=1,
        stage1_recon=_recon_file(dev.pop("out_dir")), stage2_frames=slice(0, 8), **dev),
    "run_stage3_from_coefs": lambda dev: _short_stage3(pipeline.run_stage3_from_coefs)(
        _tiny_burgers(), _coefs_file(dev["out_dir"]), out_dir=dev.pop("out_dir"),
        cache_dir=None, stage3_iters=1, **dev),
    "run_ensemble_discovery": lambda dev: _short_stage3(pipeline.run_ensemble_discovery)(
        _tiny_burgers(), 1, out_dir=dev["out_dir"], cache_dir=None, stage3_iters=1,
        member_recons=[_recon_file(dev.pop("out_dir"))], stage2_frames=slice(0, 8), **dev),
}
_WRITE_FILES = ("run_experiment", "run_experiment_mesh", "run_ensemble", "run_stage3",
                "run_discovery_pipeline", "run_stage3_from_coefs", "run_ensemble_discovery")


def _short_stage3(entry):
    """`entry` with the pipeline's Stage 3 pretraining its ISG for 1
    iteration, not 2000."""
    def call(*args, **kw):
        with mock.patch.object(pipeline, "run_stage3",
                               functools.partial(run_stage3, isg_pretrain_iters=1)):
            return entry(*args, **kw)

    return call


def _tiny_burgers():
    from percnn_tpu_torch.experiments.configs import BURGERS_STAGE1

    return dataclasses.replace(
        BURGERS_STAGE1, grid=8, train_steps=4, infer_steps=4,
        data=dataclasses.replace(BURGERS_STAGE1.data, time_stride=2, space_stride=2))


def _recon_file(out_dir):
    """A saved 9-frame 8 x 8 reconstruction (the pipeline's stage1_recon)."""
    path = os.path.join(out_dir, "recon.npz")
    rng = np.random.default_rng(0)
    save_npz(path, (rng.standard_normal((9, 8, 8, 2)) * 0.3).astype(np.float32))
    return path


def _coefs_file(out_dir):
    """A saved Stage-2 support: nu and one advection term an equation."""
    names = gen_library()
    w_u, w_v = np.zeros((70, 1)), np.zeros((70, 1))
    w_u[names.index("ones*lap_u")], w_u[names.index("u*u_x")] = 0.005, -1.0
    w_v[names.index("ones*lap_v")], w_v[names.index("v*v_y")] = 0.005, -1.0
    path = os.path.join(out_dir, "coefs.npz")
    np.savez(path, w_u=w_u, w_v=w_v, names=np.asarray(names))
    return path


@pytest.mark.parametrize("name", list(_ENTRY_POINTS))
def test_entry_points_need_cuda_unless_told_cpu(monkeypatch, tmp_path, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[name]({"out_dir": str(tmp_path)} if name in _WRITE_FILES else {})
    _ENTRY_POINTS[name]({"device": "cpu", **({"out_dir": str(tmp_path)}
                                             if name in _WRITE_FILES else {})})
