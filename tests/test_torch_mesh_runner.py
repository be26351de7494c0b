"""Spatially decomposed training through the port's public entry points, on
the CPU: ``run_experiment(mesh=...)`` against the same run without a mesh
(as tests/test_parallel.py holds percnn_tpu's), the mesh's errors, and the
``run`` CLI verb with ``--mesh``.  The mesh repeats "cpu"; on the card
chip_smoke.py runs the same path with a mesh that repeats cuda:0.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from percnn_tpu_torch import __main__ as cli
from percnn_tpu_torch.experiments import configs, runner
from percnn_tpu_torch.experiments.configs import GS2D_RECON
from percnn_tpu_torch.parallel import make_mesh

EXP = dataclasses.replace(
    GS2D_RECON, grid=16, train_steps=12, infer_steps=12, curriculum=(),
    data=dataclasses.replace(GS2D_RECON.data, time_stride=3),
    train=dataclasses.replace(GS2D_RECON.train, n_iters=8, log_every=1000, steps_per_call=4))


def _mesh(shape=(2, 2)):
    return make_mesh(("x", "y"), shape=shape, devices=["cpu"] * int(np.prod(shape)))


def _run(tmp_path, label, **kw):
    return runner.run_experiment(EXP, out_dir=str(tmp_path / label), cache_dir=str(tmp_path / "c"),
                                 isg_pretrain_override=10, seed=0, device="cpu", **kw)


def test_run_experiment_mesh_matches_single_device(tmp_path):
    """The decomposed run (eager autograd across the exchange) against the
    unsharded one (the fused pg route's plain versions): the first losses at
    rtol 1e-4 and the rel-L2 within 2e-2, percnn_tpu's own bars."""
    ref = _run(tmp_path, "single")
    got = _run(tmp_path, "mesh", mesh=_mesh())
    np.testing.assert_allclose(got["history"][:5], ref["history"][:5], rtol=1e-4)
    assert len(got["history"]) == EXP.train.n_iters and np.isfinite(got["history"]).all()
    assert abs(got["rel_l2"] - ref["rel_l2"]) < 2e-2
    assert got["params"]["cell"]["diff"].device == torch.device("cpu")


def test_mesh_rollout_fn_errors(tmp_path):
    truth = runner.make_dataset(EXP, cache_dir=None, device="cpu")
    prob = runner.setup_problem(EXP, truth, device="cpu")
    with pytest.raises(ValueError, match="not divisible by mesh axis x=3"):
        runner.make_mesh_rollout_fn(prob, 4, _mesh((3, 1)))
    with pytest.raises(ValueError, match="fewer axes"):
        runner.make_mesh_rollout_fn(prob, 4, make_mesh(("x",), devices=["cpu"] * 2))
    with pytest.raises(NotImplementedError, match="A10"):
        runner.make_mesh_rollout_fn(prob, 4, _mesh(), impl="gspmd")
    with pytest.raises(ValueError, match="unknown parallel impl"):
        runner.make_mesh_rollout_fn(prob, 4, _mesh(), impl="dtensor")
    frames = runner.make_mesh_rollout_fn(prob, 4, _mesh())(
        runner.init_model(EXP, torch.Generator().manual_seed(0), device="cpu"))
    assert frames.shape == (5, EXP.grid, EXP.grid, 2)


def test_run_experiment_mesh_errors(tmp_path):
    with pytest.raises(NotImplementedError, match="gspmd"):
        _run(tmp_path, "gspmd", mesh=_mesh(), parallel_impl="gspmd")
    with pytest.raises(ValueError, match="not divisible"):
        _run(tmp_path, "odd", mesh=_mesh((3, 1)))
    meta = make_mesh(("x", "y"), shape=(1, 1), devices=["meta"])
    with pytest.raises(ValueError, match="first device meta is not the run's device cpu"):
        _run(tmp_path, "elsewhere", mesh=meta)


def test_cli_run_verb_with_mesh(monkeypatch, tmp_path, capsys):
    """`python -m percnn_tpu_torch run gs2d_recon --cpu --mesh 2,2` trains the
    shrunk config on a 2 x 2 mesh of CPU entries and prints percnn_tpu's
    JSON line; the mesh forms parse to the run's mesh."""
    monkeypatch.setattr(configs, "EXPERIMENTS", {**configs.EXPERIMENTS, "gs2d_recon": EXP})
    argv = ["run", "gs2d_recon", "--cpu", "--mesh", "2,2", "--iters", "2", "--isg-iters", "3",
            "--out", str(tmp_path / "o"), "--cache", str(tmp_path / "c")]
    assert cli.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["experiment"] == "gs2d_recon" and np.isfinite(line["rel_l2"])
    calls = []
    monkeypatch.setattr(runner, "run_experiment",
                        lambda exp, **kw: calls.append(kw) or {"rel_l2": 0.5, "history": [1.0]})
    for form, shape in (("2x2", {"x": 2, "y": 2}), ("4,1", {"x": 4, "y": 1}),
                        ("auto", {"x": 1, "y": 1})):
        cli.main(["run", "gs2d_recon", "--cpu", "--mesh", form])
        kw = calls[-1]
        assert kw["mesh"].shape == shape and kw["device"] == torch.device("cpu")
        assert kw["parallel_impl"] == "halo"
    cli.main(["run", "gs2d_recon", "--cpu", "--iters", "6", "--x64", "--parallel", "gspmd"])
    assert calls[-1]["mesh"] is None and calls[-1]["dtype"] == torch.float64
    assert calls[-1]["n_iters_override"] == 6 and calls[-1]["parallel_impl"] == "gspmd"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "gs2d_recon", "--mesh", "2,2"])
