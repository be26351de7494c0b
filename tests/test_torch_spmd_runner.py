"""The GSPMD counterparts through the port's public entry points, on the
CPU: ``run_experiment(mesh=, parallel_impl="gspmd")`` and
``run_ensemble(mesh=, spatial_axes=)`` against the same runs without a
mesh, and the ``ensemble --shard`` and ``run --parallel gspmd`` verbs.

The ranks are gloo processes that parallel.launch spawns on meshes of
"cpu".  They import afresh, so what this process hides (matplotlib, sympy)
they see: rank 0 draws a gspmd run's figures where matplotlib is
installed, and the pi_expressions are the launching process's.
Bars: percnn_tpu's own in tests/test_parallel.py (the first losses at rtol
1e-4 and the rel-L2 within 2e-2 for the decomposed run; the ensemble's
history and members' rel-L2 at rtol 1e-3).
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from percnn_tpu_torch import __main__ as cli
from percnn_tpu_torch.experiments import configs, ensemble, runner
from percnn_tpu_torch.experiments.configs import GS2D_RECON
from percnn_tpu_torch.parallel import make_mesh


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    """No figures and no pi_expressions in this process: these tests are
    about the runs' numbers.  torch._dynamo, which torch.optim imports at
    its first step, imports sympy: it comes first."""
    import torch._dynamo  # noqa: F401

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "sympy", None)


MATPLOTLIB = importlib.util.find_spec("matplotlib") is not None

EXP = dataclasses.replace(
    GS2D_RECON, grid=16, train_steps=6, infer_steps=6, curriculum=(),
    data=dataclasses.replace(GS2D_RECON.data, time_stride=2),
    train=dataclasses.replace(GS2D_RECON.train, n_iters=5, log_every=1000, steps_per_call=5))

ENS = dataclasses.replace(
    GS2D_RECON, grid=16, train_steps=6, infer_steps=6, curriculum=(), isg_pretrain_iters=5,
    data=dataclasses.replace(GS2D_RECON.data, time_stride=2),
    train=dataclasses.replace(GS2D_RECON.train, n_iters=3, log_every=100))


def _cpu_mesh(names, shape):
    return make_mesh(names, shape=shape, devices=["cpu"] * int(np.prod(shape)))


def test_run_experiment_gspmd_matches_single_device(tmp_path):
    """run_experiment on a 2 x 2 mesh of CPU ranks, parallel_impl="gspmd",
    against the unsharded run: the first losses at rtol 1e-4, the rel-L2
    within 2e-2; the params come back on the run's device; rank 0 alone
    wrote the log (each line once), the checkpoint and the figures, and
    logged the placements DTensor gave the frames and the loss."""
    kw = dict(cache_dir=str(tmp_path / "c"), isg_pretrain_override=10, seed=0, device="cpu")
    ref = runner.run_experiment(EXP, out_dir=str(tmp_path / "single"), **kw)
    got = runner.run_experiment(EXP, out_dir=str(tmp_path / "gspmd"), parallel_impl="gspmd",
                                mesh=_cpu_mesh(("x", "y"), (2, 2)), **kw)
    np.testing.assert_allclose(got["history"][:5], ref["history"][:5], rtol=1e-4)
    assert len(got["history"]) == EXP.train.n_iters and np.isfinite(got["history"]).all()
    assert abs(got["rel_l2"] - ref["rel_l2"]) < 2e-2
    assert got["params"]["cell"]["diff"].device == torch.device("cpu")
    assert got["placements"] == {"frames": "(Shard(dim=1), Shard(dim=2))",
                                 "loss": "(Replicate(), Replicate())"}
    assert "pi_expressions" not in got and "pi_expressions" not in ref
    out = tmp_path / "gspmd"
    written = set(os.listdir(out))
    assert {f"{EXP.name}.ckpt.npz", f"{EXP.name}.metrics.jsonl"} <= written
    assert (f"{EXP.name}.panel.png" in written) == MATPLOTLIB
    with open(out / f"{EXP.name}.metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    events = [line.get("event") for line in lines]
    assert events.count("gspmd_placements") == 1
    finals = [line for line in lines if "final_rel_l2" in line]
    assert len(finals) == 1 and finals[0]["final_rel_l2"] == pytest.approx(got["rel_l2"])


@pytest.mark.parametrize("case", ["spatial_two_phase", "batched_pg", "fused_pg_spatial"])
def test_ensemble_on_a_mesh_matches_unsharded(tmp_path, case):
    """run_ensemble with the members sharded over CPU ranks against the same
    run without a mesh, history and members' rel-L2 at rtol 1e-3:
    two members on a (data, x, y) = (2, 2, 1) mesh with spatial_axes
    ("x",) by the mode "auto" takes there ("two_phase", each member cut over
    x); "batched_pg" on a ("data",) mesh of 2 (each rank's member through
    the batched kernels' plain versions); "fused_pg" on a (data, x) =
    (2, 2) mesh with spatial_axes ("x",) (the field gathered whole on x
    for the kernels)."""
    names, shape, spatial, bptt, want_mode = {
        "spatial_two_phase": (("data", "x", "y"), (2, 2, 1), ("x",), "auto", "two_phase"),
        "batched_pg": (("data",), (2,), (), "batched_pg", "batched_pg"),
        "fused_pg_spatial": (("data", "x"), (2, 2), ("x",), "fused_pg", "fused_pg"),
    }[case]
    mesh = _cpu_mesh(names, shape)
    assert ensemble.auto_bptt(ENS, mesh=mesh) == "two_phase"
    kw = dict(cache_dir=str(tmp_path / "c"), isg_pretrain_override=5, seed=0, device="cpu")
    ref = ensemble.run_ensemble(ENS, 2, out_dir=str(tmp_path / "single"), bptt=want_mode, **kw)
    got = ensemble.run_ensemble(ENS, 2, out_dir=str(tmp_path / "mesh"), mesh=mesh,
                                spatial_axes=spatial, bptt=bptt, **kw)
    np.testing.assert_allclose(got["history"], ref["history"], rtol=1e-3)
    np.testing.assert_allclose(got["rel_l2_members"], ref["rel_l2_members"], rtol=1e-3)
    assert got["params"]["cell"]["diff"].shape == ref["params"]["cell"]["diff"].shape == (2, 2)
    torch.testing.assert_close(got["params"]["isg"]["out_w"], ref["params"]["isg"]["out_w"],
                               rtol=1e-3, atol=1e-5)
    assert sorted(os.listdir(tmp_path / "mesh")) == [f"{ENS.name}.ens.ckpt.npz",
                                                     f"{ENS.name}.ens.metrics.jsonl"]


def test_cli_shard_and_gspmd_verbs(monkeypatch, tmp_path, capsys):
    """`ensemble gs2d_recon --shard --cpu` trains the shrunk config with its
    members on a ("data",) mesh of one CPU rank and prints percnn_tpu's JSON
    line; `run gs2d_recon --cpu --mesh 2,1 --parallel gspmd` reaches the
    gspmd route on two CPU ranks."""
    monkeypatch.setattr(configs, "EXPERIMENTS", {**configs.EXPERIMENTS, "gs2d_recon": ENS})
    assert cli.main(["ensemble", "gs2d_recon", "--shard", "--cpu", "--members", "2",
                     "--iters", "2", "--isg-iters", "3", "--out", str(tmp_path / "e"),
                     "--cache", str(tmp_path / "c")]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["experiment"] == "gs2d_recon" and len(line["rel_l2_members"]) == 2
    assert np.isfinite(line["rel_l2_members"]).all()
    assert cli.main(["run", "gs2d_recon", "--cpu", "--mesh", "2,1", "--parallel", "gspmd",
                     "--iters", "2", "--isg-iters", "3", "--out", str(tmp_path / "r"),
                     "--cache", str(tmp_path / "c")]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["experiment"] == "gs2d_recon" and np.isfinite(line["rel_l2"])
    assert (tmp_path / "r" / "gs2d_recon.ckpt.npz").exists()
