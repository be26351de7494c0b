"""The port's figures (viz/plots.py, runner._export_viz and the
pipeline's Pareto panel): every panel writes its file, with percnn_tpu's
file names, and without matplotlib run_experiment skips the figures."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from percnn_tpu_torch.experiments import runner
from percnn_tpu_torch.experiments.configs import FORWARD_SIM_LO, GS2D_RECON, GS3D_RECON
from percnn_tpu_torch.viz import plots

RNG = np.random.RandomState(0)


def _frames(t, n, ndim=2):
    return RNG.uniform(0.0, 1.0, (t,) + (n,) * ndim + (2,)).astype(np.float32)


def test_panels_write_their_files(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "plotly", None)     # the PNG fallback
    pred, truth = _frames(1, 16)[0], _frames(1, 16)[0]
    low = _frames(1, 4)[0]
    d = str(tmp_path)
    plots.comparison_panel(pred, truth, f"{d}/cmp.png", title="t")
    plots.measurement_panel(pred, truth, low, f"{d}/meas.png", vlims=[(0, 1), (0, 1)])
    plots.ic_panel(pred, truth, f"{d}/ic.png")
    plots.ic_panel(pred, truth, f"{d}/ic_low.png", low_res=low)
    assert plots.pareto_panel([1e-3, 1e-2, 1e-1], [0.5, 0.6, 0.9], [9, 5, 2], f"{d}/par.png",
                              selected_gamma=1e-2, eq="v") == f"{d}/par.png"
    vol = _frames(1, 8, ndim=3)[0]
    paths = plots.isosurface_pair(vol, vol * 0.5, f"{d}/iso")
    assert paths == [f"{d}/iso.{c}.{t}.png" for c in "uv" for t in ("pred", "truth")]
    for name in ("cmp", "meas", "ic", "ic_low", "par"):
        assert os.path.getsize(f"{d}/{name}.png") > 1000
    assert all(os.path.getsize(p) > 1000 for p in paths)


@pytest.mark.parametrize("meas", [False, True])
def test_frame_series(tmp_path, meas):
    frames, truth = _frames(13, 16), _frames(13, 16)
    low = _frames(4, 4) if meas else None
    paths = plots.frame_series(frames, truth, str(tmp_path / "f"), name="x", max_frames=6,
                               meas_low=low)
    assert [os.path.basename(p) for p in paths] == [f"x_{t:03d}.png" for t in range(0, 13, 2)]
    from PIL import Image

    sizes = {Image.open(p).size for p in paths}
    assert len(sizes) == 1 and all(os.path.getsize(p) > 1000 for p in paths)


def _problem(exp, t, with_isg=True):
    n = exp.grid
    truth = _frames(t, n, exp.cell.ndim).astype(np.float64)
    prob = runner.setup_problem(exp, truth, device="cpu")
    params = runner.init_model(exp, torch.Generator().manual_seed(0), device="cpu")
    frames = truth.astype(np.float32) + 0.01
    return prob, params, {"frames": frames}, truth


@pytest.mark.parametrize("case", ["2d_measurement", "2d_plain", "3d"])
def test_export_viz(tmp_path, case, monkeypatch):
    monkeypatch.setitem(sys.modules, "plotly", None)
    if case == "2d_measurement":
        exp = dataclasses.replace(GS2D_RECON, grid=16, train_steps=8,
                                  data=dataclasses.replace(GS2D_RECON.data, time_stride=2))
    elif case == "2d_plain":
        exp = dataclasses.replace(FORWARD_SIM_LO, grid=16)
    else:
        exp = dataclasses.replace(GS3D_RECON, grid=8, train_steps=4)
    prob, params, metrics, truth = _problem(exp, 9)
    runner._export_viz(exp, prob, params, metrics, truth, str(tmp_path))
    files = set(os.listdir(tmp_path))
    assert f"{exp.name}.panel.png" in files
    if case == "3d":
        assert {f"{exp.name}.iso.{c}.{t}.png" for c in "uv" for t in ("pred", "truth")} <= files
        return
    series = sorted(os.listdir(tmp_path / f"{exp.name}_frames"))
    assert series == [f"{exp.name}_{t:03d}.png" for t in range(9)]
    assert (f"{exp.name}.ic_panel.png" in files) == (exp.isg is not None)


def _tiny_gs2d():
    return dataclasses.replace(
        GS2D_RECON, grid=16, train_steps=6, infer_steps=6, curriculum=(),
        data=dataclasses.replace(GS2D_RECON.data, time_stride=2),
        train=dataclasses.replace(GS2D_RECON.train, n_iters=2, log_every=1))


@pytest.mark.parametrize("matplotlib", ["installed", "hidden"])
def test_run_experiment_draws_or_skips(tmp_path, matplotlib, monkeypatch):
    monkeypatch.setitem(sys.modules, "sympy", None)     # no pi_expressions: seconds of sympy
    if matplotlib == "hidden":
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    res = runner.run_experiment(_tiny_gs2d(), out_dir=str(tmp_path), cache_dir=None,
                                isg_pretrain_override=2, device="cpu")
    pngs = [f for f in os.listdir(tmp_path) if f.endswith(".png")]
    if matplotlib == "hidden":
        assert pngs == [] and "viz" not in res["seconds"]
        assert not os.path.exists(tmp_path / "gs2d_recon_frames")
    else:
        assert sorted(pngs) == ["gs2d_recon.ic_panel.png", "gs2d_recon.panel.png"]
        assert len(os.listdir(tmp_path / "gs2d_recon_frames")) == 7
        assert res["seconds"]["viz"] > 0


def test_export_viz_errors_propagate(tmp_path):
    exp = dataclasses.replace(FORWARD_SIM_LO, grid=16)
    prob, params, metrics, truth = _problem(exp, 5)
    metrics["frames"] = metrics["frames"][:, :8]      # frames that do not match the truth
    with pytest.raises(ValueError):
        runner._export_viz(exp, prob, params, metrics, truth, str(tmp_path))
