"""The port's CLI verbs simulate, import-pt, export and profile
(percnn_tpu_torch/__main__.py) on the CPU, against percnn_tpu's functions
(never percnn_tpu's main, which changes the process's JAX config), and
run_experiment's isg_params_path reading an ISG file written by
percnn_tpu."""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from percnn_tpu.core.checkpoint import load_checkpoint as j_load_checkpoint
from percnn_tpu.core.checkpoint import save_checkpoint as j_save_checkpoint
from percnn_tpu.core.isg import ISGConfig as JISGConfig, init_isg as j_init_isg
from percnn_tpu.data.pt_import import import_reference_checkpoint as j_import
from percnn_tpu.data.simulate import default_ic as j_default_ic, simulate as j_simulate
from percnn_tpu.serving import build_serving_fn as j_build_serving_fn

from percnn_tpu_torch.__main__ import main
from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.checkpoint import load_checkpoint, load_checkpoint_tree
from percnn_tpu_torch.core.train import TrainState
from percnn_tpu_torch.experiments import configs, runner
from percnn_tpu_torch.experiments.configs import GS2D_RECON
from percnn_tpu_torch.serving import build_serving_fn, load_model
from percnn_tpu_torch.utils.profiling import TRACE_FILE


def test_simulate_matches_jax(tmp_path):
    out = str(tmp_path / "gt.npz")
    assert main(["simulate", "gray_scott_2d", "--grid", "32", "--steps", "6", "--dt", "0.5",
                 "--dx", "0.01", "--warmup", "2", "--out", out, "--cpu"]) == 0
    got = np.load(out)["uv"]
    h0 = j_simulate("gray_scott_2d", j_default_ic("gray_scott_2d", 32), 2, 0.5, 0.01)[-1]
    want = np.asarray(j_simulate("gray_scott_2d", h0, 6, 0.5, 0.01))
    assert got.shape == (7, 32, 32, 2) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _reference_pt(path, *, id_keyed=False, bad_ids=False):
    """A GS2D reference checkpoint (train_2drd.py's module names) after two
    Adam steps, in the legacy format the reference commits."""
    torch.manual_seed(0)
    cell = torch.nn.Module()
    cell.CA = torch.nn.Parameter(torch.tensor(0.3))
    cell.CB = torch.nn.Parameter(torch.tensor(-0.2))
    cell.W_laplace = torch.nn.Parameter(torch.randn(1, 1, 5, 5), requires_grad=False)
    for cn in "uv":
        for i in (1, 2, 3):
            setattr(cell, f"Wh{i}_{cn}", torch.nn.Conv2d(2, 8, 1))
        setattr(cell, f"Wh4_{cn}", torch.nn.Conv2d(8, 1, 1))
    isg = torch.nn.Module()
    isg.convnet = torch.nn.Sequential(torch.nn.ConvTranspose2d(2, 8, 5, 2, 2, 1),
                                      torch.nn.Sigmoid(),
                                      torch.nn.ConvTranspose2d(8, 8, 5, 2, 2, 1),
                                      torch.nn.Conv2d(8, 2, 1))
    model = torch.nn.Module()
    model.UpconvBlock, model.crnn_cell = isg, cell
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    for _ in range(2):
        opt.zero_grad()
        sum((p ** 2).sum() for p in model.parameters() if p.requires_grad).backward()
        opt.step()
    osd = opt.state_dict()
    if bad_ids:
        osd["param_groups"][0]["params"] = osd["param_groups"][0]["params"][:-1]
    torch.save({"model_state_dict": model.state_dict(), "optimizer_state_dict": osd}, path,
               _use_new_zipfile_serialization=False)


def test_import_export_load_chain(tmp_path, capsys):
    pt, ckpt, art = (str(tmp_path / n) for n in ("ref.pt", "imp.ckpt.npz", "m.npz"))
    _reference_pt(pt)
    assert main(["import-pt", pt, "--out", ckpt]) == 0
    assert "Adam state @ step 2" in capsys.readouterr().out
    tree, meta = load_checkpoint_tree(ckpt)
    assert meta["iteration"] == 2 and float(tree["opt_state"]["step"]) == 2.0
    # the checkpoint has the trainer's layout: a TrainState takes it whole
    state = TrainState(params_from_numpy(tree["params"], device="cpu"), torch.device("cpu"))
    state.load_tree(load_checkpoint(ckpt, state.as_tree())[0])
    assert float(state.count) == 2.0 and bool(state.exp_avg[0].abs().sum() > 0)

    assert main(["export", "gs2d_recon", "--ckpt", ckpt, "--steps", "4", "--out", art,
                 "--cpu"]) == 0
    fn, cfg = load_model(art, device="cpu")
    assert cfg["input_shape"] == [25, 25, 2] and cfg["n_steps"] == 4
    x = np.random.RandomState(0).uniform(0.0, 1.0, (25, 25, 2)).astype(np.float32)
    got = fn(x)
    want = build_serving_fn(tree["params"], GS2D_RECON.cell, 4, isg_cfg=GS2D_RECON.isg,
                            device="cpu")(x)
    assert torch.equal(got, want)
    jcell, jisg, _ = j_import(pt)
    from percnn_tpu.experiments.configs import GS2D_RECON as J_GS2D_RECON

    jwant = np.asarray(j_build_serving_fn({"cell": jcell, "isg": jisg}, J_GS2D_RECON.cell, 4,
                                          isg_cfg=J_GS2D_RECON.isg, dtype=np.float32)(x))
    np.testing.assert_allclose(got.numpy(), jwant, rtol=2e-4, atol=1e-5)

    assert main(["export", "gs2d_recon", "--ckpt", ckpt, "--steps", "4", "--final-only",
                 "--out", art, "--cpu"]) == 0
    fn, cfg = load_model(art, device="cpu")
    assert cfg["final_only"] and torch.equal(fn(x), want[-1])


def test_import_without_mappable_optimizer_state(tmp_path, capsys):
    pt, ckpt = str(tmp_path / "ref.pt"), str(tmp_path / "imp.ckpt.npz")
    _reference_pt(pt, bad_ids=True)
    assert main(["import-pt", pt, "--out", ckpt]) == 0
    assert "warning: optimizer state not imported" in capsys.readouterr().out
    tree, meta = load_checkpoint_tree(ckpt)
    assert "iteration" not in meta and float(tree["opt_state"]["step"]) == 0.0
    assert all(not np.any(v) for v in jax.tree_util.tree_leaves(tree["opt_state"]["exp_avg"]))
    jcell, _, _ = j_import(pt)
    np.testing.assert_array_equal(tree["params"]["cell"]["pi"][1]["w2"], jcell["pi"][1]["w2"])


def _quiet(monkeypatch):
    """No figures and no pi_expressions (sympy's expansion takes seconds):
    these tests are about the runs' inputs and outputs."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "sympy", None)


def _tiny():
    return dataclasses.replace(
        GS2D_RECON, grid=16, train_steps=6, infer_steps=6, curriculum=(),
        data=dataclasses.replace(GS2D_RECON.data, time_stride=2),
        train=dataclasses.replace(GS2D_RECON.train, n_iters=2, log_every=1))


def test_isg_params_path_reads_a_jax_file(tmp_path, monkeypatch):
    _quiet(monkeypatch)
    exp = _tiny()
    path = str(tmp_path / "isg.npz")
    jisg = j_init_isg(jax.random.PRNGKey(7), JISGConfig(**dataclasses.asdict(exp.isg)))
    j_save_checkpoint(path, jisg, {"experiment": exp.name, "seed": 0})
    seen = []
    real_train = runner.train
    monkeypatch.setattr(runner, "pretrain_isg",
                        lambda *a, **k: pytest.fail("the ISG was pretrained, not loaded"))
    monkeypatch.setattr(runner, "train", lambda loss_fn, params, cfg, **kw: (
        seen.append({k: v.clone() for k, v in params["isg"].items()}),
        real_train(loss_fn, params, cfg, **kw))[1])
    res = runner.run_experiment(exp, out_dir=str(tmp_path / "run"), cache_dir=None,
                                isg_params_path=path, device="cpu")
    assert len(res["history"]) == 2
    for k, v in jisg.items():
        assert torch.equal(seen[0][k], torch.as_tensor(np.array(v)))


def test_isg_params_path_saves_the_pretrain(tmp_path, monkeypatch):
    _quiet(monkeypatch)
    exp = _tiny()
    path = str(tmp_path / "isg.npz")
    res = runner.run_experiment(exp, out_dir=str(tmp_path / "a"), cache_dir=None,
                                isg_params_path=path, isg_pretrain_override=3, device="cpu")
    assert os.path.exists(path) and "isg_pretrain" in res["seconds"]
    like = {k: np.zeros(v.shape, np.float32) for k, v in res["params"]["isg"].items()}
    saved, meta = j_load_checkpoint(path, like)
    assert meta == {"experiment": exp.name, "seed": 0}
    # a second run reuses it: the same ISG at the start of training
    res2 = runner.run_experiment(exp, out_dir=str(tmp_path / "b"), cache_dir=None,
                                 isg_params_path=path, isg_pretrain_override=3, device="cpu")
    assert res2["history"] == res["history"]


def test_profile_writes_a_trace(tmp_path, monkeypatch, capsys):
    _quiet(monkeypatch)
    monkeypatch.setitem(configs.EXPERIMENTS, "gs2d_recon", _tiny())
    out = str(tmp_path / "prof")
    assert main(["profile", "gs2d_recon", "--iters", "2", "--out", out,
                 "--cache", str(tmp_path / "cache"), "--cpu"]) == 0
    path = os.path.join(out, "gs2d_recon.trace", TRACE_FILE)
    assert path in capsys.readouterr().out
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_verbs_still_raising_name_a10(monkeypatch):
    """``ensemble --shard`` (the member axis over every CUDA device, one
    rank a device) has no CPU fallback: without a card and without --cpu
    it raises before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["ensemble", "gs2d_recon", "--shard"])
