"""The discovery pipeline of percnn_tpu_torch on the CPU against percnn_tpu's:
Stage 2 (run_stage2, run_stage2_stable) on one fixed reconstruction, the
Stage-3 loss and its gradient at transferred parameters, the pipeline's
entry points end to end from saved artifacts (run_discovery_pipeline with
stage1_recon, run_stage3_from_coefs, run_ensemble_discovery with
member_recons), and the ``pipeline`` and ``list`` verbs of the CLI.

Bars: Stage-2 outputs rtol 1e-10 (atol 1e-12); the Stage-3 loss rtol 2e-4
and its gradients rtol 2e-4, atol 2e-6 (float32).  The pipeline's Stage 3
pretrains the ISG for 2000 iterations; here it takes 20 (``_short_stage3``),
which keeps the file's many Stage-3 runs cheap.
"""

import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import init_symbolic_cell as j_init_symbolic_cell
from percnn_tpu.core.cell import symbolic_cell_step as j_symbolic_cell_step
from percnn_tpu.core.isg import init_isg as j_init_isg, isg_apply as j_isg_apply
from percnn_tpu.core.losses import data_loss as j_data_loss, ic_loss as j_ic_loss
from percnn_tpu.core.rollout import rollout as j_rollout
from percnn_tpu.experiments import configs as jconfigs
from percnn_tpu.experiments import pipeline as jpipeline
from percnn_tpu.experiments import runner as jrunner
from percnn_tpu.experiments import stage3 as jstage3

from percnn_tpu_torch.__main__ import main
from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.data.io import load_npz, save_npz
from percnn_tpu_torch.data.noise import add_noise
from percnn_tpu_torch.data.simulate import default_ic, simulate
from percnn_tpu_torch.experiments import configs, pipeline, runner, stage3
from percnn_tpu_torch.pde.terms import gen_library


@pytest.fixture(autouse=True)
def _figures_skipped(monkeypatch):
    """run_experiment's figures (tested in test_torch_viz.py) are skipped
    here, as where matplotlib is not installed: neither package's runs draw."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)


STAGE2_BAR = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(autouse=True)
def _short_stage3(monkeypatch):
    monkeypatch.setattr(pipeline, "run_stage3",
                        functools.partial(stage3.run_stage3, isg_pretrain_iters=20))


def _small(base, grid=32, steps=40, **kw):
    return dataclasses.replace(
        base, grid=grid, train_steps=steps, infer_steps=steps,
        data=dataclasses.replace(base.data, time_stride=5, space_stride=2), **kw)


def _recon(system, n=24, frames=30, noise=0.01):
    exp = configs.EXPERIMENTS["lo_stage1" if system == "lambda_omega" else "burgers_stage1"]
    h0 = default_ic(system, n, seed=1)
    if system == "lambda_omega":
        h0 = simulate(system, h0, 20, exp.dt, exp.dx, device="cpu")[-1]
    roll = simulate(system, h0, frames - 1, exp.dt, exp.dx, device="cpu")
    return add_noise(roll, noise, seed=7).astype(np.float32)


def _assert_stage2_equal(s2, js2, keys=("w_u", "w_v")):
    assert list(s2["names"]) == list(js2["names"])
    for k in keys:
        np.testing.assert_allclose(np.asarray(s2[k]), np.asarray(js2[k]), **STAGE2_BAR,
                                   err_msg=k)
    for k in ("metrics_u", "metrics_v"):
        assert (k in s2) == (k in js2) and s2.get(k) == js2.get(k)


STAGE2_CASES = {
    "lo": ("lambda_omega", "lo_stage1", {}, False),
    "lo_high_noise": ("lambda_omega", "lo_stage1", {"noise_pct": 0.3}, False),
    "burgers": ("burgers", "burgers_stage1", {}, False),
    "burgers_stable": ("burgers", "burgers_stage1", {}, True),
    "lo_stable": ("lambda_omega", "lo_stage1", {}, True),
}
DRAWS = 2


@pytest.mark.parametrize("case", list(STAGE2_CASES))
def test_stage2_matches_jax(case):
    system, name, change, stable = STAGE2_CASES[case]
    recon = _recon(system)
    exp = dataclasses.replace(configs.EXPERIMENTS[name], grid=24, **change)
    jexp = dataclasses.replace(jconfigs.EXPERIMENTS[name], grid=24, **change)
    kw = dict(frames=slice(0, 30), kwargs=dict(maxit=8, stridge_iters=8), seed=1)
    if stable:
        s2 = pipeline.run_stage2_stable(exp, recon, draws=DRAWS, **kw)
        js2 = jpipeline.run_stage2_stable(jexp, recon, draws=DRAWS, **kw)
        _assert_stage2_equal(s2, js2, ("w_u", "w_v", "votes_u", "votes_v"))
    else:
        s2 = pipeline.run_stage2(exp, recon, **kw)
        js2 = jpipeline.run_stage2(jexp, recon, **kw)
        _assert_stage2_equal(s2, js2)
        for eq in ("u", "v"):
            assert (f"pareto_{eq}" in s2) == (f"pareto_{eq}" in js2)
            if f"pareto_{eq}" in s2:
                np.testing.assert_array_equal(s2[f"pareto_{eq}"]["ls_loss"],
                                              js2[f"pareto_{eq}"]["ls_loss"])


def test_resolve_frames_and_identified_to_symbolic_match_jax():
    recon = np.zeros((60, 4, 4, 2), np.float32)
    for exp, jexp in ((configs.LO_STAGE1, jconfigs.LO_STAGE1),
                      (configs.BURGERS_STAGE1, jconfigs.BURGERS_STAGE1)):
        for frames in (None, slice(10, 200), slice(0, 20)):
            assert (pipeline._resolve_frames(exp, recon, frames)
                    == jpipeline._resolve_frames(jexp, recon, frames))
    with pytest.raises(ValueError, match="beyond"):
        pipeline._resolve_frames(configs.LO_STAGE1, recon, slice(70, 90))
    lib = gen_library()
    w_u, w_v = np.zeros((70, 1)), np.zeros((70, 1))
    w_u[lib.index("ones*lap_u")], w_u[lib.index("u*u_x")] = 0.0051, -0.98
    w_v[lib.index("ones*lap_v")], w_v[lib.index("u*v_x")] = 0.0049, -0.97
    cell, coef, nu = pipeline.identified_to_symbolic(w_u, w_v, lib, dt=1e-3, dx=0.01)
    jcell, jcoef, jnu = jpipeline.identified_to_symbolic(w_u, w_v, lib, dt=1e-3, dx=0.01)
    assert dataclasses.asdict(cell) == dataclasses.asdict(jcell)
    assert (coef, nu) == (jcoef, jnu) == (((-0.98,), (-0.97,)), (0.0051, 0.0049))
    assert pipeline.TRUTH_TERMS == jpipeline.TRUTH_TERMS


@pytest.mark.parametrize("which", ["burgers", "lambda_omega"])
def test_stage3_loss_and_gradient_match_jax(which):
    """The port's Stage-3 loss at transferred parameters against the same
    loss composed from percnn_tpu's public functions (its run_stage3's)."""
    base = configs.BURGERS_STAGE1 if which == "burgers" else configs.LO_STAGE1
    jbase = jconfigs.BURGERS_STAGE1 if which == "burgers" else jconfigs.LO_STAGE1
    exp, jexp = _small(base, grid=16, steps=10), _small(jbase, grid=16, steps=10)
    make = stage3.burgers_stage3 if which == "burgers" else stage3.lambda_omega_stage3
    jmake = jstage3.burgers_stage3 if which == "burgers" else jstage3.lambda_omega_stage3
    cfg, jcfg = make(exp), jmake(jexp)
    assert dataclasses.asdict(cfg.cell) == dataclasses.asdict(jcfg.cell)
    truth = _recon(which, n=16, frames=11).astype(np.float64)
    jprob = jrunner.setup_problem(jexp, truth, jnp.float32)
    prob = runner.setup_problem(exp, truth, torch.float32, device="cpu")
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jp = {"cell": j_init_symbolic_cell(k1, jcfg.cell, coef_init=jcfg.coef_init,
                                       nu_init=jcfg.nu_init),
          "isg": j_init_isg(k2, jexp.isg)}
    nd = jexp.cell.ndim

    def jloss(p):
        h0 = j_isg_apply(p["isg"], jprob.ic_low, jexp.isg)[0]
        frames = j_rollout(lambda h: j_symbolic_cell_step(p["cell"], h, jcfg.cell), h0,
                           jexp.train_steps)
        tr, va = j_data_loss(frames, jprob.measurement, jexp.data, nd)
        icl = j_ic_loss(j_isg_apply(p["isg"], jprob.ic_low, jexp.isg), jprob.ic_low, nd,
                        jexp.interp_method, align_corners=jexp.interp_align_corners,
                        periodic_extend=jexp.interp_periodic_extend)
        return tr + icl, (tr, va, icl)

    (jtotal, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    leaves = [tp["cell"]["nu"], *tp["cell"]["coef"], *tp["isg"].values()]
    for t in leaves:
        t.requires_grad_(True)
    total, aux = stage3.build_stage3_loss_fn(cfg)(tp, {"ic_low": prob.ic_low,
                                                       "meas": prob.measurement})
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=2e-4)
    for k, want in zip(("data", "val", "ic"), jaux):
        np.testing.assert_allclose(float(aux[k].detach()), float(want), rtol=2e-4)
    grads = torch.autograd.grad(total, leaves)
    jleaves = [jg["cell"]["nu"], *jg["cell"]["coef"], *[jg["isg"][k] for k in tp["isg"]]]
    for got, want in zip(grads, jleaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-6)


def test_pipeline_from_stage1_recon(tmp_path):
    """run_discovery_pipeline from a saved reconstruction: Stage 2 equal to
    percnn_tpu's on the same artifact, both artifacts written, a finite
    Stage-3 history; a reconstruction of the wrong shape raises."""
    exp = _small(configs.BURGERS_STAGE1, noise_pct=0.005)
    jexp = _small(jconfigs.BURGERS_STAGE1, noise_pct=0.005)
    recon = _recon("burgers", n=32, frames=41, noise=0.001)
    path = str(tmp_path / "recon.npz")
    save_npz(path, recon)
    s2kw = dict(maxit=12, stridge_iters=15, lam=0.01, d_tol=20, kappa=1.0)
    res = pipeline.run_discovery_pipeline(
        exp, out_dir=str(tmp_path), cache_dir=None, stage1_recon=path, stage3_iters=3,
        stage2_frames=slice(0, 40), stage2_kwargs=s2kw, device="cpu")
    js2 = jpipeline.run_stage2(jexp, load_npz(path), frames=slice(0, 40), kwargs=s2kw)
    _assert_stage2_equal(res["stage2"], js2)
    assert res["stage1"]["reused"] == path and res["symbolic_cell"].terms
    assert np.isfinite(res["stage3"]["history"]).all() and len(res["stage3"]["history"]) == 3
    assert res["stage3"]["frames"].shape == (exp.infer_steps + 1, 32, 32, 2)
    with np.load(str(tmp_path / "burgers_stage1.stage2_coefs.npz")) as z:
        np.testing.assert_array_equal(z["w_u"], res["stage2"]["w_u"])
    assert os.path.exists(str(tmp_path / "stage3.ckpt.npz"))
    assert set(res["seconds"]) == {"stage1", "stage2", "stage3"}
    save_npz(str(tmp_path / "bad.npz"), recon[:, :16])
    with pytest.raises(ValueError, match="expected"):
        pipeline.run_discovery_pipeline(exp, out_dir=str(tmp_path), cache_dir=None,
                                        stage1_recon=str(tmp_path / "bad.npz"), device="cpu")


def test_stage3_from_saved_coefs(tmp_path):
    exp = _small(configs.BURGERS_STAGE1, noise_pct=0.01)
    names = gen_library()
    w_u, w_v = np.zeros((70, 1)), np.zeros((70, 1))
    for n, c in (("ones*lap_u", 0.0049), ("u*u_x", -0.97), ("v*u_y", -0.96)):
        w_u[names.index(n), 0] = c
    for n, c in (("ones*lap_v", 0.0051), ("u*v_x", -0.98), ("v*v_y", -0.95)):
        w_v[names.index(n), 0] = c
    path = str(tmp_path / "coefs.npz")
    np.savez(path, w_u=w_u, w_v=w_v, names=np.asarray(names))
    res = pipeline.run_stage3_from_coefs(exp, path, out_dir=str(tmp_path), cache_dir=None,
                                         stage3_iters=4, device="cpu")
    assert res["stage1"]["reused_coefs"] == path
    assert set(res["symbolic_cell"].terms[0]) == {"u*u_x", "v*u_y"}
    assert set(res["symbolic_cell"].terms[1]) == {"u*v_x", "v*v_y"}
    m = res["stage2"]["metrics_u"]
    assert m["precision"] == 1.0 and m["recall"] == 1.0
    assert np.isfinite(res["stage3"]["history"]).all()
    assert "u*u_x" in res["stage3"]["coef_table"]
    assert os.path.exists(str(tmp_path / "stage3.ckpt.npz"))


@pytest.mark.parametrize("aggregate", ["mean", "auto"])
def test_ensemble_discovery_from_member_recons(tmp_path, aggregate):
    exp = _small(configs.BURGERS_STAGE1, grid=24)
    jexp = _small(jconfigs.BURGERS_STAGE1, grid=24)
    truth = _recon("burgers", n=24, frames=41, noise=0.0).astype(np.float64)
    rng = np.random.RandomState(0)
    paths = []
    for k in range(3):
        sigma = 0.02 * truth.std(axis=(0, 1, 2), keepdims=True)
        p = str(tmp_path / f"member{k}.npz")
        save_npz(p, (truth + sigma * rng.randn(*truth.shape)).astype(np.float32))
        paths.append(p)
    s2kw = dict(maxit=10, stridge_iters=10)
    kw = dict(stage2_frames=slice(0, 40), stage2_subsample=1.0, stage2_kwargs=s2kw)
    res = pipeline.run_ensemble_discovery(exp, 3, out_dir=str(tmp_path), cache_dir=None,
                                          member_recons=paths, aggregate=aggregate,
                                          stage3_iters=2, device="cpu", **kw)
    recons = [load_npz(p) for p in paths]
    stack = np.stack(recons)
    if aggregate == "auto":
        choice, cv = jpipeline._select_aggregate(jexp, stack, recons, frames=slice(0, 40),
                                                 subsample=1.0, kwargs=s2kw, seed=0,
                                                 truth_terms=None)
        assert res["aggregate"] == choice and res["aggregate_cv"] == cv
    agg = (stack.mean(axis=0) if res["aggregate"] == "mean"
           else np.median(stack, axis=0)).astype(stack.dtype)
    js2 = jpipeline.run_stage2(jexp, agg, frames=slice(0, 40), subsample=1.0, kwargs=s2kw)
    _assert_stage2_equal(res["stage2"], js2)
    for m, r in zip(res["members"], recons):
        _assert_stage2_equal(m["stage2"], jpipeline.run_stage2(jexp, r, frames=slice(0, 40),
                                                               subsample=1.0, kwargs=s2kw))
    names = res["uq"]["names"]
    for term in ("ones*lap_u", "u*u_x", "v*u_y"):
        assert res["uq"]["support_vote_u"][names.index(term)] == 1.0
    assert os.path.exists(str(tmp_path / f"{exp.name}.ens_uq.npz"))
    assert os.path.exists(str(tmp_path / f"{exp.name}.stage1_recon.ens_{res['aggregate']}.npz"))
    assert np.isfinite(res["stage3"]["history"]).all()


def _tiny_lo():
    base = configs.LO_STAGE1
    return dataclasses.replace(
        base, grid=16, train_steps=10, infer_steps=20, isg_pretrain_iters=20,
        cell=dataclasses.replace(base.cell, hidden=4),
        isg=dataclasses.replace(base.isg, hidden=4),
        train=dataclasses.replace(base.train, steps_per_call=2, log_every=100))


def test_cli_pipeline_on_the_cpu(tmp_path, monkeypatch, capsys):
    """python -m percnn_tpu_torch pipeline lo_stage1 --stage1-iters 2
    --stage3-iters 2 --cpu, at a shrunk lo_stage1: Stage 1 trains, Stage 2
    regresses on its reconstruction, Stage 3 fine-tunes."""
    monkeypatch.setitem(configs.EXPERIMENTS, "lo_stage1", _tiny_lo())
    # the verb takes no Stage-2 options: cut the sweep's iterations here
    stage2 = pipeline.run_stage2
    monkeypatch.setattr(pipeline, "run_stage2", lambda *a, **k: stage2(
        *a, **{**k, "kwargs": dict(maxit=5, stridge_iters=5)}))
    out = str(tmp_path / "out")
    assert main(["pipeline", "lo_stage1", "--stage1-iters", "2", "--stage3-iters", "2",
                 "--cpu", "--out", out, "--cache", str(tmp_path / "cache")]) == 0
    text = capsys.readouterr().out
    report = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert report["experiment"] == "lo_stage1" and np.isfinite(report["stage1_rel_l2"])
    assert "metrics_u" in report and "lap" in text
    assert os.path.exists(os.path.join(out, "lo_stage1.stage1_recon.npz"))
    coefs = os.path.join(out, "lo_stage1.stage2_coefs.npz")
    with np.load(coefs) as z:
        assert len(z["names"]) == 70 and "pareto_gammas_u" in z.files
    # Stage 3 alone from the artifact; options that would be ignored are refused
    assert main(["pipeline", "lo_stage1", "--stage2-coefs", coefs, "--stage3-iters", "1",
                 "--cpu", "--out", out, "--cache", str(tmp_path / "cache")]) == 0
    with pytest.raises(SystemExit):
        main(["pipeline", "lo_stage1", "--stage2-coefs", coefs, "--stage2-draws", "3", "--cpu"])
    with pytest.raises(SystemExit):
        main(["pipeline", "lo_stage1", "--ensemble-members", "2", "--stage1-recon", coefs,
              "--cpu"])


def test_cli_list(capsys):
    assert main(["list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == list(jconfigs.EXPERIMENTS)
    assert "forward_sim_lo" in lines[0] and "system=lambda_omega" in lines[0]


def test_trained_lo_stage1_artifacts_read_across_packages():
    """tests/golden/jax_lo_stage1.* (read by chip_smoke.py's pipeline_trained)
    are the JAX package's trained lambda-omega Stage-1 checkpoint and its
    Stage-2 coefficients: byte for byte the runs/pipeline_lo files where the
    checkout has them, the same tree through both packages' readers, and a
    model whose 3 steps on a 16 x 16 field agree across the packages."""
    from percnn_tpu.core import checkpoint as jcheckpoint
    from percnn_tpu.core.cell import pi_cell_step as j_pi_cell_step

    from percnn_tpu_torch.core import checkpoint
    from percnn_tpu_torch.core.cell import pi_cell_step

    golden = os.path.join(os.path.dirname(__file__), "golden")
    runs = os.path.join(os.path.dirname(__file__), os.pardir, "runs", "pipeline_lo")
    for mine, theirs in (("jax_lo_stage1.ckpt.npz", "lo_stage1.ckpt.npz"),
                         ("jax_lo_stage1.stage2_coefs.npz", "lo_stage1.stage2_coefs.npz")):
        if os.path.exists(os.path.join(runs, theirs)):
            with open(os.path.join(golden, mine), "rb") as a, \
                    open(os.path.join(runs, theirs), "rb") as b:
                assert a.read() == b.read(), mine
    path = os.path.join(golden, "jax_lo_stage1.ckpt.npz")
    tree, meta = checkpoint.load_checkpoint_tree(path)
    jtree, jmeta = jcheckpoint.load_checkpoint_tree(path)
    assert meta == jmeta and meta["iteration"] == 15000
    leaves = jax.tree_util.tree_leaves(tree["params"])
    jleaves = jax.tree_util.tree_leaves(jtree["params"])
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    h = _recon("lambda_omega", n=16, frames=1)[0]
    cell = params_from_numpy(tree["params"]["cell"], device="cpu")
    got, want = torch.from_numpy(h), jnp.asarray(h)
    for _ in range(3):
        got = pi_cell_step(cell, got, configs.LO_STAGE1.cell)
        want = j_pi_cell_step(jtree["params"]["cell"], want, jconfigs.LO_STAGE1.cell)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)
    with np.load(os.path.join(golden, "jax_lo_stage1.stage2_coefs.npz")) as z:
        assert [str(n) for n in z["names"]] == gen_library()
        assert np.isfinite(z["w_u"]).all() and np.count_nonzero(z["w_v"]) > 0
