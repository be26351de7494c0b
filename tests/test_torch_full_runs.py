"""examples/full_runs_torch.py, the port's full-budget driver, on the CPU.

Its five tasks run with ``--smoke --cpu`` on configurations shrunk to a 16
grid (16^3 for GS3D), two hidden channels and T <= 10: every row has its
fields, finite numbers and a ``reduced`` list that names the cuts; a second
call skips the tasks already done; the driver refuses to run without a card
unless given --cpu; and its source imports neither jax nor percnn_tpu.
"""

import ast
import dataclasses
import importlib.util
import json
import math
import os
import sys

import pytest
import torch
import torch._dynamo  # noqa: F401  (before sympy is hidden: torch.optim imports it)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(ROOT, "examples", "full_runs_torch.py")


def _load_driver():
    spec = importlib.util.spec_from_file_location("full_runs_torch", DRIVER)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _shrunk(exp, *, curriculum=()):
    """grid 16 (16^3), two hidden channels, T <= 10, strides that keep
    measured frames at that size."""
    return dataclasses.replace(
        exp, grid=16, train_steps=8, infer_steps=10, curriculum=curriculum,
        cell=dataclasses.replace(exp.cell, hidden=2),
        isg=dataclasses.replace(exp.isg, hidden=2),
        data=dataclasses.replace(exp.data, time_stride=2))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The five tasks once, --smoke --cpu, on the shrunk configurations;
    figures and the sympy expansion hidden (seconds each on the CPU)."""
    driver = _load_driver()
    out = tmp_path_factory.mktemp("full_runs")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        mp.setitem(sys.modules, "sympy", None)
        mp.setattr(driver, "CONFIGS", {
            "gs2d": _shrunk(driver.CONFIGS["gs2d"], curriculum=(4, 6)),
            "lo20": _shrunk(driver.CONFIGS["lo20"]),
            "gs3d": _shrunk(driver.CONFIGS["gs3d"], curriculum=(4,)),
            "burgers": _shrunk(driver.CONFIGS["burgers"]),
            "lo_forward": dataclasses.replace(
                driver.CONFIGS["lo_forward"], grid=16, train_steps=8, infer_steps=10,
                cell=dataclasses.replace(driver.CONFIGS["lo_forward"].cell, hidden=2)),
        })
        argv = ["--smoke", "--cpu", "--out", str(out / "o"), "--cache", str(out / "c")]
        rc = driver.main(argv)
        rows = [json.loads(line) for line in open(out / "o" / "rows.jsonl")]
        yield {"driver": driver, "argv": argv, "rc": rc, "out": out,
               "rows": {r["tag"]: r for r in rows}, "mp": mp}


def _numbers(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _numbers(v)
    elif isinstance(x, list):
        for v in x:
            yield from _numbers(v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield x


def _finite_rel_l2(x) -> bool:
    return isinstance(x, float) and math.isfinite(x) and x > 0


def test_every_task_writes_an_ok_row(run):
    assert run["rc"] == 0
    assert list(run["rows"]) == ["gs2d", "lo20", "gs3d", "burgers", "lo_forward"]
    for tag, row in run["rows"].items():
        assert row["ok"], (tag, row.get("error"), row.get("traceback"))
        assert row["smoke"] is True and row["device"] == "cpu" and row["card"] is None
        assert row["path_rows"] == list(run["driver"].TASK_ROWS[tag])
        # the plain versions launch nothing
        assert row["launches"] == {"rows": {}, "counters": {}}
        assert all(math.isfinite(v) for v in _numbers(row))
        assert row["wall_seconds"] > 0


@pytest.mark.parametrize("tag, cuts", [
    ("gs2d", ("train.n_iters: 6000 -> 6", "isg_pretrain_iters: 4000 -> 20",
              "curriculum: (4, 6) -> (4, 4)", "train_steps: 8 -> 4",
              "infer_steps: 10 -> 4")),
    ("lo20", ("train.n_iters: 15000 -> 2", "stage2 maxit: 50 -> 10",
              "stage2 stridge_iters: 40 -> 10", "stage3 iters: 1000 -> 2",
              "stage3 isg pretrain: 2000 -> 20", "stage2 frames: 50:150 -> 0:5")),
    ("gs3d", ("train.n_iters: 12000 -> 4", "seeds: (0, 1) -> (0,)",
              "max_restarts: 3 -> 1")),
    ("burgers", ("train.n_iters: 10000 -> 2", "stage3 iters: 1000 -> 2")),
])
def test_reduced_names_the_cuts(run, tag, cuts):
    reduced = run["rows"][tag]["reduced"]
    for cut in cuts:
        assert cut in reduced, (cut, reduced)


def test_gs2d_row(run):
    row = run["rows"]["gs2d"]
    assert row["config"] == "gs2d_recon" and row["seeds"]["run"] == 0
    r = row["run"]
    assert _finite_rel_l2(r["rel_l2"]) and r["stable_frames"] == 5 and not r["diverged"]
    assert r["candidate"] == "final" and not r["resumed"]
    assert r["iterations"] == {"isg_pretrain": 20,
                               "stages": [{"T": 4, "iters": 2}, {"T": 4, "iters": 2},
                                          {"T": 4, "iters": 2}]}
    assert set(r["seconds"]) >= {"truth", "isg_pretrain", "stages", "evaluate"}
    assert r["events"] == {"counts": {}, "records": []}
    e = row["ensemble"]
    assert e["members"] == 4 and len(e["rel_l2_members"]) == 4
    assert all(_finite_rel_l2(x) for x in e["rel_l2_members"])
    assert e["rel_l2_mean"] == pytest.approx(sum(e["rel_l2_members"]) / 4)
    assert [s["T"] for s in e["iterations"]["stages"]] == [4, 4, 4]
    assert set(e["seconds"]) >= {"truth", "isg_pretrain", "stages", "evaluate"}


def test_gs3d_row(run):
    row = run["rows"]["gs3d"]
    assert row["seeds"] == [0] and row["max_restarts"] == 1
    seed = row["by_seed"]["0"]
    # four iterations never reach the loss gate: the ladder runs both attempts
    assert [a["attempt"] for a in seed["attempts"]] == [0, 1]
    assert [a["init_seed"] for a in seed["attempts"]] == [0, 1000]
    for a in seed["attempts"]:
        assert a["final_stage_min_loss"] > row["loss_gate"]
        # the probe's verdict at each stage's end
        assert a["events"]["counts"].get("probe") == 2
    assert seed["selected_attempt"] in (0, 1)
    assert seed["candidate"] in ("best", "latest", "stable")
    assert set(seed["probe_scores"]) >= {"best", "latest"}
    assert _finite_rel_l2(seed["rel_l2"]) and seed["stable_frames"] == 5
    assert seed["iterations"]["stages"] == [{"T": 4, "iters": 2}, {"T": 4, "iters": 2}]


def test_lo_forward_row(run):
    """FORWARD_SIM_LO in float64 through run_experiment, seed 0."""
    row = run["rows"]["lo_forward"]
    assert row["config"] == "forward_sim_lo" and row["dtype"] == "float64"
    assert row["seeds"] == {"run": 0} and row["path_rows"] == []
    r = row["run"]
    assert _finite_rel_l2(r["rel_l2"]) and not r["diverged"] and r["candidate"] == "final"
    assert r["iterations"]["stages"] == [{"T": 2, "iters": 2}]
    assert set(r["seconds"]) >= {"truth", "stages", "evaluate"}
    assert "train.n_iters: 2000 -> 2" in row["reduced"]


def test_gs2d_seed_without_the_ensemble(run, tmp_path):
    """--seed sets the gs2d run's init seed; --no-ensemble leaves the
    ensemble out of its row."""
    driver = run["driver"]
    out = tmp_path / "seed2"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        mp.setattr(driver, "CONFIGS", {**driver.CONFIGS})
        assert driver.main(["--only", "gs2d", "--smoke", "--cpu", "--seed", "2",
                            "--no-ensemble", "--out", str(out), "--cache",
                            str(run["out"] / "c")]) == 0
    (row,) = [json.loads(line) for line in open(out / "rows.jsonl")]
    assert row["ok"] and row["seeds"] == {"run": 2, "ensemble": []}
    assert row["ensemble"] is None and row["run"]["seed"] == 2
    assert _finite_rel_l2(row["run"]["rel_l2"])
    assert row["run"]["rel_l2"] != run["rows"]["gs2d"]["run"]["rel_l2"]


@pytest.mark.parametrize("tag, terms", [("lo20", 6), ("burgers", 3)])
def test_pipeline_rows(run, tag, terms):
    row = run["rows"][tag]
    assert _finite_rel_l2(row["stage1"]["rel_l2"]) and row["stage1"]["candidate"] == "best_val"
    for eq in ("u", "v"):
        s2 = row["stage2"][eq]
        assert set(s2) == {"support", "true_found", "spurious", "exact", "precision",
                           "recall", "coef_rel_l2"}
        assert s2["true_found"].endswith(f"/{terms}")
        assert set(s2["spurious"]) <= set(s2["support"])
    s3 = row["stage3"]
    assert _finite_rel_l2(s3["rel_l2"]) and set(s3["coef"]) == {"u", "v"}
    assert s3["iterations"] == {"isg_pretrain": 20, "train": 2}
    assert set(row["seconds"]) == {"stage1", "stage2", "stage3"}
    assert row.get("steps_per_call") == (20 if tag == "lo20" else None)
    assert row["noise_pct"] == (0.2 if tag == "lo20" else 0.05)


def test_second_call_skips_the_tasks_done(run, capsys):
    capsys.readouterr()
    assert run["driver"].main(run["argv"]) == 0
    said = capsys.readouterr().out
    for tag in ("gs2d", "lo20", "gs3d", "burgers", "lo_forward"):
        assert f"{tag} already done" in said
    lines = open(run["out"] / "o" / "rows.jsonl").read().splitlines()
    assert len(lines) == 5
    # a full run is another mode: nothing of the smoke rows counts as done
    assert run["driver"].done_tags(str(run["out"] / "o" / "rows.jsonl"), False) == set()


def test_refuses_without_a_card_unless_cpu(monkeypatch, capsys):
    driver = _load_driver()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert driver.main(["--only", "gs2d", "--out", "never"]) == 2
    assert "pass --cpu" in capsys.readouterr().err
    assert not os.path.exists("never")


def test_the_driver_imports_neither_jax_nor_percnn_tpu():
    tree = ast.parse(open(DRIVER).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.JoinedStr)):
            names.add(ast.unparse(node.args[0]))
    tops = {n.split(".")[0] for n in names}
    assert "jax" not in tops and "percnn_tpu" not in tops
    assert "percnn_tpu_torch" in tops
