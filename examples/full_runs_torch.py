#!/usr/bin/env python3
"""Train the PyTorch/CUDA port at each configuration's full budget and write
one row a task, to hold beside the JAX package's recorded accuracy.

The port's counterpart of the JAX package's full-budget drivers
(examples/queue_round5.py's GS3D seeds, examples/lo20_protocol_row.py and
examples/discovery_pipeline.py).  Tasks, in this order:

  gs2d     run_experiment(GS2D_RECON, seed=S) for S of --seed (default
           0), then run_ensemble(GS2D_RECON, 4) at the same budget
           ("auto"), unless --no-ensemble
  lo20     run_discovery_pipeline(LO_STAGE1 at noise_pct=0.2), with
           steps_per_call=20 as lo20_protocol_row.py passes it
  gs3d     run_experiment_with_restarts(GS3D_RECON, seed=s, max_restarts=3,
           loss_gate=1.85e-3) for s = 0 and 1
  burgers  run_discovery_pipeline(BURGERS_STAGE1)
  lo_forward  run_experiment(FORWARD_SIM_LO, seed=S) in float64 (the
           physics-only lambda-omega forward simulation; no kernel runs)

Run from the root of a checkout, on one CUDA device:

    python3 examples/full_runs_torch.py [--only TAG] [--smoke] [--out DIR]
                                        [--cache DIR] [--cpu] [--seed S]
                                        [--no-ensemble]

--seed S (default 0) is the init seed of the gs2d run and of lo_forward,
and --no-ensemble leaves gs2d's ensemble out: a seed spread is measured by
one call a seed, each with its own --out (a task already done in an --out
is skipped), e.g. ``--only gs2d --seed 2 --no-ensemble --out
runs/full_torch/gs2d_seed2``.

Each task prints one JSON line and appends it to ``<out>/rows.jsonl``
(default runs/full_torch): the configuration, the seeds, the iterations of
each stage, the evaluated candidate's rel-L2 and stable frames, the
watchdog, spike and probe events of its log, the restart ladder's attempts,
Stage 2's support for each equation with precision, recall and coefficient
rel-L2, Stage 3's rollout rel-L2 and coefficients, the host seconds of each
phase, the kernels' launches during the task (each wrapper's counter, and
summed by TPU kernel row), the card's name and power limit as nvidia-smi
gives them, and ``reduced``, every cut from the configuration's own budget
(empty unless --smoke).  A task whose tag already stands in rows.jsonl as
ok (in the same mode) is skipped; a GS2D run whose checkpoint is in its
directory is resumed, and so is each ladder attempt (the runner's own
resume).

--smoke cuts every task to a few iterations, a short ISG pretrain, chains
of a tenth of each T (two measured intervals at least), an evaluation no
longer than the training chain, a ladder of one restart on one seed and a
short Stage 2 and Stage 3, and lists each cut in ``reduced``.  Without a CUDA device the script refuses to run unless
--cpu is given; on the CPU every kernel's plain version runs, and no
launch is counted.  On the card a task whose path took no launch of a
kernel row it should (TASK_ROWS) fails.  The exit code is non-zero if any
task failed.  The script imports neither jax nor percnn_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from percnn_tpu_torch.experiments.configs import (  # noqa: E402
    BURGERS_STAGE1,
    FORWARD_SIM_LO,
    GS2D_RECON,
    GS3D_RECON,
    LO_STAGE1,
)

TASKS = ("gs2d", "lo20", "gs3d", "burgers", "lo_forward")
# the configuration of each task, as the JAX package's drivers ran them
CONFIGS = {
    "gs2d": GS2D_RECON,
    "lo20": dataclasses.replace(LO_STAGE1, noise_pct=0.2),
    "gs3d": GS3D_RECON,
    "burgers": BURGERS_STAGE1,
    "lo_forward": FORWARD_SIM_LO,
}
ENSEMBLE_MEMBERS = 4
LO20_STEPS_PER_CALL = 20          # lo20_protocol_row.py's argument
GS3D_SEEDS = (0, 1)
GS3D_MAX_RESTARTS = 3
GS3D_LOSS_GATE = 1.85e-3          # queue_round5.py's LOSS_GATE
STAGE2_MAXIT, STAGE2_STRIDGE_ITERS = 50, 40   # run_stage2's defaults
STAGE3_ITERS, STAGE3_ISG_PRETRAIN = 1000, 2000  # the pipeline's Stage 3 defaults

# --smoke
SMOKE_ITERS_PER_STAGE = 2
SMOKE_ISG_PRETRAIN = 20
SMOKE_T_DIV = 10                  # each chain T cut to T // 10
SMOKE_MAX_RESTARTS = 1
SMOKE_GS3D_SEEDS = (0,)
SMOKE_STAGE2 = {"maxit": 10, "stridge_iters": 10}
SMOKE_STAGE3_ITERS = 2

# the kernels' launch counters, (module of percnn_tpu_torch.ops.kernels,
# wrapper, attribute), and the TPU kernel rows (PERF.md) they count
COUNTERS = (
    ("cell2d", "fused_rollout_2d", "launches", 1),
    ("cell2d", "fused_rollout_2d", "launches_kxk", 1),
    ("cell2d", "fused_rollout_final_2d", "launches", 2),
    ("cell2d", "fused_rollout_final_2d", "launches_kxk", 2),
    ("cell2d", "fused_rollout_kxk_2d", "launches", 3),
    ("backward2d", "fused_phase1_2d", "launches", 4),
    ("backward2d", "fused_phase1_ys_2d", "launches", 5),
    ("backward2d", "fused_rollout_tp_2d", "launches", 6),
    ("backward2d", "fused_rollout_tp_2d_pg", "launches", 7),
    ("cell3d", "fused_rollout_3d", "launches", 8),
    ("backward3d", "fused_phase1_3d", "launches", 9),
    ("backward3d", "fused_rollout_tp_3d_pg", "launches", 10),
    ("batched2d", "fused_rollout_2d_batched", "launches", 11),
    ("batched2d", "fused_rollout_2d_batched", "launches_kxk", 11),
    ("batched2d", "fused_phase1_2d_batched", "launches", 12),
    ("batched2d", "fused_phase1_2d_batched", "launches_kxk", 12),
    ("batched2d", "fused_phase1_pg_2d_batched", "launches", 13),
    ("sharded_step2d", "step_haloed_2d", "launches", 14),
    ("sharded_step2d", "step_blocks_2d", "launches", 14),
    ("sharded_step2d", "rollout_blocks_2d", "launches", 14),
)
# the kernel rows each task's path must launch on the card
TASK_ROWS = {"gs2d": (1, 7), "lo20": (3, 6), "gs3d": (8, 10), "burgers": (3, 6),
             "lo_forward": ()}


def _counters():
    import importlib

    for module, fn, attr, row in COUNTERS:
        obj = getattr(importlib.import_module(f"percnn_tpu_torch.ops.kernels.{module}"), fn)
        yield obj, attr, f"{module}.{fn}.{attr}", row


def zero_counts() -> None:
    for obj, attr, _, _ in _counters():
        setattr(obj, attr, 0)


def take_counts() -> dict:
    """The launches since the last zero_counts or take_counts, by counter
    and by TPU kernel row; the counters are set to 0 again."""
    counters, rows = {}, {}
    for obj, attr, key, row in _counters():
        n = int(getattr(obj, attr))
        if n:
            counters[key] = n
            rows[str(row)] = rows.get(str(row), 0) + n
    zero_counts()
    return {"rows": rows, "counters": counters}


def _add_counts(*parts: dict) -> dict:
    out = {"rows": {}, "counters": {}}
    for part in parts:
        for kind in out:
            for key, n in part[kind].items():
                out[kind][key] = out[kind].get(key, 0) + n
    return out


def card() -> str | None:
    """nvidia-smi's name and power limit of the first card, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def _json_safe(x):
    """Strict JSON: numpy scalars and arrays to Python, non-finite floats to None."""
    if isinstance(x, dict):
        return {str(k): _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, np.ndarray):
        return _json_safe(x.tolist())
    if isinstance(x, (np.bool_, bool)):
        return bool(x)
    if isinstance(x, (np.integer, int)):
        return int(x)
    if isinstance(x, (np.floating, float)):
        return float(x) if math.isfinite(float(x)) else None
    return x


def events(log_path: str) -> dict:
    """The events of a run's metrics log: counts by kind (nan_watchdog,
    spike_watchdog, spike_accepted, probe, aborted) and each record."""
    counts: dict = {}
    records = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            for line in f:
                rec = json.loads(line)
                if "event" in rec:
                    counts[rec["event"]] = counts.get(rec["event"], 0) + 1
                    records.append({k: v for k, v in rec.items() if k != "time"})
    return {"counts": counts, "records": records}


def _candidate(exp, res: dict) -> str:
    """The evaluated parameters: the stability probe's pick, else the
    trainer's selection."""
    if res.get("candidate"):
        return res["candidate"]
    return ("best_val" if exp.train.best_val else
            f"best_{exp.train.best_key}" if exp.train.best_key else "final")


def run_fields(exp, res: dict, log_path: str) -> dict:
    """A run_experiment result's row fields."""
    sec = res.get("seconds", {})
    return {
        "rel_l2": res.get("rel_l2"),
        "rel_l2_u": res.get("rel_l2_u"),
        "rel_l2_v": res.get("rel_l2_v"),
        "rel_l2_stable": res.get("rel_l2_stable"),
        "stable_frames": res.get("stable_frames"),
        "diverged": res.get("diverged"),
        "candidate": _candidate(exp, res),
        "probe_scores": res.get("probe_scores"),
        "final_stage_min_loss": res.get("final_stage_min_loss"),
        "final_loss": res["history"][-1] if res.get("history") else None,
        "iterations": {
            "isg_pretrain": exp.isg_pretrain_iters if "isg_pretrain" in sec else 0,
            "stages": [{"T": s["steps"], "iters": s["iters"]} for s in sec.get("stages", [])],
        },
        "seconds": sec,
        "events": events(log_path),
    }


class Task:
    """What a task needs: its configuration (cut under --smoke, each cut
    listed in ``reduced``), its directory, the cache and the device."""

    def __init__(self, tag: str, *, out: str, cache: str | None, device: str, smoke: bool,
                 seed: int = 0, ensemble: bool = True):
        self.tag, self.cache, self.device, self.smoke = tag, cache, device, smoke
        self.seed, self.ensemble = seed, ensemble
        self.dir = os.path.join(out, tag)
        self.reduced: list = []
        exp = CONFIGS[tag]
        if smoke:
            n_stages = len(exp.curriculum) + 1
            n_iters = SMOKE_ITERS_PER_STAGE * n_stages
            stride = exp.data.time_stride if exp.data is not None else 1

            def short(t: int) -> int:   # two measured intervals at least
                return min(t, max(t // SMOKE_T_DIV, 2 * stride))

            curriculum = tuple(short(t) for t in exp.curriculum)
            train_steps = short(exp.train_steps)
            infer = min(exp.infer_steps, train_steps)
            self.cut("train.n_iters", exp.train.n_iters, n_iters)
            self.cut("isg_pretrain_iters", exp.isg_pretrain_iters, SMOKE_ISG_PRETRAIN)
            self.cut("curriculum", exp.curriculum, curriculum)
            self.cut("train_steps", exp.train_steps, train_steps)
            self.cut("infer_steps", exp.infer_steps, infer)
            exp = dataclasses.replace(
                exp, curriculum=curriculum, train_steps=train_steps, infer_steps=infer,
                isg_pretrain_iters=SMOKE_ISG_PRETRAIN,
                train=dataclasses.replace(exp.train, n_iters=n_iters))
        self.exp = exp

    def cut(self, what: str, full, smoke) -> None:
        if full != smoke:
            self.reduced.append(f"{what}: {full} -> {smoke}")

    def path(self, *parts: str) -> str:
        return os.path.join(self.dir, *parts)


def task_gs2d(task: Task) -> dict:
    from percnn_tpu_torch.experiments.ensemble import run_ensemble
    from percnn_tpu_torch.experiments.runner import run_experiment

    exp = task.exp
    d = task.path("run")
    resume = os.path.exists(os.path.join(d, f"{exp.name}.ckpt.npz"))
    res = run_experiment(exp, out_dir=d, cache_dir=task.cache, seed=task.seed,
                         resume=resume, device=task.device)
    run = {"seed": task.seed, "resumed": resume,
           **run_fields(exp, res, os.path.join(d, f"{exp.name}.metrics.jsonl")),
           "launches": take_counts()}
    if not task.ensemble:
        return {"seeds": {"run": task.seed, "ensemble": []}, "run": run, "ensemble": None,
                "launches": run["launches"]}
    d = task.path("ensemble")
    ens = run_ensemble(exp, ENSEMBLE_MEMBERS, out_dir=d, cache_dir=task.cache,
                       device=task.device)
    sec = ens["seconds"]
    ensemble = {
        "members": ENSEMBLE_MEMBERS, "bptt": "auto", "init_seeds": list(range(ENSEMBLE_MEMBERS)),
        "noise_seeds": [exp.seed + k for k in range(ENSEMBLE_MEMBERS)],
        "rel_l2_members": ens["rel_l2_members"], "rel_l2_mean": ens["rel_l2_mean"],
        "rel_l2_std": ens["rel_l2_std"], "final_loss": ens["history"][-1],
        "iterations": {"isg_pretrain": exp.isg_pretrain_iters,
                       "stages": [{"T": s["steps"], "iters": s["iters"]}
                                  for s in sec["stages"]]},
        "seconds": sec,
        "events": events(os.path.join(d, f"{exp.name}.ens.metrics.jsonl")),
        "launches": take_counts(),
    }
    return {"seeds": {"run": task.seed, "ensemble": ensemble["init_seeds"]},
            "run": run, "ensemble": ensemble,
            "launches": _add_counts(run["launches"], ensemble["launches"])}


def task_gs3d(task: Task) -> dict:
    from percnn_tpu_torch.experiments.runner import run_experiment_with_restarts

    exp = task.exp
    seeds, max_restarts = GS3D_SEEDS, GS3D_MAX_RESTARTS
    if task.smoke:
        task.cut("seeds", GS3D_SEEDS, SMOKE_GS3D_SEEDS)
        task.cut("max_restarts", GS3D_MAX_RESTARTS, SMOKE_MAX_RESTARTS)
        seeds, max_restarts = SMOKE_GS3D_SEEDS, SMOKE_MAX_RESTARTS
    out = {}
    for s in seeds:
        t0 = time.perf_counter()
        res = run_experiment_with_restarts(
            exp, out_dir=task.path(f"seed{s}"), cache_dir=task.cache, seed=s,
            max_restarts=max_restarts, loss_gate=GS3D_LOSS_GATE, device=task.device)
        wall = time.perf_counter() - t0
        attempts = []
        for a in res["attempts"]:
            attempts.append({**{k: v for k, v in a.items() if k != "out_dir"},
                             "events": events(os.path.join(a["out_dir"],
                                                           f"{exp.name}.metrics.jsonl"))})
        # the ladder returns the completed attempt of the lowest final-stage
        # loss, else its first completed one
        done = [a for a in res["attempts"] if "error" not in a]
        scored = [a for a in done if a.get("final_stage_min_loss") is not None]
        selected = (min(scored, key=lambda a: a["final_stage_min_loss"]) if scored
                    else done[0])
        out[str(s)] = {"selected_attempt": selected["attempt"], "wall_seconds": wall,
                       **run_fields(exp, res, os.path.join(selected["out_dir"],
                                                           f"{exp.name}.metrics.jsonl")),
                       "attempts": attempts, "launches": take_counts()}
    return {"seeds": list(seeds), "max_restarts": max_restarts, "loss_gate": GS3D_LOSS_GATE,
            "by_seed": out,
            "launches": _add_counts(*(r["launches"] for r in out.values()))}


def stage2_fields(s2: dict, system: str) -> dict:
    """Each equation's support (nonzero terms and coefficients), beside the
    true support: terms found, spurious terms, exact, and the metrics."""
    from percnn_tpu_torch.experiments.pipeline import TRUTH_TERMS

    names = list(s2["names"])
    out = {}
    for eq in ("u", "v"):
        w = np.ravel(np.asarray(s2[f"w_{eq}"]))
        support = {names[i]: float(w[i]) for i in range(len(names)) if w[i] != 0.0}
        true = set(TRUTH_TERMS.get(system, {}).get(eq, {}))
        m = s2.get(f"metrics_{eq}") or {}
        out[eq] = {"support": support,
                   "true_found": f"{len(true & set(support))}/{len(true)}",
                   "spurious": sorted(set(support) - true),
                   "exact": set(support) == true,
                   "precision": m.get("precision"), "recall": m.get("recall"),
                   "coef_rel_l2": m.get("rel_l2")}
    return out


def stage3_fields(s3: dict, cell) -> dict:
    """Stage 3's rollout rel-L2 and its coefficients: nu and each term's."""
    p = s3["params"]["cell"]
    nu = p["nu"].detach().cpu().numpy()
    coef = {}
    for c, eq in enumerate(("u", "v")):
        values = p["coef"][c].detach().cpu().numpy()
        coef[eq] = {t: float(v) for t, v in zip(cell.terms[c], values)}
    return {"rel_l2": s3["rel_l2"], "nu_u": float(nu[0]), "nu_v": float(nu[1]),
            "coef": coef}


@contextlib.contextmanager
def _stage3_isg_pretrain(n: int):
    """Stage 3's ISG pretrain cut to n iterations (run_discovery_pipeline
    takes no argument for it)."""
    from percnn_tpu_torch.experiments import pipeline

    saved = pipeline.run_stage3
    pipeline.run_stage3 = functools.partial(saved, isg_pretrain_iters=n)
    try:
        yield
    finally:
        pipeline.run_stage3 = saved


def task_pipeline(task: Task) -> dict:
    from percnn_tpu_torch.experiments import pipeline

    exp = task.exp
    kw = {"steps_per_call": LO20_STEPS_PER_CALL} if task.tag == "lo20" else {}
    stage3_isg = STAGE3_ISG_PRETRAIN
    stage3_iters = STAGE3_ITERS
    cut = contextlib.nullcontext()
    if task.smoke:
        task.cut("stage2 maxit", STAGE2_MAXIT, SMOKE_STAGE2["maxit"])
        task.cut("stage2 stridge_iters", STAGE2_STRIDGE_ITERS, SMOKE_STAGE2["stridge_iters"])
        task.cut("stage3 iters", STAGE3_ITERS, SMOKE_STAGE3_ITERS)
        task.cut("stage3 isg pretrain", STAGE3_ISG_PRETRAIN, SMOKE_ISG_PRETRAIN)
        kw.update(stage2_kwargs=dict(SMOKE_STAGE2), stage3_iters=SMOKE_STAGE3_ITERS)
        stage3_isg, stage3_iters = SMOKE_ISG_PRETRAIN, SMOKE_STAGE3_ITERS
        cut = _stage3_isg_pretrain(SMOKE_ISG_PRETRAIN)
        window = pipeline.default_stage2_frames(exp)
        n_recon = exp.infer_steps + 1
        if window.start >= n_recon:   # the short evaluation ends before the window
            task.cut("stage2 frames", f"{window.start}:{window.stop}", f"0:{n_recon}")
            kw["stage2_frames"] = slice(0, n_recon)
    with cut:
        res = pipeline.run_discovery_pipeline(exp, out_dir=task.dir, cache_dir=task.cache,
                                              device=task.device, **kw)
    s1 = res["stage1"]
    stage1 = run_fields(exp, s1, task.path(f"{exp.name}.metrics.jsonl"))
    return {
        "seeds": {"init": 0, "noise": exp.seed},
        "noise_pct": exp.noise_pct,
        **({"steps_per_call": LO20_STEPS_PER_CALL} if task.tag == "lo20" else {}),
        "stage1": stage1,
        "stage2": stage2_fields(res["stage2"], exp.system),
        "stage3": {**stage3_fields(res["stage3"], res["symbolic_cell"]),
                   "iterations": {"isg_pretrain": stage3_isg, "train": stage3_iters}},
        "seconds": res["seconds"],
        "launches": take_counts(),
    }


def task_lo_forward(task: Task) -> dict:
    import torch

    from percnn_tpu_torch.experiments.runner import run_experiment

    exp = task.exp
    d = task.path("run")
    resume = os.path.exists(os.path.join(d, f"{exp.name}.ckpt.npz"))
    res = run_experiment(exp, out_dir=d, cache_dir=task.cache, dtype=torch.float64,
                         seed=task.seed, resume=resume, device=task.device)
    return {"seeds": {"run": task.seed}, "dtype": "float64",
            "run": {"seed": task.seed, "resumed": resume,
                    **run_fields(exp, res, os.path.join(d, f"{exp.name}.metrics.jsonl"))},
            "launches": take_counts()}


RUNNERS = {"gs2d": task_gs2d, "lo20": task_pipeline, "gs3d": task_gs3d,
           "burgers": task_pipeline, "lo_forward": task_lo_forward}


def done_tags(rows_path: str, smoke: bool) -> set:
    """Tags with an ok row of the same mode in rows.jsonl."""
    tags = set()
    if os.path.exists(rows_path):
        with open(rows_path) as f:
            for line in f:
                row = json.loads(line)
                if row.get("ok") and bool(row.get("smoke")) == smoke:
                    tags.add(row["tag"])
    return tags


def run_task(tag: str, *, out: str, cache: str | None, device: str, smoke: bool,
             card_name: str | None, seed: int = 0, ensemble: bool = True) -> dict:
    import torch

    task = Task(tag, out=out, cache=cache, device=device, smoke=smoke, seed=seed,
                ensemble=ensemble)
    zero_counts()
    t0 = time.perf_counter()
    row = {"tag": tag, "config": task.exp.name, "smoke": smoke, "device": device,
           "card": card_name, "torch": torch.__version__}
    try:
        row.update(RUNNERS[tag](task))
        missing = [r for r in TASK_ROWS[tag] if device == "cuda"
                   and not row["launches"]["rows"].get(str(r))]
        row["ok"] = not missing
        if missing:
            row["error"] = f"kernel rows {missing} launched no kernel on the card"
    except Exception as e:  # noqa: BLE001 - the row records the failure; the next task runs
        row.update(ok=False, error=f"{type(e).__name__}: {e}"[:2000],
                   traceback=traceback.format_exc()[-4000:])
    row["path_rows"] = list(TASK_ROWS[tag])
    row["wall_seconds"] = time.perf_counter() - t0
    row["reduced"] = task.reduced
    return _json_safe(row)


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=TASKS, help="run this task alone")
    ap.add_argument("--smoke", action="store_true",
                    help="a few iterations a task, every cut listed in the row's 'reduced'")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    ap.add_argument("--out", default=os.path.join("runs", "full_torch"))
    ap.add_argument("--cache", default="data_cache", help="ground-truth cache directory")
    ap.add_argument("--seed", type=int, default=0,
                    help="the init seed of the gs2d run and of lo_forward")
    ap.add_argument("--no-ensemble", action="store_true",
                    help="the gs2d task without its ensemble")
    args = ap.parse_args(argv)

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("full_runs_torch: no CUDA device; pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"
    card_name = card() if device == "cuda" else None
    os.makedirs(args.out, exist_ok=True)
    rows_path = os.path.join(args.out, "rows.jsonl")
    done = done_tags(rows_path, args.smoke)
    failed = 0
    for tag in ([args.only] if args.only else TASKS):
        if tag in done:
            print(f"full_runs_torch: {tag} already done in {rows_path}; skipped", flush=True)
            continue
        row = run_task(tag, out=args.out, cache=args.cache, device=device, smoke=args.smoke,
                       card_name=card_name, seed=args.seed, ensemble=not args.no_ensemble)
        failed += not row["ok"]
        line = json.dumps(row, allow_nan=False)
        with open(rows_path, "a") as f:
            f.write(line + "\n")
        print(line, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
