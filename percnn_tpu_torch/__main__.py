"""CLI of the port, with percnn_tpu's verbs and flags (percnn_tpu/__main__.py):

  python -m percnn_tpu_torch list
  python -m percnn_tpu_torch run gs2d_recon [--iters N] [--mesh 2,2 [--parallel gspmd]] [--resume] [--cpu]
  python -m percnn_tpu_torch pipeline lo_stage1 [--stage1-iters N] [--stage3-iters N] [--cpu]
  python -m percnn_tpu_torch ensemble gs2d_recon --members 4 [--iters N] [--shard] [--cpu]
  python -m percnn_tpu_torch simulate gray_scott_2d --dt 0.5 --dx 0.01 --steps 500 --out gt.npz
  python -m percnn_tpu_torch import-pt checkpoint.pt --out imported.ckpt.npz
  python -m percnn_tpu_torch export gs2d_recon --ckpt runs/gs2d_recon.ckpt.npz --out m.npz
  python -m percnn_tpu_torch profile gs2d_recon --iters 20 --out runs/profile

It runs on the card unless told --cpu.  ``run --mesh`` trains on a
spatially decomposed field (experiments.runner.run_experiment(mesh=...)):
over that many CUDA devices, or with --cpu over a mesh of that many CPU
entries; ``--parallel gspmd`` runs it as one process a mesh position on
DTensors (parallel/spmd.py).  ``ensemble --shard`` shards the members over
a ("data",) mesh of every CUDA device (with --cpu, one CPU rank), as
percnn_tpu does.  ``pipeline`` runs the three-stage discovery
(experiments.pipeline): Stage-1 reconstruction, Stage-2 STRidge, Stage-3
symbolic fine-tune, or parts of it from saved artifacts.  ``simulate``
writes the RK4 ground truth; ``import-pt`` turns a reference ``.pt``
checkpoint into the port's checkpoint (weights and Adam state, which ``run
--resume`` continues from once it is the experiment's checkpoint);
``export`` writes a serving artifact (serving.export_model) and
``profile`` a torch.profiler trace of training iterations.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="percnn_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="train one experiment")
    pr.add_argument("experiment")
    pr.add_argument("--iters", type=int, default=None)
    pr.add_argument("--isg-iters", type=int, default=None)
    pr.add_argument("--out", default="runs")
    pr.add_argument("--cache", default="data_cache")
    pr.add_argument("--x64", action="store_true")
    pr.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--steps-per-call", type=int, default=None,
                    help="optimizer steps between host reads of the losses")
    pr.add_argument("--resume", action="store_true",
                    help="resume from the experiment checkpoint")
    pr.add_argument("--mesh", default=None,
                    help="spatial device mesh for decomposed training, e.g. 2,2 or 2x2 "
                         "(2D) or 2,2,2 (3D), over that many CUDA devices (with --cpu, "
                         "that many CPU entries); 'auto' factors every CUDA device (with "
                         "--cpu, one CPU entry a block: a 1 x 1 mesh) over the "
                         "experiment's spatial axes")
    pr.add_argument("--parallel", choices=("halo", "gspmd"), default="halo",
                    help="decomposition: the explicit halo exchange in one process, or "
                         "GSPMD's counterpart, one process a mesh position on DTensors")

    pe = sub.add_parser("ensemble", help="train K members together")
    pe.add_argument("experiment")
    pe.add_argument("--members", type=int, default=4)
    pe.add_argument("--iters", type=int, default=None)
    pe.add_argument("--isg-iters", type=int, default=None)
    pe.add_argument("--out", default="runs/ensemble")
    pe.add_argument("--cache", default="data_cache")
    pe.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--steps-per-call", type=int, default=None)
    pe.add_argument("--shard", action="store_true",
                    help="shard the member axis over all devices (one process a device)")

    pp = sub.add_parser("pipeline", help="Stage-1/2/3 discovery pipeline")
    pp.add_argument("experiment")
    pp.add_argument("--stage1-iters", type=int, default=None)
    pp.add_argument("--stage3-iters", type=int, default=None)
    pp.add_argument("--out", default="runs/pipeline")
    pp.add_argument("--cache", default="data_cache")
    pp.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--steps-per-call", type=int, default=None)
    pp.add_argument("--stage1-recon", default=None,
                    help="reuse a saved Stage-1 reconstruction .npz "
                         "(skips Stage-1 training)")
    pp.add_argument("--noise", type=float, default=None,
                    help="override the measurement noise %% (e.g. 0.2 for "
                         "the reference's 0-30%% robustness matrix)")
    pp.add_argument("--stage2-frames", default=None,
                    help="Stage-2 regression window as START:STOP frames "
                         "(reference uses 50:150, PDE_FIND_u.py:220-222)")
    pp.add_argument("--stage2-coefs", default=None,
                    help="path to a saved *.stage2_coefs.npz: skip Stage-1/2 "
                         "and fine-tune (Stage-3) from that support")
    pp.add_argument("--stage2-subsample", type=float, default=0.2,
                    help="Stage-2 design-matrix row subsample fraction "
                         "(reference: 0.2, PDE_FIND_u.py:246-247)")
    pp.add_argument("--stage2-draws", type=int, default=None,
                    help="stability-selection Stage-2: majority-vote the "
                         "support over N independent subsample draws, then "
                         "full-matrix lstsq refit")
    pp.add_argument("--ensemble-members", type=int, default=None,
                    help="ensemble-rescued discovery: train K Stage-1 "
                         "members on the SAME measurement (init seeds "
                         "seed..seed+K-1), aggregate reconstructions, run "
                         "Stage-2/3 on the aggregate + per-coef UQ")
    pp.add_argument("--ensemble-aggregate", choices=("mean", "median"),
                    default="mean")
    pp.add_argument("--member-recon", action="append", default=None,
                    help="reuse a saved member reconstruction .npz (repeat "
                         "per member; remaining members train here)")

    ps = sub.add_parser("simulate", help="generate FD ground truth")
    ps.add_argument("system")
    ps.add_argument("--grid", type=int, default=100)
    ps.add_argument("--steps", type=int, default=500)
    ps.add_argument("--dt", type=float, required=True)
    ps.add_argument("--dx", type=float, required=True)
    ps.add_argument("--out", default="truth.npz")
    ps.add_argument("--warmup", type=int, default=0)
    ps.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")

    px = sub.add_parser("export", help="export a trained model as a self-contained "
                        "torch.export serving artifact")
    px.add_argument("experiment")
    px.add_argument("--ckpt", required=True, help="the port's .npz checkpoint (from `run`)")
    px.add_argument("--steps", type=int, default=None,
                    help="rollout length baked into the artifact "
                         "(default: the experiment's infer_steps)")
    px.add_argument("--out", default="model.export.npz")
    px.add_argument("--final-only", action="store_true",
                    help="emit only the final state (no frame streaming)")
    px.add_argument("--cpu", action="store_true", help="trace on the CPU, not the card")

    pi = sub.add_parser("import-pt", help="convert a reference PyTorch .pt checkpoint "
                        "to the port's .npz checkpoint")
    pi.add_argument("pt_path")
    pi.add_argument("--out", default="imported.ckpt.npz")
    pi.add_argument("--cpu", action="store_true", help="accepted for percnn_tpu's flags; "
                    "the import runs on the host")

    pf = sub.add_parser("profile", help="capture a torch.profiler trace of N training "
                        "iterations (Perfetto / chrome://tracing)")
    pf.add_argument("experiment")
    pf.add_argument("--iters", type=int, default=20)
    pf.add_argument("--out", default="runs/profile")
    pf.add_argument("--cache", default="data_cache")
    pf.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")

    sub.add_parser("list", help="list experiment configs")

    args = p.parse_args(argv)

    from percnn_tpu_torch.experiments.configs import EXPERIMENTS

    if args.cmd == "list":
        for name, exp in EXPERIMENTS.items():
            print(f"{name:<18} system={exp.system:<14} grid={exp.grid} "
                  f"dt={exp.dt} steps={exp.train_steps}")
        return 0
    if args.cmd == "simulate":
        return _simulate(args)
    if args.cmd == "import-pt":
        return _import_pt(args)

    if args.experiment not in EXPERIMENTS:
        p.error(f"unknown experiment {args.experiment!r}; ported: {', '.join(EXPERIMENTS)}")
    exp = EXPERIMENTS[args.experiment]

    if args.cmd == "run":
        import math

        import torch

        from percnn_tpu_torch._device import resolve_device
        from percnn_tpu_torch.experiments.runner import run_experiment
        from percnn_tpu_torch.parallel import make_mesh

        device = resolve_device("cpu" if args.cpu else "cuda")
        mesh = None
        if args.mesh:
            axes = ("x", "y", "z")[: exp.cell.ndim]
            if args.mesh == "auto":
                mesh = make_mesh(axes, devices=["cpu"] if args.cpu else None)
            else:
                shape = tuple(int(n) for n in args.mesh.replace("x", ",").split(",") if n)
                n = math.prod(shape)
                devices = (["cpu"] * n if args.cpu else
                           [torch.device("cuda", i) for i in range(torch.cuda.device_count())][:n])
                mesh = make_mesh(axes, shape=shape, devices=devices)
            device = mesh.devices.flat[0]
        res = run_experiment(
            exp, out_dir=args.out, cache_dir=args.cache,
            dtype=torch.float64 if args.x64 else torch.float32,
            n_iters_override=args.iters, isg_pretrain_override=args.isg_iters,
            steps_per_call=args.steps_per_call, resume=args.resume, seed=args.seed,
            device=device, mesh=mesh, parallel_impl=args.parallel,
        )
        print(json.dumps({"experiment": exp.name, "rel_l2": res["rel_l2"],
                          "final_loss": res["history"][-1]}))
        return 0

    if args.cmd == "pipeline":
        return _pipeline(p, args, exp)
    if args.cmd == "export":
        return _export(args, exp)
    if args.cmd == "profile":
        return _profile(args, exp)

    # ensemble
    from percnn_tpu_torch.experiments.ensemble import run_ensemble

    device = "cpu" if args.cpu else "cuda"
    shard = {}
    if args.shard:
        from percnn_tpu_torch.parallel import make_mesh

        mesh = make_mesh(("data",), devices=["cpu"] if args.cpu else None)
        device = mesh.devices.flat[0]
        shard = {"mesh": mesh}
    res = run_ensemble(
        exp, args.members, out_dir=args.out, cache_dir=args.cache,
        n_iters_override=args.iters, isg_pretrain_override=args.isg_iters,
        steps_per_call=args.steps_per_call, seed=args.seed, device=device, **shard,
    )
    print(json.dumps({"experiment": exp.name,
                      "rel_l2_members": res["rel_l2_members"],
                      "rel_l2_mean": res["rel_l2_mean"],
                      "rel_l2_std": res["rel_l2_std"]}))
    return 0


def _pipeline(p: argparse.ArgumentParser, args, exp) -> int:
    """The pipeline verb: run_discovery_pipeline, or run_stage3_from_coefs
    (--stage2-coefs), or run_ensemble_discovery (--ensemble-members); print
    the identified equation as JSON and Stage 3's coefficient table."""
    import dataclasses

    from percnn_tpu_torch.experiments import pipeline

    device = "cpu" if args.cpu else "cuda"
    if args.noise is not None:
        exp = dataclasses.replace(exp, name=f"{exp.name}_n{int(round(args.noise * 100))}",
                                  noise_pct=args.noise)
    frames = None
    if args.stage2_frames:
        a, b = args.stage2_frames.split(":")
        frames = slice(int(a), int(b))
    if args.stage2_coefs:
        dropped = [flag for flag, on in (
            ("--stage1-recon", args.stage1_recon is not None),
            ("--stage2-frames", args.stage2_frames is not None),
            ("--stage2-subsample", args.stage2_subsample != 0.2),
            ("--stage2-draws", args.stage2_draws is not None),
            ("--ensemble-members", args.ensemble_members is not None),
        ) if on]
        if dropped:
            p.error(f"--stage2-coefs skips Stage-1/2 entirely; "
                    f"{', '.join(dropped)} would be silently ignored")
        res = pipeline.run_stage3_from_coefs(
            exp, args.stage2_coefs, out_dir=args.out, cache_dir=args.cache,
            stage3_iters=args.stage3_iters, seed=args.seed, device=device)
    elif args.ensemble_members is not None:
        if args.stage1_recon is not None:
            p.error("--ensemble-members trains its own members; use "
                    "--member-recon (repeatable) to reuse saved ones")
        res = pipeline.run_ensemble_discovery(
            exp, args.ensemble_members, out_dir=args.out, cache_dir=args.cache,
            stage1_iters=args.stage1_iters, aggregate=args.ensemble_aggregate,
            member_recons=args.member_recon, stage2_frames=frames,
            stage2_subsample=args.stage2_subsample, stage2_draws=args.stage2_draws,
            stage3_iters=args.stage3_iters, steps_per_call=args.steps_per_call,
            seed=args.seed, device=device)
    else:
        res = pipeline.run_discovery_pipeline(
            exp, out_dir=args.out, cache_dir=args.cache, stage1_iters=args.stage1_iters,
            stage3_iters=args.stage3_iters, stage2_frames=frames,
            stage2_subsample=args.stage2_subsample, stage2_draws=args.stage2_draws,
            steps_per_call=args.steps_per_call, stage1_recon=args.stage1_recon,
            seed=args.seed, device=device)
    s2 = res["stage2"]
    out = {
        "experiment": exp.name,
        "stage1_rel_l2": res["stage1"].get("rel_l2"),
        "stage2_u": {n: float(c) for n, c in zip(s2["names"], s2["w_u"][:, 0]) if c != 0},
        "stage2_v": {n: float(c) for n, c in zip(s2["names"], s2["w_v"][:, 0]) if c != 0},
        "stage3_rel_l2": res["stage3"]["rel_l2"],
    }
    for k in ("metrics_u", "metrics_v"):
        if k in s2:
            out[k] = s2[k]
    if "uq" in res:
        names = res["uq"]["names"]
        for eq in ("u", "v"):
            mu, sd = res["uq"][f"coef_mean_{eq}"], res["uq"][f"coef_std_{eq}"]
            vote = res["uq"][f"support_vote_{eq}"]
            out[f"uq_{eq}"] = {names[i]: {"mean": float(mu[i]), "std": float(sd[i]),
                                          "vote": float(vote[i])}
                               for i in range(len(names)) if vote[i] > 0}
    print(json.dumps(out, indent=2))
    print(res["stage3"]["coef_table"])
    return 0


def _simulate(args) -> int:
    """The simulate verb: the system's default IC on a --grid, --warmup
    steps discarded, then --steps frames of RK4 (f64) saved as ``uv``."""
    from percnn_tpu_torch.data.io import save_npz
    from percnn_tpu_torch.data.simulate import default_ic, simulate

    device = "cpu" if args.cpu else "cuda"
    h0 = default_ic(args.system, args.grid)
    if args.warmup:
        h0 = simulate(args.system, h0, args.warmup, args.dt, args.dx, device=device)[-1]
    truth = simulate(args.system, h0, args.steps, args.dt, args.dx, device=device)
    save_npz(args.out, truth)
    print(f"wrote {args.out}: {truth.shape}")
    return 0


def _import_pt(args) -> int:
    """The import-pt verb: the reference checkpoint's weights and Adam state
    as the port's checkpoint {'params', 'opt_state': {'step', 'exp_avg',
    'exp_avg_sq'}} (core/train.TrainState.as_tree).  Optimizer state that
    cannot be mapped is reported and left out: the moments are then zero
    and the step 0, a fresh Adam on the imported weights."""
    import numpy as np

    from percnn_tpu_torch.bridge import _map_tree
    from percnn_tpu_torch.core.checkpoint import flatten_with_paths, save_checkpoint
    from percnn_tpu_torch.data.pt_import import import_reference_checkpoint, map_adam_moments

    cell, isg, raw = import_reference_checkpoint(args.pt_path)
    params = {"cell": cell, **({"isg": isg} if isg is not None else {})}
    meta = {"source": args.pt_path}
    try:
        moments = map_adam_moments(raw)
    except (ValueError, KeyError) as e:
        # a non-Adam optimizer, or positions that do not match the state dict
        print(f"warning: optimizer state not imported ({e!r})")
        moments = None

    if moments is not None:
        def as_params(pair):
            cell_m, isg_m = pair
            return {"cell": cell_m, **({"isg": isg_m} if isg is not None else {})}

        opt = {"step": np.asarray(moments["count"], np.float32),
               "exp_avg": as_params(moments["mu"]), "exp_avg_sq": as_params(moments["nu"])}
        meta["iteration"] = moments["count"]
    else:
        opt = {"step": np.asarray(0.0, np.float32),
               "exp_avg": _map_tree(np.zeros_like, params),
               "exp_avg_sq": _map_tree(np.zeros_like, params)}
    save_checkpoint(args.out, {"params": params, "opt_state": opt}, meta=meta)
    n = len(flatten_with_paths(params))
    print(f"wrote {args.out}: {n} tensors"
          + (" (cell + isg)" if isg is not None else " (cell only)")
          + (f" + Adam state @ step {moments['count']}" if moments is not None else ""))
    return 0


def _export(args, exp) -> int:
    """The export verb: serving.export_model of a checkpoint's params, the
    ISG baked in when the experiment and the checkpoint have one."""
    from percnn_tpu_torch.core.checkpoint import load_checkpoint_tree
    from percnn_tpu_torch.serving import export_model

    tree, _meta = load_checkpoint_tree(args.ckpt)
    params = tree.get("params", tree)
    n_steps = args.steps if args.steps is not None else exp.infer_steps
    if exp.isg is not None and "isg" in params:
        input_shape = (exp.grid // exp.isg.scale,) * exp.cell.ndim + (2,)
        isg_cfg = exp.isg
    else:
        input_shape = (exp.grid,) * exp.cell.ndim + (2,)
        isg_cfg = None
    export_model(params, exp.cell, n_steps, input_shape, isg_cfg=isg_cfg,
                 final_only=args.final_only, path=args.out,
                 device="cpu" if args.cpu else "cuda")
    print(f"wrote {args.out}: input {input_shape}, {n_steps} steps"
          f"{' (final only)' if args.final_only else ''}")
    return 0


def _profile(args, exp) -> int:
    """The profile verb: one warm-up run of one iteration (the kernels'
    builds and first calls stay out of the trace), then a traced
    run_experiment of --iters iterations; both with an ISG pretrain of one
    iteration.  The trace goes to {out}/{name}.trace/trace.json."""
    import os

    from percnn_tpu_torch.experiments.runner import run_experiment
    from percnn_tpu_torch.utils.profiling import TRACE_FILE, trace

    device = "cpu" if args.cpu else "cuda"
    trace_dir = os.path.join(args.out, f"{exp.name}.trace")
    run_experiment(exp, out_dir=args.out, cache_dir=args.cache, n_iters_override=1,
                   isg_pretrain_override=1, seed=0, device=device)
    with trace(trace_dir):
        run_experiment(exp, out_dir=args.out, cache_dir=args.cache,
                       n_iters_override=args.iters, isg_pretrain_override=1, seed=0,
                       device=device)
    print(f"trace written to {os.path.join(trace_dir, TRACE_FILE)} (open with Perfetto "
          f"or chrome://tracing)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
