"""CLI of the port, percnn_tpu's CLI (percnn_tpu/__main__.py) for the verbs
ported so far:

  python -m percnn_tpu_torch run gs2d_recon [--iters N] [--mesh 2,2] [--cpu]
  python -m percnn_tpu_torch ensemble gs2d_recon --members 4 [--iters N] [--cpu]

It runs on the card unless told --cpu.  ``run --mesh`` trains on a
spatially decomposed field (experiments.runner.run_experiment(mesh=...)):
over that many CUDA devices, or with --cpu over a mesh of that many CPU
entries.  The other verbs (list, pipeline, simulate, export, import-pt,
profile) come with their slices (ROADMAP.md A5, A8, A9).
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
                    help="decomposition: the explicit halo exchange, or GSPMD (not ported)")

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
                    help="shard the member axis over all devices (not ported yet)")

    args = p.parse_args(argv)

    from percnn_tpu_torch.experiments.configs import EXPERIMENTS

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

    # ensemble
    if args.shard:
        p.error("--shard (the member axis over a device mesh) is not ported yet: "
                "ROADMAP.md A10")
    from percnn_tpu_torch.experiments.ensemble import run_ensemble

    res = run_ensemble(
        exp, args.members, out_dir=args.out, cache_dir=args.cache,
        n_iters_override=args.iters, isg_pretrain_override=args.isg_iters,
        steps_per_call=args.steps_per_call, seed=args.seed,
        device="cpu" if args.cpu else "cuda",
    )
    print(json.dumps({"experiment": exp.name,
                      "rel_l2_members": res["rel_l2_members"],
                      "rel_l2_mean": res["rel_l2_mean"],
                      "rel_l2_std": res["rel_l2_std"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
