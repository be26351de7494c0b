"""CLI of the port, percnn_tpu's CLI (percnn_tpu/__main__.py) for the verbs
ported so far:

  python -m percnn_tpu_torch ensemble gs2d_recon --members 4 [--iters N] [--cpu]

It runs on the card unless told --cpu.  The other verbs (run, list,
pipeline, simulate, export, import-pt, profile) come with their slices
(ROADMAP.md A5, A8, A9).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="percnn_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

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

    # the one verb so far: ensemble
    if args.shard:
        p.error("--shard (the member axis over a device mesh) is not ported yet: "
                "ROADMAP.md A7")
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
