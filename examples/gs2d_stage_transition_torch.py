#!/usr/bin/env python3
"""GS2D_RECON's curriculum up to the T = 800 stage, then that stage's first
iterations from one saved state by each training route.

    python3 examples/gs2d_stage_transition_torch.py [--seed 0] [--iters 60]
        [--out DIR] [--cpu] [--from CKPT] [--routes fused_pg,...] [--evaluate]

Runs what run_experiment(GS2D_RECON, seed=...) runs before its last stage
(truth, ISG pretrain, 2000 iterations at T = 200 and at T = 400, the
runner's own functions and the trainer), saves the parameters it reached
(``<out>/gs2d_stage2_seed<seed>.ckpt.npz``, save_checkpoint's format, which
both packages read), then trains the T = 800 stage from them for --iters
iterations, one host read an iteration, by each bptt route of
build_loss_fn ("fused_pg", the kernels the runner takes, "two_phase" and
"remat"), each with a fresh Adam as the runner starts a stage.  Prints one
JSON line: each route's loss at every iteration and its first non-finite
iteration, beside the card's name and power limit.  It answers whether a
divergence at the switch to T = 800 comes from the kernels or from the
state training reached.  --from CKPT starts the T = 800 stage from a saved
state instead of training up to it; --routes picks the routes; --evaluate
scores the first route's parameters after the stage as run_experiment does
(the 2500-step rollout against the truth).  Imports neither jax nor
percnn_tpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROUTES = ("fused_pg", "two_phase", "remat")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--out", default=os.path.join("runs", "gs2d_transition"))
    ap.add_argument("--cache", default="data_cache")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--from", dest="start", default=None,
                    help="a saved state to start the T = 800 stage from")
    ap.add_argument("--routes", default=",".join(ROUTES))
    ap.add_argument("--evaluate", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from percnn_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
    from percnn_tpu_torch.core.train import pretrain_isg, train
    from percnn_tpu_torch.experiments.configs import GS2D_RECON
    from percnn_tpu_torch.experiments.runner import (build_isg_pretrain_loss, build_loss_fn,
                                                     evaluate, init_model, make_dataset,
                                                     setup_problem)

    if not args.cpu and not torch.cuda.is_available():
        print("gs2d_stage_transition_torch: no CUDA device; pass --cpu", file=sys.stderr)
        return 2
    dev = torch.device("cpu" if args.cpu else "cuda")
    exp = GS2D_RECON
    os.makedirs(args.out, exist_ok=True)
    seconds = {}
    t0 = time.perf_counter()
    truth = make_dataset(exp, cache_dir=args.cache, device=dev)
    seconds["truth"] = time.perf_counter() - t0
    prob = setup_problem(exp, truth, device=dev)
    params = init_model(exp, torch.Generator().manual_seed(args.seed), device=dev)
    stages = list(exp.curriculum) + [exp.train_steps]
    per_stage = exp.train.n_iters // len(stages)
    history = {}
    if args.start:
        path = args.start
        params = load_checkpoint(path, params)[0]
    else:
        t0 = time.perf_counter()
        params["isg"] = pretrain_isg(build_isg_pretrain_loss(prob), params["isg"],
                                     n_iters=exp.isg_pretrain_iters, device=dev)
        seconds["isg_pretrain"] = time.perf_counter() - t0
        for steps in stages[:-1]:
            t0 = time.perf_counter()
            params, h = train(build_loss_fn(prob, steps), params,
                              dataclasses.replace(exp.train, n_iters=per_stage,
                                                  log_every=10 ** 9),
                              device=dev)
            seconds[f"T{steps}"] = time.perf_counter() - t0
            history[f"T{steps}"] = {"first": h[0], "last": h[-1], "min": min(h)}
        path = os.path.join(args.out, f"gs2d_stage2_seed{args.seed}.ckpt.npz")
        save_checkpoint(path, params, {"experiment": exp.name, "seed": args.seed,
                                       "stages_done": stages[:-1]})

    routes = {}
    names = args.routes.split(",")
    for bptt in names:
        t0 = time.perf_counter()
        trained, h = train(build_loss_fn(prob, stages[-1], bptt=bptt), params,
                           dataclasses.replace(exp.train, n_iters=args.iters, steps_per_call=1,
                                               log_every=10 ** 9),
                           device=dev)
        bad = [i for i, x in enumerate(h) if not math.isfinite(x)]
        routes[bptt] = {"first_nonfinite": bad[0] if bad else None, "loss": h,
                        "seconds": time.perf_counter() - t0}
        if args.evaluate and bptt == names[0]:
            m = evaluate(trained, prob, min(exp.infer_steps, truth.shape[0] - 1))
            routes[bptt].update({k: m[k] for k in ("rel_l2", "stable_frames", "diverged")})
    smi = shutil.which("nvidia-smi")
    card = (subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
            if smi and dev.type == "cuda" else None)
    print(json.dumps({"seed": args.seed, "device": dev.type, "card": card,
                      "torch": torch.__version__, "checkpoint": path,
                      "stages": history, "seconds": seconds, "T": stages[-1],
                      "routes": routes},
                     default=lambda x: None if isinstance(x, float) else str(x)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
