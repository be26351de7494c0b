"""run_ensemble's spatial two_phase route, graphed against eager.

    python3 examples/spmd_two_phase_graph.py            # one card: a one-position
                                                        # ("data", "x") NCCL mesh
    python3 examples/spmd_two_phase_graph.py --cards 4  # ("data", "x") = (2, 2), a
                                                        # rank a card, x cut in two
    python3 examples/spmd_two_phase_graph.py --cpu      # two gloo ranks, x cut in two

With ``spatial_axes`` each member's loss runs the eager rollout on DTensors
cut over the spatial mesh axes (``ensemble._run_sharded``'s split route).
The script trains two members of GS2D_RECON (full width on the card, T cut
to 50, 6 iterations, one a chunk) with graph on and off from the same
init, holds the losses to each other (rtol 1e-4), and prints one JSON line
with each run's losses and ms per iteration (``chip_smoke.iteration_ms``)
and the card's name and power limit.  A step that cannot be captured
raises on its rank, and the launch's error names the op.  On the CPU both
runs are eager (the CPU replays no graph) and the grid is cut to 16.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

T, ITERS, MEMBERS = 50, 6, 2


def main() -> int:
    args = sys.argv[1:]
    cpu = "--cpu" in args
    cards = int(args[args.index("--cards") + 1]) if "--cards" in args else 1
    if cards not in (1, 4):
        raise SystemExit("--cards takes 1 or 4")
    import numpy as np
    import torch

    from percnn_tpu_torch.experiments.configs import GS2D_RECON
    from percnn_tpu_torch.experiments.ensemble import run_ensemble
    from percnn_tpu_torch.parallel import make_mesh

    sys.modules["matplotlib"] = None
    exp = dataclasses.replace(GS2D_RECON, curriculum=(), train_steps=T, infer_steps=T,
                              train=dataclasses.replace(GS2D_RECON.train, log_every=0))
    if cpu:
        exp = dataclasses.replace(exp, grid=16, train_steps=6, infer_steps=6,
                                  data=dataclasses.replace(exp.data, time_stride=2))
        mesh = make_mesh(("data", "x"), shape=(1, 2), devices=["cpu"] * 2)
        smi = "cpu"
    else:
        if torch.cuda.device_count() < cards:
            raise SystemExit(f"--cards {cards}: {torch.cuda.device_count()} CUDA devices; "
                             "pass --cpu to run on the CPU")
        mesh = make_mesh(("data", "x"), shape=(1, 1) if cards == 1 else (2, 2),
                         devices=[torch.device("cuda", i) for i in range(cards)])
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
    out: dict = {"experiment": exp.name, "grid": exp.grid, "steps": exp.train_steps,
                 "iters": ITERS, "members": MEMBERS, "mesh": mesh.shape}
    with tempfile.TemporaryDirectory(prefix="spmd_two_phase_") as tmp:
        for label, graph in (("graphed", True), ("eager", False)):
            run_dir = os.path.join(tmp, label)
            with chip_smoke.stdout_to_stderr():
                res = run_ensemble(exp, MEMBERS, mesh=mesh, spatial_axes=("x",),
                                   bptt="two_phase", n_iters_override=ITERS, steps_per_call=1,
                                   isg_pretrain_override=5, seed=0, graph=graph,
                                   out_dir=run_dir, cache_dir=os.path.join(tmp, "truth"),
                                   device=mesh.devices.flat[0])
            ms = chip_smoke.iteration_ms(os.path.join(run_dir, f"{exp.name}.ens.metrics.jsonl"))
            out[label] = {"history": res["history"], "rel_l2_members": res["rel_l2_members"],
                          "iteration_ms": ms, "ms_per_iter": chip_smoke.steady_ms(ms, graph)}
    g, e = (np.asarray(out[k]["history"]) for k in ("graphed", "eager"))
    out["history_max_rel_err"] = float(np.max(np.abs(g - e) / np.abs(e)))
    chip_smoke.check(len(g) == ITERS and bool(np.isfinite(g).all())
                     and out["history_max_rel_err"] <= 1e-4,
                     f"graphed losses {g.tolist()} against eager {e.tolist()} (rtol 1e-4)")
    print(json.dumps({**out, "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except chip_smoke.CheckFailed as e:
        print(f"spmd_two_phase_graph: check failed: {e}", file=sys.stderr)
        sys.exit(1)
