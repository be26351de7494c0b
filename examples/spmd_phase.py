"""Run the ``spmd`` phase of chip_smoke.py alone (``chip_smoke.spmd_phase``).

    python3 examples/spmd_phase.py             # one card, one-position meshes
    python3 examples/spmd_phase.py --cards 4   # four cards, one rank a card:
                                               # a 2 x 2 mesh and a ("data",) mesh of 4
    python3 examples/spmd_phase.py --cpu       # four gloo ranks on the CPU, shrunk

With four cards (or four CPU ranks) each ensemble rank holds one of the
four members, and the phase checks each rank's launches; the GS2D and
Burgers gspmd runs cut their 100 x 100 grids into 50 x 50 blocks, whose
halos cross the cards (part (d) checks that rank 0 sent them).  On the CPU the
wrappers run their plain versions, so every count must be 0, and the
configuration is cut to a 16 x 16 grid and a few steps.  The script checks
that the phase ran on as many ranks as the meshes have positions, prints
the phase's JSON line, and exits non-zero if a check failed.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main() -> int:
    args = sys.argv[1:]
    cpu = "--cpu" in args
    cards = 4 if cpu else int(args[args.index("--cards") + 1]) if "--cards" in args else 1
    if cards not in (1, 4):
        raise SystemExit("--cards takes 1 or 4")
    import numpy as np
    import torch

    from percnn_tpu_torch.bridge import unflatten_dotted
    from percnn_tpu_torch.experiments.configs import BURGERS_STAGE1, GS2D_RECON
    from percnn_tpu_torch.parallel import make_mesh

    sys.modules["matplotlib"] = None   # as in chip_smoke.py before its viz phase
    sizes = {}
    exp, burgers = GS2D_RECON, BURGERS_STAGE1
    if cpu:
        devices = [torch.device("cpu")] * 4
        exp = dataclasses.replace(exp, grid=16, train_steps=8, infer_steps=10, curriculum=(),
                                  data=dataclasses.replace(exp.data, time_stride=2))
        burgers = dataclasses.replace(burgers, grid=16,
                                      data=dataclasses.replace(burgers.data, time_stride=2))
        sizes = dict(steps=6, stage_t=8, iters=3, ens_iters=3, isg_iters=5, eval_steps=10,
                     burgers_t=6)
        smi = "cpu"
    else:
        from percnn_tpu_torch.ops.kernels import _build

        if torch.cuda.device_count() < cards:
            raise SystemExit(f"--cards {cards}: {torch.cuda.device_count()} CUDA devices")
        devices = [torch.device("cuda", i) for i in range(cards)]
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            list(pool.map(_build.load_library, ("cell2d", "backward2d", "batched2d", "adj2d",
                                                "cell2d_kxk", "backward2d_kxk")))
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
    n = len(devices)
    spmd_mesh = make_mesh(("x", "y"), shape=(2, 2) if n == 4 else (1, 1), devices=devices)
    data_mesh = make_mesh(("data",), shape=(n,), devices=devices)
    with np.load(chip_smoke.GOLDEN) as z:
        cell_np = unflatten_dotted({k: z[k] for k in z.files}, "cell.")
    out = chip_smoke.spmd_phase(devices[0], spmd_mesh, data_mesh, cell_np=cell_np,
                                halo_stage=None, exp=exp, burgers=burgers, **sizes)
    chip_smoke.check(out["world_size"] == n
                     and all(len(c["launches_by_rank"]) == n for c in out["c"].values()),
                     f"the phase ran on {out['world_size']} ranks, the meshes have {n} positions")
    print(json.dumps({"phase": "spmd", **out, "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except chip_smoke.CheckFailed as e:
        print(f"spmd_phase: check failed: {e}", file=sys.stderr)
        sys.exit(1)
