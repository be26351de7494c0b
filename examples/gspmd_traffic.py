"""The traffic of the port's gspmd route, counted: one GS2D training loss
and its backward at full width (100 x 100, the golden-free random init) on
a 2 x 2 mesh of CPU ranks (gloo), at T = 1 and T = 2, so that the
difference is one step's.  Every collective DTensor issues is seen by a
dispatch mode in each rank (the op and the bytes of its input on the
rank); the halo exchange's point-to-point sends (ops/spmd_halo.py: the
periodic rolls and pads along cut dims) are its own counts, under
"halo_exchange".  Rank 0 prints one JSON line.

    PYTHONPATH=. python examples/gspmd_traffic.py [--steps 1 2] [--mesh 2 2]

The traffic is the same on any device (it follows the placements), so this
runs on the CPU.  The bytes are those each rank hands to a collective (an
all-gather of a B-byte block moves B to each of the other g - 1 ranks) or
sends to a neighbour.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def traffic(steps: tuple, mesh) -> dict:
    """On every rank: the collectives of the gspmd loss and its backward
    at each T in `steps`, by op, and the halo exchange's sends: calls and
    bytes handed in."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from percnn_tpu_torch.experiments import runner
    from percnn_tpu_torch.experiments.configs import GS2D_RECON
    from percnn_tpu_torch.ops import spmd_halo
    from percnn_tpu_torch.parallel import replicate, spmd

    class Counting(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = defaultdict(lambda: {"calls": 0, "bytes": 0})

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented   # DTensor first: its collectives come back here
            name = func._schema.name
            op = name.split("::")[1]
            if name.startswith("_c10d_functional::") and op not in ("wait_tensor",
                                                                  "_wrap_tensor_autograd"):
                first = args[0]
                tensors = first if isinstance(first, (list, tuple)) else [first]
                rec = self.ops[op]
                rec["calls"] += 1
                rec["bytes"] += sum(t.numel() * t.element_size() for t in tensors)
            return func(*args, **(kwargs or {}))

    exp = GS2D_RECON
    truth = runner.make_dataset(exp, n_frames=max(steps) + 1, cache_dir=None, device="cpu")
    prob = runner.setup_problem(exp, truth, device="cpu")
    params = spmd.tree_map(lambda x: x.requires_grad_(True), replicate(
        runner.init_model(exp, torch.Generator().manual_seed(0), device="cpu"), mesh))
    out = {}
    for t in steps:
        loss_fn = spmd.implicitly_replicated(runner.build_loss_fn(
            runner.spmd_problem(prob, mesh), t,
            rollout_fn=runner.make_mesh_rollout_fn(prob, t, mesh, impl="gspmd")))
        spmd_halo.sends = spmd_halo.bytes_sent = 0
        with Counting() as mode:
            total, _ = loss_fn(params)
            total.backward()
        out[t] = {**mode.ops, "halo_exchange": {"calls": spmd_halo.sends,
                                                "bytes": spmd_halo.bytes_sent}}
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, nargs=2, default=(1, 2))
    p.add_argument("--mesh", type=int, nargs=2, default=(2, 2))
    args = p.parse_args()
    from percnn_tpu_torch.parallel import launch, make_mesh

    n = args.mesh[0] * args.mesh[1]
    mesh = make_mesh(("x", "y"), shape=tuple(args.mesh), devices=["cpu"] * n)
    got = launch(traffic, mesh, tuple(args.steps), mesh)
    a, b = args.steps
    per_step = {op: {k: (got[b][op][k] - got[a].get(op, {}).get(k, 0)) / (b - a)
                     for k in ("calls", "bytes")} for op in got[b]}
    print(json.dumps({"mesh": list(args.mesh), "grid": 100, "channels": 2,
                      "by_T": {str(t): got[t] for t in args.steps},
                      "per_step": per_step,
                      "field_bytes": 100 * 100 * 2 * 4}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
