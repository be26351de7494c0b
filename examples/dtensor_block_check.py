"""Check, op by op, that DTensor leaves each rank the block its spec
describes: GS2D's physics residual on frames [201, 100, 100, 2] cut
(Shard(1), Shard(2)) over a 2 x 2 mesh, and one Pi-cell step on a cut
field, each intermediate's local shape against the one its placements
give, and the results against the same ops on the whole tensors.

    python3 examples/dtensor_block_check.py          # four CUDA devices (NCCL)
    python3 examples/dtensor_block_check.py --cpu    # four CPU ranks (gloo)

The residual is written out with ``torch.stack(..., dim=-1)``, as
``pde/systems.py`` wrote it before: on PyTorch 2.11 that stack's block
disagrees with its spec (the port now passes a positive dim).  Prints one
JSON line: the torch version, the errors (or the exception) and every
record whose block and spec disagree.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def check(mesh) -> dict:
    """On every rank: the records and errors of both computations."""
    import torch
    from torch.distributed.tensor import Shard

    from percnn_tpu_torch.core.cell import init_pi_cell, pi_cell_step
    from percnn_tpu_torch.experiments.configs import GS2D_RECON
    from percnn_tpu_torch.ops import stencils
    from percnn_tpu_torch.parallel import replicate, spmd

    dmesh = spmd.device_mesh(mesh)
    dev = spmd.rank_device(mesh)
    try:
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        def expected(t):
            return tuple(compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                               t.placements)[0])
    except ImportError:
        from torch.distributed.tensor._utils import compute_local_shape

        def expected(t):
            return tuple(compute_local_shape(t.shape, t.device_mesh, t.placements))
    records = []

    def log(name, t):
        if spmd.is_dtensor(t):
            records.append({"op": name, "placements": str(tuple(t.placements)),
                            "local": list(t.to_local().shape), "expected": list(expected(t)),
                            "ok": tuple(t.to_local().shape) == expected(t)})
        return t

    def residual(x):
        h = log("frames[:-2]", x[:-2])
        for d in (1, 2):
            for off in (-2, -1, 1, 2):
                log(f"roll({-off}, dim {d})", stencils.periodic_roll(h, -off, d))
        lap = log("laplacian", stencils.laplacian(h, 0.01, dims=(1, 2)))
        u, v = log("u", h[..., 0]), log("v", h[..., 1])
        uvv = log("u v v", u * v * v)
        fu = log("fu", 2e-5 * lap[..., 0] - uvv + 0.04 * (1.0 - u))
        fv = log("fv", 1e-5 * lap[..., 1] + uvv - 0.1 * v)
        st = log("stack(dim=-1)", torch.stack([fu, fv], dim=-1))
        return log("residual", st - log("time derivative", (x[1:-1] - x[:-2]) / 0.5))

    gen = torch.Generator().manual_seed(0)
    frames = torch.rand(201, 100, 100, 2, generator=gen).to(dev)
    errors = {}
    try:
        got = residual(log("frames", spmd.distribute(frames, dmesh, (Shard(1), Shard(2)))))
        errors["residual"] = float((got.full_tensor() - residual(frames)).abs().max())
    except RuntimeError as e:
        errors["residual"] = repr(e)[:300]
    cfg = GS2D_RECON.cell
    params = init_pi_cell(torch.Generator().manual_seed(1), cfg, device="cpu")
    h0 = torch.rand(100, 100, 2, generator=gen).to(dev)
    try:
        step = log("pi_cell_step", pi_cell_step(
            replicate(params, mesh), spmd.distribute(h0, dmesh, (Shard(0), Shard(1))), cfg))
        want = pi_cell_step(spmd.tree_map(lambda t: t.to(dev), params), h0, cfg)
        errors["pi_cell_step"] = float((step.full_tensor() - want).abs().max())
    except RuntimeError as e:
        errors["pi_cell_step"] = repr(e)[:300]
    return {"torch": torch.__version__, "errors": errors,
            "disagreeing": [r for r in records if not r["ok"]], "records": len(records)}


def main() -> int:
    import torch

    from percnn_tpu_torch.parallel import launch, make_mesh

    cpu = sys.argv[1:] == ["--cpu"]
    devices = ["cpu"] * 4 if cpu else [torch.device("cuda", i) for i in range(4)]
    mesh = make_mesh(("x", "y"), shape=(2, 2), devices=devices)
    print(json.dumps(launch(check, mesh, mesh, timeout=600)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
