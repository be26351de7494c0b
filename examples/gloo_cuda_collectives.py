"""What a mesh that repeats one CUDA device can run on: ranks on cuda:0,
joined by gloo and by NCCL, each trying c10d's collectives on CUDA tensors
and then DTensor's (a redistribute to Replicate, which waits on a
functional all-gather, and a periodic roll of a cut field).

    python3 examples/gloo_cuda_collectives.py [--ranks 2]

Each rank reports what passed and what raised; a rank that dies (a
segmentation fault) reports nothing, and its exit code says so.  This is
why ``parallel.spmd.launch`` refuses such a mesh: NCCL refuses two ranks
on one GPU, and on PyTorch 2.11 a gloo rank died in DTensor's
``wait_tensor``.  Prints one JSON line a backend.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing
import os
import socket
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rank_main(rank: int, world: int, port: int, backend: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    res = {}
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    x = torch.full((8 * world,), float(rank + 1), device=dev)
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("all_gather_into_tensor",
             lambda: dist.all_gather_into_tensor(torch.empty(8 * world * world, device=dev), x)),
            ("reduce_scatter_tensor",
             lambda: dist.reduce_scatter_tensor(torch.empty(8, device=dev), x)),
            ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
            ("all_to_all_single", lambda: dist.all_to_all_single(torch.empty_like(x), x))):
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except RuntimeError as e:
            res[name] = f"{type(e).__name__}: {str(e)[:200]}"
        _write(out_dir, rank, res)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from percnn_tpu_torch.ops.stencils import periodic_roll

    try:
        mesh = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("x",))
        field = distribute_tensor(torch.rand(100, 100, 2, device=dev), mesh, [Shard(0)])
        res["dtensor_redistribute"] = "started"
        _write(out_dir, rank, res)
        field.redistribute(mesh, [Replicate()]).to_local()
        torch.cuda.synchronize()
        res["dtensor_redistribute"] = "ok"
        periodic_roll(field, 1, 0).full_tensor()
        torch.cuda.synchronize()
        res["dtensor_roll"] = "ok"
    except RuntimeError as e:
        res["dtensor"] = f"{type(e).__name__}: {str(e)[:200]}"
    _write(out_dir, rank, res)
    dist.destroy_process_group()


def _write(out_dir: str, rank: int, res: dict) -> None:
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(res, f)


def main() -> int:
    import torch

    world = int(sys.argv[sys.argv.index("--ranks") + 1]) if "--ranks" in sys.argv else 2
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    ctx = multiprocessing.get_context("spawn")
    for backend in ("gloo", "nccl"):
        with tempfile.TemporaryDirectory() as out_dir, socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
            procs = [ctx.Process(target=rank_main, args=(r, world, port, backend, out_dir))
                     for r in range(world)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(180)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            ranks = {}
            for r in range(world):
                path = os.path.join(out_dir, f"{r}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        ranks[r] = json.load(f)
            print(json.dumps({"backend": backend, "ranks": world,
                              "exit_codes": [p.exitcode for p in procs], "results": ranks}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
