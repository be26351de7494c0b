"""GSPMD's counterpart: DTensor over a torch.distributed process group.

Counterpart of the GSPMD half of percnn_tpu/parallel.  There XLA
partitions one program over a mesh of devices in one process.  Here one
process runs each mesh position (a rank): rank r runs on
``mesh.devices.flat[r]``, and a ``DTensor`` on the ``DeviceMesh`` of the
same shape and axis names (``device_mesh``) holds each rank's part of an
array.  DTensor runs the plain model on those parts and places the
collectives, as XLA does.

- ``P`` stands in for ``PartitionSpec`` and ``placements`` turns it into
  DTensor's placements: ``Shard(d)`` on a mesh dim that the spec names for
  tensor dim d, else ``Replicate()``.
- ``launch(fn, mesh, *args)`` runs ``fn(*args)`` on every rank and returns
  rank 0's result.  Under a process group that is already up (``torchrun``)
  with one rank a mesh position, ``fn`` runs in place.  Otherwise it spawns
  one process a mesh position, joined over ``tcp://127.0.0.1``: NCCL for
  distinct CUDA devices, gloo for a CPU mesh; a mesh that repeats a CUDA
  device is refused (``backend_for``).  A rank's error or the time limit
  kills every rank and raises with the failing rank's traceback: nothing
  falls back to one process or to the CPU.
- Every rank must make the same collective calls in the same order, so
  every host read of a DTensor (``host``) is made on all ranks and gives
  all of them the same value; only rank 0 (``is_writer``) writes files.
  These reads live in _device.py, below ``core``, and are named here too.

Along a cut dim, a periodic roll or a k x k branch's circular pad trades
halos with the neighbouring ranks by point-to-point sends
(``ops/spmd_halo.py``), as XLA's collective-permute does; the dim stays
cut.
"""

from __future__ import annotations

import datetime
import faulthandler
import functools
import json
import multiprocessing
import multiprocessing.connection
import os
import socket
import sys
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from percnn_tpu_torch._device import (  # noqa: F401 (the helpers' home is _device)
    barrier,
    distribute,
    full,
    host,
    in_group,
    is_dtensor,
    is_writer,
    local_like,
    rank,
)

DEFAULT_TIMEOUT = 1800.0   # seconds a launch may take, spawn included


class P(tuple):
    """A partition spec: one entry a tensor dim, a mesh axis name, a tuple of
    axis names (in mesh order) or None (the dim is not cut).  ``P()``
    replicates; missing trailing entries are None, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)   # pickle (a launch's arguments) rebuilds P(*entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def placements(mesh, spec) -> tuple:
    """DTensor placements of `spec` on `mesh` (a parallel.Mesh): for each
    mesh dim, Shard(d) if the spec names its axis for tensor dim d, else
    Replicate()."""
    from torch.distributed.tensor import Replicate, Shard

    owner: dict = {}
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            if name is None:
                continue
            if name not in mesh.axis_names:
                raise ValueError(f"spec {spec!r} names axis {name!r}, not one of "
                                 f"{mesh.axis_names}")
            if name in owner:
                raise ValueError(f"spec {spec!r} names axis {name!r} twice")
            owner[name] = d
        order = [mesh.axis_names.index(n) for n in names if n is not None]
        if order != sorted(order):
            raise ValueError(f"spec {spec!r}: the axes of one dim must be in mesh order "
                             f"{mesh.axis_names}")
    return tuple(Shard(owner[n]) if n in owner else Replicate() for n in mesh.axis_names)


def rank_device(mesh) -> torch.device:
    """This rank's device: ``mesh.devices.flat[rank]``."""
    return mesh.devices.flat[rank()]


def _check_group(mesh) -> None:
    if not in_group():
        raise RuntimeError("no process group: run this on every rank, under "
                           "parallel.launch() or torchrun")
    n = mesh.devices.size
    if dist.get_world_size() != n:
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, the mesh "
                         f"{n} positions: one rank a mesh position")


def _mesh_key(mesh) -> tuple:
    return (mesh.devices.shape, mesh.axis_names, tuple(str(d) for d in mesh.devices.flat))


_DEVICE_MESHES: dict = {}


def device_mesh(mesh):
    """The DeviceMesh of `mesh` over the default group (same shape and axis
    names; rank r at position r in C order), made once a process.  Sets a
    CUDA rank's current device to its mesh device."""
    from torch.distributed.device_mesh import DeviceMesh

    _check_group(mesh)
    dev = rank_device(mesh)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    key = _mesh_key(mesh)
    if key not in _DEVICE_MESHES:
        _DEVICE_MESHES[key] = DeviceMesh(
            dev.type, torch.arange(mesh.devices.size).reshape(mesh.devices.shape),
            mesh_dim_names=mesh.axis_names)
    return _DEVICE_MESHES[key]


def tree_map(fn, tree):
    """fn on every leaf of nested dicts, lists, tuples and named tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def replicated_local(fn: Callable, *args):
    """fn run whole on every rank: its DTensor arguments gathered (a
    replicated one is already whole) and passed as plain tensors, its
    tensor outputs replicated DTensors on their mesh (differentiable both
    ways).  The ISG runs so (``runner.replicated_isg``)."""
    from torch.distributed.tensor import DTensor, Replicate

    meshes = []
    tree_map(lambda x: meshes.append(x.device_mesh) if is_dtensor(x) else None, args)
    dmesh = meshes[0]
    rep = [Replicate()] * dmesh.ndim
    local = tree_map(lambda x: x.redistribute(dmesh, rep).to_local() if is_dtensor(x) else x,
                     args)
    out = fn(*local)
    return tree_map(lambda y: DTensor.from_local(y, dmesh, rep)
                    if isinstance(y, torch.Tensor) else y, out)


def implicitly_replicated(fn: Callable) -> Callable:
    """fn run with plain tensors taken as replicated DTensors (the
    constants a model makes inside its ops: zeros, interpolation
    matrices)."""
    from torch.distributed.tensor.experimental import implicit_replication

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with implicit_replication():
            return fn(*args, **kwargs)

    return wrapped


# ---------------------------------------------------------------------------
# launch: one process a mesh position


def backend_for(mesh) -> str:
    """gloo for a CPU mesh, NCCL for a mesh of distinct CUDA devices.

    A mesh that repeats a CUDA device raises: NCCL refuses two ranks on one
    GPU, and gloo, which carries c10d's collectives on CUDA tensors, crashes
    in DTensor's functional collectives on them (a segmentation fault in
    wait_tensor under PyTorch 2.11 on an H100).  One rank on one card is a
    one-position mesh."""
    devs = list(mesh.devices.flat)
    types = {d.type for d in devs}
    if types == {"cpu"}:
        return "gloo"
    if types != {"cuda"}:
        raise ValueError(f"a process-group mesh holds CPU or CUDA devices, got "
                         f"{[str(d) for d in devs]}")
    if len(set(devs)) != len(devs):
        raise ValueError(f"mesh {[str(d) for d in devs]} repeats a CUDA device: NCCL refuses "
                         "two ranks on one GPU, and gloo's DTensor collectives on CUDA "
                         "tensors crash; give each rank its own card (or run on a "
                         "one-position mesh, or a CPU mesh)")
    return "nccl"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host_tree(tree):
    """Tensors on the CPU, for the result file (rank 0's result must hold
    plain tensors: a DTensor's gather is a collective)."""
    def leaf(x):
        if is_dtensor(x):
            raise TypeError("a launched function returns plain tensors (full() them on "
                            "every rank first), not DTensors")
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x

    return tree_map(leaf, tree)


def _rank_main(r: int, world: int, port: int, backend: str, mesh, timeout: float,
               threads: int, libraries: dict, fn: Callable, args: tuple, out_dir: str) -> None:
    """A spawned rank: join the group, run fn; rank 0 writes the result.  A
    native crash prints the rank's Python stack (faulthandler)."""
    faulthandler.enable()
    try:
        from percnn_tpu_torch.ops.kernels import _build

        _build.adopt(libraries)
        dev = mesh.devices.flat[r]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=r,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(*args)
            if r == 0:
                path = os.path.join(out_dir, "result.pt")
                torch.save(_to_host_tree(result), path + ".tmp")
                os.replace(path + ".tmp", path)
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error.{r}.json"), "w") as f:
            json.dump({"time": time.time(), "traceback": traceback.format_exc()}, f)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _failure(procs: list, out_dir: str, why: str) -> RuntimeError:
    """The error of the rank that failed first (by the time it wrote its
    traceback), with every rank's exit code."""
    errors = []
    for r in range(len(procs)):
        path = os.path.join(out_dir, f"error.{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                errors.append((json.load(f), r))
    codes = [p.exitcode for p in procs]
    if not errors:
        return RuntimeError(f"{why}; exit codes {codes}, no traceback written")
    first, r = min(errors, key=lambda e: e[0]["time"])
    return RuntimeError(f"{why}: rank {r} failed first (exit codes {codes}):\n"
                        f"{first['traceback']}")


def _name(fn: Callable) -> str:
    return getattr(fn, "__name__", None) or getattr(getattr(fn, "func", None), "__name__", repr(fn))


def launch(fn: Callable, mesh, *args, timeout: float = DEFAULT_TIMEOUT,
           libraries: tuple = ()) -> Any:
    """Run ``fn(*args)`` on every rank of `mesh` and return rank 0's result.

    Under a process group that is up (torchrun), with as many ranks as the
    mesh has positions, fn runs in place and each rank gets its own result.
    Otherwise one process a mesh position is spawned (fn and args must
    pickle: fn a module-level function of an importable module) and joined
    into a group over ``tcp://127.0.0.1:<free port>`` (``backend_for``);
    rank 0's result comes back through a file, its tensors on the CPU.
    `libraries` are kernel libraries (ops/kernels/_build names) to build
    here before the ranks start, so that they load them instead of each
    building its own; any the ranks need beyond those they build.  The
    ranks import afresh: a module hidden here (``sys.modules[name] = None``)
    is not hidden there (DTensor needs sympy).  A
    rank's error, or `timeout` seconds passing, kills every rank and raises
    RuntimeError (TimeoutError) with the failing rank's traceback.
    """
    n = mesh.devices.size
    if in_group():
        _check_group(mesh)
        return fn(*args)
    backend = backend_for(mesh)
    from percnn_tpu_torch.ops.kernels import _build

    for name in libraries:
        _build.load_library(name)
    threads = max(1, torch.get_num_threads() // n)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="percnn_spmd_") as out_dir:
        port = _free_port()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, port, backend, mesh, timeout, threads,
                                   _build.built(), fn, args, out_dir))
                 for r in range(n)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while True:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    raise _failure(procs, out_dir, f"a rank of {_name(fn)} failed")
                if all(c == 0 for c in codes):
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(str(_failure(
                        procs, out_dir, f"{_name(fn)} did not end within {timeout} s "
                        f"({backend}, {n} ranks)")))
                multiprocessing.connection.wait([p.sentinel for p in procs
                                                 if p.exitcode is None], min(left, 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        return torch.load(os.path.join(out_dir, "result.pt"), weights_only=False)
