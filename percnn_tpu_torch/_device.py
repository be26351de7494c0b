"""Device resolution, the f32 numerics of the port's entry points, and the
process-group reads that the trainer makes.

The last group serves a run on every rank of a process group
(parallel/spmd.py): every rank must make the same collective calls in the
same order, so a host read (``host``) is made on every rank and gives all
of them rank 0's value, and only rank 0 (``is_writer``) writes files.
Outside a group they are the plain reads and writes of one process.  They
live here, below ``core``, so that the trainer needs nothing of
``parallel``."""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch
import torch.distributed as dist


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raise if it is CUDA and absent.

    The port never falls back to the CPU on its own: a caller that wants
    the CPU says ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@contextlib.contextmanager
def full_f32():
    """Run float32 convolutions and matmuls in full float32, not TF32.

    cuDNN takes float32 convolutions to TF32 by default, which keeps about
    three decimal digits; the JAX package measured what reduced precision
    costs this model (docs/DESIGN.md section 3).  The flags are restored on
    exit.
    """
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


@contextlib.contextmanager
def repeatable():
    """Run cuDNN's convolutions by deterministic algorithms.

    Without it cuDNN may pick, for the 3D transposed convolutions of the
    GS3D ISG, an algorithm whose sums are ordered by atomics: two identical
    requests then differ in the last bits (2.4e-7 on an H100).  The serving
    callables run under it, so a request gets the same answer every time.
    The flag is restored on exit.
    """
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def is_dtensor(x) -> bool:
    """Whether x is a DTensor (parallel/spmd.py), without importing
    torch.distributed.tensor: where it is not imported, no DTensor exists."""
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(x, module.DTensor)


def in_group() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def is_writer() -> bool:
    """Whether this process writes files: rank 0, or a process outside a group."""
    return rank() == 0


def barrier() -> None:
    if in_group():
        dist.barrier()


def full(x):
    """The whole tensor of a DTensor (a collective: call it on every rank;
    differentiable), a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def host(x: torch.Tensor) -> np.ndarray:
    """A host read that every rank makes and that gives every rank rank 0's
    value, so that decisions on it are the same on every rank.  Never
    inside a captured step: a graph holds no host read, so it raises
    there."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a host read inside a step being captured into a CUDA graph: "
                           "read the step's results after it (TrainStep.read)")
    x = full(x).detach()
    if in_group():
        x = x.contiguous().clone()
        dist.broadcast(x, 0)
    return x.cpu().numpy()


def distribute(x: torch.Tensor, dmesh, place):
    """A plain tensor placed on DeviceMesh `dmesh` (rank 0's data is the
    source), or a DTensor redistributed there; a no-op when it is already so."""
    from torch.distributed.tensor import distribute_tensor

    if is_dtensor(x):
        return x if tuple(x.placements) == tuple(place) else x.redistribute(dmesh, place)
    dev = torch.device(dmesh.device_type, torch.cuda.current_device()) \
        if dmesh.device_type == "cuda" else torch.device(dmesh.device_type)
    return distribute_tensor(x.detach().to(dev), dmesh, place)


def local_like(x: torch.Tensor, like):
    """Plain tensor `x` laid out as `like` (a DTensor, or a plain tensor on
    the device of `like`)."""
    if is_dtensor(like):
        return distribute(x, like.device_mesh, like.placements)
    return x.to(device=like.device, dtype=like.dtype)
