"""Device resolution and the f32 numerics of the port's entry points."""

from __future__ import annotations

import contextlib

import torch


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
