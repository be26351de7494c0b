"""PyTorch/CUDA port of percnn_tpu.

The JAX package ``percnn_tpu`` is the reference.  This package mirrors its
layout (``core/cell.py`` here is the counterpart of ``core/cell.py`` there),
keeps its channels-last ``[H, W, 2]`` state at public functions, and runs
the kernels that the JAX package wrote in Pallas as CUDA kernels written for
Hopper (``ops/kernels``).  It imports torch, numpy and the standard library,
never jax or percnn_tpu.

Entry points run on the card: they take ``device="cuda"`` by default and
raise when there is no CUDA device, unless the caller passes ``device="cpu"``.
"""

from percnn_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
