"""Numerical-safety tooling: a checked call that names the op that first
made a non-finite value, a host-side finite check over a tree, and an
in-graph scrub.

Counterpart of percnn_tpu/utils/debug.py.  JAX instruments a function with
``checkify.float_checks``; here a ``TorchDispatchMode`` watches every ATen
op the call runs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from percnn_tpu_torch.core.checkpoint import flatten_with_paths


class CheckError:
    """What ``checked`` found: ``get()`` gives the message or None,
    ``throw()`` raises FloatingPointError with it."""

    def __init__(self, message: str | None = None):
        self.message = message

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)

    def __repr__(self) -> str:
        return f"CheckError({self.message!r})"


def _float_tensors(tree) -> list:
    out = []
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() or tree.is_complex() else []
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            out.extend(_float_tensors(x))
    return out


def _n_bad(tensors) -> int:
    return sum(int((~torch.isfinite(t)).sum()) for t in tensors)


class _FirstNonFinite(TorchDispatchMode):
    """Records the first op whose floating outputs hold a non-finite value
    while its floating inputs hold none (the nan check of checkify: an op
    that only passes a NaN on is not the one that made it)."""

    def __init__(self):
        super().__init__()
        self.message = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.message is None:
            bad = _n_bad(_float_tensors(out))
            if bad and not _n_bad(_float_tensors([args, kwargs or {}])):
                self.message = f"non-finite values produced by {func}: {bad} of its outputs"
        return out


def checked(fn):
    """Wrap fn so that a call returns ``(err, out)``; ``err.throw()`` raises
    FloatingPointError naming the first ATen op that turned finite inputs
    into a NaN or an Inf, or, failing that, the output leaf of fn that holds
    one.

    >>> safe_step = checked(lambda h: pi_cell_step(params, h, cfg))
    >>> err, out = safe_step(h)
    >>> err.throw()   # raises if a NaN appeared anywhere inside

    The watch sees ops that pass PyTorch's dispatcher.  A hand-written
    kernel launched through ctypes does not: a NaN it makes is reported at
    the next ATen op that reads it only as an input (so not as made there),
    and at fn's outputs, which are checked too.  The serving op
    ``percnn_tpu_torch::serve_rollout`` does pass the dispatcher and is
    named when its answer holds a NaN made inside it.  Every op is followed
    by a finite check, a device sync on the card: a debugging tool.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        mode = _FirstNonFinite()
        with mode:
            out = fn(*args, **kwargs)
        message = mode.message
        if message is None:
            for path, leaf in flatten_with_paths(out):
                if isinstance(leaf, torch.Tensor) and _n_bad(_float_tensors(leaf)):
                    message = (f"non-finite values in the output{path} of "
                               f"{getattr(fn, '__name__', fn)}: {_n_bad([leaf])} of them")
                    break
        return CheckError(message), out

    return wrapped


def assert_all_finite(tree, name: str = "tree") -> None:
    """Host-side finite check over a tree of tensors or arrays (post-run
    validation)."""
    for path, leaf in flatten_with_paths(tree):
        if leaf is None:
            continue
        a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if not np.isfinite(a).all():
            bad = int((~np.isfinite(a)).sum())
            raise FloatingPointError(f"{name}{path}: {bad}/{a.size} non-finite values")


def nan_guard(x: torch.Tensor, replace: float = 0.0) -> torch.Tensor:
    """In-graph NaN/Inf scrub (for diagnostics only: training uses the
    reload watchdog in core/train.py instead of masking)."""
    return torch.where(torch.isfinite(x), x, torch.full_like(x, replace))
