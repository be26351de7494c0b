"""Recurrent rollout of a cell step, with segmented gradient checkpointing.

Counterpart of ``rollout``, ``_pick_segment`` and ``rollout_final`` in
percnn_tpu/core/rollout.py.  With ``remat=True`` the steps are cut into
segments of about sqrt(T) steps and each segment runs under
``torch.utils.checkpoint`` (non-reentrant), so back-propagation keeps
O(sqrt(T)) segments' activations and recomputes each segment once.  This is
the ``bptt="remat"`` path of the runner and the plain-autograd reference for
the fused gradients.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint


def _pick_segment(n_steps: int, target: int | None = None) -> int:
    """Largest divisor of n_steps not exceeding ~sqrt(n_steps) (or target)."""
    if target is None:
        target = max(1, int(math.sqrt(n_steps)))
    best = 1
    for d in range(1, n_steps + 1):
        if n_steps % d == 0 and d <= target:
            best = d
    return best


def _unroll(step_fn: Callable[[torch.Tensor], torch.Tensor], h: torch.Tensor,
            n_steps: int) -> torch.Tensor:
    """The n_steps states after h, stacked: [n_steps, *h.shape]."""
    out = []
    for _ in range(n_steps):
        h = step_fn(h)
        out.append(h)
    return torch.stack(out)


def rollout(step_fn: Callable[[torch.Tensor], torch.Tensor], h0: torch.Tensor,
            n_steps: int, *, remat: bool = True,
            segment: int | None = None) -> torch.Tensor:
    """Unroll `step_fn` n_steps times; return [n_steps + 1, *h0.shape] with
    frame 0 = h0.

    remat: checkpoint each segment when autograd records (a rollout under
    no_grad or inference_mode has nothing to checkpoint).
    segment: inner segment length (auto ~sqrt(n_steps) divisor if None).
    """
    if n_steps == 0:
        return h0[None]
    remat = remat and torch.is_grad_enabled()
    if segment is None and remat and n_steps > 4 and _pick_segment(n_steps) == 1:
        # a prime n_steps has no useful divisor: peel one step off the
        # front so the remaining (even) count gets ~sqrt(T) segments
        h1 = step_fn(h0)
        rest = rollout(step_fn, h1, n_steps - 1, remat=remat)
        return torch.cat([h0[None], rest], dim=0)
    seg = segment if segment is not None else _pick_segment(n_steps)
    if n_steps % seg != 0:
        raise ValueError(f"segment {seg} must divide n_steps {n_steps}")
    frames = [h0[None]]
    h = h0
    for _ in range(n_steps // seg):
        if remat:
            part = checkpoint(_unroll, step_fn, h, seg, use_reentrant=False)
        else:
            part = _unroll(step_fn, h, seg)
        frames.append(part)
        h = part[-1]
    return torch.cat(frames, dim=0)


def rollout_final(step_fn: Callable[[torch.Tensor], torch.Tensor],
                  h0: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Final state only."""
    h = h0
    for _ in range(n_steps):
        h = step_fn(h)
    return h
