"""Recurrent rollout of a cell step, forward only.

Counterpart of the forward half of percnn_tpu/core/rollout.py (``rollout``
and ``rollout_final``).  Gradients through a rollout come with training.
"""

from __future__ import annotations

from typing import Callable

import torch


def rollout(step_fn: Callable[[torch.Tensor], torch.Tensor], h0: torch.Tensor,
            n_steps: int) -> torch.Tensor:
    """Unroll `step_fn` n_steps times; return [n_steps + 1, *h0.shape]
    with frame 0 = h0."""
    frames = [h0]
    for _ in range(n_steps):
        frames.append(step_fn(frames[-1]))
    return torch.stack(frames)


def rollout_final(step_fn: Callable[[torch.Tensor], torch.Tensor],
                  h0: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Final state only."""
    h = h0
    for _ in range(n_steps):
        h = step_fn(h)
    return h
