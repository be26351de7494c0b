"""Recurrent rollout of a cell step: segmented gradient checkpointing and
the two-phase backward.

Counterpart of percnn_tpu/core/rollout.py.  ``rollout`` with
``remat=True`` cuts the steps into segments of about sqrt(T) steps and runs
each under ``torch.utils.checkpoint`` (non-reentrant), so back-propagation
keeps O(sqrt(T)) segments' activations and recomputes each segment once:
the ``bptt="remat"`` path of the runner and the plain-autograd reference
for the fused gradients.

``rollout_tp`` is the ``bptt="two_phase"`` path.  Only the state cotangent
of a recurrence is sequential; the parameter gradient is a sum of
independent per-step terms.  So its backward is a reverse sweep of one
``autograd.grad`` a step through the state alone (phase 1), then
``chunked_param_grads`` (phase 2): one ``autograd.grad`` through the step
batched over a chunk of time steps, which sums the chunk's parameter
gradients.  The fused adjoints of ops/kernels run phase 1 in a kernel and
share phase 2.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator

import torch
from torch.utils.checkpoint import checkpoint

from percnn_tpu_torch._device import full_f32


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
            # the steps draw no random numbers: no RNG state to save and
            # restore around the recompute, in a captured graph or not
            part = checkpoint(_unroll, step_fn, h, seg, use_reentrant=False,
                              preserve_rng_state=False)
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


def _flatten(tree) -> list:
    """The leaves of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flatten(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(like, leaves: Iterator):
    """A tree of `like`'s structure holding the next leaves of `leaves`."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_unflatten(v, leaves) for v in like]
    return next(leaves)


def chunked_param_grads(step_fn: Callable, params, h_prev: torch.Tensor,
                        g_ins: torch.Tensor, n_steps: int, chunk: int):
    """Phase 2 of the two-phase backward: the parameter gradient
    sum_t vjp_params(step_fn at h_t)(g_{t+1}), a tree like `params`.

    step_fn(params, h) -> h_next takes a batch of states along a leading
    dim.  h_prev, g_ins: [n_steps, *state], the steps' inputs and the
    cotangents of their outputs.  Each chunk of `chunk` steps is one
    ``autograd.grad`` through step_fn on [chunk, *state], which sums the
    chunk's gradients, in full float32.
    """
    leaves = [p.detach().requires_grad_(True) for p in _flatten(params)]
    tree = _unflatten(params, iter(leaves))
    sums = [torch.zeros_like(p) for p in leaves]
    with torch.enable_grad(), full_f32():
        for s in range(0, n_steps, chunk):
            out = step_fn(tree, h_prev[s:s + chunk].detach())
            grads = torch.autograd.grad(out, leaves, g_ins[s:s + chunk], allow_unused=True)
            for acc, g in zip(sums, grads):
                if g is not None:
                    acc += g
    return _unflatten(params, iter(sums))


class _RolloutTP(torch.autograd.Function):
    """frames = the rollout of step_fn from h0; backward in two phases."""

    @staticmethod
    def forward(ctx, step_fn, n_steps, pgrad_chunk, like, h0, *leaves):
        params = _unflatten(like, iter(leaves))
        frames = [h0]
        for _ in range(n_steps):
            frames.append(step_fn(params, frames[-1]))
        frames = torch.stack(frames)
        ctx.step_fn, ctx.n_steps, ctx.pgrad_chunk, ctx.like = step_fn, n_steps, pgrad_chunk, like
        ctx.save_for_backward(frames, *leaves)
        return frames

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, frames_bar):
        frames, *leaves = ctx.saved_tensors
        params = _unflatten(ctx.like, (p.detach() for p in leaves))
        g = torch.zeros_like(frames[0])
        g_ins = [None] * ctx.n_steps
        # phase 1: the state cotangent, one step at a time in reverse
        with torch.enable_grad(), full_f32():
            for t in range(ctx.n_steps - 1, -1, -1):
                g_ins[t] = g + frames_bar[t + 1]
                h = frames[t].detach().requires_grad_(True)
                (g,) = torch.autograd.grad(ctx.step_fn(params, h), h, g_ins[t])
        # phase 2: the parameter gradients, batched over time
        bar = chunked_param_grads(ctx.step_fn, params, frames[:-1],
                                  torch.stack(g_ins) if g_ins else frames[:0],
                                  ctx.n_steps, ctx.pgrad_chunk)
        return (None, None, None, None, g + frames_bar[0], *_flatten(bar))


def rollout_tp(step_fn: Callable, params, h0: torch.Tensor, n_steps: int,
               pgrad_chunk: int = 64) -> torch.Tensor:
    """Differentiable rollout with the two-phase backward:
    [n_steps + 1, *h0.shape], frame 0 = h0.

    step_fn(params, h) -> h_next.  Gradients reach h0 and every tensor leaf
    of `params`; pgrad_chunk is phase 2's number of steps a batch.
    """
    return _RolloutTP.apply(step_fn, n_steps, pgrad_chunk, params, h0, *_flatten(params))
