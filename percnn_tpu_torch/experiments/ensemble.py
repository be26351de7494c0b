"""Ensemble training: K independent PeRCNN fits trained together.

Counterpart of percnn_tpu/experiments/ensemble.py.  The K members differ in
their init seed (``seed + k``) and their noise seed (``exp.seed + k``) and
share the truth.  Their parameters are stacked on a leading member axis and
trained by one optimizer on the mean of the members' losses; Adam is
elementwise, so each member trains as it would alone (the 1/K gradient
scale cancels in Adam's m / sqrt(v)).

The member axis is a Python loop where percnn_tpu vmaps (the ISG, the
two-phase loss), or one kernel launch a step for every member (the
``batched`` modes, ops/kernels/batched2d.py).  Not ported yet: sharding the
members over a device mesh (``mesh``, ``spatial_axes``; ROADMAP.md A10).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from percnn_tpu_torch._device import resolve_device
from percnn_tpu_torch.core.isg import isg_apply
from percnn_tpu_torch.core.train import pretrain_isg, train
from percnn_tpu_torch.experiments.configs import ExperimentConfig
from percnn_tpu_torch.experiments.runner import (
    Problem,
    build_isg_pretrain_loss,
    build_loss_fn,
    evaluate,
    init_model,
    make_dataset,
    setup_problem,
)
from percnn_tpu_torch.ops.kernels.backward2d import fused_rollout_tp_2d, fused_rollout_tp_2d_pg
from percnn_tpu_torch.ops.kernels.batched2d import (
    _member,
    fused_rollout_tp_2d_batched,
    fused_rollout_tp_2d_batched_pg,
)
from percnn_tpu_torch.utils.metrics import MetricsLogger

BPTT_MODES = ("fused", "fused_pg", "batched", "batched_pg", "two_phase")


def _stack_trees(trees: list):
    """Same-structured trees -> one tree, each leaf stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack_trees([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def auto_bptt(exp: ExperimentConfig, dtype=torch.float32) -> str:
    """The mode ``bptt="auto"`` picks: percnn_tpu's rule with its TPU-only
    conditions mapped as runner.forward_rollout maps them (the kernels on the
    card, their plain versions on the CPU; no VMEM limit): a float32 2D cell
    with kernel_size 1, 3 or 5 takes the per-member loop of the single
    model's fused rollouts, 'fused_pg' at kernel_size 1 and 'fused' at 3, 5;
    anything else 'two_phase'."""
    cell = exp.cell
    fusable = cell.ndim == 2 and cell.kernel_size in (1, 3, 5) and dtype == torch.float32
    return "fused_pg" if fusable and cell.kernel_size == 1 else "fused" if fusable else "two_phase"


def build_ensemble_loss_fn(exp: ExperimentConfig, problems: list[Problem], n_steps: int,
                           bptt: str):
    """The ensemble's loss over stacked params: loss_fn(params) -> (the mean
    of the members' composite losses, the mean of each aux entry).

    problems[m] holds member m's data.  bptt: 'fused' / 'fused_pg' roll each
    member out by the single model's fused rollout (backward2d.py);
    'batched' / 'batched_pg' roll every member out at once
    (batched2d.py); 'two_phase' runs each member's two-phase loss.
    """
    if bptt not in BPTT_MODES:
        raise ValueError(f"unknown bptt mode {bptt!r}")
    n_members = len(problems)

    def h0_of(params, m):
        prob = problems[m]
        if exp.isg is None:
            return prob.h0
        return isg_apply(_member(params["isg"], m), prob.ic_low, exp.isg)[0]

    def combine(params, frames_for):
        """Per-member composite losses from precomputed frames, averaged:
        the one place the ensemble loss is composed (all fused and batched
        modes share it)."""
        totals, auxs = [], []
        for m in range(n_members):
            frames = frames_for(m)
            t_m, a_m = build_loss_fn(problems[m], n_steps,
                                     rollout_fn=lambda _p, f=frames: f)(_member(params, m))
            totals.append(t_m)
            auxs.append(a_m)
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        return torch.stack(totals).mean(), aux

    if bptt in ("fused", "fused_pg"):
        roll = fused_rollout_tp_2d_pg if bptt == "fused_pg" else fused_rollout_tp_2d

        def loss_fn(params):
            return combine(params, lambda m: roll(_member(params["cell"], m), h0_of(params, m),
                                                  exp.cell, n_steps))
    elif bptt in ("batched", "batched_pg"):
        broll = fused_rollout_tp_2d_batched_pg if bptt == "batched_pg" \
            else fused_rollout_tp_2d_batched

        def loss_fn(params):
            h0_all = torch.stack([h0_of(params, m) for m in range(n_members)])
            frames_all = broll(params["cell"], h0_all, exp.cell, n_steps)
            return combine(params, lambda m: frames_all[m])
    else:
        def loss_fn(params):
            outs = [build_loss_fn(problems[m], n_steps, bptt="two_phase")(_member(params, m))
                    for m in range(n_members)]
            aux = {k: torch.stack([a[k] for _, a in outs]).mean() for k in outs[0][1]}
            return torch.stack([t for t, _ in outs]).mean(), aux

    return loss_fn


def run_ensemble(
    exp: ExperimentConfig,
    n_members: int,
    *,
    out_dir: str = "runs/ensemble",
    cache_dir: str | None = "data_cache",
    dtype=torch.float32,
    n_iters_override: int | None = None,
    isg_pretrain_override: int | None = None,
    steps_per_call: int | None = None,
    mesh=None,
    member_axis: str = "data",
    spatial_axes: tuple = (),
    warmup: int | None = None,
    bptt: str = "auto",
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> dict:
    """Train `n_members` models (distinct init and noise seeds) together on
    `device`: truth, per-member data, the ISG pretrain of every member on
    the mean of their losses, the curriculum, and each member's evaluation.

    bptt: 'auto' (auto_bptt), or one of BPTT_MODES (build_ensemble_loss_fn).
    mesh / spatial_axes / member_axis: percnn_tpu's sharding over a device
    mesh; not ported (a mesh or spatial axes raise NotImplementedError).
    The checkpoint (``<out_dir>/<name>.ens.ckpt.npz``) holds the stacked
    params; the log is ``<name>.ens.metrics.jsonl``.  Returns the params,
    the loss history and the members' rel-L2 with its mean and spread.
    """
    if mesh is not None or spatial_axes:
        raise NotImplementedError("ensemble training over a device mesh (mesh=, "
                                  "spatial_axes=) is not ported yet: ROADMAP.md A10")
    if bptt == "auto":
        bptt = auto_bptt(exp, dtype)
    if bptt not in BPTT_MODES:
        raise ValueError(f"unknown bptt mode {bptt!r}")
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(out_dir, f"{exp.name}.ens.metrics.jsonl"),
                           echo_every=exp.train.log_every)
    if warmup is None:
        warmup = 100 if exp.system == "lambda_omega" else 0
    truth = make_dataset(exp, warmup=warmup, cache_dir=cache_dir, device=dev)

    problems, params_list = [], []
    for k in range(n_members):
        exp_k = dataclasses.replace(exp, seed=exp.seed + k)
        problems.append(setup_problem(exp_k, truth, dtype, device=dev))
        params_list.append(init_model(exp, torch.Generator().manual_seed(seed + k), dtype,
                                      device=dev))
    params = _stack_trees(params_list)

    if exp.isg is not None:
        n_pre = (isg_pretrain_override if isg_pretrain_override is not None
                 else exp.isg_pretrain_iters)

        def ens_isg_loss(isg_params):
            return torch.stack([build_isg_pretrain_loss(problems[m])(_member(isg_params, m))
                                for m in range(n_members)]).mean()

        params["isg"] = pretrain_isg(ens_isg_loss, params["isg"], n_iters=n_pre,
                                     logger=logger, device=dev)

    stages = list(exp.curriculum) + [exp.train_steps]
    n_total = n_iters_override if n_iters_override is not None else exp.train.n_iters
    per_stage = max(1, n_total // len(stages))
    history = []
    for i, steps in enumerate(stages):
        tcfg = dataclasses.replace(
            exp.train,
            n_iters=per_stage if i < len(stages) - 1 else n_total - per_stage * (len(stages) - 1),
            ckpt_path=os.path.join(out_dir, f"{exp.name}.ens.ckpt.npz"),
            **({"steps_per_call": steps_per_call} if steps_per_call else {}),
        )
        params, h = train(build_ensemble_loss_fn(exp, problems, steps, bptt), params, tcfg,
                          logger=logger, device=dev)
        history.extend(h)

    n_eval = min(exp.infer_steps, truth.shape[0] - 1)
    rel = np.asarray([evaluate(_member(params, k), problems[k], n_eval)["rel_l2"]
                      for k in range(n_members)])
    result = {
        "params": params,
        "history": history,
        "rel_l2_members": rel.tolist(),
        "rel_l2_mean": float(rel.mean()),
        "rel_l2_std": float(rel.std()),
    }
    logger.log(n_total, rel_l2_mean=result["rel_l2_mean"], rel_l2_std=result["rel_l2_std"])
    logger.close()
    return result
