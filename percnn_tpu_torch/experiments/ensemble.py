"""Ensemble training: K independent PeRCNN fits trained together.

Counterpart of percnn_tpu/experiments/ensemble.py.  The K members differ in
their init seed (``seed + k``) and their noise seed (``exp.seed + k``) and
share the truth.  Their parameters are stacked on a leading member axis and
trained by one optimizer on the mean of the members' losses; Adam is
elementwise, so each member trains as it would alone (the 1/K gradient
scale cancels in Adam's m / sqrt(v)).

The member axis is a Python loop where percnn_tpu vmaps (the ISG, the
two-phase loss), or one kernel launch a step for every member (the
``batched`` modes, ops/kernels/batched2d.py).  With a mesh the members are
sharded over a process group of one rank a mesh position
(parallel/spmd.py): each rank trains its own members, and the mean of the
losses reduces across ranks.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time

import numpy as np
import torch

from percnn_tpu_torch._device import resolve_device
from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.isg import isg_apply
from percnn_tpu_torch.core.train import pretrain_isg, train
from percnn_tpu_torch.experiments.configs import ExperimentConfig
from percnn_tpu_torch.experiments.runner import (
    Problem,
    _mesh_libraries,
    build_isg_pretrain_loss,
    build_loss_fn,
    evaluate,
    gspmd_rollout_fn,
    init_model,
    make_dataset,
    replicated_isg,
    setup_problem,
)
from percnn_tpu_torch.ops.kernels.backward2d import fused_rollout_tp_2d, fused_rollout_tp_2d_pg
from percnn_tpu_torch.ops.kernels.batched2d import (
    _member,
    fused_rollout_tp_2d_batched,
    fused_rollout_tp_2d_batched_pg,
)
from percnn_tpu_torch.parallel import spmd
from percnn_tpu_torch.parallel.mesh import canonical_device
from percnn_tpu_torch.parallel.spmd import P
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


def auto_bptt(exp: ExperimentConfig, dtype=torch.float32, mesh=None) -> str:
    """The mode ``bptt="auto"`` picks: percnn_tpu's rule with its TPU-only
    conditions mapped as runner.forward_rollout maps them (the kernels on the
    card, their plain versions on the CPU; no VMEM limit): without a mesh, a
    float32 2D cell with kernel_size 1, 3 or 5 takes the per-member loop of
    the single model's fused rollouts, 'fused_pg' at kernel_size 1 and
    'fused' at 3, 5; anything else, and any run on a mesh, 'two_phase'."""
    cell = exp.cell
    fusable = (mesh is None and cell.ndim == 2 and cell.kernel_size in (1, 3, 5)
               and dtype == torch.float32)
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
    graph: bool = True,
) -> dict:
    """Train `n_members` models (distinct init and noise seeds) together on
    `device`: truth, per-member data, the ISG pretrain of every member on
    the mean of their losses, the curriculum, and each member's evaluation.

    bptt: 'auto' (auto_bptt), or one of BPTT_MODES (build_ensemble_loss_fn).
    The checkpoint (``<out_dir>/<name>.ens.ckpt.npz``) holds the stacked
    params; the log is ``<name>.ens.metrics.jsonl``.  Returns the params,
    the loss history and the members' rel-L2 with its mean and spread; on
    one device also ``seconds``, the host seconds of each phase (truth, ISG
    pretrain, each stage, evaluation), as run_experiment's.

    mesh: a parallel.Mesh whose first device is `device`; the run goes
    through parallel.launch, one rank a mesh position (``_run_sharded``).
    The stacked params and every member array are sharded over
    `member_axis` (which must divide n_members); the member data also over
    `spatial_axes` (mesh axes for the leading grid dims) where each grid
    dim divides, else member-sharded only, as percnn_tpu places them.  Each
    rank trains its own members: the kernel modes run the kernels on the
    rank's members, with the field first gathered whole on the spatial mesh
    dims (as GSPMD does around a custom call); 'two_phase' (the mode 'auto'
    takes on a mesh) runs each member's two-phase loss, and with
    spatial_axes each member's eager rollout on DTensors cut over those
    axes instead (autograd through it).  The rank's loss sum reduces across
    ranks and is divided by M.  Only rank 0 writes the log and checkpoints.
    Unlike percnn_tpu, which ignores spatial_axes without a mesh, that
    raises.

    graph: on CUDA the ISG pretrain and every training iteration replay a
    captured CUDA graph (core/train.py), on every rank of a mesh too;
    graph=False runs them eagerly.
    """
    if spatial_axes and mesh is None:
        raise ValueError("spatial_axes shard the members' fields over a mesh: pass mesh=")
    if bptt == "auto":
        bptt = auto_bptt(exp, dtype, mesh)
    if bptt not in BPTT_MODES:
        raise ValueError(f"unknown bptt mode {bptt!r}")
    dev = resolve_device(device)
    if mesh is not None:
        _check_mesh(mesh, n_members, member_axis, spatial_axes, dev)
        run = functools.partial(
            _run_sharded, n_members=n_members, out_dir=out_dir, cache_dir=cache_dir,
            dtype=dtype, n_iters_override=n_iters_override,
            isg_pretrain_override=isg_pretrain_override, steps_per_call=steps_per_call,
            mesh=mesh, member_axis=member_axis, spatial_axes=tuple(spatial_axes),
            warmup=warmup, bptt=bptt, seed=seed, graph=graph)
        if spmd.in_group():
            return run(exp)
        result = spmd.launch(run, mesh, exp, libraries=_mesh_libraries(
            mesh, ("cell2d", "backward2d", "batched2d", "adj2d")))
        result["params"] = params_from_numpy(result["params"], device=dev)
        return result
    os.makedirs(out_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(out_dir, f"{exp.name}.ens.metrics.jsonl"),
                           echo_every=exp.train.log_every)
    if warmup is None:
        warmup = 100 if exp.system == "lambda_omega" else 0
    seconds: dict = {"stages": []}
    t0 = time.perf_counter()
    truth = make_dataset(exp, warmup=warmup, cache_dir=cache_dir, device=dev)
    seconds["truth"] = time.perf_counter() - t0

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

        t0 = time.perf_counter()
        params["isg"] = pretrain_isg(ens_isg_loss, params["isg"], n_iters=n_pre,
                                     logger=logger, device=dev, graph=graph)
        seconds["isg_pretrain"] = time.perf_counter() - t0

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
        t0 = time.perf_counter()
        params, h = train(build_ensemble_loss_fn(exp, problems, steps, bptt), params, tcfg,
                          logger=logger, device=dev, graph=graph)
        seconds["stages"].append({"steps": steps, "iters": tcfg.n_iters,
                                  "seconds": time.perf_counter() - t0})
        history.extend(h)

    n_eval = min(exp.infer_steps, truth.shape[0] - 1)
    t0 = time.perf_counter()
    rel = np.asarray([evaluate(_member(params, k), problems[k], n_eval)["rel_l2"]
                      for k in range(n_members)])
    seconds["evaluate"] = time.perf_counter() - t0
    result = {
        "params": params,
        "history": history,
        "rel_l2_members": rel.tolist(),
        "rel_l2_mean": float(rel.mean()),
        "rel_l2_std": float(rel.std()),
        "seconds": seconds,
    }
    logger.log(n_total, rel_l2_mean=result["rel_l2_mean"], rel_l2_std=result["rel_l2_std"])
    logger.close()
    return result


# ---------------------------------------------------------------------------
# The members sharded over a mesh: one rank a mesh position


def _check_mesh(mesh, n_members: int, member_axis: str, spatial_axes, dev) -> None:
    if mesh.devices.flat[0] != canonical_device(dev):
        raise ValueError(f"the mesh's first device {mesh.devices.flat[0]} is not the "
                         f"run's device {dev}; pass device={mesh.devices.flat[0]!s}")
    for axis in (member_axis, *spatial_axes):
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} is not one of the mesh's {mesh.axis_names}")
    if member_axis in spatial_axes:
        raise ValueError(f"the member axis {member_axis!r} cannot cut the field too")
    if n_members % mesh.shape[member_axis]:
        raise ValueError(f"{n_members} members do not split over mesh axis "
                         f"{member_axis}={mesh.shape[member_axis]}")


def _member_spec(x: torch.Tensor, mesh, member_axis: str, sp: tuple, nd: int) -> P:
    """percnn_tpu's placement of a stacked member array [M, ..., *spatial, C]
    (the spatial dims just before the channel dim): cut over `sp` too when
    every one of those grid dims divides, else member-sharded only."""
    dims = x.shape[x.ndim - 1 - nd:x.ndim - 1]
    if sp and all(d % mesh.shape[a] == 0 for d, a in zip(dims, sp)):
        return P(member_axis, *(None,) * (x.ndim - 2 - nd), *sp, None)
    return P(member_axis)


def _local(x):
    """This rank's block of a DTensor (differentiable), or None."""
    return None if x is None else x.to_local()


def _run_sharded(exp: ExperimentConfig, n_members: int, *, out_dir: str,
                 cache_dir: str | None, dtype, n_iters_override, isg_pretrain_override,
                 steps_per_call, mesh, member_axis: str, spatial_axes: tuple, warmup,
                 bptt: str, seed: int, graph: bool) -> dict:
    """run_ensemble on every rank of a process group over `mesh`."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dmesh = spmd.device_mesh(mesh)
    dev = spmd.rank_device(mesh)
    writer = spmd.is_writer()
    nd = exp.cell.ndim
    if writer:
        os.makedirs(out_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(out_dir, f"{exp.name}.ens.metrics.jsonl")
                           if writer else None, echo_every=exp.train.log_every if writer else 0)
    if warmup is None:
        warmup = 100 if exp.system == "lambda_omega" else 0
    truth = make_dataset(exp, warmup=warmup, cache_dir=cache_dir, device=dev) if writer else None
    spmd.barrier()   # rank 0 made the cache file, which the other ranks read
    if truth is None:
        truth = make_dataset(exp, warmup=warmup, cache_dir=cache_dir, device=dev)

    problems, params_list = [], []
    for k in range(n_members):
        exp_k = dataclasses.replace(exp, seed=exp.seed + k)
        problems.append(setup_problem(exp_k, truth, dtype, device=dev))
        params_list.append(init_model(exp, torch.Generator().manual_seed(seed + k), dtype,
                                      device=dev))
    member_p = spmd.placements(mesh, P(member_axis))
    params = spmd.tree_map(lambda t: spmd.distribute(t, dmesh, member_p),
                           _stack_trees(params_list))
    # each member array twice: placed as percnn_tpu places it (the spatial
    # two-phase route reads it so) and member-sharded only, whole fields
    # (the ISG pretrain, the kernel modes and the unsplit two-phase route)
    placed, whole = {}, {}
    for name in ("h0", "ic_low", "measurement"):
        if getattr(problems[0], name) is None:
            placed[name] = whole[name] = None
            continue
        stacked = torch.stack([getattr(p, name) for p in problems])
        spec = _member_spec(stacked, mesh, member_axis, spatial_axes, nd)
        placed[name] = spmd.distribute(stacked, dmesh, spmd.placements(mesh, spec))
        whole[name] = spmd.distribute(placed[name], dmesh, member_p)
    # this rank's members: a block of the member axis
    per_rank = n_members // mesh.shape[member_axis]
    first = dmesh.get_local_rank(member_axis) * per_rank
    mine = range(first, first + per_rank)
    local_whole = {k: _local(v) for k, v in whole.items()}
    local_probs = [Problem(exp, truth, *(None if local_whole[k] is None else local_whole[k][j]
                                         for k in ("h0", "ic_low", "measurement")))
                   for j in range(per_rank)]
    partial = tuple(Partial() if n == member_axis else Replicate() for n in mesh.axis_names)

    def mean_over_members(local_sum: torch.Tensor):
        """The members' mean of a per-rank sum: a partial sum over the
        member axis, divided by M."""
        return DTensor.from_local(local_sum, dmesh, partial) / n_members

    if exp.isg is not None:
        n_pre = (isg_pretrain_override if isg_pretrain_override is not None
                 else exp.isg_pretrain_iters)

        def ens_isg_loss(isg_params):
            local = spmd.tree_map(_local, isg_params)
            return mean_over_members(torch.stack([
                build_isg_pretrain_loss(local_probs[j])(_member(local, j))
                for j in range(per_rank)]).sum())

        params["isg"] = pretrain_isg(ens_isg_loss, params["isg"], n_iters=n_pre,
                                     logger=logger, device=dev, graph=graph)

    split = bptt == "two_phase" and bool(spatial_axes)
    if split:
        sub = dmesh[spatial_axes]
        rep = [Replicate()] * sub.ndim
        state_p = tuple(Shard(k) for k in range(len(spatial_axes)))
        frames_p = tuple(Shard(k + 1) for k in range(len(spatial_axes)))
        cut = {k: v is not None and _member_spec(v, mesh, member_axis, spatial_axes, nd)
               != P(member_axis) for k, v in placed.items()}
        placed_local = {k: _local(v) for k, v in placed.items()}

    def member_loss_split(local_params, j: int, n_steps: int):
        """Member j's loss on the spatial sub-mesh: its blocks of the placed
        field and measurement as DTensors there (its low-res IC whole: the
        ISG reads it replicated), its params replicated, the gspmd
        rollout."""
        def on_sub(name):
            x = placed_local[name][j]
            lead = x.ndim - nd - 1
            return DTensor.from_local(x, sub, [Shard(lead + k) for k in range(len(spatial_axes))]
                                      if cut[name] else rep)

        prob = Problem(exp, truth, None if placed["h0"] is None else on_sub("h0"),
                       None if local_whole["ic_low"] is None
                       else DTensor.from_local(local_whole["ic_low"][j], sub, rep),
                       None if placed["measurement"] is None else on_sub("measurement"))
        p_j = spmd.tree_map(lambda t: DTensor.from_local(t[j], sub, rep), local_params)
        roll = gspmd_rollout_fn(prob, n_steps, sub, state_p, frames_p)
        total, aux = spmd.implicitly_replicated(
            build_loss_fn(prob, n_steps, rollout_fn=roll, isg_fn=replicated_isg))(p_j)
        return spmd.full(total), {k: spmd.full(v) for k, v in aux.items()}

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
        local_loss = None if split else build_ensemble_loss_fn(exp, local_probs, steps, bptt)

        def loss_fn(params, steps=steps, local_loss=local_loss):
            local = spmd.tree_map(_local, params)
            if split:
                outs = [member_loss_split(local, j, steps) for j in range(per_rank)]
                total = torch.stack([t for t, _ in outs]).sum()
                aux = {k: torch.stack([a[k] for _, a in outs]).sum() for k in outs[0][1]}
            else:
                mean, aux_mean = local_loss(local)
                total = mean * per_rank
                aux = {k: v * per_rank for k, v in aux_mean.items()}
            return (mean_over_members(total),
                    {k: mean_over_members(v.detach()) for k, v in aux.items()})

        params, h = train(loss_fn, params, tcfg, logger=logger, device=dev, graph=graph)
        history.extend(h)

    # each rank evaluates its own members; every rank learns every score
    n_eval = min(exp.infer_steps, truth.shape[0] - 1)
    local = spmd.tree_map(lambda t: _local(t).detach(), params)
    scores = {first + j: evaluate(_member(local, j), local_probs[j], n_eval)["rel_l2"]
              for j in range(per_rank)}
    gathered = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(gathered, scores)
    merged = {k: v for part in gathered for k, v in part.items()}
    rel = np.asarray([merged[k] for k in range(n_members)])
    result = {
        "params": spmd.tree_map(lambda t: spmd.full(t).detach(), params),
        "history": history,
        "rel_l2_members": rel.tolist(),
        "rel_l2_mean": float(rel.mean()),
        "rel_l2_std": float(rel.std()),
    }
    logger.log(n_total, rel_l2_mean=result["rel_l2_mean"], rel_l2_std=result["rel_l2_std"])
    logger.close()
    return result
