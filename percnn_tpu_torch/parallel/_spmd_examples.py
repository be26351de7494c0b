"""A worked example of the GSPMD train step, for tests and chip_smoke.py.

It exists only to serve them: ``make_train_step_spmd`` on the loss of
fitting a Pi cell's rollout to target frames, the case of percnn_tpu's
tests/test_parallel.py that the port's tests and chip_smoke.py hold the
port's step to.  It lives in the package, not in a test file, because a
rank that ``parallel.launch`` spawns imports the module of its target, and
the test files import JAX.  Nothing in the package calls it.
"""

from __future__ import annotations

import functools

import torch

from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step
from percnn_tpu_torch.core.losses import mse
from percnn_tpu_torch.core.rollout import rollout
from percnn_tpu_torch.parallel.mesh import make_mesh
from percnn_tpu_torch.parallel.sharded import (
    make_train_step_spmd,
    replicate,
    scale_by_adam,
    shard_array,
    sharded_rollout_nd,
)
from percnn_tpu_torch.parallel.spmd import P, full, is_dtensor, rank_device, tree_map


def rollout_fit_loss(params: dict, batch: tuple, *, cfg: PiCellConfig, n_steps: int,
                     halo_mesh=None):
    """The loss of fitting a Pi cell's rollout to target frames:
    batch = (h0 [*spatial, C], target [n_steps, *spatial, C]) ->
    (the mean squared error of frames 1..n_steps, {'l': it}).

    Without halo_mesh, the eager rollout of pi_cell_step (given DTensors,
    DTensor partitions it as they are placed).  With halo_mesh, a
    parallel.Mesh of this process's devices, the rollout is
    sharded_rollout_nd's halo decomposition over it, run whole on each
    rank's copy of the inputs, and the loss a replicated DTensor when they
    were DTensors."""
    from torch.distributed.tensor import DTensor, Replicate

    h0, target = batch
    if halo_mesh is None:
        frames = rollout(lambda h: pi_cell_step(params, h, cfg), h0, n_steps, remat=False)
        loss = mse(frames[1:], target)
        return loss, {"l": loss}
    frames = sharded_rollout_nd(tree_map(full, params), full(h0), cfg, n_steps, halo_mesh)
    loss = mse(frames[1:], full(target))
    if is_dtensor(h0):
        loss = DTensor.from_local(loss, h0.device_mesh, [Replicate()] * h0.device_mesh.ndim)
    return loss, {"l": loss}


def spmd_fit_step(params: dict, h0: torch.Tensor, target: torch.Tensor, cfg: PiCellConfig,
                  n_steps: int, mesh, lr: float, *, halo: bool = False) -> tuple:
    """One make_train_step_spmd step of scale_by_adam on rollout_fit_loss,
    on every rank of `mesh` (under launch): the parameters replicated, h0
    placed P(*axes, None) and the target P(None, *axes, None) over the
    mesh's first cfg.ndim axes; with `halo`, the loss's rollout is the halo
    decomposition on a mesh of this rank's device in `mesh`'s shape.
    Returns (the parameters after the step, the loss), full tensors."""
    axes = tuple(mesh.axis_names)[:cfg.ndim]
    dev = rank_device(mesh)
    batch = (shard_array(h0, mesh, P(*axes, None)), shard_array(target, mesh, P(None, *axes, None)))
    params = replicate(params, mesh)
    halo_mesh = (make_mesh(mesh.axis_names, shape=mesh.devices.shape,
                           devices=[dev] * mesh.devices.size) if halo else None)
    tx = scale_by_adam()
    step = make_train_step_spmd(
        functools.partial(rollout_fit_loss, cfg=cfg, n_steps=n_steps, halo_mesh=halo_mesh),
        tx, mesh)
    new, _, total, _ = step(params, tx.init(params), batch, lr)
    return tree_map(full, new), full(total)
