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
from percnn_tpu_torch.core.train import train
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


def train_dtensor_probed(params: dict, h0: torch.Tensor, target: torch.Tensor,
                         cfg: PiCellConfig, n_steps: int, mesh, tcfg) -> tuple:
    """core/train.train of rollout_fit_loss on every rank of `mesh` (under
    launch), the parameters replicated DTensors and the data placed as
    spmd_fit_step places them: (the trained parameters, full tensors; the
    loss history; the addresses of the parameters' local blocks at each
    probe).  The probe fires every tcfg.probe_every iterations and at the
    end, so the addresses show whether the in-place update kept each block
    where a captured graph writes it."""
    axes = tuple(mesh.axis_names)[:cfg.ndim]
    batch = (shard_array(h0, mesh, P(*axes, None)), shard_array(target, mesh, P(None, *axes, None)))
    loss = functools.partial(rollout_fit_loss, cfg=cfg, n_steps=n_steps)
    seen = []

    def probe(p):
        leaves = []
        tree_map(leaves.append, p)
        seen.append([t.to_local().data_ptr() for t in leaves])
        return 0.0

    trained, history = train(loss, replicate(params, mesh), tcfg, loss_args=(batch,),
                             probe=probe, device=rank_device(mesh))
    return tree_map(full, trained), history, seen


def halo_against_whole(cases: list, mesh, widths: tuple = (1, 2), seed: int = 0) -> list:
    """ops/spmd_halo against the same ops on whole tensors, on every rank,
    for each case (x [*spatial, C], spec): x placed `spec` on `mesh`; for
    each width w, ``pad_periodic`` by (w, w) on every spatial dim against
    this rank's window of ``F.pad(mode="circular")``, and ``roll`` by +-w
    along each spatial dim against ``torch.roll``.  Each forward is
    compared to the bit; each adjoint is the backward of numpy-seeded
    cotangents (one a rank's window for the pad, one whole for the roll)
    against plain autograd of the whole op, as the largest gap.  Also
    pad_periodic's ValueError for a pad thicker than a block, raised before
    any send.  Returns, for each case, every rank's dict of results."""
    import torch.distributed as dist

    out = []
    for x, spec in cases:
        got = _halo_case(x, spec, mesh, widths, seed)
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, got)
        out.append(gathered)
    return out


def _halo_case(x: torch.Tensor, spec: P, mesh, widths: tuple, seed: int) -> dict:
    import itertools

    import numpy as np
    import torch.nn.functional as F

    from percnn_tpu_torch.ops import spmd_halo
    from percnn_tpu_torch.parallel.spmd import device_mesh, distribute, placements

    dmesh = device_mesh(mesh)
    place = placements(mesh, spec)
    x = x.to(rank_device(mesh))
    xd = distribute(x, dmesh, place)
    nd = x.ndim - 1

    def window(coord, w):
        """A rank's padded block within F.pad of the whole x."""
        sl = []
        for d in range(nd):
            cut = [i for i, p in enumerate(place) if getattr(p, "dim", None) == d]
            b = x.shape[d] // (dmesh.size(cut[0]) if cut else 1)
            o = coord[cut[0]] * b if cut else 0
            sl.append(slice(o, o + b + 2 * w))
        return tuple(sl)

    def cotangent(shape, key):
        rs = np.random.RandomState(seed + key)
        return torch.as_tensor(rs.standard_normal(tuple(shape)), dtype=x.dtype, device=x.device)

    out = {}
    me = tuple(dmesh.get_coordinate())
    coords = list(itertools.product(*[range(s) for s in dmesh.shape]))
    for w in widths:
        xl = xd.detach().requires_grad_(True)
        got = spmd_halo.pad_periodic(xl, {d: (w, w) for d in range(nd)})
        xw = x.detach().clone().requires_grad_(True)
        whole = F.pad(xw.movedim(-1, 0)[None], [w] * (2 * nd), mode="circular")[0].movedim(0, -1)
        out[f"pad{w}"] = bool(torch.equal(got, whole[window(me, w)]))
        cts = {c: cotangent(whole[window(c, w)].shape, k) for k, c in enumerate(coords)}
        sum(((whole[window(c, w)] * ct).sum() for c, ct in cts.items())).backward()
        (got * cts[me]).sum().backward()
        out[f"pad{w}_adjoint"] = float((full(xl.grad) - xw.grad).abs().max())
        for d in range(nd):
            for s in (w, -w):
                xl = xd.detach().requires_grad_(True)
                r = spmd_halo.roll(xl, s, d)
                xw = x.detach().clone().requires_grad_(True)
                rw = torch.roll(xw, s, d)
                out[f"roll{s:+d}@{d}"] = (bool(torch.equal(full(r), rw))
                                          and tuple(r.placements) == tuple(place))
                ct = cotangent(x.shape, 100 + d)
                (rw * ct).sum().backward()
                (r * distribute(ct, dmesh, place)).sum().backward()
                out[f"roll{s:+d}@{d}_adjoint"] = float((full(xl.grad) - xw.grad).abs().max())
    try:
        spmd_halo.pad_periodic(xd, {d: (x.shape[d], 0) for d in range(nd)})
        out["thick_pad"] = None
    except ValueError as e:
        out["thick_pad"] = str(e)
    return out
