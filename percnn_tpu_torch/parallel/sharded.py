"""Domain-decomposed Pi-cell rollout: blocks over a mesh, a halo exchange a step.

Counterpart of percnn_tpu/parallel/sharded.py's explicit path.
``sharded_rollout_nd`` cuts the field into one block per mesh position
(the first ``cfg.ndim`` mesh axes cut the spatial dims in order), puts
each block on its mesh device with a copy of the parameters there, and
advances all blocks together: each step exchanges the 2-cell halo
(parallel/halo.py) and runs the local update on every block.  With
``remat`` the blocks' steps are checkpointed in segments of about sqrt(T)
steps, as ``core.rollout.rollout`` does for one field.

impl (the JAX package's names, so a caller moves between the packages
unchanged):
  'jnp'    -- the eager valid-region step (core.cell.pi_cell_step_valid),
              any spatial rank, any kernel_size;
  'pallas' -- the CUDA kernel step2d_haloed_kernel
              (ops/kernels/sharded_step2d.py, its plain version on the CPU),
              2D two-channel cells of odd kernel_size <= 5; 3D runs 'jnp'.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step_valid
from percnn_tpu_torch.core.rollout import _flatten, _pick_segment, _unflatten
from percnn_tpu_torch.ops.kernels.sharded_step2d import step_haloed_2d
from percnn_tpu_torch.ops.stencils import STENCIL_HALO
from percnn_tpu_torch.parallel.halo import halo_exchange, object_grid

_IMPLS = ("jnp", "pallas")


def _tree_to(tree, dev: torch.device):
    """The parameter tree on `dev` (the same tensors where they already are)."""
    return _unflatten(tree, iter([t.to(dev) for t in _flatten(tree)]))


def _block_devices(mesh, axis_names: Sequence[str]) -> np.ndarray:
    """The device of each block: grid axis k along mesh axis axis_names[k];
    a mesh axis that cuts no dim contributes its first position."""
    names = mesh.axis_names
    sub = mesh.devices[tuple(slice(None) if n in axis_names else 0 for n in names)]
    kept = [n for n in names if n in axis_names]
    return np.transpose(sub, [kept.index(a) for a in axis_names])


def _step_blocks(replicas: dict, blocks: np.ndarray, cfg: PiCellConfig, mesh,
                 axis_names: Sequence[str], impl: str) -> np.ndarray:
    xp = halo_exchange(blocks, halo=STENCIL_HALO, mesh=mesh, axis_names=axis_names,
                       array_axes=tuple(range(cfg.ndim)))
    step = step_haloed_2d if impl == "pallas" else pi_cell_step_valid
    return object_grid(xp.shape, [step(replicas[b.device], b, cfg) for b in xp.flat])


def pi_cell_step_haloed(params: dict, blocks: np.ndarray, cfg: PiCellConfig, *, mesh,
                        axis_names: Sequence[str], impl: str = "jnp") -> np.ndarray:
    """One Euler step of every block of the grid (an object array of
    [*local_spatial, C] tensors in mesh order, as halo_exchange takes):
    the halo exchange, then the local step of `impl` on each block.  1x1
    and k x k cells alike: the exchanged corners make the haloed block
    valid for the k x k branches."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {_IMPLS})")
    replicas = {d: _tree_to(params, d) for d in {b.device for b in blocks.flat}}
    return _step_blocks(replicas, blocks, cfg, mesh, axis_names, impl)


def _split(h0: torch.Tensor, devices: np.ndarray) -> np.ndarray:
    """h0 [*spatial, C] cut into the grid of blocks, each on its device."""
    sizes = []
    for d, n in enumerate(devices.shape):
        if h0.shape[d] % n:
            raise ValueError(f"spatial dim {d} of size {h0.shape[d]} does not split "
                             f"into {n} blocks")
        sizes.append(h0.shape[d] // n)
    blocks = []
    for idx in np.ndindex(devices.shape):
        sl = tuple(slice(i * s, (i + 1) * s) for i, s in zip(idx, sizes))
        blocks.append(h0[sl].to(devices[idx]))
    return object_grid(devices.shape, blocks)


def _assemble(blocks: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The grid of [T, *local_spatial, C] blocks joined into one tensor on
    `dev`: grid axis k along tensor dim 1 + k, the last grid axis first."""
    grid = object_grid(blocks.shape, [b.to(dev) for b in blocks.flat])
    while grid.ndim:
        k = grid.ndim - 1
        grid = object_grid(grid.shape[:k], [torch.cat(list(grid[idx]), dim=1 + k)
                                            for idx in np.ndindex(grid.shape[:k])])
    return grid[()]


def _segments(n_steps: int, remat: bool) -> list[int]:
    """Step counts of the checkpointed segments: about sqrt(T) each; a prime
    T first takes one step alone so the rest divides."""
    if n_steps == 0:
        return []
    if not remat:
        return [n_steps]
    if n_steps > 4 and _pick_segment(n_steps) == 1:
        return [1] + _segments(n_steps - 1, remat)
    seg = _pick_segment(n_steps)
    return [seg] * (n_steps // seg)


def sharded_rollout_nd(params: dict, h0: torch.Tensor, cfg: PiCellConfig, n_steps: int,
                       mesh, *, axis_names: Sequence[str] | None = None, remat: bool = True,
                       impl: str = "jnp") -> torch.Tensor:
    """Domain-decomposed rollout: h0 [*spatial, C] -> frames
    [n_steps + 1, *spatial, C] on the mesh's first device.

    Any spatial rank matching ``cfg.ndim``: 2D over ('x', 'y'), 3D over
    ('x', 'y', 'z'); ``axis_names`` defaults to the first ``cfg.ndim`` mesh
    axes, and each spatial dim must divide by its axis' size, into blocks of
    at least 2 cells.  Differentiable in ``params`` and ``h0``: autograd
    crosses the exchange, and the blocks' parameter gradients sum on
    ``params``.  impl='pallas' runs each block's step through the CUDA
    kernel of ops/kernels/sharded_step2d.py (2D cells of odd kernel_size
    <= 5); 'jnp' through the eager valid-region step.
    """
    if axis_names is None:
        axis_names = tuple(mesh.axis_names)[:cfg.ndim]
    axis_names = tuple(axis_names)
    if len(axis_names) != cfg.ndim:
        raise ValueError(f"need {cfg.ndim} mesh axes for a {cfg.ndim}D rollout, "
                         f"got {axis_names}")
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {_IMPLS})")
    devices = _block_devices(mesh, axis_names)
    replicas = {d: _tree_to(params, d) for d in set(devices.flat)}
    blocks = _split(h0, devices)
    shape = blocks.shape

    def advance(n: int, *flat: torch.Tensor) -> tuple:
        """n steps of the blocks: per block its n states, stacked."""
        grid = object_grid(shape, flat)
        states = [[] for _ in flat]
        for _ in range(n):
            grid = _step_blocks(replicas, grid, cfg, mesh, axis_names, impl)
            for k, b in enumerate(grid.flat):
                states[k].append(b)
        return tuple(torch.stack(s) for s in states)

    remat = remat and torch.is_grad_enabled()
    frames = [[b[None]] for b in blocks.flat]
    flat = list(blocks.flat)
    for n in _segments(n_steps, remat):
        part = (checkpoint(advance, n, *flat, use_reentrant=False, preserve_rng_state=False)
                if remat else advance(n, *flat))
        for k, p in enumerate(part):
            frames[k].append(p)
        flat = [p[-1] for p in part]
    joined = object_grid(shape, [torch.cat(f, dim=0) for f in frames])
    return _assemble(joined, mesh.devices.flat[0])
