"""Periodic halo exchange between the blocks of a decomposed field.

Counterpart of percnn_tpu/parallel/halo.py.  There each device holds one
block inside ``shard_map`` and sends its edge strips round the ring with
``lax.ppermute``.  Here one process holds the whole grid of blocks, so
``halo_exchange`` takes the grid (a numpy object array of tensors in mesh
order) and returns the grid of extended blocks: a strip moves to its
neighbour with ``.to(block.device)``.  The ring's wrap-around is the global
periodic boundary, so the blocks at the field's edge need no special case,
and an axis of one block wraps locally.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def object_grid(shape: tuple[int, ...], items) -> np.ndarray:
    """A numpy object array of `shape` holding `items` in C order (tensors
    stay tensors: numpy would otherwise try to convert them)."""
    out = np.empty(shape, dtype=object)
    for idx, item in zip(np.ndindex(shape), items):
        out[idx] = item
    return out


def _exchange_axis(blocks: np.ndarray, grid_axis: int, dim: int, halo: int) -> np.ndarray:
    """Every block extended by `halo` cells on both sides of tensor dim
    `dim`: on the left the high strip of its neighbour before it along
    `grid_axis`, on the right the low strip of the one after it (ring order)."""
    n = blocks.shape[grid_axis]
    out = []
    for idx in np.ndindex(blocks.shape):
        block = blocks[idx]
        before = list(idx)
        after = list(idx)
        before[grid_axis] = (idx[grid_axis] - 1) % n
        after[grid_axis] = (idx[grid_axis] + 1) % n
        left, right = blocks[tuple(before)], blocks[tuple(after)]
        recv_left = left.narrow(dim, left.shape[dim] - halo, halo).to(block.device)
        recv_right = right.narrow(dim, 0, halo).to(block.device)
        out.append(torch.cat([recv_left, block, recv_right], dim=dim))
    return object_grid(blocks.shape, out)


def halo_exchange(blocks: np.ndarray, *, halo: int = 2, mesh, axis_names: Sequence[str],
                  array_axes: Sequence[int]) -> np.ndarray:
    """Extend every block of the grid by `halo` cells on each side of each
    listed tensor dim, filled from its ring neighbours (any spatial rank).

    blocks: object array of tensors [*local_spatial, C], grid axis k along
    mesh axis ``axis_names[k]`` (so ``blocks.shape`` is those axes' sizes),
    each tensor on its mesh device.  ``array_axes[k]`` is the tensor dim
    that grid axis k cuts.  The axes are exchanged in turn, each later one
    sending strips of the already-extended blocks, so the corners hold the
    diagonal neighbours' cells: the k x k Pi branches may read them.

    Unlike the JAX function, which runs inside ``shard_map`` on one block
    and takes the axis sizes, this one takes the whole grid and the mesh.
    """
    want = tuple(mesh.shape[a] for a in axis_names)
    if blocks.shape != want:
        raise ValueError(f"a grid of {blocks.shape} blocks for mesh axes "
                         f"{tuple(axis_names)} of sizes {want}")
    out = blocks
    for k, dim in enumerate(array_axes):
        short = [tuple(b.shape) for b in out.flat if b.shape[dim] < halo]
        if short:
            raise ValueError(f"each block needs at least {halo} cells along dim {dim} "
                             f"for a {halo}-cell halo, got {short[0]}")
        out = _exchange_axis(out, k, dim, halo)
    return out
