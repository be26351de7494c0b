"""Periodic halo exchange between the ranks of a DTensor's mesh: the port
of what XLA's SPMD partitioner does for a circular pad, a periodic
convolution and a roll along a cut dim.

A DTensor cut along a periodic dim holds one block of it on each rank of
the mesh dims that cut it; the blocks form a ring, the last one's
neighbour the first.  ``pad_periodic`` wrap-pads each rank's block with
the neighbouring blocks' edge cells, which the ranks trade by
point-to-point sends (XLA's collective-permute); along a dim that is not
cut, or cut by a mesh dim of size 1, the wrap is local.  ``roll`` is a pad
on one side followed by a slice, so a roll by at most a block's thickness
moves only that many planes.  The dims are padded in turn, each on the
already padded block, so the corners hold the diagonal neighbours' cells
(a 5 x 5 branch on a 2 x 2 mesh reads them), the order of
parallel/halo.halo_exchange.

Each exchange is an autograd Function whose backward is its adjoint: the
cotangents of the received cells go back to the ranks that own them and
are added into their edge cells.  The sends are posted together
(``batch_isend_irecv``) on the default group, the peers named by their
global ranks (the port's DeviceMesh spans every rank of the group); gloo
and NCCL both take them.  Every rank of a ring must make the same calls
in the same order, as for any collective.

Inside a CUDA graph capture (core/graph.py) the sends, the receives and
the waits are captured on NCCL as they are posted: ``work.wait()`` makes
the capturing stream wait for NCCL's, with no host wait, and a replay
posts them in the same order.

``sends`` and ``bytes_sent`` count this rank's sends and the bytes they
carry, forward and backward, as the kernels' wrappers count launches (a
replayed graph's too, core/graph.py): set them to 0 to start a count.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

sends = 0
bytes_sent = 0

# tags that keep the two directions apart when both neighbours are one rank
# (gloo matches on them; NCCL matches a pair's messages in posting order,
# which the two directions keep alike on every rank)
_TO_PREV, _TO_NEXT = 0, 1


def _post(ops: list) -> None:
    """Post the sends and receives together and wait for all of them."""
    global sends, bytes_sent
    if not ops:
        return
    for op in ops:
        if op.op is dist.isend:
            sends += 1
            bytes_sent += op.tensor.numel() * op.tensor.element_size()
    for work in dist.batch_isend_irecv(ops):
        work.wait()


class _Exchange(torch.autograd.Function):
    """A block extended along `dim` by `lo` cells from the rank before it
    in its ring (`prev`) and `hi` cells from the rank after it (`nxt`)."""

    @staticmethod
    def forward(ctx, x, dim: int, lo: int, hi: int, prev: int, nxt: int):
        b = x.shape[dim]
        ctx.args = (dim, lo, hi, prev, nxt, b)
        shape = list(x.shape)
        left = x.new_empty(shape[:dim] + [lo] + shape[dim + 1:])
        right = x.new_empty(shape[:dim] + [hi] + shape[dim + 1:])
        ops = []
        if lo:   # my high edge becomes the next block's low pad
            ops += [dist.P2POp(dist.isend, x.narrow(dim, b - lo, lo).contiguous(), nxt,
                               tag=_TO_NEXT),
                    dist.P2POp(dist.irecv, left, prev, tag=_TO_NEXT)]
        if hi:   # my low edge becomes the previous block's high pad
            ops += [dist.P2POp(dist.isend, x.narrow(dim, 0, hi).contiguous(), prev,
                               tag=_TO_PREV),
                    dist.P2POp(dist.irecv, right, nxt, tag=_TO_PREV)]
        _post(ops)
        return torch.cat([left, x, right], dim)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dim, lo, hi, prev, nxt, b = ctx.args
        gx = g.narrow(dim, lo, b).clone()
        from_next = g.new_empty(gx.shape[:dim] + (lo,) + gx.shape[dim + 1:])
        from_prev = g.new_empty(gx.shape[:dim] + (hi,) + gx.shape[dim + 1:])
        ops = []
        if lo:   # my low pad's cotangent belongs to the previous block
            ops += [dist.P2POp(dist.isend, g.narrow(dim, 0, lo).contiguous(), prev,
                               tag=_TO_PREV),
                    dist.P2POp(dist.irecv, from_next, nxt, tag=_TO_PREV)]
        if hi:   # my high pad's cotangent belongs to the next block
            ops += [dist.P2POp(dist.isend, g.narrow(dim, lo + b, hi).contiguous(), nxt,
                               tag=_TO_NEXT),
                    dist.P2POp(dist.irecv, from_prev, prev, tag=_TO_NEXT)]
        _post(ops)
        if lo:
            gx.narrow(dim, b - lo, lo).add_(from_next)
        if hi:
            gx.narrow(dim, 0, hi).add_(from_prev)
        return gx, None, None, None, None, None


def _wrap(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    """x wrap-padded along `dim` within the rank."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, n - lo, lo), x, x.narrow(dim, 0, hi)], dim)


def _ring(x, dim: int) -> tuple | None:
    """The ring of blocks of DTensor `x` along tensor dim `dim`: (its
    length, this rank's global ranks before and after it in the ring,
    the thinnest block), or None when one block holds the whole dim.  A
    dim cut by several mesh dims counts its blocks in mesh order, as
    DTensor lays them out."""
    from torch.distributed.tensor import Shard

    mesh, place = x.device_mesh, x.placements
    cut = [i for i, p in enumerate(place) if isinstance(p, Shard) and p.dim % x.ndim == dim]
    sizes = [mesh.size(i) for i in cut]
    n = math.prod(sizes)
    if n == 1:
        return None
    coord = list(mesh.get_coordinate())
    idx = 0
    for i, s in zip(cut, sizes):
        idx = idx * s + coord[i]

    def rank_of(j: int) -> int:
        c = list(coord)
        for i, s in zip(reversed(cut), reversed(sizes)):
            c[i], j = j % s, j // s
        return int(mesh.mesh[tuple(c)])

    # DTensor's Shard splits as torch.chunk does: blocks of ceil(N / n), the
    # last ones short or empty
    whole = x.shape[dim]
    chunk = -(-whole // n)
    thinnest = min(max(0, min(chunk, whole - j * chunk)) for j in range(n))
    return n, rank_of((idx - 1) % n), rank_of((idx + 1) % n), thinnest


def pad_periodic(x, pads: Mapping[int, tuple]) -> torch.Tensor:
    """This rank's block of DTensor `x`, a plain tensor (differentiable),
    wrap-padded by pads[d] = (lo, hi) cells on each dim d named, in the
    order named: the rank's part of ``F.pad(mode="circular")`` of the
    whole tensor.  Across the ring of blocks where the dim is cut, within
    the rank where it is not."""
    local = x.to_local()
    for d, (lo, hi) in pads.items():
        d %= x.ndim
        ring = _ring(x, d)
        if ring is None:
            local = _wrap(local, d, lo, hi)
            continue
        n, prev, nxt, thinnest = ring
        if thinnest < max(lo, hi):
            raise ValueError(f"dim {d} of {tuple(x.shape)} is cut into {n} blocks, the "
                             f"thinnest {thinnest} cells: each block needs at least "
                             f"{max(lo, hi)} cells to hand on a ({lo}, {hi}) halo")
        local = _Exchange.apply(local, d, lo, hi, prev, nxt)
    return local


def roll(x, shift: int, dim: int):
    """``torch.roll(x, shift, dims=dim)`` of DTensor `x`, a DTensor with
    x's placements: each block takes |shift| cells from its neighbour in
    the ring (the shift taken modulo the dim's size, to the smaller
    side)."""
    from torch.distributed.tensor import DTensor

    d = dim % x.ndim
    n = x.shape[d]
    shift %= n
    if shift > n // 2:
        shift -= n
    if _ring(x, d) is None:
        local = torch.roll(x.to_local(), shift, dims=d)
    else:
        lo, hi = max(shift, 0), max(-shift, 0)
        padded = pad_periodic(x, {d: (lo, hi)})
        local = padded.narrow(d, hi, padded.shape[d] - lo - hi)
    return DTensor.from_local(local, x.device_mesh, x.placements, shape=x.shape,
                              stride=x.stride())
