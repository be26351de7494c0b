"""The Euler step of a domain-decomposed 2D field: the CUDA kernels for
Hopper, their plain versions and the autograd Function around them.

Counterpart of percnn_tpu/ops/pallas/sharded_step2d.py.  Under spatial
decomposition (parallel/sharded.py) every block of the periodic field takes
each step from its cells and a 2-cell halo of its neighbours' cells, any 2D
two-channel Pi cell of odd kernel_size <= 5.  All three kernels
(csrc/sharded_step2d.cu) stand in place of ``_step_kernel``; on a CPU
tensor each wrapper runs its plain version, a CUDA tensor launches the
kernel or raises, and each wrapper counts its launches (``.launches``).

``step_haloed_2d``: one block already extended by the exchange
(parallel/halo.py), [h + 4, w + 4, 2] -> [h, w, 2], through
``step2d_haloed_kernel``: the one-block counterpart of
``pallas_step_haloed``.

``step_blocks_2d``: every block of one device in one launch of
``step2d_blocks_kernel``.  The device's blocks are one state [nb, h, w, 2]
in mesh order; a ``BlockLayout`` says where each block's haloed block lies:
a neighbour on the same device is read in the state, one on another device
from ``strips``, its 2-cell edge rows, columns and corners copied there by
the caller.  ``rollout_blocks_2d``: every block on one device through a
whole rollout in one cooperative launch of ``rollout2d_blocks_kernel``,
frame t -> frame t + 1 of the assembled frames, no gradient; past
``blocks_plan`` a call takes ``step_blocks_2d`` a step.

The backward of both trainable steps is autograd through the eager
valid-region step (core.cell.pi_cell_step_valid), as the JAX package's
custom VJP is: the cotangents of the parameters and of the whole haloed
block, halo included, which the strips and the exchange carry back to the
neighbours.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from percnn_tpu_torch._device import full_f32
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step_valid
from percnn_tpu_torch.core.rollout import _flatten, _unflatten
from percnn_tpu_torch.ops.kernels import _build
from percnn_tpu_torch.ops.kernels.cell2d import (
    _MAX_PARAMS,
    _MAX_SMEM,
    _check_fusable,
    _packed_equation,
    _param_block,
    _raise_on_error,
    _round_up,
    pack_pi_params_2d,
)
from percnn_tpu_torch.ops.stencils import STENCIL_HALO as HALO

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# params, n_params, xp, out, H, W, hidden, n_branches, kernel_size, dt,
# inv_dx2, stream
_SIGNATURE = [_P, _I, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P]
_SIGNATURES = {
    # params, n_params, src, strips, out, table, n_blocks, h, w, hidden,
    # n_branches, kernel_size, dt, inv_dx2, stream
    "sharded_blocks_step": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    # params, n_params, frames, table, n_blocks, h, w, frame_cells, n_steps,
    # hidden, n_branches, kernel_size, dt, inv_dx2, stream, per_sm
    "sharded_blocks_rollout": [_P, _I, _P, _P, _I, _I, _I, ctypes.c_longlong, _I, _I, _I, _I,
                               _F, _F, _P, ctypes.POINTER(_I)],
    # n_params, n_blocks, h, w, n_branches, kernel_size, per_sm
    "sharded_blocks_occupancy": [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)],
}
# cudaErrorCooperativeLaunchTooLarge: a one-launch grid the card cannot hold.
_COOPERATIVE_TOO_LARGE = 720
# Entries a block has in a BlockLayout table (csrc: kRegions), and the
# threads of a CTA of the k = 1 blocks step at most (step2d::kThreads).
REGIONS = 10
_SEGMENT_THREADS = 256
# blocks_plan's rule: a one-launch grid of at most this many threads an SM,
# a quarter of an H100 SM's 2048, which the kernels' registers (at most 128
# a thread) always let an SM hold at once.
_ONE_LAUNCH_THREADS_AN_SM = 512


def _check_packed(packed: torch.Tensor, cfg: PiCellConfig) -> None:
    """The packed vector and the branch count the kernels are compiled for."""
    n_params = packed.numel()
    if n_params != 2 + 2 * _param_block(cfg) or n_params > _MAX_PARAMS:
        raise ValueError(f"packed params have {n_params} floats, expected "
                         f"{2 + 2 * _param_block(cfg)} (at most {_MAX_PARAMS})")
    if cfg.kernel_size > 1 and cfg.n_branches not in (1, 2, 3, 4):
        raise ValueError(f"the k x k step is compiled for 1 to 4 branches, "
                         f"got {cfg.n_branches}")


def step_haloed_2d_plain(packed: torch.Tensor, xp: torch.Tensor,
                         cfg: PiCellConfig) -> torch.Tensor:
    """Plain version of step2d_haloed_kernel: [h + 4, w + 4, 2] ->
    [h, w, 2], from the packed parameters, with tensor ops."""
    h, w = xp.shape[0] - 2 * HALO, xp.shape[1] - 2 * HALO

    def at(di: int, dj: int) -> torch.Tensor:
        return xp[HALO + di:HALO + di + h, HALO + dj:HALO + dj + w]

    s1 = at(1, 0) + at(-1, 0) + at(0, 1) + at(0, -1)
    s2 = at(2, 0) + at(-2, 0) + at(0, 2) + at(0, -2)
    lap = (-5.0 * at(0, 0) + (4.0 / 3.0) * s1 - (1.0 / 12.0) * s2) / (cfg.dx * cfg.dx)
    r = cfg.kernel_size // 2
    cols = torch.cat([at(ki - r, kj - r) for ki in range(cfg.kernel_size)
                      for kj in range(cfg.kernel_size)], dim=-1)   # [h, w, k*k*2]
    pis = []
    for o in range(2):
        wt, b, w_out, b_out = _packed_equation(packed, o, cfg)
        y = torch.einsum("...q,iqc->...ic", cols, wt) + b          # [h, w, nb, C]
        pis.append(torch.prod(y, dim=-2) @ w_out + b_out)
    return at(0, 0) + cfg.dt * (packed[:2] * lap + torch.stack(pis, dim=-1))


def _step_cuda(packed: torch.Tensor, xp: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """step2d_haloed_kernel: one launch."""
    if xp.device.type != "cuda" or packed.device != xp.device:
        raise ValueError(f"step2d_haloed_kernel takes CUDA tensors on one device; got "
                         f"block on {xp.device}, params on {packed.device}")
    if xp.dtype != torch.float32 or packed.dtype != torch.float32:
        raise ValueError(f"step2d_haloed_kernel takes float32, got {xp.dtype}")
    if not (xp.is_contiguous() and packed.is_contiguous()):
        raise ValueError("step2d_haloed_kernel takes contiguous tensors")
    _check_packed(packed, cfg)
    n_params = packed.numel()
    fn = _build.load_library("sharded_step2d").sharded_step2d
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    h, w = xp.shape[0] - 2 * HALO, xp.shape[1] - 2 * HALO
    out = torch.empty((h, w, 2), dtype=torch.float32, device=xp.device)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), n_params, xp.data_ptr(), out.data_ptr(), h, w,
                           cfg.hidden, cfg.n_branches, cfg.kernel_size, cfg.dt,
                           1.0 / (cfg.dx * cfg.dx), stream), "sharded_step2d")
    step_haloed_2d.launches += 1
    return out


class _StepHaloed2d(torch.autograd.Function):
    """Forward: the kernel (or, on the CPU, its plain version) on the f32
    block.  Backward: autograd through pi_cell_step_valid at the saved
    inputs, in full float32."""

    @staticmethod
    def forward(ctx, cfg, like, xp, *leaves):
        ctx.cfg, ctx.like = cfg, like
        ctx.save_for_backward(xp, *leaves)
        packed = pack_pi_params_2d(_unflatten(like, iter(leaves)), cfg)
        x = xp.to(torch.float32).contiguous()
        if x.device.type == "cpu":
            return step_haloed_2d_plain(packed, x, cfg)
        return _step_cuda(packed, x, cfg)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad(), full_f32():
            out = pi_cell_step_valid(_unflatten(ctx.like, iter(inputs[1:])), inputs[0], ctx.cfg)
            grads = torch.autograd.grad(out, inputs, g.to(out.dtype))
        return (None, None, *grads)


def step_haloed_2d(params: dict, xp: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """One Euler step on a haloed block [h + 4, w + 4, 2] -> [h, w, 2] f32,
    any 2D two-channel cell of odd kernel_size <= 5 (h, w >= 2).

    Trainable: the forward is step2d_haloed_kernel on CUDA (its plain
    version on the CPU); the backward is autograd through the eager
    valid-region step, with cotangents for the parameters and for the
    whole block.
    """
    _check_fusable(cfg)
    if xp.dim() != 3 or xp.shape[-1] != 2 or min(xp.shape[:2]) < 2 + 2 * HALO:
        raise ValueError(f"a haloed block is [h + 4, w + 4, 2] with h, w >= 2, "
                         f"got {tuple(xp.shape)}")
    leaves = _flatten(params)
    return _StepHaloed2d.apply(cfg, params, xp, *leaves)


step_haloed_2d.launches = 0


# ---------------------------------------------------------------------------
# Every block of a device in one launch: step2d_blocks_kernel, and the whole
# rollout of one device's blocks in one launch: rollout2d_blocks_kernel

# The k x k steps' tile (csrc/kxk_common.cuh: kTileH x kTileW cells, two
# threads a cell, staged with a 2-cell halo).
_TILE_H, _TILE_W = 8, 16


class BlockLayout:
    """Where each of the nb blocks of one launch reads its haloed block and
    writes its step: the table step2d_blocks_kernel and
    rollout2d_blocks_kernel read (csrc/cell2d_step.cuh, ``Blocks``).

    ``table`` [nb, REGIONS, 4] int32 holds per block the nine regions of its
    haloed block [h + 4, w + 4], row-major over rows (the 2 above, its h, the
    2 below) by columns (the 2 left, its w, the 2 right), each (buffer,
    base, ld, 0): the region's first cell is cell ``base`` of buffer 0, the
    source (a state [nb, h, w, 2] or a frame: ``src_cells`` cells), or of
    buffer 1, the strips (``strip_cells`` cells), and its rows lie ld cells
    apart; then (0, base, ld, 0) of the block's output [h, w] in the output
    buffer (``out_cells`` cells).  Every region is checked to lie in its
    buffer, so a table cannot send the kernel out of bounds.
    """

    def __init__(self, table: np.ndarray, h: int, w: int, *, src_cells: int,
                 strip_cells: int, out_cells: int):
        table = np.ascontiguousarray(table, dtype=np.int32)
        if table.ndim != 3 or table.shape[1:] != (REGIONS, 4) or min(h, w) < HALO:
            raise ValueError(f"a block table is [nb, {REGIONS}, 4] for blocks of at least "
                             f"{HALO} x {HALO}, got {table.shape} for {h} x {w}")
        if max(src_cells, strip_cells, out_cells) >= 2 ** 31:
            raise ValueError("a block table's buffers hold fewer than 2^31 cells")
        nr = np.repeat([HALO, h, HALO], 3)
        nc = np.tile([HALO, w, HALO], 3)
        buf, base, ld = (table[:, :9, k].astype(np.int64) for k in range(3))
        cells = np.where(buf == 0, src_cells, strip_cells)
        out = table[:, 9, :3].astype(np.int64)
        if not (np.isin(buf, (0, 1)).all() and (base >= 0).all() and (ld >= nc).all()
                and (base + (nr - 1) * ld + nc <= cells).all() and (out[:, 0] == 0).all()
                and (out[:, 1] >= 0).all() and (out[:, 2] >= w).all()
                and (out[:, 1] + (h - 1) * out[:, 2] + w <= out_cells).all()):
            raise ValueError("a region of the block table lies outside its buffer")
        self.table, self.h, self.w = table, h, w
        self.src_cells, self.strip_cells, self.out_cells = src_cells, strip_cells, out_cells
        n = table.shape[0]
        self.writes_blocks = out_cells == n * h * w and bool(
            (out[:, 1] == np.arange(n) * h * w).all() and (out[:, 2] == w).all())
        self._cache: dict = {}

    @property
    def n_blocks(self) -> int:
        return self.table.shape[0]

    def _cached(self, key, device, make):
        device = torch.device(device)
        if (key, device) not in self._cache:
            self._cache[key, device] = make().to(device)
        return self._cache[key, device]

    def on(self, device) -> torch.Tensor:
        """The table on `device`, as the kernels read it."""
        return self._cached("table", device, lambda: torch.from_numpy(self.table))

    def haloed_index(self, device) -> torch.Tensor:
        """[nb, h + 4, w + 4] int64: cell (r, c) of each block's haloed block
        as an index into the source's cells followed by the strips'."""
        def make():
            h, w = self.h, self.w
            r, c = np.arange(-HALO, h + HALO), np.arange(-HALO, w + HALO)
            ri = (r >= 0).astype(np.int64) + (r >= h)
            rj = (c >= 0).astype(np.int64) + (c >= w)
            rl = r - np.array([-HALO, 0, h])[ri]
            cl = c - np.array([-HALO, 0, w])[rj]
            reg = self.table[:, 3 * ri[:, None] + rj[None, :]].astype(np.int64)
            return torch.from_numpy(reg[..., 0] * self.src_cells + reg[..., 1]
                                    + rl[:, None] * reg[..., 2] + cl[None, :])
        return self._cached("haloed", device, make)

    def out_index(self, device) -> torch.Tensor:
        """[nb, h, w] int64: output cell (i, j) of each block as an index into
        the output buffer's cells."""
        def make():
            o = self.table[:, 9].astype(np.int64)
            i, j = np.arange(self.h), np.arange(self.w)
            return torch.from_numpy(o[:, 1, None, None] + i[None, :, None] * o[:, 2, None, None]
                                    + j[None, None, :])
        return self._cached("out", device, make)


def _check_buffers(layout: BlockLayout, src: torch.Tensor, strips: torch.Tensor) -> None:
    if src.numel() != 2 * layout.src_cells or strips.numel() != 2 * layout.strip_cells:
        raise ValueError(f"the block table reads {layout.src_cells} source and "
                         f"{layout.strip_cells} strip cells, got tensors {tuple(src.shape)} "
                         f"and {tuple(strips.shape)}")


def haloed_blocks(src: torch.Tensor, strips: torch.Tensor, layout: BlockLayout) -> torch.Tensor:
    """The layout's haloed blocks [nb, h + 4, w + 4, 2], read from the source
    and the strips by the table: what step2d_blocks_kernel steps from, with
    the same cells in every halo.  Differentiable in both buffers."""
    _check_buffers(layout, src, strips)
    flat = torch.cat([src.reshape(-1, 2), strips.reshape(-1, 2).to(src.dtype)])
    return flat[layout.haloed_index(flat.device)]


def step_blocks_2d_plain(packed: torch.Tensor, src: torch.Tensor, strips: torch.Tensor,
                         layout: BlockLayout, cfg: PiCellConfig) -> torch.Tensor:
    """Plain version of step2d_blocks_kernel: the layout's haloed blocks
    built from the source and the strips, then step_haloed_2d_plain's
    arithmetic on each: [nb, h, w, 2]."""
    return torch.stack([step_haloed_2d_plain(packed, xp, cfg)
                        for xp in haloed_blocks(src, strips, layout)])


def blocks_shape(n_blocks: int, h: int, w: int, cfg: PiCellConfig) -> dict:
    """The launch of a blocks step, either kernel (csrc: blocks_shape): at
    k = 1 one CTA of min(256, w rounded up to 32) threads a row segment of a
    block, grid (segments, h, nb), the parameters and 5 staged rows in
    shared memory; at k > 1 one CTA of 256 threads an 8 x 16 tile of a
    block, grid (tile columns, tile rows, nb), the parameters and the tile."""
    params_bytes = 4 * _round_up(2 + 2 * _param_block(cfg), 4)
    if cfg.kernel_size == 1:
        threads = min(_SEGMENT_THREADS, _round_up(w, 32))
        return {"grid": (-(-w // threads), h, n_blocks), "threads": threads,
                "smem": params_bytes + 8 * (2 * HALO + 1) * (threads + 2 * HALO)}
    return {"grid": (-(-w // _TILE_W), -(-h // _TILE_H), n_blocks), "threads": 2 * _TILE_H * _TILE_W,
            "smem": params_bytes + 8 * (_TILE_H + 2 * HALO) * (_TILE_W + 2 * HALO)}


def blocks_plan(n_blocks: int, h: int, w: int, cfg: PiCellConfig, n_sm: int) -> dict:
    """The route of a no-gradient rollout of n_blocks blocks of h x w on one
    card of n_sm SMs, by a rule on the shape and the card's limits: a blocks
    step whose grid has at most 512 threads an SM of the card, and whose
    shared memory fits a CTA, takes rollout2d_blocks_kernel, one cooperative
    launch a rollout ('one_launch'); any other, step2d_blocks_kernel, one
    launch a step ('per_step').  Both with blocks_shape's grid.  GS2D
    100 x 100 on a 2 x 2 mesh: 200 CTAs of 64 threads; the Burgers cell
    there: 112 CTAs of 256 threads."""
    shape = blocks_shape(n_blocks, h, w, cfg)
    ctas = shape["grid"][0] * shape["grid"][1] * shape["grid"][2]
    fits = (ctas * shape["threads"] <= n_sm * _ONE_LAUNCH_THREADS_AN_SM
            and shape["smem"] <= _MAX_SMEM)
    return {"route": "one_launch" if fits else "per_step", **shape}


@functools.cache
def _blocks_fn(name: str):
    """A C entry point of the blocks kernels, its argument types set once."""
    fn = getattr(_build.load_library("sharded_step2d"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def blocks_occupancy(n_blocks: int, h: int, w: int, cfg: PiCellConfig,
                     device: torch.device) -> dict:
    """CTAs of rollout2d_blocks_kernel an SM of the card holds at this shape,
    and whether the card holds the whole grid at once (the launch's own
    check)."""
    n_params = 2 + 2 * _param_block(cfg)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _blocks_fn("sharded_blocks_occupancy")(n_params, n_blocks, h, w, cfg.n_branches,
                                                     cfg.kernel_size, ctypes.byref(per_sm))
    if err not in (0, _COOPERATIVE_TOO_LARGE):
        _raise_on_error(err, "sharded_blocks_occupancy")
    return {"ctas_an_sm_holds": per_sm.value, "fits": err == 0}



def _check_blocks_cuda(packed: torch.Tensor, src: torch.Tensor, strips: torch.Tensor,
                       layout: BlockLayout, cfg: PiCellConfig, name: str) -> None:
    if src.device.type != "cuda" or packed.device != src.device or strips.device != src.device:
        raise ValueError(f"{name} takes CUDA tensors on one device; got source on "
                         f"{src.device}, strips on {strips.device}, params on {packed.device}")
    if not all(t.dtype == torch.float32 for t in (packed, src, strips)):
        raise ValueError(f"{name} takes float32, got {src.dtype}, {strips.dtype}, "
                         f"{packed.dtype}")
    if not all(t.is_contiguous() for t in (packed, src, strips)):
        raise ValueError(f"{name} takes contiguous tensors")
    _check_packed(packed, cfg)
    _check_buffers(layout, src, strips)


def _step_blocks_cuda(packed: torch.Tensor, state: torch.Tensor, strips: torch.Tensor,
                      layout: BlockLayout, cfg: PiCellConfig) -> torch.Tensor:
    """step2d_blocks_kernel: one launch for every block of the state."""
    _check_blocks_cuda(packed, state, strips, layout, cfg, "step2d_blocks_kernel")
    if not layout.writes_blocks:
        raise ValueError("step2d_blocks_kernel writes the blocks [nb, h, w, 2] in order: the "
                         "table's output entries must say so")
    nb, h, w = layout.n_blocks, layout.h, layout.w
    out = torch.empty((nb, h, w, 2), dtype=torch.float32, device=state.device)
    table = layout.on(state.device)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(_blocks_fn("sharded_blocks_step")(
            packed.data_ptr(), packed.numel(), state.data_ptr(),
            strips.data_ptr() if strips.numel() else None, out.data_ptr(), table.data_ptr(),
            nb, h, w, cfg.hidden, cfg.n_branches, cfg.kernel_size, cfg.dt,
            1.0 / (cfg.dx * cfg.dx), stream), "sharded_blocks_step")
    step_blocks_2d.launches += 1
    return out


class _StepBlocks2d(torch.autograd.Function):
    """Forward: step2d_blocks_kernel (on the CPU, its plain version) on the
    f32 state and strips.  Backward: autograd through pi_cell_step_valid on
    the haloed blocks rebuilt from the saved state and strips, in full
    float32: the cotangents of the parameters, the state and the strips
    (whose part the caller's strip copies carry back to the neighbours)."""

    @staticmethod
    def forward(ctx, cfg, like, packed, layout, state, strips, *leaves):
        ctx.cfg, ctx.like, ctx.layout = cfg, like, layout
        ctx.save_for_backward(state, strips, *leaves)
        if state.device.type == "cpu":
            return step_blocks_2d_plain(packed, state, strips, layout, cfg)
        return _step_blocks_cuda(packed, state, strips, layout, cfg)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad(), full_f32():
            xp = haloed_blocks(inputs[0], inputs[1], ctx.layout)
            out = pi_cell_step_valid(_unflatten(ctx.like, iter(inputs[2:])), xp, ctx.cfg)
            grads = torch.autograd.grad(out, inputs, g.to(out.dtype))
        return (None, None, None, None, *grads)


def step_blocks_2d(params: dict, state: torch.Tensor, strips: torch.Tensor,
                   layout: BlockLayout, cfg: PiCellConfig, *,
                   packed: torch.Tensor | None = None) -> torch.Tensor:
    """One Euler step of every block of one device, any 2D two-channel cell
    of odd kernel_size <= 5: state [nb, h, w, 2] f32 (the device's blocks in
    mesh order) and strips [n, 2] f32 (the cells the layout reads from other
    devices' blocks) -> [nb, h, w, 2].  ``packed`` is
    pack_pi_params_2d(params, cfg) on the state's device, for a caller that
    steps many times (a rollout packs once a device).

    Trainable in params, state and strips: the forward is
    step2d_blocks_kernel on CUDA, one launch (its plain version on the
    CPU); the backward is autograd through the eager valid-region step.
    """
    _check_fusable(cfg)
    if packed is None:
        packed = pack_pi_params_2d(params, cfg)
    return _StepBlocks2d.apply(cfg, params, packed.detach(), layout, state, strips,
                               *_flatten(params))


step_blocks_2d.launches = 0


def rollout_blocks_2d_plain(packed: torch.Tensor, h0: torch.Tensor, layout: BlockLayout,
                            cfg: PiCellConfig, n_steps: int) -> torch.Tensor:
    """Plain version of rollout2d_blocks_kernel: frame t + 1 is
    step_blocks_2d_plain of frame t, written where the table says."""
    frames = h0.new_empty((n_steps + 1,) + tuple(h0.shape))
    frames[0] = h0
    none = h0.new_empty((0, 2))
    out = layout.out_index(h0.device)
    for t in range(n_steps):
        frames[t + 1].view(-1, 2)[out] = step_blocks_2d_plain(packed, frames[t], none,
                                                              layout, cfg)
    return frames


def _rollout_blocks_cuda(packed: torch.Tensor, h0: torch.Tensor, layout: BlockLayout,
                         cfg: PiCellConfig, n_steps: int) -> torch.Tensor:
    """rollout2d_blocks_kernel: one cooperative launch for the whole rollout
    (none for n_steps = 0); raises where the card cannot hold its grid."""
    none = h0.new_empty((0, 2))
    _check_blocks_cuda(packed, h0, none, layout, cfg, "rollout2d_blocks_kernel")
    frames = torch.empty((n_steps + 1,) + tuple(h0.shape), dtype=torch.float32,
                         device=h0.device)
    frames[0] = h0
    table = layout.on(h0.device)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(_blocks_fn("sharded_blocks_rollout")(
            packed.data_ptr(), packed.numel(), frames.data_ptr(), table.data_ptr(),
            layout.n_blocks, layout.h, layout.w, layout.src_cells, n_steps, cfg.hidden,
            cfg.n_branches, cfg.kernel_size, cfg.dt, 1.0 / (cfg.dx * cfg.dx), stream,
            ctypes.byref(per_sm)), "sharded_blocks_rollout")
    if n_steps:
        rollout_blocks_2d.launches += 1
    return frames


def rollout_blocks_2d(packed: torch.Tensor, h0: torch.Tensor, layout: BlockLayout,
                      cfg: PiCellConfig, n_steps: int) -> torch.Tensor:
    """n_steps of every block of a field on one device, no gradient: h0 [H,
    W, 2] f32 -> frames [n_steps + 1, H, W, 2], frame 0 = h0, each step
    reading frame t and writing frame t + 1 through the layout, whose source
    and output are a frame (src_cells = out_cells = H W, no strips).  On
    CUDA one cooperative launch of rollout2d_blocks_kernel (within
    blocks_plan; past it the launch is refused and this raises); on the CPU
    its plain version.  ``packed`` is pack_pi_params_2d's vector."""
    _check_fusable(cfg)
    if (h0.dim() != 3 or h0.shape[-1] != 2 or layout.strip_cells
            or not layout.src_cells == layout.out_cells == h0.shape[0] * h0.shape[1]):
        raise ValueError(f"a blocks rollout reads and writes frames of the layout's "
                         f"{layout.src_cells} cells, got h0 {tuple(h0.shape)}")
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    packed = packed.detach()
    if h0.device.type == "cpu":
        return rollout_blocks_2d_plain(packed, h0.to(torch.float32), layout, cfg, n_steps)
    return _rollout_blocks_cuda(packed, h0, layout, cfg, n_steps)


rollout_blocks_2d.launches = 0
