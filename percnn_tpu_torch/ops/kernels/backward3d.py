"""Backward of the 3D 1x1 Pi-cell rollout: CUDA kernels for Hopper and their
plain versions.

Counterpart of percnn_tpu/ops/pallas/backward3d.py.  Its streaming half:
``fused_rollout_tp_3d`` is a differentiable rollout whose forward is
cell3d.rollout3d_plan's kernel and whose backward is a reverse sweep that
streams g_in out (in place of ``_phase1_kernel3d``), then
``core.rollout.chunked_param_grads`` over chunks of 16 steps.
``adj3d_plan`` picks the sweep's kernel from the shape:
``adj3d_persistent_kernel``, the whole sweep in one cooperative launch
(pg3d_persistent_kernel's body without the accumulators, its g0 that
kernel's to the bit), for the GS3D cell's widths on any field that fits
(51^3 at most on 132 SMs), else ``adj3d_kernel``, one launch a reverse step
(both in csrc/backward3d.cu).  The sweep is the 2D one of
ops/kernels/backward2d.py at k = 1 with the 13-point 3D Laplacian.
``fused_phase1_3d.launches`` counts its launches (one a sweep on the
one-launch route, none for no steps; one a reverse step on the per-step
route) and ``fused_phase1_3d.steps`` its reverse steps run on the card.

The fused-pg half: ``fused_rollout_tp_3d_pg`` is a differentiable rollout whose forward is
cell3d.rollout3d_plan's kernel (ops/kernels/cell3d.py, the expanded cubic)
and whose backward is one reverse sweep that carries the adjoint from frame
T down to frame 0 and accumulates every parameter gradient into
[A, D, H, W] planes, A = 44 for the GS3D cell, in place of
``_phase1_pg_kernel3d``.  ``pg3d_plan`` picks its kernel from the shape:
``pg3d_persistent_kernel``, the whole sweep in one cooperative launch with
each block's accumulators in its shared memory, for the GS3D cell's widths
on any field that fits (51^3 at most on 132 SMs), else ``pg3d_kernel``,
one launch a reverse step
(both in csrc/backward3d.cu).  The sweep is the 2D one
(ops/kernels/backward2d.py) with the 13-point 3D Laplacian; the plane
layout and the unpacking are shared with it, as in percnn_tpu.

The Function's differentiable input is the literal packed vector
(``pack_pi_params_3d``, which applies mu_up * sigmoid), so autograd carries
the gradient on through the reparametrisation; the forward derives the
expanded coefficients from it without a gradient.

A CPU tensor takes the plain versions (``fused_rollout_3d_plain``,
``fused_phase1_3d_plain``, ``fused_phase1_pg_3d_plain``); a CUDA tensor
launches the kernels or raises.  ``fused_rollout_tp_3d_pg.launches`` counts the
sweep's launches (one a sweep on the persistent route, one a reverse step
on the per-step route) and ``fused_rollout_tp_3d_pg.steps`` its reverse
steps run on the card.
"""

from __future__ import annotations

import ctypes

import torch

from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step
from percnn_tpu_torch.core.rollout import chunked_param_grads
from percnn_tpu_torch.ops.kernels import _build
from percnn_tpu_torch.ops.kernels.backward2d import (
    _adjoint_sweep_plain,
    _branch_operands,
    _cell_leaves,
    _cell_tree,
    _pg_layout,
    _pg_sweep_plain,
    _pg_unpack,
)
from percnn_tpu_torch.ops.kernels.cell2d import (
    _MAX_PARAMS,
    _MAX_SMEM,
    _param_block,
    _raise_on_error,
    _round_up,
    _sm_count,
)
from percnn_tpu_torch.ops.kernels.cell3d import (
    _check_fusable,
    _rollout_cuda,
    expand_packed_3d,
    fused_rollout_3d_plain,
    pack_pi_expanded_3d,
    pack_pi_params_3d,
)
from percnn_tpu_torch.ops.stencils import laplacian

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# params, n_params, frames, frames_bar, g0, scratch, acc, n_steps, D, H, W,
# hidden, n_branches, dt, inv_dx2, stream
_SIGNATURE = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]
# params, n_params, frames, frames_bar, g0, scratch, g_ins, n_steps, D, H, W,
# hidden, n_branches, dt, inv_dx2, stream
_ADJ_SIGNATURE = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]
# the same as _SIGNATURE, then blocks, stream, blocks an SM (out)
_PERSISTENT_SIGNATURE = _SIGNATURE[:-1] + [_I, _P, ctypes.POINTER(_I)]
# the same as _ADJ_SIGNATURE, then blocks, stream, blocks an SM (out)
_ADJ_PERSISTENT_SIGNATURE = _ADJ_SIGNATURE[:-1] + [_I, _P, ctypes.POINTER(_I)]
# n_params, D, H, W, hidden, n_branches, blocks, blocks an SM (out)
_OCCUPANCY_SIGNATURE = [_I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]
# pg3d_persistent_kernel and adj3d_persistent_kernel (csrc/backward3d.cu):
# their threads a block, and the cell widths (hidden, n_branches) they are
# compiled for, the GS3D cell's
_PG3D_THREADS = 512
_PG3D_WIDTHS = (2, 3)


def _lap3d(cfg: PiCellConfig):
    return lambda x: laplacian(x, cfg.dx, dims=(0, 1, 2))


def fused_phase1_pg_3d_plain(packed: torch.Tensor, frames: torch.Tensor,
                             frames_bar: torch.Tensor, cfg: PiCellConfig):
    """Plain version of pg3d_kernel: the reverse sweep written with tensor ops.

    packed [P] (pack_pi_params_3d); frames [T+1, D, H, W, 2], the forward's
    output; frames_bar [T+1, D, H, W, 2], their cotangent.  Returns (g0
    [D, H, W, 2], the adjoint at frame 0 without frames_bar[0]; acc
    [A, D, H, W]).
    """
    return _pg_sweep_plain(packed, frames, frames_bar, cfg, _lap3d(cfg))


def _kernel_fn(name: str = "backward3d_pg", signature: list = _SIGNATURE):
    fn = getattr(_build.load_library("backward3d"), name)
    fn.argtypes = signature
    fn.restype = ctypes.c_int
    return fn


def _check_pg_inputs(packed: torch.Tensor, frames: torch.Tensor,
                     frames_bar: torch.Tensor, cfg: PiCellConfig,
                     name: str = "pg3d_kernel") -> torch.Tensor:
    """Check the inputs of pg3d_kernel (or adj3d_kernel); return frames_bar
    as contiguous f32."""
    if frames.device.type != "cuda" or packed.device != frames.device \
            or frames_bar.device != frames.device:
        raise ValueError(f"{name} takes CUDA tensors on one device; got "
                         f"{packed.device}, {frames.device}, {frames_bar.device}")
    if frames.dtype != torch.float32 or packed.dtype != torch.float32:
        raise ValueError(f"{name} takes float32, got {frames.dtype}, {packed.dtype}")
    if frames.dim() != 5 or frames.shape[-1] != 2 or frames_bar.shape != frames.shape \
            or min(frames.shape[1:4]) < 5:
        raise ValueError(f"frames and frames_bar must be [T+1, D, H, W, 2] with "
                         f"D, H, W >= 5, got {tuple(frames.shape)} and "
                         f"{tuple(frames_bar.shape)}")
    if not (frames.is_contiguous() and packed.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    n_params = packed.numel()
    if n_params != 2 + 2 * _param_block(cfg) or n_params > _MAX_PARAMS:
        raise ValueError(f"packed params have {n_params} floats, expected "
                         f"{2 + 2 * _param_block(cfg)} (at most {_MAX_PARAMS})")
    _check_fusable(cfg)
    # the cotangent of a strided slice arrives sparse, expanded or strided
    return frames_bar.to(torch.float32).contiguous()


def pg3d_smem_bytes(cfg: PiCellConfig, D: int, H: int, W: int, blocks: int) -> int:
    """Shared memory of a block of pg3d_persistent_kernel: the packed
    parameters rounded up to 4 floats, the A accumulators of each of the
    most cells a block owns (cap), and g's window, its run with two rows of
    W cells on each side, cap + 4 W float2 (csrc: persistent_smem_bytes)."""
    cap = -(-(D * H * W) // blocks)
    n_params = 2 + 2 * _param_block(cfg)
    return 4 * (_round_up(n_params, 4) + _pg_layout(cfg)["A"] * cap) + 8 * (cap + 4 * W)


def pg3d_plan(D: int, H: int, W: int, cfg: PiCellConfig, n_sm: int) -> dict:
    """The route of the fused reverse sweep of a D x H x W field on a card of
    n_sm SMs, by a rule on the cell, the shape and the card's limits: a cell
    of the widths the kernel is compiled for (C = 2, 3 branches: GS3D's) on
    one block an SM (min(n_sm, D H W) blocks of 512 threads, each owning
    split_evenly's share of the cells, at most two a thread) whose
    accumulators fit a block's shared memory takes pg3d_persistent_kernel,
    one cooperative launch a sweep ('persistent', with blocks and smem);
    else pg3d_kernel, one launch a step ('per_step').  At 48^3 on 132 SMs:
    132 blocks of 837 or 838 cells, 155 904 bytes each; the largest cube it
    takes is 51^3 (1005 cells a block)."""
    if (cfg.hidden, cfg.n_branches) != _PG3D_WIDTHS:
        return {"route": "per_step"}
    blocks = min(n_sm, D * H * W)
    smem = pg3d_smem_bytes(cfg, D, H, W, blocks)
    if smem > _MAX_SMEM or -(-(D * H * W) // blocks) > 2 * _PG3D_THREADS:
        return {"route": "per_step"}
    return {"route": "persistent", "blocks": blocks, "smem": smem}


def _pg_steps_cuda(packed: torch.Tensor, frames: torch.Tensor, frames_bar: torch.Tensor,
                   cfg: PiCellConfig):
    """pg3d_kernel: one launch per reverse step, the loop in C."""
    fn = _kernel_fn()
    frames_bar = _check_pg_inputs(packed, frames, frames_bar, cfg)
    n_steps = frames.shape[0] - 1
    D, H, W = frames.shape[1:4]
    g0 = torch.zeros((D, H, W, 2), dtype=torch.float32, device=frames.device)
    scratch = torch.zeros_like(g0)
    acc = torch.zeros((_pg_layout(cfg)["A"], D, H, W), dtype=torch.float32,
                      device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.numel(), frames.data_ptr(),
                           frames_bar.data_ptr(), g0.data_ptr(), scratch.data_ptr(),
                           acc.data_ptr(), n_steps, D, H, W, cfg.hidden, cfg.n_branches,
                           cfg.dt, 1.0 / (cfg.dx * cfg.dx), stream), "backward3d_pg")
    fused_rollout_tp_3d_pg.launches += n_steps
    fused_rollout_tp_3d_pg.steps += n_steps
    return g0, acc


def _pg_persistent_cuda(packed: torch.Tensor, frames: torch.Tensor, frames_bar: torch.Tensor,
                        cfg: PiCellConfig):
    """pg3d_persistent_kernel: the whole sweep in one cooperative launch, by
    pg3d_plan's configuration.  Raises if the card cannot hold the grid."""
    frames_bar = _check_pg_inputs(packed, frames, frames_bar, cfg)
    n_steps = frames.shape[0] - 1
    D, H, W = frames.shape[1:4]
    plan = pg3d_plan(D, H, W, cfg, _sm_count(frames.device))
    if plan["route"] != "persistent":
        raise ValueError(f"a {D} x {H} x {W} field takes no persistent sweep (pg3d_plan)")
    fn = _kernel_fn("backward3d_pg_persistent", _PERSISTENT_SIGNATURE)
    g0 = torch.zeros((D, H, W, 2), dtype=torch.float32, device=frames.device)
    scratch = torch.zeros_like(g0)
    acc = torch.empty((_pg_layout(cfg)["A"], D, H, W), dtype=torch.float32,
                      device=frames.device)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.numel(), frames.data_ptr(),
                           frames_bar.data_ptr(), g0.data_ptr(), scratch.data_ptr(),
                           acc.data_ptr(), n_steps, D, H, W, cfg.hidden, cfg.n_branches,
                           cfg.dt, 1.0 / (cfg.dx * cfg.dx), plan["blocks"], stream,
                           ctypes.byref(per_sm)), "backward3d_pg_persistent")
    fused_rollout_tp_3d_pg.launches += 1
    fused_rollout_tp_3d_pg.steps += n_steps
    return g0, acc


def pg3d_occupancy(cfg: PiCellConfig, D: int, H: int, W: int, device: torch.device) -> int:
    """How many blocks of pg3d_plan's configuration an SM of the card holds."""
    plan = pg3d_plan(D, H, W, cfg, _sm_count(device))
    if plan["route"] != "persistent":
        raise ValueError(f"a {D} x {H} x {W} field takes no persistent sweep")
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise_on_error(_kernel_fn("backward3d_pg_occupancy", _OCCUPANCY_SIGNATURE)(
            2 + 2 * _param_block(cfg), D, H, W, cfg.hidden, cfg.n_branches, plan["blocks"],
            ctypes.byref(per_sm)), "backward3d_pg_occupancy")
    return per_sm.value


def _pg_cuda(packed: torch.Tensor, frames: torch.Tensor, frames_bar: torch.Tensor,
             cfg: PiCellConfig):
    """The fused reverse sweep on CUDA by pg3d_plan's route: one cooperative
    launch of pg3d_persistent_kernel ('persistent') or one pg3d_kernel
    launch a step ('per_step')."""
    if frames.dim() == 5 and frames.device.type == "cuda" and pg3d_plan(
            *frames.shape[1:4], cfg, _sm_count(frames.device))["route"] == "persistent":
        return _pg_persistent_cuda(packed, frames, frames_bar, cfg)
    return _pg_steps_cuda(packed, frames, frames_bar, cfg)


def fused_phase1_pg_3d(packed: torch.Tensor, frames: torch.Tensor,
                       frames_bar: torch.Tensor, cfg: PiCellConfig):
    """(g0 [D, H, W, 2], acc [A, D, H, W]): pg3d_plan's kernel on CUDA, the
    plain version on the CPU."""
    if frames.device.type == "cpu":
        return fused_phase1_pg_3d_plain(packed, frames, frames_bar.to(torch.float32), cfg)
    return _pg_cuda(packed, frames, frames_bar, cfg)


class FusedRolloutTP3dPG(torch.autograd.Function):
    """frames = rollout(packed, h0); backward by the fused reverse sweep."""

    @staticmethod
    def forward(ctx, packed, h0, cfg, n_steps):
        expanded = expand_packed_3d(packed.detach(), cfg).contiguous()
        if h0.device.type == "cpu":
            frames = fused_rollout_3d_plain(expanded, h0, n_steps)
        else:
            frames = _rollout_cuda(expanded, h0, n_steps)
        ctx.cfg = cfg
        ctx.save_for_backward(packed, frames)
        return frames

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, frames_bar):
        packed, frames = ctx.saved_tensors
        g0, acc = fused_phase1_pg_3d(packed, frames, frames_bar, ctx.cfg)
        d_packed = _pg_unpack(acc.sum((1, 2, 3)), packed, ctx.cfg)
        return d_packed, g0 + frames_bar[0], None, None


def fused_rollout_tp_3d_pg(params: dict, h0: torch.Tensor, cfg: PiCellConfig,
                           n_steps: int) -> torch.Tensor:
    """Differentiable rollout of a 3D 1x1 Pi cell: [D, H, W, 2] ->
    [n_steps+1, D, H, W, 2] f32.  Forward and backward by the kernels that
    cell3d.rollout3d_plan and pg3d_plan pick on CUDA; the plain versions of
    both on the CPU."""
    _check_fusable(cfg)
    packed = pack_pi_params_3d(params, cfg)
    return FusedRolloutTP3dPG.apply(packed, h0.to(torch.float32).contiguous(), cfg, n_steps)


fused_rollout_tp_3d_pg.launches = 0
fused_rollout_tp_3d_pg.steps = 0


# ---------------------------------------------------------------------------
# The streaming half: adj3d_kernel and chunked_param_grads
# ---------------------------------------------------------------------------


def fused_phase1_3d_plain(packed: torch.Tensor, frames: torch.Tensor,
                          frames_bar: torch.Tensor, cfg: PiCellConfig):
    """Plain version of adj3d_kernel: (g_ins [T, D, H, W, 2], g0 [D, H, W, 2]
    without frames_bar[0]) from the literal packed vector
    (pack_pi_params_3d), the frames [T+1, D, H, W, 2] and their cotangent."""
    w, b, w_out = _branch_operands(packed, cfg)
    return _adjoint_sweep_plain(w, b, w_out, packed[:2], frames, frames_bar, cfg, _lap3d(cfg))


def _phase1_steps_cuda(packed: torch.Tensor, frames: torch.Tensor, frames_bar: torch.Tensor,
                       cfg: PiCellConfig):
    """adj3d_kernel: one launch per reverse step, the loop in C."""
    frames_bar = _check_pg_inputs(packed, frames, frames_bar, cfg, "adj3d_kernel")
    fn = _kernel_fn("backward3d_adj", _ADJ_SIGNATURE)
    n_steps = frames.shape[0] - 1
    D, H, W = frames.shape[1:4]
    g0 = torch.zeros((D, H, W, 2), dtype=torch.float32, device=frames.device)
    scratch = torch.zeros_like(g0)
    g_ins = torch.empty((n_steps, D, H, W, 2), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.numel(), frames.data_ptr(),
                           frames_bar.data_ptr(), g0.data_ptr(), scratch.data_ptr(),
                           g_ins.data_ptr(), n_steps, D, H, W, cfg.hidden, cfg.n_branches,
                           cfg.dt, 1.0 / (cfg.dx * cfg.dx), stream), "backward3d_adj")
    fused_phase1_3d.launches += n_steps
    fused_phase1_3d.steps += n_steps
    return g_ins, g0


def adj3d_smem_bytes(cfg: PiCellConfig, D: int, H: int, W: int, blocks: int) -> int:
    """Shared memory of a block of adj3d_persistent_kernel: the packed
    parameters rounded up to 4 floats and g's window, the run of the most
    cells a block owns (cap) with two rows of W cells on each side, cap +
    4 W float2; no accumulator (csrc: persistent_smem_bytes with no
    planes)."""
    cap = -(-(D * H * W) // blocks)
    return 4 * _round_up(2 + 2 * _param_block(cfg), 4) + 8 * (cap + 4 * W)


def adj3d_plan(D: int, H: int, W: int, cfg: PiCellConfig, n_sm: int) -> dict:
    """The route of the streaming reverse sweep of a D x H x W field on a
    card of n_sm SMs, by a rule on the cell, the shape and the card's
    limits: a cell of the widths the kernel is compiled for (C = 2, 3
    branches: GS3D's) on one block an SM (min(n_sm, D H W) blocks of 512
    threads, each owning split_evenly's share of the cells, at most two a
    thread) whose window fits a block's shared memory takes
    adj3d_persistent_kernel, one cooperative launch a sweep ('persistent',
    with blocks and smem); else adj3d_kernel, one launch a step
    ('per_step').  At 48^3 on 132 SMs: 132 blocks of 837 or 838 cells,
    8 416 bytes each (pg3d_plan's blocks, without the 147 488 bytes of
    accumulators); the largest cube it takes is 51^3 (1005 cells a block,
    two a thread: the same rule as pg3d_plan's, which the bytes no longer
    bind)."""
    if (cfg.hidden, cfg.n_branches) != _PG3D_WIDTHS:
        return {"route": "per_step"}
    blocks = min(n_sm, D * H * W)
    smem = adj3d_smem_bytes(cfg, D, H, W, blocks)
    if smem > _MAX_SMEM or -(-(D * H * W) // blocks) > 2 * _PG3D_THREADS:
        return {"route": "per_step"}
    return {"route": "persistent", "blocks": blocks, "smem": smem}


def _phase1_persistent_cuda(packed: torch.Tensor, frames: torch.Tensor,
                            frames_bar: torch.Tensor, cfg: PiCellConfig):
    """adj3d_persistent_kernel: the whole streaming sweep in one cooperative
    launch, by adj3d_plan's configuration; (g_ins, g0).  No launch at
    n_steps = 0.  Raises if the card cannot hold the grid."""
    frames_bar = _check_pg_inputs(packed, frames, frames_bar, cfg, "adj3d_persistent_kernel")
    n_steps = frames.shape[0] - 1
    D, H, W = frames.shape[1:4]
    plan = adj3d_plan(D, H, W, cfg, _sm_count(frames.device))
    if plan["route"] != "persistent":
        raise ValueError(f"a {D} x {H} x {W} field takes no one-launch sweep (adj3d_plan)")
    fn = _kernel_fn("backward3d_adj_persistent", _ADJ_PERSISTENT_SIGNATURE)
    g0 = torch.zeros((D, H, W, 2), dtype=torch.float32, device=frames.device)
    scratch = torch.zeros_like(g0)
    g_ins = torch.empty((n_steps, D, H, W, 2), dtype=torch.float32, device=frames.device)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.numel(), frames.data_ptr(),
                           frames_bar.data_ptr(), g0.data_ptr(), scratch.data_ptr(),
                           g_ins.data_ptr(), n_steps, D, H, W, cfg.hidden, cfg.n_branches,
                           cfg.dt, 1.0 / (cfg.dx * cfg.dx), plan["blocks"], stream,
                           ctypes.byref(per_sm)), "backward3d_adj_persistent")
    fused_phase1_3d.launches += 1 if n_steps else 0
    fused_phase1_3d.steps += n_steps
    return g_ins, g0


def adj3d_occupancy(cfg: PiCellConfig, D: int, H: int, W: int, device: torch.device) -> int:
    """How many blocks of adj3d_plan's configuration an SM of the card holds."""
    plan = adj3d_plan(D, H, W, cfg, _sm_count(device))
    if plan["route"] != "persistent":
        raise ValueError(f"a {D} x {H} x {W} field takes no one-launch sweep")
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise_on_error(_kernel_fn("backward3d_adj_occupancy", _OCCUPANCY_SIGNATURE)(
            2 + 2 * _param_block(cfg), D, H, W, cfg.hidden, cfg.n_branches, plan["blocks"],
            ctypes.byref(per_sm)), "backward3d_adj_occupancy")
    return per_sm.value


def _phase1_cuda(packed: torch.Tensor, frames: torch.Tensor, frames_bar: torch.Tensor,
                 cfg: PiCellConfig):
    """The streaming reverse sweep on CUDA by adj3d_plan's route: one
    cooperative launch of adj3d_persistent_kernel ('persistent') or one
    adj3d_kernel launch a step ('per_step'); (g_ins, g0)."""
    if frames.dim() == 5 and frames.device.type == "cuda" and adj3d_plan(
            *frames.shape[1:4], cfg, _sm_count(frames.device))["route"] == "persistent":
        return _phase1_persistent_cuda(packed, frames, frames_bar, cfg)
    return _phase1_steps_cuda(packed, frames, frames_bar, cfg)


def fused_phase1_3d(packed: torch.Tensor, frames: torch.Tensor,
                    frames_bar: torch.Tensor, cfg: PiCellConfig):
    """(g_ins, g0): adj3d_plan's kernel on CUDA, the plain version on the CPU."""
    if frames.device.type == "cpu":
        return fused_phase1_3d_plain(packed, frames, frames_bar.to(torch.float32), cfg)
    return _phase1_cuda(packed, frames, frames_bar, cfg)


class FusedRolloutTP3d(torch.autograd.Function):
    """frames = the rollout of a 3D 1x1 cell from h0 by rollout3d_plan's kernel;
    backward by adj3d_plan's sweep, then chunked_param_grads."""

    @staticmethod
    def forward(ctx, h0, cfg, n_steps, pgrad_chunk, like, *leaves):
        params = _cell_tree(like, leaves)
        expanded = pack_pi_expanded_3d(params, cfg).contiguous()
        if h0.device.type == "cpu":
            frames = fused_rollout_3d_plain(expanded, h0, n_steps)
        else:
            frames = _rollout_cuda(expanded, h0, n_steps)
        ctx.cfg, ctx.pgrad_chunk, ctx.like = cfg, pgrad_chunk, like
        ctx.save_for_backward(frames, *leaves)
        return frames

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, frames_bar):
        frames, *leaves = ctx.saved_tensors
        cfg, params = ctx.cfg, _cell_tree(ctx.like, leaves)
        g_ins, g0 = fused_phase1_3d(pack_pi_params_3d(params, cfg), frames, frames_bar, cfg)
        bar = chunked_param_grads(lambda p, h: pi_cell_step(p, h, cfg), params, frames[:-1],
                                  g_ins, frames.shape[0] - 1, ctx.pgrad_chunk)
        return (g0 + frames_bar[0], None, None, None, None, *_cell_leaves(bar))


def fused_rollout_tp_3d(params: dict, h0: torch.Tensor, cfg: PiCellConfig, n_steps: int,
                        pgrad_chunk: int = 16) -> torch.Tensor:
    """Differentiable rollout of a 3D 1x1 Pi cell: [D, H, W, 2] ->
    [n_steps+1, D, H, W, 2] f32, percnn_tpu's ``fused_rollout_tp_3d``.
    Forward by rollout3d_plan's kernel, backward by adj3d_plan's sweep on CUDA and
    chunked_param_grads over pgrad_chunk steps a batch; the plain versions
    on the CPU.  Any D, H, W >= 5: the TPU kernels' tile alignment has no
    counterpart here."""
    _check_fusable(cfg)
    return FusedRolloutTP3d.apply(h0.to(torch.float32).contiguous(), cfg, n_steps, pgrad_chunk,
                                  params, *_cell_leaves(params))


fused_phase1_3d.launches = 0
fused_phase1_3d.steps = 0
