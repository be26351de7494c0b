"""Backward of the 3D 1x1 Pi-cell rollout: CUDA kernels for Hopper and their
plain versions.

Counterpart of percnn_tpu/ops/pallas/backward3d.py.  Its streaming half:
``fused_rollout_tp_3d`` is a differentiable rollout whose forward is
``rollout3d_kernel`` and whose backward is ``adj3d_kernel``
(csrc/backward3d.cu, in place of ``_phase1_kernel3d``), a reverse sweep
that streams g_in out, then ``core.rollout.chunked_param_grads`` over
chunks of 16 steps.  The sweep is the 2D one of ops/kernels/backward2d.py
at k = 1 with the 13-point 3D Laplacian.  ``fused_phase1_3d.launches``
counts its launches, one a reverse step.

The fused-pg half: ``fused_rollout_tp_3d_pg`` is a differentiable rollout whose forward is
``rollout3d_kernel`` (ops/kernels/cell3d.py, the expanded cubic) and whose
backward is ``pg3d_kernel`` (csrc/backward3d.cu, in place of
``_phase1_pg_kernel3d``): one reverse sweep that carries the adjoint from
frame T down to frame 0 and accumulates every parameter gradient into
[A, D, H, W] planes, A = 44 for the GS3D cell.  The sweep is the 2D one
(ops/kernels/backward2d.py) with the 13-point 3D Laplacian; the plane
layout and the unpacking are shared with it, as in percnn_tpu.

The Function's differentiable input is the literal packed vector
(``pack_pi_params_3d``, which applies mu_up * sigmoid), so autograd carries
the gradient on through the reparametrisation; the forward derives the
expanded coefficients from it without a gradient.

A CPU tensor takes the plain versions (``fused_rollout_3d_plain``,
``fused_phase1_3d_plain``, ``fused_phase1_pg_3d_plain``); a CUDA tensor
launches the kernels or raises.  ``fused_rollout_tp_3d_pg.launches`` counts the reverse steps
launched.
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
from percnn_tpu_torch.ops.kernels.cell2d import _MAX_PARAMS, _param_block, _raise_on_error
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


def _pg_cuda(packed: torch.Tensor, frames: torch.Tensor, frames_bar: torch.Tensor,
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
    return g0, acc


def fused_phase1_pg_3d(packed: torch.Tensor, frames: torch.Tensor,
                       frames_bar: torch.Tensor, cfg: PiCellConfig):
    """(g0 [D, H, W, 2], acc [A, D, H, W]): pg3d_kernel on CUDA, the plain
    version on the CPU."""
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
    [n_steps+1, D, H, W, 2] f32.  Forward by rollout3d_kernel, backward by
    pg3d_kernel on CUDA; the plain versions of both on the CPU."""
    _check_fusable(cfg)
    packed = pack_pi_params_3d(params, cfg)
    return FusedRolloutTP3dPG.apply(packed, h0.to(torch.float32).contiguous(), cfg, n_steps)


fused_rollout_tp_3d_pg.launches = 0


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


def _phase1_cuda(packed: torch.Tensor, frames: torch.Tensor, frames_bar: torch.Tensor,
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
    return g_ins, g0


def fused_phase1_3d(packed: torch.Tensor, frames: torch.Tensor,
                    frames_bar: torch.Tensor, cfg: PiCellConfig):
    """(g_ins, g0): adj3d_kernel on CUDA, the plain version on the CPU."""
    if frames.device.type == "cpu":
        return fused_phase1_3d_plain(packed, frames, frames_bar.to(torch.float32), cfg)
    return _phase1_cuda(packed, frames, frames_bar, cfg)


class FusedRolloutTP3d(torch.autograd.Function):
    """frames = the rollout of a 3D 1x1 cell from h0 by rollout3d_kernel;
    backward by adj3d_kernel, then chunked_param_grads."""

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
    Forward by rollout3d_kernel, backward by adj3d_kernel on CUDA and
    chunked_param_grads over pgrad_chunk steps a batch; the plain versions
    on the CPU.  Any D, H, W >= 5: the TPU kernels' tile alignment has no
    counterpart here."""
    _check_fusable(cfg)
    return FusedRolloutTP3d.apply(h0.to(torch.float32).contiguous(), cfg, n_steps, pgrad_chunk,
                                  params, *_cell_leaves(params))


fused_phase1_3d.launches = 0
