"""Fully fused backward of the 3D 1x1 Pi-cell rollout: a CUDA kernel for
Hopper and its plain version.

Counterpart of the fused-pg half of percnn_tpu/ops/pallas/backward3d.py.
``fused_rollout_tp_3d_pg`` is a differentiable rollout whose forward is
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
``fused_phase1_pg_3d_plain``); a CUDA tensor launches the kernels or
raises.  ``fused_rollout_tp_3d_pg.launches`` counts the reverse steps
launched.
"""

from __future__ import annotations

import ctypes

import torch

from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.ops.kernels import _build
from percnn_tpu_torch.ops.kernels.backward2d import (
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
    pack_pi_params_3d,
)
from percnn_tpu_torch.ops.stencils import laplacian

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# params, n_params, frames, frames_bar, g0, scratch, acc, n_steps, D, H, W,
# hidden, n_branches, dt, inv_dx2, stream
_SIGNATURE = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]


def fused_phase1_pg_3d_plain(packed: torch.Tensor, frames: torch.Tensor,
                             frames_bar: torch.Tensor, cfg: PiCellConfig):
    """Plain version of pg3d_kernel: the reverse sweep written with tensor ops.

    packed [P] (pack_pi_params_3d); frames [T+1, D, H, W, 2], the forward's
    output; frames_bar [T+1, D, H, W, 2], their cotangent.  Returns (g0
    [D, H, W, 2], the adjoint at frame 0 without frames_bar[0]; acc
    [A, D, H, W]).
    """
    return _pg_sweep_plain(packed, frames, frames_bar, cfg,
                           lambda x: laplacian(x, cfg.dx, dims=(0, 1, 2)))


def _kernel_fn():
    fn = _build.load_library("backward3d").backward3d_pg
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    return fn


def _check_pg_inputs(packed: torch.Tensor, frames: torch.Tensor,
                     frames_bar: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """Check pg3d_kernel's inputs; return frames_bar as contiguous f32."""
    if frames.device.type != "cuda" or packed.device != frames.device \
            or frames_bar.device != frames.device:
        raise ValueError("pg3d_kernel takes CUDA tensors on one device; got "
                         f"{packed.device}, {frames.device}, {frames_bar.device}")
    if frames.dtype != torch.float32 or packed.dtype != torch.float32:
        raise ValueError(f"pg3d_kernel takes float32, got {frames.dtype}, {packed.dtype}")
    if frames.dim() != 5 or frames.shape[-1] != 2 or frames_bar.shape != frames.shape \
            or min(frames.shape[1:4]) < 5:
        raise ValueError(f"frames and frames_bar must be [T+1, D, H, W, 2] with "
                         f"D, H, W >= 5, got {tuple(frames.shape)} and "
                         f"{tuple(frames_bar.shape)}")
    if not (frames.is_contiguous() and packed.is_contiguous()):
        raise ValueError("pg3d_kernel takes contiguous tensors")
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
