"""One Euler step on a haloed block: the CUDA kernel for Hopper, its plain
version and the autograd Function around it.

Counterpart of percnn_tpu/ops/pallas/sharded_step2d.py.  Under spatial
decomposition (parallel/sharded.py) every block of the field is extended
each step by a 2-cell halo from its neighbours (parallel/halo.py); the
local update is then ``step_haloed_2d``: [h + 4, w + 4, 2] -> [h, w, 2],
any 2D two-channel Pi cell of odd kernel_size <= 5.  On a CUDA tensor it
launches ``step2d_haloed_kernel`` (csrc/sharded_step2d.cu, in place of
``_step_kernel``), on a CPU tensor it runs ``step_haloed_2d_plain``; a
CUDA tensor launches the kernel or raises.  ``step_haloed_2d.launches``
counts the kernel's launches, one a call.

The backward is autograd through the eager valid-region step
(core.cell.pi_cell_step_valid), as the JAX package's custom VJP is: it
returns the cotangents of the parameters and of the whole haloed block,
halo included, which the exchange carries back to the neighbours.
"""

from __future__ import annotations

import ctypes

import torch

from percnn_tpu_torch._device import full_f32
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step_valid
from percnn_tpu_torch.core.rollout import _flatten, _unflatten
from percnn_tpu_torch.ops.kernels import _build
from percnn_tpu_torch.ops.kernels.cell2d import (
    _MAX_PARAMS,
    _check_fusable,
    _packed_equation,
    _param_block,
    _raise_on_error,
    pack_pi_params_2d,
)
from percnn_tpu_torch.ops.stencils import STENCIL_HALO as HALO

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# params, n_params, xp, out, H, W, hidden, n_branches, kernel_size, dt,
# inv_dx2, stream
_SIGNATURE = [_P, _I, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P]


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
    n_params = packed.numel()
    if n_params != 2 + 2 * _param_block(cfg) or n_params > _MAX_PARAMS:
        raise ValueError(f"packed params have {n_params} floats, expected "
                         f"{2 + 2 * _param_block(cfg)} (at most {_MAX_PARAMS})")
    if cfg.kernel_size > 1 and cfg.n_branches not in (1, 2, 3, 4):
        raise ValueError(f"the k x k step is compiled for 1 to 4 branches, "
                         f"got {cfg.n_branches}")
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
