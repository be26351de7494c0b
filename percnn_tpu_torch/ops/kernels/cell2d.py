"""Fused 2D Pi-cell rollout: CUDA kernels for Hopper and their plain versions.

Counterpart of percnn_tpu/ops/pallas/cell2d.py for 1x1 Pi cells (the GS2D
model).  ``fused_rollout_2d`` streams every frame (``rollout2d_kernel``, in
place of ``_rollout_kernel``); ``fused_rollout_final_2d`` returns the final
state only (``final2d_kernel``, in place of ``_final_kernel``).  The kernels
are in csrc/cell2d.cu, with their bound on the card and their design.

A CPU tensor takes the plain PyTorch version of the same arithmetic
(``fused_rollout_2d_plain``, ``fused_rollout_final_2d_plain``); a CUDA
tensor launches the kernel or raises.  Each public wrapper counts, in its
``launches`` attribute, the kernel launches it makes: one per time step.
"""

from __future__ import annotations

import ctypes

import torch

from percnn_tpu_torch.core.cell import PiCellConfig, effective_diffusion
from percnn_tpu_torch.ops.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # params, n_params, h0, frames, n_steps, H, W, hidden, n_branches, dt,
    # inv_dx2, stream
    "cell2d_rollout": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    # params, n_params, h0, out, scratch, n_steps, H, W, hidden, n_branches,
    # dt, inv_dx2, stream
    "cell2d_final": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
}
# The kernels stage the packed parameters in the default 48 KB of shared memory.
_MAX_PARAMS = 48 * 1024 // 4


def _param_block(cfg: PiCellConfig) -> int:
    """Per-output-channel length of the packed parameter vector."""
    wsize = cfg.kernel_size ** 2 * cfg.channels * cfg.hidden
    return cfg.n_branches * (wsize + cfg.hidden) + cfg.hidden + 1


def pack_pi_params_2d(params: dict, cfg: PiCellConfig) -> torch.Tensor:
    """Flatten cell params to one f32 vector, the layout of percnn_tpu's.

    [Du, Dv] then per output channel: per branch (w_i [2, C] row-major,
    then b_i [C]), then w_out [C], b_out [1].  The diffusion
    reparametrisation (mu_up * sigmoid) is applied here, so the kernel sees
    plain coefficients.  164 floats for the GS2D cell.
    """
    parts = [effective_diffusion(params, cfg).reshape(-1)]
    for c in range(cfg.channels):
        br = params["pi"][c]
        for i in range(cfg.n_branches):
            parts.append(br[f"w{i}"].reshape(-1))
            parts.append(br[f"b{i}"].reshape(-1))
        parts.append(br["w_out"].reshape(-1))
        parts.append(br["b_out"].reshape(-1))
    return torch.cat([p.to(torch.float32) for p in parts])


def _check_fusable(cfg: PiCellConfig) -> None:
    if cfg.ndim != 2 or cfg.channels != 2:
        raise NotImplementedError("the fused 2D kernels take 2D cells with 2 "
                                  "state channels (u, v)")
    if cfg.kernel_size != 1:
        raise NotImplementedError(
            f"fused rollout with kernel_size {cfg.kernel_size} "
            "(percnn_tpu cell2d._rollout_kernel_mxu) is not ported yet")


def _plain_step(packed: torch.Tensor, h: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """One Euler step from the packed parameters, the kernels' arithmetic
    written with tensor ops.  h: [H, W, 2]."""
    C, nb = cfg.hidden, cfg.n_branches
    block = _param_block(cfg)
    inv_dx2 = 1.0 / (cfg.dx * cfg.dx)
    s1 = (torch.roll(h, -1, 0) + torch.roll(h, 1, 0)
          + torch.roll(h, -1, 1) + torch.roll(h, 1, 1))
    s2 = (torch.roll(h, -2, 0) + torch.roll(h, 2, 0)
          + torch.roll(h, -2, 1) + torch.roll(h, 2, 1))
    lap = (-5.0 * h + (4.0 / 3.0) * s1 - (1.0 / 12.0) * s2) * inv_dx2
    pis = []
    for o in range(2):
        p = packed[2 + o * block: 2 + (o + 1) * block]
        br = p[: nb * 3 * C].reshape(nb, 3, C)   # per branch: w[0], w[1], b
        y = h[..., 0, None, None] * br[:, 0] + h[..., 1, None, None] * br[:, 1] + br[:, 2]
        prod = y[..., 0, :]
        for i in range(1, nb):
            prod = prod * y[..., i, :]
        pis.append(prod @ p[nb * 3 * C: nb * 3 * C + C] + p[-1])
    pi = torch.stack(pis, dim=-1)
    return h + cfg.dt * (packed[:2] * lap + pi)


def fused_rollout_2d_plain(packed: torch.Tensor, h0: torch.Tensor,
                           cfg: PiCellConfig, n_steps: int) -> torch.Tensor:
    """Plain version of rollout2d_kernel: [H, W, 2] -> [n_steps+1, H, W, 2]."""
    frames = [h0]
    for _ in range(n_steps):
        frames.append(_plain_step(packed, frames[-1], cfg))
    return torch.stack(frames)


def fused_rollout_final_2d_plain(packed: torch.Tensor, h0: torch.Tensor,
                                 cfg: PiCellConfig, n_steps: int) -> torch.Tensor:
    """Plain version of final2d_kernel: [H, W, 2] -> [H, W, 2]."""
    h = h0
    for _ in range(n_steps):
        h = _plain_step(packed, h, cfg)
    return h


def _launch_args(packed: torch.Tensor, h0: torch.Tensor, cfg: PiCellConfig,
                 n_steps: int) -> tuple:
    """Check the kernel's inputs and return the shared ctypes arguments."""
    if h0.device.type != "cuda" or packed.device != h0.device:
        raise ValueError(f"the cell2d kernels take CUDA tensors on one device; "
                         f"got state on {h0.device}, params on {packed.device}")
    if h0.dtype != torch.float32 or packed.dtype != torch.float32:
        raise ValueError(f"the cell2d kernels take float32, got {h0.dtype}")
    if h0.dim() != 3 or h0.shape[-1] != 2:
        raise ValueError(f"state must be [H, W, 2], got {tuple(h0.shape)}")
    if not (h0.is_contiguous() and packed.is_contiguous()):
        raise ValueError("the cell2d kernels take contiguous tensors")
    n_params = packed.numel()
    if n_params != 2 + 2 * _param_block(cfg) or n_params > _MAX_PARAMS:
        raise ValueError(f"packed params have {n_params} floats, expected "
                         f"{2 + 2 * _param_block(cfg)} (at most {_MAX_PARAMS})")
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    H, W = h0.shape[0], h0.shape[1]
    return (packed.data_ptr(), n_params, h0.data_ptr(), n_steps, H, W,
            cfg.hidden, cfg.n_branches, cfg.dt, 1.0 / (cfg.dx * cfg.dx))


def _kernel_fn(fn_name: str):
    """A C entry point of the cell2d library, built on first use."""
    fn = getattr(_build.load_library("cell2d"), fn_name)
    fn.argtypes = _SIGNATURES[fn_name]
    fn.restype = ctypes.c_int
    return fn


def _raise_on_error(err: int, fn_name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {err}")


def _rollout_cuda(packed, h0, cfg, n_steps):
    fn = _kernel_fn("cell2d_rollout")
    p_ptr, n_params, h_ptr, n, H, W, C, nb, dt, inv_dx2 = _launch_args(
        packed, h0, cfg, n_steps)
    frames = torch.empty((n + 1, H, W, 2), dtype=torch.float32, device=h0.device)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(p_ptr, n_params, h_ptr, frames.data_ptr(), n, H, W,
                           C, nb, dt, inv_dx2, stream), "cell2d_rollout")
    fused_rollout_2d.launches += n
    return frames


def _final_cuda(packed, h0, cfg, n_steps):
    fn = _kernel_fn("cell2d_final")
    p_ptr, n_params, h_ptr, n, H, W, C, nb, dt, inv_dx2 = _launch_args(
        packed, h0, cfg, n_steps)
    out = torch.empty((H, W, 2), dtype=torch.float32, device=h0.device)
    scratch = torch.empty_like(out)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(p_ptr, n_params, h_ptr, out.data_ptr(),
                           scratch.data_ptr(), n, H, W, C, nb, dt, inv_dx2,
                           stream), "cell2d_final")
    fused_rollout_final_2d.launches += n
    return out


def fused_rollout_2d(params: dict, h0: torch.Tensor, cfg: PiCellConfig,
                     n_steps: int) -> torch.Tensor:
    """Full rollout: [H, W, 2] -> [n_steps+1, H, W, 2] f32 (frame 0 = h0).

    On CUDA, one rollout2d_kernel launch per step; on the CPU, the plain
    version.
    """
    _check_fusable(cfg)
    packed = pack_pi_params_2d(params, cfg)
    h0 = h0.to(torch.float32).contiguous()
    if h0.device.type == "cpu":
        return fused_rollout_2d_plain(packed, h0, cfg, n_steps)
    return _rollout_cuda(packed, h0, cfg, n_steps)


def fused_rollout_final_2d(params: dict, h0: torch.Tensor, cfg: PiCellConfig,
                           n_steps: int) -> torch.Tensor:
    """Final state only: [H, W, 2] -> [H, W, 2] f32 after n_steps.

    On CUDA, one final2d_kernel launch per step; on the CPU, the plain
    version.
    """
    _check_fusable(cfg)
    packed = pack_pi_params_2d(params, cfg)
    h0 = h0.to(torch.float32).contiguous()
    if h0.device.type == "cpu":
        return fused_rollout_final_2d_plain(packed, h0, cfg, n_steps)
    return _final_cuda(packed, h0, cfg, n_steps)


fused_rollout_2d.launches = 0
fused_rollout_final_2d.launches = 0
