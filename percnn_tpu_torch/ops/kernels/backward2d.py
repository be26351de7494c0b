"""Fully fused backward of the 1x1 Pi-cell rollout: a CUDA kernel for Hopper
and its plain version.

Counterpart of the fused-pg half of percnn_tpu/ops/pallas/backward2d.py.
``fused_rollout_tp_2d_pg`` is a differentiable rollout whose forward is
``rollout2d_kernel`` (ops/kernels/cell2d.py) and whose backward is
``pg2d_kernel`` (csrc/backward2d.cu, in place of ``_phase1_pg_kernel``): one
reverse sweep that carries the adjoint g_t from frame T down to frame 0 and,
in the same pass, accumulates every parameter gradient into [A, H, W]
planes, one plane per scalar parameter.  For t = T-1 .. 0 and every cell:

    g_in  = g_{t+1} + fbar_{t+1}
    diff planes += g_in * Lap(h_t);   b_out planes += g_in
    per equation o, hidden channel c, branch i, with y_i = w_i[:, c] . h_t + b_i[c]:
        w_out plane += g * prod_j y_j
        zz = g * prod_{j != i} y_j:   dw planes += zz * (u, v);  db plane += zz
    g_t = g_in + dt * (D * Lap(g_in) + sum w_i * w_out * zz)

The planes are summed over the grid once, after the sweep; dt, the w_out
factor and the layout of the packed parameter vector are applied then
(``_pg_unpack``).  The Function's differentiable input is the packed vector
(``pack_pi_params_2d``, which applies mu_up * sigmoid), so autograd carries
the gradient on through the reparametrisation to the parameter tree.

A CPU tensor takes the plain version (``fused_phase1_pg_2d_plain``); a CUDA
tensor launches the kernel or raises.  ``fused_rollout_tp_2d_pg.launches``
counts the reverse steps launched.
"""

from __future__ import annotations

import ctypes

import torch

from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.ops.kernels import _build
from percnn_tpu_torch.ops.kernels.cell2d import (
    _MAX_PARAMS,
    _check_fusable,
    _param_block,
    _raise_on_error,
    _rollout_cuda,
    fused_rollout_2d_plain,
    pack_pi_params_2d,
)
from percnn_tpu_torch.ops.stencils import laplacian_2d

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# params, n_params, frames, frames_bar, g0, scratch, acc, n_steps, H, W,
# hidden, n_branches, dt, inv_dx2, stream
_SIGNATURE = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P]
# The kernel is compiled for 1 to 4 branches (csrc/backward2d.cu).
_MAX_BRANCHES = 4


def _pg_layout(cfg: PiCellConfig) -> dict:
    """Accumulator-plane offsets of the fused parameter gradients: dw
    (o, i, c, cin), db (o, i, c), w_out (o, c), b_out (o), diff (o).
    A = 164 for the GS2D cell (C = 8, 3 branches)."""
    C, nb = cfg.hidden, cfg.n_branches
    dw = 2 * nb * C * 2
    db = 2 * nb * C
    wout = 2 * C
    return {"dw": 0, "db": dw, "wout": dw + db, "bout": dw + db + wout,
            "diff": dw + db + wout + 2, "A": dw + db + wout + 2 + 2}


def _pg_sweep_plain(packed: torch.Tensor, frames: torch.Tensor,
                    frames_bar: torch.Tensor, cfg: PiCellConfig, lap) -> tuple:
    """The fused reverse sweep written with tensor ops, for any spatial rank.

    packed [P] (pack_pi_params_2d); frames [T+1, *spatial, 2], the forward's
    output; frames_bar [T+1, *spatial, 2], their cotangent; lap(x) the
    Laplacian of a [*spatial, 2] field.  Returns (g0 [*spatial, 2], the
    adjoint at frame 0 without frames_bar[0]; acc [A, *spatial]).
    """
    C, nb = cfg.hidden, cfg.n_branches
    block = _param_block(cfg)
    n_steps = frames.shape[0] - 1
    spatial = tuple(frames.shape[1:-1])
    acc = torch.zeros(spatial + (_pg_layout(cfg)["A"],), dtype=torch.float32,
                      device=frames.device)
    g = torch.zeros(spatial + (2,), dtype=torch.float32, device=frames.device)
    for t in range(n_steps - 1, -1, -1):
        h = frames[t]
        g_in = g + frames_bar[t + 1]
        dw, db, wout_planes, jac = [], [], [], 0.0
        for o in range(2):
            p = packed[2 + o * block: 2 + (o + 1) * block]
            br = p[: nb * 3 * C].reshape(nb, 3, C)      # per branch: w[0], w[1], b
            w_out = p[nb * 3 * C: nb * 3 * C + C]
            y = h[..., 0, None, None] * br[:, 0] + h[..., 1, None, None] * br[:, 1] + br[:, 2]
            go = g_in[..., o, None, None]                # [*spatial, 1, 1]
            others = []                                   # prod_{j != i} y_j
            for i in range(nb):
                pexc = torch.ones_like(y[..., 0, :])
                for j in range(nb):
                    if j != i:
                        pexc = pexc * y[..., j, :]
                others.append(pexc)
            zz = go * torch.stack(others, dim=-2)         # [*spatial, nb, C]
            dw.append(torch.stack([zz * h[..., 0, None, None], zz * h[..., 1, None, None]],
                                  dim=-1).reshape(spatial + (nb * C * 2,)))
            db.append(zz.reshape(spatial + (nb * C,)))
            wout_planes.append(go[..., 0] * torch.prod(y, dim=-2))
            # Pi Jacobian transpose: d/du and d/dv of both equations
            jac = jac + torch.stack([(zz * br[:, 0] * w_out).sum((-2, -1)),
                                     (zz * br[:, 1] * w_out).sum((-2, -1))], dim=-1)
        acc += torch.cat(dw + db + wout_planes + [g_in, g_in * lap(h)], dim=-1)
        g = g_in + cfg.dt * (packed[:2] * lap(g_in) + jac)
    return g, acc.movedim(-1, 0)


def fused_phase1_pg_2d_plain(packed: torch.Tensor, frames: torch.Tensor,
                             frames_bar: torch.Tensor, cfg: PiCellConfig):
    """Plain version of pg2d_kernel: the reverse sweep written with tensor ops.

    packed [P] (pack_pi_params_2d); frames [T+1, H, W, 2], the forward's
    output; frames_bar [T+1, H, W, 2], their cotangent.  Returns (g0
    [H, W, 2], the adjoint at frame 0 without frames_bar[0]; acc [A, H, W]).
    """
    return _pg_sweep_plain(packed, frames, frames_bar, cfg,
                           lambda x: laplacian_2d(x, cfg.dx))


def _pg_unpack(acc_sums: torch.Tensor, packed: torch.Tensor,
               cfg: PiCellConfig) -> torch.Tensor:
    """[A] plane sums -> gradient of the packed parameter vector.

    Applies dt and the w_out factor of the branch gradients, and scatters
    into the layout of pack_pi_params_2d.  The diffusion entries are the
    gradient of the effective coefficients; autograd applies the
    reparametrisation through pack_pi_params_2d.
    """
    C, nb = cfg.hidden, cfg.n_branches
    lay = _pg_layout(cfg)
    block = _param_block(cfg)
    parts = [acc_sums[lay["diff"]: lay["diff"] + 2]]
    for o in range(2):
        base = 2 + o * block
        w_out = packed[base + nb * 3 * C: base + nb * 3 * C + C]
        for i in range(nb):
            k = o * nb + i
            dw = acc_sums[lay["dw"] + k * C * 2: lay["dw"] + (k + 1) * C * 2]
            parts.append((dw.reshape(C, 2).T * w_out).reshape(-1))   # w_i [2, C]
            parts.append(acc_sums[lay["db"] + k * C: lay["db"] + (k + 1) * C] * w_out)
        parts.append(acc_sums[lay["wout"] + o * C: lay["wout"] + (o + 1) * C])
        parts.append(acc_sums[lay["bout"] + o: lay["bout"] + o + 1])
    return cfg.dt * torch.cat(parts)


def _kernel_fn():
    fn = _build.load_library("backward2d").backward2d_pg
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    return fn


def _check_pg_inputs(packed: torch.Tensor, frames: torch.Tensor,
                     frames_bar: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """Check pg2d_kernel's inputs; return frames_bar as contiguous f32."""
    if frames.device.type != "cuda" or packed.device != frames.device \
            or frames_bar.device != frames.device:
        raise ValueError("pg2d_kernel takes CUDA tensors on one device; got "
                         f"{packed.device}, {frames.device}, {frames_bar.device}")
    if frames.dtype != torch.float32 or packed.dtype != torch.float32:
        raise ValueError(f"pg2d_kernel takes float32, got {frames.dtype}, {packed.dtype}")
    if frames.dim() != 4 or frames.shape[-1] != 2 or frames_bar.shape != frames.shape:
        raise ValueError(f"frames and frames_bar must be [T+1, H, W, 2], got "
                         f"{tuple(frames.shape)} and {tuple(frames_bar.shape)}")
    if not (frames.is_contiguous() and packed.is_contiguous()):
        raise ValueError("pg2d_kernel takes contiguous tensors")
    n_params = packed.numel()
    if n_params != 2 + 2 * _param_block(cfg) or n_params > _MAX_PARAMS:
        raise ValueError(f"packed params have {n_params} floats, expected "
                         f"{2 + 2 * _param_block(cfg)} (at most {_MAX_PARAMS})")
    if not 1 <= cfg.n_branches <= _MAX_BRANCHES:
        raise ValueError(f"pg2d_kernel takes 1 to {_MAX_BRANCHES} branches, "
                         f"got {cfg.n_branches}")
    # the cotangent of a strided slice arrives sparse, expanded or strided
    return frames_bar.to(torch.float32).contiguous()


def _pg_cuda(packed: torch.Tensor, frames: torch.Tensor, frames_bar: torch.Tensor,
             cfg: PiCellConfig):
    """pg2d_kernel: one launch per reverse step, the loop in C."""
    fn = _kernel_fn()
    frames_bar = _check_pg_inputs(packed, frames, frames_bar, cfg)
    n_params = packed.numel()
    n_steps, H, W = frames.shape[0] - 1, frames.shape[1], frames.shape[2]
    g0 = torch.zeros((H, W, 2), dtype=torch.float32, device=frames.device)
    scratch = torch.zeros_like(g0)
    acc = torch.zeros((_pg_layout(cfg)["A"], H, W), dtype=torch.float32,
                      device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), n_params, frames.data_ptr(),
                           frames_bar.data_ptr(), g0.data_ptr(), scratch.data_ptr(),
                           acc.data_ptr(), n_steps, H, W, cfg.hidden, cfg.n_branches,
                           cfg.dt, 1.0 / (cfg.dx * cfg.dx), stream), "backward2d_pg")
    fused_rollout_tp_2d_pg.launches += n_steps
    return g0, acc


def fused_phase1_pg_2d(packed: torch.Tensor, frames: torch.Tensor,
                       frames_bar: torch.Tensor, cfg: PiCellConfig):
    """(g0 [H, W, 2], acc [A, H, W]): pg2d_kernel on CUDA, the plain version
    on the CPU."""
    if frames.device.type == "cpu":
        return fused_phase1_pg_2d_plain(packed, frames, frames_bar.to(torch.float32), cfg)
    return _pg_cuda(packed, frames, frames_bar, cfg)


class FusedRolloutTP2dPG(torch.autograd.Function):
    """frames = rollout(packed, h0); backward by the fused reverse sweep."""

    @staticmethod
    def forward(ctx, packed, h0, cfg, n_steps):
        if h0.device.type == "cpu":
            frames = fused_rollout_2d_plain(packed, h0, cfg, n_steps)
        else:
            frames = _rollout_cuda(packed, h0, cfg, n_steps)
        ctx.cfg = cfg
        ctx.save_for_backward(packed, frames)
        return frames

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, frames_bar):
        packed, frames = ctx.saved_tensors
        g0, acc = fused_phase1_pg_2d(packed, frames, frames_bar, ctx.cfg)
        d_packed = _pg_unpack(acc.sum((1, 2)), packed, ctx.cfg)
        return d_packed, g0 + frames_bar[0], None, None


def fused_rollout_tp_2d_pg(params: dict, h0: torch.Tensor, cfg: PiCellConfig,
                           n_steps: int) -> torch.Tensor:
    """Differentiable rollout of a 1x1 Pi cell: [H, W, 2] -> [n_steps+1, H, W, 2]
    f32.  Forward by rollout2d_kernel, backward by pg2d_kernel on CUDA; the
    plain versions of both on the CPU."""
    if cfg.ndim != 2 or cfg.kernel_size != 1:
        raise NotImplementedError(
            "fused_rollout_tp_2d_pg requires ndim=2, kernel_size=1 "
            f"(got ndim={cfg.ndim}, kernel_size={cfg.kernel_size})")
    _check_fusable(cfg)
    packed = pack_pi_params_2d(params, cfg)
    return FusedRolloutTP2dPG.apply(packed, h0.to(torch.float32).contiguous(), cfg, n_steps)


fused_rollout_tp_2d_pg.launches = 0
