"""Member-batched fused 2D rollout and backward (ensemble training): CUDA
kernels for Hopper and their plain versions.

Counterpart of percnn_tpu/ops/pallas/batched2d.py.  An ensemble's M members
are M independent 2D Pi cells, each with its own parameters and initial
state.  Their parameters are stacked, a leading member axis on every leaf,
and packed per member into one [M, P] table (``pack_pi_params_2d_batched``,
row m = ``pack_pi_params_2d`` of member m).  Three kernels advance all M
members at once, one launch a step (csrc/batched2d.cu):

- ``rollout2d_batched_kernel`` (in place of ``_rollout_kernel_b``): the
  forward, frames [M, T+1, H, W, 2], any odd kernel_size <= 5, each member's
  step the step of rollout2d_kernel (the tap-by-tap form at k > 1, whatever
  cell2d.MXU_FWD_ENABLED says, as percnn_tpu's batched kernels use
  ``_pi_poly``);
- ``adj2d_batched_kernel`` (in place of ``_phase1_kernel_b``): the streaming
  reverse sweep, g_ins [M, T, H, W, 2] and g0 [M, H, W, 2], each member's
  step that of adj2d_kernel (one launch a step at k = 1, the activation and
  gather pair at k > 1); the parameter gradients follow per member by
  ``core.rollout.chunked_param_grads``, as ``_fused_tp_b_bwd`` leaves them
  to XLA;
- ``pg2d_batched_kernel`` (in place of ``_phase1_pg_kernel_b``): the fully
  fused reverse sweep of a 1x1 cell, each member's step that of
  pg2d_kernel, the parameter gradients in [M, A, H, W] planes, summed and
  unpacked per member after the sweep (``_pg_unpack``).

``fused_rollout_tp_2d_batched`` (forward + streaming sweep) and
``fused_rollout_tp_2d_batched_pg`` (forward + fused sweep) are the
differentiable rollouts: stacked params and h0 [M, H, W, 2] in, frames
[M, n_steps+1, H, W, 2] f32 out.

A CPU tensor takes the plain versions, loops over members of the single
model's plain sweeps (``fused_rollout_2d_batched_plain``,
``fused_phase1_2d_batched_plain``, ``fused_phase1_pg_2d_batched_plain``); a
CUDA tensor launches the kernel or raises.  Launch counters, one a launch
(each launch covers all M members): ``fused_rollout_2d_batched.launches``
(k = 1) and ``.launches_kxk`` (k > 1), one a step;
``fused_phase1_2d_batched.launches`` (k = 1, one a reverse step) and
``.launches_kxk`` (k > 1, two a reverse step); and
``fused_phase1_pg_2d_batched.launches``, one a reverse step.
"""

from __future__ import annotations

import ctypes

import torch

from percnn_tpu_torch.bridge import _map_tree
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step
from percnn_tpu_torch.core.rollout import chunked_param_grads
from percnn_tpu_torch.ops.kernels import _build
from percnn_tpu_torch.ops.kernels.backward2d import (
    _MAX_BRANCHES,
    _cell_leaves,
    _cell_tree,
    _pg_layout,
    _pg_unpack,
    fused_phase1_2d_plain,
    fused_phase1_pg_2d_plain,
)
from percnn_tpu_torch.ops.kernels.cell2d import (
    _MAX_PARAMS,
    _check_fusable,
    _param_block,
    _raise_on_error,
    fused_rollout_2d_plain,
    pack_pi_params_2d,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # params, n_params, h0, frames, M, n_steps, H, W, hidden, n_branches,
    # kernel_size, dt, inv_dx2, stream
    "batched2d_rollout": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    # params, n_params, frames, frames_bar, g, scratch, g_ins, zw, M, n_steps,
    # H, W, hidden, n_branches, kernel_size, dt, inv_dx2, stream
    "batched2d_adj_sweep": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                            _P],
    # params, n_params, frames, frames_bar, g0, scratch, acc, M, n_steps, H,
    # W, hidden, n_branches, dt, inv_dx2, stream
    "batched2d_pg": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
}


def _member(tree, m: int):
    """Member m of a stacked tree (a view of each leaf)."""
    return _map_tree(lambda x: x[m], tree)


def pack_pi_params_2d_batched(params: dict, cfg: PiCellConfig) -> torch.Tensor:
    """Stacked cell params -> [M, P] f32, row m = pack_pi_params_2d of member m
    (percnn_tpu's ``vmap`` of ``pack_pi_params_2d``); differentiable."""
    n_members = params["diff"].shape[0]
    return torch.stack([pack_pi_params_2d(_member(params, m), cfg) for m in range(n_members)])


def fused_rollout_2d_batched_plain(packed: torch.Tensor, h0: torch.Tensor,
                                   cfg: PiCellConfig, n_steps: int) -> torch.Tensor:
    """Plain version of rollout2d_batched_kernel: [M, P], [M, H, W, 2] ->
    [M, n_steps+1, H, W, 2], the single model's plain rollout per member."""
    return torch.stack([fused_rollout_2d_plain(packed[m], h0[m], cfg, n_steps)
                        for m in range(packed.shape[0])])


def fused_phase1_2d_batched_plain(packed: torch.Tensor, frames: torch.Tensor,
                                  frames_bar: torch.Tensor, cfg: PiCellConfig):
    """Plain version of adj2d_batched_kernel: (g_ins [M, T, H, W, 2], g0
    [M, H, W, 2] without frames_bar[:, 0]), fused_phase1_2d_plain per member."""
    outs = [fused_phase1_2d_plain(packed[m], frames[m], frames_bar[m], cfg)
            for m in range(packed.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def fused_phase1_pg_2d_batched_plain(packed: torch.Tensor, frames: torch.Tensor,
                                     frames_bar: torch.Tensor, cfg: PiCellConfig):
    """Plain version of pg2d_batched_kernel: (g0 [M, H, W, 2] without
    frames_bar[:, 0], acc [M, A, H, W]), fused_phase1_pg_2d_plain per member."""
    outs = [fused_phase1_pg_2d_plain(packed[m], frames[m], frames_bar[m], cfg)
            for m in range(packed.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _kernel_fn(fn_name: str):
    """A C entry point of csrc/batched2d.cu, built on first use."""
    fn = getattr(_build.load_library("batched2d"), fn_name)
    fn.argtypes = _SIGNATURES[fn_name]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(name: str, packed: torch.Tensor, state: torch.Tensor, cfg: PiCellConfig,
                  *tensors: torch.Tensor, any_branches: bool = False) -> None:
    """Check a batched kernel's inputs: CUDA tensors on one device, contiguous
    f32, packed [M, P] and state [M, ..., H, W, 2] of the same M, and 1 to
    4 branches unless any_branches (the 1x1 forward takes any)."""
    dev = state.device
    if dev.type != "cuda" or any(t.device != dev for t in (packed,) + tensors):
        raise ValueError(f"{name} takes CUDA tensors on one device; got "
                         f"{[str(t.device) for t in (packed, state) + tensors]}")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in (packed, state) + tensors):
        raise ValueError(f"{name} takes contiguous float32 tensors")
    n_params = 2 + 2 * _param_block(cfg)
    if packed.dim() != 2 or packed.shape[1] != n_params or n_params > _MAX_PARAMS:
        raise ValueError(f"packed params must be [M, {n_params}] (at most {_MAX_PARAMS} "
                         f"floats a member), got {tuple(packed.shape)}")
    if state.dim() < 4 or state.shape[0] != packed.shape[0] or state.shape[-1] != 2:
        raise ValueError(f"state must be [{packed.shape[0]}, ..., H, W, 2], got "
                         f"{tuple(state.shape)}")
    if not (any_branches or 1 <= cfg.n_branches <= _MAX_BRANCHES):
        raise ValueError(f"{name} takes 1 to {_MAX_BRANCHES} branches, got {cfg.n_branches}")


def _rollout_b_cuda(packed, h0, cfg, n_steps):
    """rollout2d_batched_kernel: one launch a step for all members, the loop in C."""
    fn = _kernel_fn("batched2d_rollout")
    _check_inputs("rollout2d_batched_kernel", packed, h0, cfg,
                  any_branches=cfg.kernel_size == 1)
    if h0.dim() != 4 or n_steps < 0:
        raise ValueError(f"h0 must be [M, H, W, 2] and n_steps >= 0, got "
                         f"{tuple(h0.shape)} and {n_steps}")
    M, H, W = h0.shape[0], h0.shape[1], h0.shape[2]
    frames = torch.empty((M, n_steps + 1, H, W, 2), dtype=torch.float32, device=h0.device)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.shape[1], h0.data_ptr(), frames.data_ptr(),
                           M, n_steps, H, W, cfg.hidden, cfg.n_branches, cfg.kernel_size,
                           cfg.dt, 1.0 / (cfg.dx * cfg.dx), stream), "batched2d_rollout")
    if cfg.kernel_size == 1:
        fused_rollout_2d_batched.launches += n_steps
    else:
        fused_rollout_2d_batched.launches_kxk += n_steps
    return frames


def _sweep_shapes(name, packed, frames, frames_bar, cfg):
    """Check a sweep's inputs; return frames_bar as contiguous f32 (the
    cotangent of the members' slices arrives strided or expanded) and
    (M, T, H, W)."""
    frames_bar = frames_bar.to(torch.float32).contiguous()
    _check_inputs(name, packed, frames, cfg, frames_bar)
    if frames.dim() != 5 or frames_bar.shape != frames.shape:
        raise ValueError(f"frames and frames_bar must be [M, T+1, H, W, 2], got "
                         f"{tuple(frames.shape)} and {tuple(frames_bar.shape)}")
    M, n_steps, H, W = frames.shape[0], frames.shape[1] - 1, frames.shape[2], frames.shape[3]
    return frames_bar, (M, n_steps, H, W)


def _phase1_b_cuda(packed, frames, frames_bar, cfg):
    """adj2d_batched_kernel: one launch a reverse step for all members at
    k = 1, two at k > 1, the loop in C."""
    fn = _kernel_fn("batched2d_adj_sweep")
    frames_bar, (M, n_steps, H, W) = _sweep_shapes("adj2d_batched_kernel", packed, frames,
                                                   frames_bar, cfg)
    k, dev = cfg.kernel_size, frames.device
    g = torch.zeros((M, H, W, 2), dtype=torch.float32, device=dev)
    scratch = torch.zeros_like(g) if k == 1 else None
    zw = torch.empty((M, k * k * 2, H, W), dtype=torch.float32, device=dev) if k > 1 else None
    g_ins = torch.empty((M, n_steps, H, W, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.shape[1], frames.data_ptr(),
                           frames_bar.data_ptr(), g.data_ptr(),
                           None if scratch is None else scratch.data_ptr(), g_ins.data_ptr(),
                           None if zw is None else zw.data_ptr(), M, n_steps, H, W,
                           cfg.hidden, cfg.n_branches, k, cfg.dt, 1.0 / (cfg.dx * cfg.dx),
                           stream), "batched2d_adj_sweep")
    if k == 1:
        fused_phase1_2d_batched.launches += n_steps
    else:
        fused_phase1_2d_batched.launches_kxk += 2 * n_steps
    return g_ins, g


def _pg_b_cuda(packed, frames, frames_bar, cfg):
    """pg2d_batched_kernel: one launch a reverse step for all members, the loop in C."""
    fn = _kernel_fn("batched2d_pg")
    frames_bar, (M, n_steps, H, W) = _sweep_shapes("pg2d_batched_kernel", packed, frames,
                                                   frames_bar, cfg)
    dev = frames.device
    g0 = torch.zeros((M, H, W, 2), dtype=torch.float32, device=dev)
    scratch = torch.zeros_like(g0)
    acc = torch.zeros((M, _pg_layout(cfg)["A"], H, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.shape[1], frames.data_ptr(),
                           frames_bar.data_ptr(), g0.data_ptr(), scratch.data_ptr(),
                           acc.data_ptr(), M, n_steps, H, W, cfg.hidden, cfg.n_branches,
                           cfg.dt, 1.0 / (cfg.dx * cfg.dx), stream), "batched2d_pg")
    fused_phase1_pg_2d_batched.launches += n_steps
    return g0, acc


def fused_rollout_2d_batched(packed: torch.Tensor, h0: torch.Tensor, cfg: PiCellConfig,
                             n_steps: int) -> torch.Tensor:
    """Frames [M, n_steps+1, H, W, 2] of every member from packed [M, P] and
    h0 [M, H, W, 2]: rollout2d_batched_kernel on CUDA, the plain version on
    the CPU."""
    if h0.device.type == "cpu":
        return fused_rollout_2d_batched_plain(packed, h0, cfg, n_steps)
    return _rollout_b_cuda(packed, h0, cfg, n_steps)


def fused_phase1_2d_batched(packed, frames, frames_bar, cfg):
    """(g_ins, g0): adj2d_batched_kernel on CUDA, the plain version on the CPU."""
    if frames.device.type == "cpu":
        return fused_phase1_2d_batched_plain(packed, frames, frames_bar.to(torch.float32), cfg)
    return _phase1_b_cuda(packed, frames, frames_bar, cfg)


def fused_phase1_pg_2d_batched(packed, frames, frames_bar, cfg):
    """(g0, acc): pg2d_batched_kernel on CUDA, the plain version on the CPU."""
    if frames.device.type == "cpu":
        return fused_phase1_pg_2d_batched_plain(packed, frames, frames_bar.to(torch.float32),
                                                cfg)
    return _pg_b_cuda(packed, frames, frames_bar, cfg)


class FusedRolloutTP2dBatched(torch.autograd.Function):
    """frames = every member's rollout by rollout2d_batched_kernel; backward
    by adj2d_batched_kernel, then each member's parameter gradients by
    chunked_param_grads (percnn_tpu's ``_fused_tp_b_bwd``)."""

    @staticmethod
    def forward(ctx, h0, cfg, n_steps, pgrad_chunk, like, *leaves):
        packed = pack_pi_params_2d_batched(_cell_tree(like, leaves), cfg)
        frames = fused_rollout_2d_batched(packed, h0, cfg, n_steps)
        ctx.cfg, ctx.pgrad_chunk, ctx.like = cfg, pgrad_chunk, like
        ctx.save_for_backward(packed, frames, *leaves)
        return frames

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, frames_bar):
        packed, frames, *leaves = ctx.saved_tensors
        cfg, params = ctx.cfg, _cell_tree(ctx.like, leaves)
        n_steps = frames.shape[1] - 1
        g_ins, g0 = fused_phase1_2d_batched(packed, frames, frames_bar, cfg)
        bars = [_cell_leaves(chunked_param_grads(lambda p, h: pi_cell_step(p, h, cfg),
                                                 _member(params, m), frames[m, :-1], g_ins[m],
                                                 n_steps, ctx.pgrad_chunk))
                for m in range(frames.shape[0])]
        return (g0 + frames_bar[:, 0], None, None, None, None,
                *[torch.stack(leaf) for leaf in zip(*bars)])


class FusedRolloutTP2dBatchedPG(torch.autograd.Function):
    """frames = every member's rollout from packed [M, P]; backward by
    pg2d_batched_kernel, each member's plane sums unpacked (percnn_tpu's
    ``_fused_tp_b_pg_bwd``)."""

    @staticmethod
    def forward(ctx, packed, h0, cfg, n_steps):
        frames = fused_rollout_2d_batched(packed, h0, cfg, n_steps)
        ctx.cfg = cfg
        ctx.save_for_backward(packed, frames)
        return frames

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, frames_bar):
        packed, frames = ctx.saved_tensors
        g0, acc = fused_phase1_pg_2d_batched(packed, frames, frames_bar, ctx.cfg)
        sums = acc.sum((2, 3))
        d_packed = torch.stack([_pg_unpack(sums[m], packed[m], ctx.cfg)
                                for m in range(packed.shape[0])])
        return d_packed, g0 + frames_bar[:, 0], None, None


def fused_rollout_tp_2d_batched(params: dict, h0: torch.Tensor, cfg: PiCellConfig,
                                n_steps: int, pgrad_chunk: int = 64) -> torch.Tensor:
    """Differentiable member-batched rollout of a 2D cell, any odd
    kernel_size <= 5: stacked params (a leading member axis M on every leaf)
    and h0 [M, H, W, 2] -> [M, n_steps+1, H, W, 2] f32.  The forward and
    the streaming sweep in one launch a step (two for a k x k sweep) for all
    members on CUDA, their plain versions on the CPU; pgrad_chunk is
    chunked_param_grads' steps a batch.  Gradients reach every leaf and h0."""
    _check_fusable(cfg)
    return FusedRolloutTP2dBatched.apply(h0.to(torch.float32).contiguous(), cfg, n_steps,
                                         pgrad_chunk, params, *_cell_leaves(params))


def fused_rollout_tp_2d_batched_pg(params: dict, h0: torch.Tensor, cfg: PiCellConfig,
                                   n_steps: int) -> torch.Tensor:
    """Differentiable member-batched rollout of a 1x1 2D cell: as
    fused_rollout_tp_2d_batched, with the fully fused sweep
    (pg2d_batched_kernel) and no phase-2 pass."""
    if cfg.ndim != 2 or cfg.kernel_size != 1:
        raise NotImplementedError(
            "batched pg path requires ndim=2, kernel_size=1 "
            f"(got ndim={cfg.ndim}, kernel_size={cfg.kernel_size})")
    _check_fusable(cfg)
    packed = pack_pi_params_2d_batched(params, cfg)
    return FusedRolloutTP2dBatchedPG.apply(packed, h0.to(torch.float32).contiguous(), cfg,
                                           n_steps)


fused_rollout_2d_batched.launches = 0
fused_rollout_2d_batched.launches_kxk = 0
fused_phase1_2d_batched.launches = 0
fused_phase1_2d_batched.launches_kxk = 0
fused_phase1_pg_2d_batched.launches = 0
