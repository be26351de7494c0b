"""Backward of the fused 2D Pi-cell rollout: CUDA kernels for Hopper and
their plain versions.

Counterpart of percnn_tpu/ops/pallas/backward2d.py, in two parts.

**The streaming adjoints.** ``fused_rollout_tp_2d`` is a differentiable
rollout of any odd kernel_size <= 5, percnn_tpu's ``fused_rollout_tp_2d``.
Its forward is cell2d.kxk_plan's k x k kernel for a k x k cell with
cell2d.MXU_FWD_ENABLED, else cell2d._rollout_cuda's route
(``rollout2d_ffma_persistent_kernel`` by cell2d.ffma_plan for a k x k cell,
or ``rollout2d_kernel``; ops/kernels/cell2d.py).
Its backward is a reverse sweep that streams the adjoint out, then the
parameter gradients outside any kernel, as the JAX package leaves them to
XLA.  For t = T-1 .. 0 the sweep computes

    g_in  = g_{t+1} + fbar_{t+1}                       (g_T = 0)
    y     = the branch activations at h_t, [M] a cell
    z[m]  = w_out_o[c] g_in_o prod_{j != i} y[(o nb + j) C + c],  m = (o nb + i) C + c
    zw    = the branch weights' taps contracted with z
    jt    = sum_{tap} zw[tap] shifted by the reversed tap offset
    g_t   = g_in + dt (D Lap(g_in) + jt)

and returns g_ins [T, H, W, 2] and g_0.  ``backward_route`` picks the sweep
as percnn_tpu's ``_fused_tp_bwd`` does:

- 'mxu', a k x k cell with MXU_BWD_ENABLED: the branch-matrix sweep (in
  place of ``_phase1_mxu_kernel``, csrc/backward2d_kxk.cu), y as a product
  with the branch matrix, streamed out as ys [T, M, H, W]:
  ``adj2d_kxk_persistent_kernel``, the whole sweep in one cooperative
  launch with both products on the tensor cores in 3xTF32, for any field
  and cell ``kxk_adj_plan`` admits, else ``adj2d_kxk_kernel``, two
  launches a step in FFMA; then ``_param_grads_stream``, time-batched
  contractions of the cotangents;
- 'ys', a k x k cell otherwise: ``_precompute_ys`` (time-batched convs),
  then the sweep that reads y from it (csrc/adj2d.cu, in place of
  ``_phase1_ys_kernel``): ``adj2d_ys_persistent_kernel``, the whole sweep
  in one cooperative launch in FFMA, for any field and cell ``ys_plan``
  admits, else ``adj2d_ys_kernel``, two launches a step; then
  ``_param_grads_stream``;
- 'adjoint', a 1x1 cell, or with YS_PATH_ENABLED off or over its 8 GiB:
  the sweep that recomputes y from the frames (csrc/adj2d.cu, in place of
  ``_phase1_kernel``), then ``core.rollout.chunked_param_grads``.  At k = 1
  it is ``adj2d_persistent_kernel`` for any field and cell ``adj_plan``
  admits: the whole sweep in one cooperative launch, one block an SM, one
  grid barrier a step, ``pg2d_persistent_kernel``'s three passes without
  its accumulators (the same code, adj2d_step.cuh, so its g0 is the fused
  sweep's to the bit), g_in streamed to g_ins; on an NVIDIA H100 80GB HBM3
  at 700 W, 2.427 ms per T = 800 at 100 x 100 (3.03 us a step) against
  4.647 for ``adj2d_kernel``, one launch a step, which runs past the plan
  (448 x 448 at most for the GS2D cell).  At k = 3, 5 it is
  the ensemble's ``adj2d_batched_ffma_persistent_kernel``
  (csrc/batched2d.cu) on a one-member batch, for any field and cell
  ``adj_b_plan`` admits at M = 1: the whole sweep in one cooperative
  launch, one block an SM, full f32 FFMA, the activations formed from frame
  t in the block, no ys stream, one grid barrier a step; past the plan
  (768 x 768 at most for the Burgers cell) ``adj2d_act_kernel`` +
  ``adj2d_gather_kernel``, two launches a step.

**1x1 cells** (GS2D), the fused-pg half.
``fused_rollout_tp_2d_pg`` is a differentiable rollout whose forward is
cell2d's frames rollout (``rollout2d_cluster_kernel``, or
``rollout2d_kernel`` past its capacity: ``cell2d.rollout_plan``) and whose
backward is ``pg2d_persistent_kernel`` (csrc/backward2d.cu, in place of
``_phase1_pg_kernel``; ``pg2d_kernel``, one launch a step, past its
capacity: ``pg_plan``): one reverse sweep that carries the adjoint g_t from
frame T down to frame 0 and, in the same pass, accumulates every parameter
gradient into [A, H, W] planes, one plane per scalar parameter.  For
t = T-1 .. 0 and every cell:

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

A CPU tensor takes the plain versions (``fused_phase1_kxk_2d_plain``,
``fused_phase1_2d_plain``, ``fused_phase1_ys_2d_plain``,
``fused_phase1_pg_2d_plain``); a CUDA tensor launches the kernel or
raises.  Launch counters: ``fused_rollout_tp_2d_pg.launches`` (one a sweep
by pg2d_persistent_kernel, one a reverse step by pg2d_kernel) beside
``fused_rollout_tp_2d_pg.steps`` (the reverse steps run on the card),
``fused_rollout_tp_2d.launches`` (the k x k sweep: one a sweep by
adj2d_kxk_persistent_kernel, two a reverse step by adj2d_kxk_kernel) beside
``fused_rollout_tp_2d.steps`` (its reverse steps run on the card),
``fused_phase1_2d.launches`` (one a sweep by adj2d_persistent_kernel or
adj2d_batched_ffma_persistent_kernel, none for no steps; one a reverse step by
adj2d_kernel at k = 1, two at k > 1) beside
``fused_phase1_2d.steps``, ``fused_phase1_ys_2d.launches``
(one a sweep by adj2d_ys_persistent_kernel, two a reverse step by
adj2d_ys_kernel) beside ``fused_phase1_ys_2d.steps``.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from percnn_tpu_torch._device import full_f32
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step
from percnn_tpu_torch.core.rollout import chunked_param_grads
from percnn_tpu_torch.ops.convs import conv_nd_periodic
from percnn_tpu_torch.ops.kernels import _build, cell2d
from percnn_tpu_torch.ops.kernels.cell2d import (
    _KXK_SIZES,
    _MAX_PARAMS,
    _MAX_SMEM,
    _FFMA_TAIL,
    _FFMA_TILE,
    _FFMA_TILES,
    _check_fusable,
    _check_kxk_inputs,
    _ffma_adj_taps,
    _ffma_fwd_floats,
    _ffma_widths_ok,
    _kxk_smem_bytes,
    _mma_shape,
    _mma_widths_ok,
    _packed_equation,
    _param_block,
    _raise_on_error,
    _rollout_cuda,
    _rollout_kxk_cuda,
    _round_up,
    _sm_count,
    fused_rollout_2d_plain,
    ffma_grid,
    ffma_occupancy,
    fused_rollout_kxk_2d_plain,
    im2col_2d,
    kxk_grid,
    kxk_occupancy,
    mxu_rows,
    pack_ffma_adj_2d,
    pack_ffma_fwd_2d,
    pack_ffma_tail_2d,
    pack_mma_adj_2d,
    pack_mma_fwd_2d,
    pack_pi_matrix_2d,
    pack_pi_params_2d,
    pi_tail_2d,
)
from percnn_tpu_torch.ops.stencils import laplacian_2d

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# params, n_params, frames, frames_bar, g0, scratch, acc, n_steps, H, W,
# hidden, n_branches, dt, inv_dx2, stream
_SIGNATURE = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P]
# the same, then blocks, stream, blocks an SM (out)
_PERSISTENT_SIGNATURE = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P,
                         ctypes.POINTER(_I)]
# n_params, H, W, hidden, n_branches, blocks, blocks an SM (out)
_OCCUPANCY_SIGNATURE = [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]
# wmat, tail, frames, frames_bar, g, g_ins, ys, zw, n_steps, H, W, hidden,
# n_branches, kernel_size, dt, inv_dx2, stream
_KXK_SIGNATURE = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]
# bfwd, badj, tail, frames, frames_bar, g, g_ins, ys, zw, n_steps, H, W,
# hidden, n_branches, kernel_size, ch, dt, inv_dx2, blocks, threads, smem,
# stream, blocks an SM (out)
_KXK_PERSISTENT_SIGNATURE = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _F, _F, _I, _I, _I, _P, ctypes.POINTER(_I)]
# params, n_params, frames, frames_bar, g, scratch, g_ins, zw, n_steps, H, W,
# hidden, n_branches, kernel_size, dt, inv_dx2, stream
_ADJ_SIGNATURE = [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]
# params, n_params, frames, frames_bar, g0, scratch, g_ins, n_steps, H, W,
# hidden, n_branches, dt, inv_dx2, blocks, stream, blocks an SM (out)
_ADJ_PERSISTENT_SIGNATURE = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P,
                             ctypes.POINTER(_I)]
# batched2d_adj_ffma_persistent (csrc/batched2d.cu): wf, wa, tail, frames,
# frames_bar, g, g_ins, zw, M, n_steps, H, W, hidden, n_branches,
# kernel_size, dt, inv_dx2, per_member, threads, smem, stream, blocks an SM
# (out)
_ADJ_B_FFMA_SIGNATURE = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                         _I, _I, _I, _P, ctypes.POINTER(_I)]
# params, n_params, frames_bar, ys, g, g_ins, zw, n_steps, H, W, hidden,
# n_branches, kernel_size, dt, inv_dx2, stream
_YS_SIGNATURE = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]
# wa, tail, frames_bar, ys, g, g_ins, zw, n_steps, H, W, hidden, n_branches,
# kernel_size, dt, inv_dx2, blocks, threads, smem, stream, blocks an SM (out)
_YS_PERSISTENT_SIGNATURE = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                            _I, _P, ctypes.POINTER(_I)]
# The kernels are compiled for 1 to 4 branches (csrc/backward2d.cu, csrc/adj2d.cu).
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


def _kernel_fn(name: str = "backward2d_pg", signature: list = _SIGNATURE):
    fn = getattr(_build.load_library("backward2d"), name)
    fn.argtypes = signature
    fn.restype = ctypes.c_int
    return fn


def adj_smem_bytes(cfg: PiCellConfig, H: int, W: int, blocks: int, n_planes: int = 0) -> int:
    """Shared memory of a block of the 1x1 one-launch sweeps: the packed
    parameters rounded up to 4 floats, then for each of the most cells a
    block owns its n_planes accumulators (none for adj2d_persistent_kernel),
    6 floats of its state and 2 x 2 C shares of the Jacobian's transpose
    (csrc: adj2d::persistent_smem)."""
    cap = -(-(H * W) // blocks)
    n_params = 2 + 2 * _param_block(cfg)
    return 4 * (_round_up(n_params, 4) + (n_planes + 6 + 4 * cfg.hidden) * cap)


def persistent_smem_bytes(cfg: PiCellConfig, H: int, W: int, blocks: int) -> int:
    """Shared memory of a block of pg2d_persistent_kernel: adj_smem_bytes
    with the A accumulators of each cell (csrc: persistent_smem_bytes)."""
    return adj_smem_bytes(cfg, H, W, blocks, _pg_layout(cfg)["A"])


def pg_plan(H: int, W: int, cfg: PiCellConfig, n_sm: int) -> dict:
    """The route of the fused reverse sweep of an H x W field on a card of
    n_sm SMs, by a rule on the shape and the card's limits: one block an SM
    (min(n_sm, H W) blocks, each owning split_evenly's share of the cells)
    whose accumulators fit a block's shared memory takes
    pg2d_persistent_kernel, one cooperative launch a sweep ('persistent',
    with blocks and smem); else pg2d_kernel, one launch a step
    ('per_step').  At 100 x 100 on 132 SMs: 132 blocks of 75 or 76 cells,
    62 064 bytes each; the largest square field that fits is 194 x 194."""
    blocks = min(n_sm, H * W)
    smem = persistent_smem_bytes(cfg, H, W, blocks)
    if smem > _MAX_SMEM:
        return {"route": "per_step"}
    return {"route": "persistent", "blocks": blocks, "smem": smem}


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


def _pg_steps_cuda(packed: torch.Tensor, frames: torch.Tensor, frames_bar: torch.Tensor,
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
    fused_rollout_tp_2d_pg.steps += n_steps
    return g0, acc


def _pg_persistent_cuda(packed: torch.Tensor, frames: torch.Tensor, frames_bar: torch.Tensor,
                        cfg: PiCellConfig):
    """pg2d_persistent_kernel: the whole sweep in one cooperative launch, by
    pg_plan's configuration.  Raises if the card cannot hold the grid."""
    fn = _kernel_fn("backward2d_pg_persistent", _PERSISTENT_SIGNATURE)
    frames_bar = _check_pg_inputs(packed, frames, frames_bar, cfg)
    n_steps, H, W = frames.shape[0] - 1, frames.shape[1], frames.shape[2]
    plan = pg_plan(H, W, cfg, _sm_count(frames.device))
    if plan["route"] != "persistent":
        raise ValueError(f"the accumulators of a {H} x {W} field do not fit the "
                         "persistent sweep's shared memory")
    g0 = torch.zeros((H, W, 2), dtype=torch.float32, device=frames.device)
    scratch = torch.zeros_like(g0)
    acc = torch.empty((_pg_layout(cfg)["A"], H, W), dtype=torch.float32,
                      device=frames.device)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.numel(), frames.data_ptr(),
                           frames_bar.data_ptr(), g0.data_ptr(), scratch.data_ptr(),
                           acc.data_ptr(), n_steps, H, W, cfg.hidden, cfg.n_branches,
                           cfg.dt, 1.0 / (cfg.dx * cfg.dx), plan["blocks"], stream,
                           ctypes.byref(per_sm)), "backward2d_pg_persistent")
    fused_rollout_tp_2d_pg.launches += 1
    fused_rollout_tp_2d_pg.steps += n_steps
    return g0, acc


def pg_occupancy(cfg: PiCellConfig, H: int, W: int, device: torch.device) -> int:
    """How many blocks of pg_plan's configuration an SM of the card holds."""
    plan = pg_plan(H, W, cfg, _sm_count(device))
    if plan["route"] != "persistent":
        raise ValueError(f"a {H} x {W} field takes no persistent sweep")
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise_on_error(_kernel_fn("backward2d_pg_occupancy", _OCCUPANCY_SIGNATURE)(
            2 + 2 * _param_block(cfg), H, W, cfg.hidden, cfg.n_branches, plan["blocks"],
            ctypes.byref(per_sm)), "backward2d_pg_occupancy")
    return per_sm.value


def _pg_cuda(packed: torch.Tensor, frames: torch.Tensor, frames_bar: torch.Tensor,
             cfg: PiCellConfig):
    """The fused reverse sweep on CUDA by pg_plan's route: one cooperative
    launch of pg2d_persistent_kernel ('persistent') or one pg2d_kernel
    launch a step ('per_step')."""
    if frames.dim() == 4 and frames.device.type == "cuda" and pg_plan(
            frames.shape[1], frames.shape[2], cfg,
            _sm_count(frames.device))["route"] == "persistent":
        return _pg_persistent_cuda(packed, frames, frames_bar, cfg)
    return _pg_steps_cuda(packed, frames, frames_bar, cfg)


def fused_phase1_pg_2d(packed: torch.Tensor, frames: torch.Tensor,
                       frames_bar: torch.Tensor, cfg: PiCellConfig):
    """(g0 [H, W, 2], acc [A, H, W]): pg_plan's kernel on CUDA, the plain
    version on the CPU."""
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
    f32.  On CUDA the forward by cell2d's frames rollout and the backward by
    pg2d_persistent_kernel (or, past their capacity, by one rollout2d_kernel
    and one pg2d_kernel launch a step); the plain versions of both on the
    CPU."""
    if cfg.ndim != 2 or cfg.kernel_size != 1:
        raise NotImplementedError(
            "fused_rollout_tp_2d_pg requires ndim=2, kernel_size=1 "
            f"(got ndim={cfg.ndim}, kernel_size={cfg.kernel_size})")
    _check_fusable(cfg)
    packed = pack_pi_params_2d(params, cfg)
    return FusedRolloutTP2dPG.apply(packed, h0.to(torch.float32).contiguous(), cfg, n_steps)


fused_rollout_tp_2d_pg.launches = 0
fused_rollout_tp_2d_pg.steps = 0


# ---------------------------------------------------------------------------
# The streaming adjoints: adj2d_kxk_kernel (row 6), adj2d_kernel (row 4),
# adj2d_ys_kernel (row 5), and the parameter gradients after them
# ---------------------------------------------------------------------------


def pack_adjoint_matrix_2d(wmat: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """[K2, M] adjoint operand from the forward's [M, K] matrix: the
    transpose of its k*k*2 tap columns (the biases do not enter the
    Jacobian), zero rows up to the next multiple of 8."""
    taps = cfg.kernel_size ** 2 * 2
    return F.pad(wmat[:, :taps].T, (0, 0, 0, _round_up(taps, 8) - taps))


def _leave_one_out_prod(y: torch.Tensor, dim: int) -> torch.Tensor:
    """prod_{j != i} y_j along `dim` for every i, in y's shape."""
    n = y.shape[dim]
    return torch.stack([torch.prod(torch.cat([y.narrow(dim, 0, i),
                                              y.narrow(dim, i + 1, n - i - 1)], dim=dim), dim=dim)
                        for i in range(n)], dim=dim)


def _branch_operands(packed: torch.Tensor, cfg: PiCellConfig) -> tuple:
    """(w [k*k*2, M], b [M], w_out [2, C]) from the packed vector, column m =
    (o nb + i) C + c of w holding branch i of equation o, hidden channel c."""
    taps, M = cfg.kernel_size ** 2 * 2, mxu_rows(cfg)
    eqs = [_packed_equation(packed, o, cfg) for o in range(2)]
    w = torch.cat([e[0] for e in eqs]).permute(1, 0, 2).reshape(taps, M)
    return w, torch.cat([e[1] for e in eqs]).reshape(M), torch.stack([e[2] for e in eqs])


def _adjoint_sweep_plain(w: torch.Tensor, b: torch.Tensor, w_out: torch.Tensor,
                         diff: torch.Tensor, frames: torch.Tensor, frames_bar: torch.Tensor,
                         cfg: PiCellConfig, lap, ys: torch.Tensor | None = None,
                         keep_ys: bool = False) -> tuple:
    """The streaming reverse sweep with tensor ops, any spatial rank (k > 1
    in 2D only).  For t = T-1 .. 0, at every cell:

        g_in  = g_{t+1} + fbar_{t+1}                       (g_T = 0)
        y     = w^T im2col(h_t) + b, or ys[t]              ([..., M])
        z[m]  = w_out_o[c] g_in_o prod_{j != i} y[(o nb + j) C + c]
        zw    = w z                                        ([..., k*k*2])
        jt    = sum_{tap} zw[tap] shifted by the reversed tap offset
        g_t   = g_in + dt (diff Lap(g_in) + jt)

    w [k*k*2, M], b [M], w_out [2, C], diff [2] (_branch_operands);
    frames [T+1, *spatial, 2], frames_bar their cotangent; lap(x) the
    Laplacian of a [*spatial, 2] field; ys, if given, [T, M, *spatial].
    Returns (g_ins [T, *spatial, 2], g0 without frames_bar[0]) and, with
    keep_ys, the activations [T, M, *spatial].
    """
    C, nb, k = cfg.hidden, cfg.n_branches, cfg.kernel_size
    r = k // 2
    n_steps = frames_bar.shape[0] - 1
    g = torch.zeros_like(frames_bar[0])
    g_ins, y_out = [None] * n_steps, [None] * n_steps
    for t in range(n_steps - 1, -1, -1):
        g_in = g + frames_bar[t + 1]
        if ys is not None:
            y = ys[t].movedim(0, -1)
        else:
            h = frames[t]
            cols = h if k == 1 else im2col_2d(h, cfg)[..., :k * k * 2]
            y = cols @ w + b
        y_out[t] = y.movedim(-1, 0)
        gw = g_in[..., :, None, None] * w_out[:, None, :]              # [..., 2, 1, C]
        z = gw * _leave_one_out_prod(y.unflatten(-1, (2, nb, C)), -2)  # [..., 2, nb, C]
        zw = z.flatten(-3) @ w.T                                       # [..., k*k*2]
        jt = 0.0
        for ki in range(k):
            for kj in range(k):
                tap = ki * k + kj
                jt = jt + torch.roll(zw[..., 2 * tap: 2 * tap + 2],
                                     shifts=(ki - r, kj - r), dims=(0, 1))
        g_ins[t] = g_in
        g = g_in + cfg.dt * (diff * lap(g_in) + jt)
    out = (torch.stack(g_ins), g)
    return out + (torch.stack(y_out),) if keep_ys else out


def fused_phase1_kxk_2d_plain(wmat: torch.Tensor, tail: torch.Tensor, frames: torch.Tensor,
                              frames_bar: torch.Tensor, cfg: PiCellConfig):
    """Plain version of adj2d_kxk_kernel: the reverse sweep with tensor ops.

    wmat [M, K] (pack_pi_matrix_2d); tail (pi_tail_2d); frames [T+1, H, W, 2],
    the forward's output; frames_bar [T+1, H, W, 2], their cotangent.
    Returns (g_ins [T, H, W, 2], g0 [H, W, 2] without frames_bar[0],
    ys [T, M, H, W]).
    """
    taps, C = cfg.kernel_size ** 2 * 2, cfg.hidden
    return _adjoint_sweep_plain(wmat[:, :taps].T, wmat[:, taps], tail[2:2 + 2 * C].reshape(2, C),
                                tail[:2], frames, frames_bar, cfg,
                                lambda x: laplacian_2d(x, cfg.dx), keep_ys=True)


def fused_phase1_2d_plain(packed: torch.Tensor, frames: torch.Tensor,
                          frames_bar: torch.Tensor, cfg: PiCellConfig):
    """Plain version of adj2d_kernel (any odd k <= 5): (g_ins [T, H, W, 2],
    g0 [H, W, 2] without frames_bar[0]) from the packed vector
    (pack_pi_params_2d), the frames [T+1, H, W, 2] and their cotangent."""
    w, b, w_out = _branch_operands(packed, cfg)
    return _adjoint_sweep_plain(w, b, w_out, packed[:2], frames, frames_bar, cfg,
                                lambda x: laplacian_2d(x, cfg.dx))


def fused_phase1_ys_2d_plain(packed: torch.Tensor, frames_bar: torch.Tensor,
                             ys: torch.Tensor, cfg: PiCellConfig):
    """Plain version of adj2d_ys_kernel: fused_phase1_2d_plain with the
    activations read from ys [T, M, H, W] (_precompute_ys)."""
    w, b, w_out = _branch_operands(packed, cfg)
    return _adjoint_sweep_plain(w, b, w_out, packed[:2], None, frames_bar, cfg,
                                lambda x: laplacian_2d(x, cfg.dx), ys=ys)


def _check_sweep_inputs(name: str, packed: torch.Tensor, frames_bar: torch.Tensor,
                        cfg: PiCellConfig, *tensors: torch.Tensor) -> torch.Tensor:
    """Check a streaming sweep's inputs (frames_bar [T+1, H, W, 2] and the
    contiguous f32 `tensors` on its device); return frames_bar as contiguous
    f32 (the cotangent of a strided slice arrives sparse, expanded or
    strided)."""
    dev = frames_bar.device
    if dev.type != "cuda" or any(t.device != dev for t in (packed,) + tensors):
        raise ValueError(f"{name} takes CUDA tensors on one device; got "
                         f"{[str(t.device) for t in (packed, frames_bar) + tensors]}")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in (packed,) + tensors):
        raise ValueError(f"{name} takes contiguous float32 tensors")
    if frames_bar.dim() != 4 or frames_bar.shape[-1] != 2:
        raise ValueError(f"frames_bar must be [T+1, H, W, 2], got {tuple(frames_bar.shape)}")
    if packed.numel() != 2 + 2 * _param_block(cfg) or packed.numel() > _MAX_PARAMS:
        raise ValueError(f"packed params have {packed.numel()} floats, expected "
                         f"{2 + 2 * _param_block(cfg)} (at most {_MAX_PARAMS})")
    if not 1 <= cfg.n_branches <= _MAX_BRANCHES:
        raise ValueError(f"{name} takes 1 to {_MAX_BRANCHES} branches, got {cfg.n_branches}")
    return frames_bar.to(torch.float32).contiguous()


def _sweep_fn(name: str, signature: list):
    fn = getattr(_build.load_library("adj2d"), name)
    fn.argtypes = signature
    fn.restype = ctypes.c_int
    return fn


def _check_phase1_inputs(name, packed, frames, frames_bar, cfg):
    """Check adj2d_kernel's inputs; return frames_bar as contiguous f32."""
    frames_bar = _check_sweep_inputs(name, packed, frames_bar, cfg, frames)
    if frames.shape != frames_bar.shape:
        raise ValueError(f"frames {tuple(frames.shape)} and frames_bar "
                         f"{tuple(frames_bar.shape)} differ")
    return frames_bar


def _phase1_steps_cuda(packed, frames, frames_bar, cfg):
    """adj2d_kernel: one launch per reverse step at k = 1, two at k > 1, the
    loop in C."""
    frames_bar = _check_phase1_inputs("adj2d_kernel", packed, frames, frames_bar, cfg)
    fn = _sweep_fn("adj2d_sweep", _ADJ_SIGNATURE)
    n_steps, H, W = frames.shape[0] - 1, frames.shape[1], frames.shape[2]
    k, dev = cfg.kernel_size, frames.device
    g = torch.zeros((H, W, 2), dtype=torch.float32, device=dev)
    scratch = torch.zeros_like(g) if k == 1 else None
    zw = torch.empty((k * k * 2, H, W), dtype=torch.float32, device=dev) if k > 1 else None
    g_ins = torch.empty((n_steps, H, W, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.numel(), frames.data_ptr(),
                           frames_bar.data_ptr(), g.data_ptr(),
                           None if scratch is None else scratch.data_ptr(), g_ins.data_ptr(),
                           None if zw is None else zw.data_ptr(), n_steps, H, W, cfg.hidden,
                           cfg.n_branches, k, cfg.dt, 1.0 / (cfg.dx * cfg.dx), stream),
                        "adj2d_sweep")
    fused_phase1_2d.launches += n_steps if k == 1 else 2 * n_steps
    fused_phase1_2d.steps += n_steps
    return g_ins, g


def adj_plan(H: int, W: int, cfg: PiCellConfig, n_sm: int) -> dict:
    """The route of the 1x1 streaming reverse sweep of an H x W field on a
    card of n_sm SMs, by a rule on the cell, the shape and the card's
    limits: a 1x1 cell of 1 to 4 branches whose block (min(n_sm, H W)
    blocks, one an SM, each owning split_evenly's share of the cells) fits
    a block's shared memory takes adj2d_persistent_kernel, one cooperative
    launch a sweep ('persistent', with blocks and smem); else adj2d_kernel,
    one launch a step ('per_step').  At 100 x 100 on 132 SMs for the GS2D
    cell (C = 8): 132 blocks of 75 or 76 cells, 152 bytes a cell, 12 208
    bytes; the largest square field that fits is 448 x 448 (pg_plan's,
    with the 164 accumulators a cell, 194 x 194)."""
    if cfg.kernel_size != 1 or not 1 <= cfg.n_branches <= _MAX_BRANCHES:
        return {"route": "per_step"}
    blocks = min(n_sm, H * W)
    smem = adj_smem_bytes(cfg, H, W, blocks)
    if smem > _MAX_SMEM:
        return {"route": "per_step"}
    return {"route": "persistent", "blocks": blocks, "smem": smem}


def adj_occupancy(cfg: PiCellConfig, H: int, W: int, device: torch.device) -> int:
    """How many blocks of adj_plan's configuration an SM of the card holds."""
    plan = adj_plan(H, W, cfg, _sm_count(device))
    if plan["route"] != "persistent":
        raise ValueError(f"a {H} x {W} field of this cell takes no one-launch sweep: {cfg}")
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise_on_error(_sweep_fn("adj2d_persistent_occupancy", _OCCUPANCY_SIGNATURE)(
            2 + 2 * _param_block(cfg), H, W, cfg.hidden, cfg.n_branches, plan["blocks"],
            ctypes.byref(per_sm)), "adj2d_persistent_occupancy")
    return per_sm.value


def _phase1_persistent_cuda(packed, frames, frames_bar, cfg):
    """adj2d_persistent_kernel: the whole 1x1 sweep in one cooperative
    launch, by adj_plan's configuration; (g_ins, g0).  No launch at
    n_steps = 0.  Raises if the card cannot hold the grid."""
    frames_bar = _check_phase1_inputs("adj2d_persistent_kernel", packed, frames, frames_bar,
                                      cfg)
    n_steps, H, W = frames.shape[0] - 1, frames.shape[1], frames.shape[2]
    dev = frames.device
    plan = adj_plan(H, W, cfg, _sm_count(dev))
    if plan["route"] != "persistent":
        raise ValueError(f"a {H} x {W} field of this cell takes no one-launch sweep: {cfg}")
    fn = _sweep_fn("adj2d_persistent", _ADJ_PERSISTENT_SIGNATURE)
    g0 = torch.zeros((H, W, 2), dtype=torch.float32, device=dev)
    scratch = torch.zeros_like(g0)
    g_ins = torch.empty((n_steps, H, W, 2), dtype=torch.float32, device=dev)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.numel(), frames.data_ptr(),
                           frames_bar.data_ptr(), g0.data_ptr(), scratch.data_ptr(),
                           g_ins.data_ptr(), n_steps, H, W, cfg.hidden, cfg.n_branches, cfg.dt,
                           1.0 / (cfg.dx * cfg.dx), plan["blocks"], stream,
                           ctypes.byref(per_sm)), "adj2d_persistent")
    fused_phase1_2d.launches += 1 if n_steps else 0
    fused_phase1_2d.steps += n_steps
    return g_ins, g0


def adj_b_grid(H: int, W: int, per_member: int) -> dict:
    """The grid of adj2d_batched_ffma_persistent_kernel with per_member
    blocks a member: cell2d.ffma_grid's split on per_member blocks (each
    owning split_evenly's run of at most cap cells), its rounds balanced:
    the cap / 16 tiles (rounded up) go in the fewest rounds of at most 8
    tiles, the same number each, a warp pair a tile, so that no round runs
    its products on a whole tile of cells the block does not own (152 cells
    a block: 2 rounds of 5 tiles, 320 threads, not 8 + 8 tiles of which 6
    hold none of its cells)."""
    grid = ffma_grid(H, W, per_member)
    n16 = -(-grid["cap"] // _FFMA_TILE)
    tiles = -(-n16 // -(-n16 // _FFMA_TILES))
    return {**grid, "threads": 64 * tiles, "rc": _FFMA_TILE * tiles}


def adj_b_smem_bytes(cfg: PiCellConfig, H: int, W: int, per_member: int) -> int:
    """Shared memory of a block of adj2d_batched_ffma_persistent_kernel with
    per_member blocks a member (adj_b_grid's layout): the forward operand
    (pack_ffma_fwd_2d), the adjoint operand (pack_ffma_adj_2d), the tail,
    the round's im2col stack [k*k*2][rc] (whose place then holds the warp
    pairs' exchange, 4 R floats a lane: the larger of the two), Z of a round
    [M][rc] (whose place then holds zw [k*k*2][rc]: the larger), g_in of the
    most cells a block owns (2 floats a cell) and its most staged rows
    (csrc/batched2d.cu: adj_b_smem)."""
    grid = adj_b_grid(H, W, per_member)
    M, r, taps = mxu_rows(cfg), _ffma_adj_taps(cfg), cfg.kernel_size ** 2 * 2
    tiles = grid["threads"] // 64
    return (4 * (_ffma_fwd_floats(cfg) + M * _round_up(r, 4) * 8 + _FFMA_TAIL
                 + max(taps * grid["rc"], tiles * 4 * r * 32) + max(M, taps) * grid["rc"]
                 + 2 * grid["cap"]) + grid["tile_bytes"])


def adj_b_plan(M: int, H: int, W: int, cfg: PiCellConfig, n_sm: int) -> dict:
    """The route of the member-batched k x k streaming sweep of M members on
    an H x W field on a card of n_sm SMs (at M = 1 the single model's), by a
    rule on the cell, the shape and the card's limits: a cell of the widths
    adj2d_batched_ffma_persistent_kernel is built for (k = 3 or 5, 1 to 4
    branches, C <= 16) takes it, one cooperative launch a sweep for all
    members ('persistent', with blocks, blocks_a_member, threads and smem),
    when every member gets at least one block of the n_sm (n_sm // M each,
    at most one a cell: one block an SM) and a block fits its shared
    memory; else adj2d_batched_act_kernel and adj2d_batched_gather_kernel
    (at M = 1 adj2d_act_kernel and adj2d_gather_kernel), two launches a step
    ('per_step').  For the Burgers cell (k = 5, C = 16, 3 branches) at
    100 x 100 on 132 SMs: M = 1, 132 blocks of 75 or 76 cells, one round of
    5 tiles (320 threads), 105 072 bytes; M = 2, 66 blocks a member of 151
    or 152 cells, 2 rounds of 5 tiles (320 threads), 106 512 bytes; M = 4,
    33 of 303 or 304 cells, 3 rounds of 7 tiles (448 threads), 128 848
    bytes; M = 8, 16 of 625, 5 rounds of 8 (512 threads), 143 640 bytes;
    the largest square fields it admits are 768 x 768 at M = 1, 570 x 570
    at M = 2, 419 x 419 at M = 4 and 300 x 300 at M = 8."""
    if not _ffma_widths_ok(cfg) or not 1 <= M <= n_sm:
        return {"route": "per_step"}
    per_member = min(n_sm // M, H * W)
    smem = adj_b_smem_bytes(cfg, H, W, per_member)
    if smem > _MAX_SMEM:
        return {"route": "per_step"}
    return {"route": "persistent", "blocks": M * per_member, "blocks_a_member": per_member,
            "threads": adj_b_grid(H, W, per_member)["threads"], "smem": smem}


def _ffma_sweep_b(packed, frames, frames_bar, cfg):
    """One cooperative launch of adj2d_batched_ffma_persistent_kernel
    (csrc/batched2d.cu) on checked inputs, packed [M, P], frames and
    frames_bar [M, T+1, H, W, 2] contiguous f32 on the card, by adj_b_plan's
    configuration, full f32 FFMA whatever the MXU switches say; (g_ins
    [M, T, H, W, 2], g0 [M, H, W, 2]).  Nothing is launched at T = 0; the
    caller counts the launch.  Raises if the plan refuses the shape or the
    card cannot hold the grid."""
    M, n_steps, H, W = frames.shape[0], frames.shape[1] - 1, frames.shape[2], frames.shape[3]
    dev = frames.device
    plan = adj_b_plan(M, H, W, cfg, _sm_count(dev))
    if plan["route"] != "persistent":
        raise ValueError(f"{M} members of a {H} x {W} field take no one-launch sweep: {cfg}")
    fn = getattr(_build.load_library("batched2d"), "batched2d_adj_ffma_persistent")
    fn.argtypes, fn.restype = _ADJ_B_FFMA_SIGNATURE, ctypes.c_int
    members = [packed[m] for m in range(M)]
    wf = torch.stack([pack_ffma_fwd_2d(p, cfg) for p in members]).contiguous()
    wa = torch.stack([pack_ffma_adj_2d(p, cfg) for p in members]).contiguous()
    tail = torch.stack([pack_ffma_tail_2d(p, cfg) for p in members]).contiguous()
    k = cfg.kernel_size
    g = torch.zeros((M, H, W, 2), dtype=torch.float32, device=dev)
    g_ins = torch.empty((M, n_steps, H, W, 2), dtype=torch.float32, device=dev)
    zw = torch.empty((M, 2, k * k * 2, H, W), dtype=torch.float32, device=dev)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(wf.data_ptr(), wa.data_ptr(), tail.data_ptr(), frames.data_ptr(),
                           frames_bar.data_ptr(), g.data_ptr(), g_ins.data_ptr(), zw.data_ptr(),
                           M, n_steps, H, W, cfg.hidden, cfg.n_branches, k, cfg.dt,
                           1.0 / (cfg.dx * cfg.dx), plan["blocks_a_member"], plan["threads"],
                           plan["smem"], stream, ctypes.byref(per_sm)),
                        "batched2d_adj_ffma_persistent")
    return g_ins, g


def _phase1_ffma_cuda(packed, frames, frames_bar, cfg):
    """The k x k streaming sweep of one model in one cooperative launch:
    adj2d_batched_ffma_persistent_kernel on a one-member batch, by
    adj_b_plan's configuration at M = 1; (g_ins, g0).  No launch at
    n_steps = 0."""
    frames_bar = _check_phase1_inputs("adj2d_batched_ffma_persistent_kernel", packed, frames,
                                      frames_bar, cfg)
    g_ins, g = _ffma_sweep_b(packed[None], frames[None], frames_bar[None], cfg)
    n_steps = frames.shape[0] - 1
    fused_phase1_2d.launches += 1 if n_steps else 0
    fused_phase1_2d.steps += n_steps
    return g_ins[0], g[0]


def _phase1_cuda(packed, frames, frames_bar, cfg):
    """The streaming reverse sweep on CUDA: at k = 1 by adj_plan's route,
    one launch of adj2d_persistent_kernel ('persistent') or one adj2d_kernel
    launch a step ('per_step'); at k > 1 by adj_b_plan's at M = 1, one
    launch of adj2d_batched_ffma_persistent_kernel on a one-member batch
    ('persistent') or two, adj2d_act_kernel and adj2d_gather_kernel, a step
    ('per_step')."""
    if frames.dim() == 4 and frames.device.type == "cuda":
        H, W, n_sm = frames.shape[1], frames.shape[2], _sm_count(frames.device)
        if cfg.kernel_size == 1 and adj_plan(H, W, cfg, n_sm)["route"] == "persistent":
            return _phase1_persistent_cuda(packed, frames, frames_bar, cfg)
        if cfg.kernel_size > 1 and adj_b_plan(1, H, W, cfg, n_sm)["route"] == "persistent":
            return _phase1_ffma_cuda(packed, frames, frames_bar, cfg)
    return _phase1_steps_cuda(packed, frames, frames_bar, cfg)


def _check_ys_inputs(packed, frames_bar, ys, cfg, name):
    """Check a ys sweep's inputs; return frames_bar as contiguous f32."""
    frames_bar = _check_sweep_inputs(name, packed, frames_bar, cfg, ys)
    n_steps, H, W = frames_bar.shape[0] - 1, frames_bar.shape[1], frames_bar.shape[2]
    if cfg.kernel_size not in _KXK_SIZES or tuple(ys.shape) != (n_steps, mxu_rows(cfg), H, W):
        raise ValueError(f"{name} takes kernel_size {_KXK_SIZES} and ys "
                         f"[{n_steps}, {mxu_rows(cfg)}, {H}, {W}], got {cfg.kernel_size} "
                         f"and {tuple(ys.shape)}")
    return frames_bar


def _phase1_ys_steps_cuda(packed, frames_bar, ys, cfg):
    """adj2d_ys_kernel: two launches per reverse step, the loop in C."""
    frames_bar = _check_ys_inputs(packed, frames_bar, ys, cfg, "adj2d_ys_kernel")
    n_steps, H, W = frames_bar.shape[0] - 1, frames_bar.shape[1], frames_bar.shape[2]
    fn = _sweep_fn("adj2d_ys_sweep", _YS_SIGNATURE)
    dev = frames_bar.device
    k = cfg.kernel_size
    g = torch.zeros((H, W, 2), dtype=torch.float32, device=dev)
    zw = torch.empty((k * k * 2, H, W), dtype=torch.float32, device=dev)
    g_ins = torch.empty((n_steps, H, W, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.numel(), frames_bar.data_ptr(),
                           ys.data_ptr(), g.data_ptr(), g_ins.data_ptr(), zw.data_ptr(),
                           n_steps, H, W, cfg.hidden, cfg.n_branches, k, cfg.dt,
                           1.0 / (cfg.dx * cfg.dx), stream), "adj2d_ys_sweep")
    fused_phase1_ys_2d.launches += 2 * n_steps
    fused_phase1_ys_2d.steps += n_steps
    return g_ins, g


def ys_smem_bytes(cfg: PiCellConfig, H: int, W: int, n_sm: int) -> int:
    """Shared memory of a block of adj2d_ys_persistent_kernel: the adjoint
    operand (pack_ffma_adj_2d), z of a round [M][rc] (whose place then holds
    the round's zw [k*k*2][rc], so the larger of the two), the tail, each warp
    pair's exchange (4 R floats a lane), g_in of the most cells a block
    owns (2 floats a cell) and two [M][cap] buffers of ys (csrc:
    ys_persistent_smem)."""
    grid = ffma_grid(H, W, n_sm)
    M, r = mxu_rows(cfg), _ffma_adj_taps(cfg)
    tiles = grid["threads"] // 64
    zrows = max(M, cfg.kernel_size ** 2 * 2)
    return 4 * (M * _round_up(r, 4) * 8 + zrows * grid["rc"] + _FFMA_TAIL + tiles * 4 * r * 32
                + 2 * grid["cap"] + 2 * M * grid["cap"])


def ys_plan(H: int, W: int, cfg: PiCellConfig, n_sm: int) -> dict:
    """The route of the ys reverse sweep of an H x W field on a card of n_sm
    SMs, by a rule on the cell, the shape and the card's limits: a cell of
    the widths adj2d_ys_persistent_kernel is built for (k = 3 or 5, 1 to 4
    branches, C <= 16) whose block fits a block's shared memory takes it, one
    cooperative launch a sweep ('persistent', with blocks, threads and smem:
    cell2d.ffma_grid's); else adj2d_ys_kernel, two launches a step
    ('per_step').  At 100 x 100, C = 16, 3 branches, k = 5 on 132 SMs: 132
    blocks of 320 threads, 132 336 bytes; the largest square field that
    fits is 148 x 148 (the two ys buffers take 768 bytes a cell of a block)."""
    if not _ffma_widths_ok(cfg):
        return {"route": "per_step"}
    smem = ys_smem_bytes(cfg, H, W, n_sm)
    if smem > _MAX_SMEM:
        return {"route": "per_step"}
    grid = ffma_grid(H, W, n_sm)
    return {"route": "persistent", "blocks": grid["blocks"], "threads": grid["threads"],
            "smem": smem}


def ys_occupancy(cfg: PiCellConfig, H: int, W: int, device: torch.device) -> int:
    """How many blocks of ys_plan's configuration an SM of the card holds."""
    return ffma_occupancy(cfg, H, W, device, plan=ys_plan(H, W, cfg, _sm_count(device)),
                          library="adj2d", fn_name="adj2d_ys_occupancy")


def _phase1_ys_persistent_cuda(packed, frames_bar, ys, cfg):
    """adj2d_ys_persistent_kernel: the whole ys sweep in one cooperative
    launch, by ys_plan's configuration.  No launch at n_steps = 0.  Raises if
    the card cannot hold the grid."""
    frames_bar = _check_ys_inputs(packed, frames_bar, ys, cfg, "adj2d_ys_persistent_kernel")
    n_steps, H, W = frames_bar.shape[0] - 1, frames_bar.shape[1], frames_bar.shape[2]
    dev = frames_bar.device
    plan = ys_plan(H, W, cfg, _sm_count(dev))
    if plan["route"] != "persistent":
        raise ValueError(f"a {H} x {W} field of this cell takes no one-launch ys sweep: {cfg}")
    fn = _sweep_fn("adj2d_ys_persistent", _YS_PERSISTENT_SIGNATURE)
    wa, tail = pack_ffma_adj_2d(packed, cfg), pack_ffma_tail_2d(packed, cfg)
    k = cfg.kernel_size
    g = torch.zeros((H, W, 2), dtype=torch.float32, device=dev)
    zw = torch.empty((2, k * k * 2, H, W), dtype=torch.float32, device=dev)
    g_ins = torch.empty((n_steps, H, W, 2), dtype=torch.float32, device=dev)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(wa.data_ptr(), tail.data_ptr(), frames_bar.data_ptr(), ys.data_ptr(),
                           g.data_ptr(), g_ins.data_ptr(), zw.data_ptr(), n_steps, H, W,
                           cfg.hidden, cfg.n_branches, k, cfg.dt, 1.0 / (cfg.dx * cfg.dx),
                           plan["blocks"], plan["threads"], plan["smem"], stream,
                           ctypes.byref(per_sm)), "adj2d_ys_persistent")
    fused_phase1_ys_2d.launches += 1 if n_steps else 0
    fused_phase1_ys_2d.steps += n_steps
    return g_ins, g


def _phase1_ys_cuda(packed, frames_bar, ys, cfg):
    """The ys reverse sweep on CUDA by ys_plan's route: one launch of
    adj2d_ys_persistent_kernel ('persistent') or two adj2d_ys_kernel
    launches a step ('per_step')."""
    if frames_bar.dim() == 4 and frames_bar.device.type == "cuda" and ys_plan(
            frames_bar.shape[1], frames_bar.shape[2], cfg,
            _sm_count(frames_bar.device))["route"] == "persistent":
        return _phase1_ys_persistent_cuda(packed, frames_bar, ys, cfg)
    return _phase1_ys_steps_cuda(packed, frames_bar, ys, cfg)


def fused_phase1_2d(packed, frames, frames_bar, cfg):
    """(g_ins, g0): _phase1_cuda's kernel on CUDA, the plain version on the
    CPU."""
    if frames.device.type == "cpu":
        return fused_phase1_2d_plain(packed, frames, frames_bar.to(torch.float32), cfg)
    return _phase1_cuda(packed, frames, frames_bar, cfg)


def fused_phase1_ys_2d(packed, frames_bar, ys, cfg):
    """(g_ins, g0): ys_plan's kernel on CUDA, the plain version on the CPU."""
    if frames_bar.device.type == "cpu":
        return fused_phase1_ys_2d_plain(packed, frames_bar.to(torch.float32), ys, cfg)
    return _phase1_ys_cuda(packed, frames_bar, ys, cfg)


def _kxk_bwd_smem_bytes(cfg: PiCellConfig) -> int:
    """Shared memory of adj2d_kxk_kernel's first kernel (csrc/backward2d_kxk.cu):
    the forward's staging plus the exchange of the k*k*2 partial sums of
    128 cells."""
    return _kxk_smem_bytes(cfg) + 4 * cfg.kernel_size ** 2 * 2 * 128


def _check_kxk_sweep(wmat, tail, frames, frames_bar, cfg, smem_bytes):
    """Check the k x k sweeps' inputs; return frames_bar as contiguous f32."""
    if frames.dim() != 4 or frames_bar.shape != frames.shape or not frames.is_contiguous():
        raise ValueError(f"frames and frames_bar must be [T+1, H, W, 2] and frames "
                         f"contiguous, got {tuple(frames.shape)} and {tuple(frames_bar.shape)}")
    _check_kxk_inputs(wmat, tail, frames[0], cfg, frames.shape[0] - 1, smem_bytes)
    if frames_bar.device != frames.device:
        raise ValueError(f"frames_bar on {frames_bar.device}, frames on {frames.device}")
    # the cotangent of a strided slice arrives sparse, expanded or strided
    return frames_bar.to(torch.float32).contiguous()


def kxk_adj_smem_bytes(cfg: PiCellConfig, H: int, W: int, n_sm: int) -> int:
    """Shared memory of a block of adj2d_kxk_persistent_kernel: both operands
    split into hi and lo (16 bytes a fragment pair), the padded tail, g_in of
    the most cells a block owns (2 floats a cell), the zw exchange of each
    warp pair (Q / 8 x 4 x 32 floats) and kxk_grid's staged rows (csrc:
    persistent_smem)."""
    m, grid = _mma_shape(cfg), kxk_grid(H, W, n_sm)
    return (16 * (m["k8"] + m["qt"]) * m["nt2"] * 32 + 4 * m["tail"] + 8 * grid["cap"]
            + 4 * (grid["threads"] // 64) * m["qt"] * 4 * 32 + grid["tile_bytes"])


def kxk_adj_plan(H: int, W: int, cfg: PiCellConfig, n_sm: int) -> dict:
    """The route of the k x k reverse sweep of an H x W field on a card of
    n_sm SMs, as cell2d.kxk_plan picks the forward's: the widths the
    one-launch kernels are built for and a block that fits shared memory
    take adj2d_kxk_persistent_kernel, one cooperative launch a sweep
    ('persistent', with blocks, threads and smem, the forward's grid); else
    adj2d_kxk_kernel, two launches a step ('per_step').  At 100 x 100, C =
    16, 3 branches, k = 5 on 132 SMs: 132 blocks of 320 threads, 109 680
    bytes."""
    if not _mma_widths_ok(cfg):
        return {"route": "per_step"}
    smem = kxk_adj_smem_bytes(cfg, H, W, n_sm)
    if smem > _MAX_SMEM:
        return {"route": "per_step"}
    grid = kxk_grid(H, W, n_sm)
    return {"route": "persistent", "blocks": grid["blocks"], "threads": grid["threads"],
            "smem": smem}


def kxk_adj_occupancy(cfg: PiCellConfig, H: int, W: int, device: torch.device) -> int:
    """How many blocks of kxk_adj_plan's configuration an SM of the card holds."""
    return kxk_occupancy(cfg, H, W, device, plan=kxk_adj_plan(H, W, cfg, _sm_count(device)),
                         library="backward2d_kxk", fn_name="backward2d_kxk_occupancy")


def _phase1_kxk_persistent_cuda(wmat, tail, frames, frames_bar, cfg):
    """adj2d_kxk_persistent_kernel: the whole sweep in one cooperative launch,
    by kxk_adj_plan's configuration.  Raises if the card cannot hold the
    grid."""
    n_steps, H, W = frames.shape[0] - 1, frames.shape[1], frames.shape[2]
    plan = kxk_adj_plan(H, W, cfg, _sm_count(frames.device))
    if plan["route"] != "persistent":
        raise ValueError(f"a {H} x {W} field of this cell takes no one-launch sweep: {cfg}")
    frames_bar = _check_kxk_sweep(wmat, tail, frames, frames_bar, cfg, plan["smem"])
    fn = _build.load_library("backward2d_kxk").backward2d_kxk_persistent
    fn.argtypes = _KXK_PERSISTENT_SIGNATURE
    fn.restype = ctypes.c_int
    dev = frames.device
    bfwd, badj = pack_mma_fwd_2d(wmat, cfg), pack_mma_adj_2d(wmat, cfg)
    g = torch.zeros((H, W, 2), dtype=torch.float32, device=dev)
    g_ins = torch.empty((n_steps, H, W, 2), dtype=torch.float32, device=dev)
    ys = torch.empty((n_steps, mxu_rows(cfg), H, W), dtype=torch.float32, device=dev)
    zw = torch.empty((2, cfg.kernel_size ** 2 * 2, H, W), dtype=torch.float32, device=dev)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(bfwd.data_ptr(), badj.data_ptr(), tail.data_ptr(), frames.data_ptr(),
                           frames_bar.data_ptr(), g.data_ptr(), g_ins.data_ptr(), ys.data_ptr(),
                           zw.data_ptr(), n_steps, H, W, cfg.hidden, cfg.n_branches,
                           cfg.kernel_size, _mma_shape(cfg)["ch"], cfg.dt,
                           1.0 / (cfg.dx * cfg.dx), plan["blocks"], plan["threads"],
                           plan["smem"], stream, ctypes.byref(per_sm)),
                        "backward2d_kxk_persistent")
    if n_steps:
        fused_rollout_tp_2d.launches += 1
        fused_rollout_tp_2d.steps += n_steps
    return g_ins, g, ys


def _phase1_kxk_steps_cuda(wmat, tail, frames, frames_bar, cfg):
    """adj2d_kxk_kernel: two launches per reverse step, the loop in C."""
    n_steps, H, W = frames.shape[0] - 1, frames.shape[1], frames.shape[2]
    frames_bar = _check_kxk_sweep(wmat, tail, frames, frames_bar, cfg, _kxk_bwd_smem_bytes(cfg))
    fn = _build.load_library("backward2d_kxk").backward2d_kxk
    fn.argtypes = _KXK_SIGNATURE
    fn.restype = ctypes.c_int
    dev = frames.device
    g = torch.zeros((H, W, 2), dtype=torch.float32, device=dev)
    g_ins = torch.empty((n_steps, H, W, 2), dtype=torch.float32, device=dev)
    ys = torch.empty((n_steps, mxu_rows(cfg), H, W), dtype=torch.float32, device=dev)
    zw = torch.empty((cfg.kernel_size ** 2 * 2, H, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(wmat.data_ptr(), tail.data_ptr(), frames.data_ptr(),
                           frames_bar.data_ptr(), g.data_ptr(), g_ins.data_ptr(),
                           ys.data_ptr(), zw.data_ptr(), n_steps, H, W, cfg.hidden,
                           cfg.n_branches, cfg.kernel_size, cfg.dt, 1.0 / (cfg.dx * cfg.dx),
                           stream), "backward2d_kxk")
    fused_rollout_tp_2d.launches += 2 * n_steps
    fused_rollout_tp_2d.steps += n_steps
    return g_ins, g, ys


def _phase1_kxk_cuda(wmat, tail, frames, frames_bar, cfg):
    """The k x k reverse sweep on CUDA by kxk_adj_plan's route: one launch of
    adj2d_kxk_persistent_kernel ('persistent') or two adj2d_kxk_kernel
    launches a step ('per_step')."""
    if frames.dim() == 4 and frames.device.type == "cuda" and kxk_adj_plan(
            frames.shape[1], frames.shape[2], cfg,
            _sm_count(frames.device))["route"] == "persistent":
        return _phase1_kxk_persistent_cuda(wmat, tail, frames, frames_bar, cfg)
    return _phase1_kxk_steps_cuda(wmat, tail, frames, frames_bar, cfg)


def fused_phase1_kxk_2d(wmat, tail, frames, frames_bar, cfg):
    """(g_ins, g0, ys): kxk_adj_plan's kernel on CUDA, the plain version on
    the CPU."""
    if frames.device.type == "cpu":
        return fused_phase1_kxk_2d_plain(wmat, tail, frames, frames_bar.to(torch.float32), cfg)
    return _phase1_kxk_cuda(wmat, tail, frames, frames_bar, cfg)


def _precompute_ys(params: dict, h_prev: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """The branch activations y of every step, [T, M, H, W] f32 with plane
    (o nb + i) C + c: time-batched periodic convs of h_prev [T, H, W, 2]
    (the steps' inputs) in full f32, outside any kernel, as percnn_tpu's
    ``_precompute_ys`` leaves them to XLA."""
    k, C = cfg.kernel_size, cfg.hidden
    h32 = h_prev.to(torch.float32)
    ys = [conv_nd_periodic(h32, br[f"w{i}"].to(torch.float32).reshape(k, k, 2, C),
                           br[f"b{i}"].to(torch.float32))
          for br in params["pi"] for i in range(cfg.n_branches)]   # [T, H, W, C] each
    stacked = torch.stack(ys, dim=1).movedim(-1, 2)                  # [T, 2 nb, C, H, W]
    return stacked.reshape(h_prev.shape[0], mxu_rows(cfg), h_prev.shape[1], h_prev.shape[2])


def _param_grads_direct(params: dict, h_prev: torch.Tensor, g_ins: torch.Tensor,
                        ys: torch.Tensor, cfg: PiCellConfig) -> dict:
    """Parameter gradients from the sweep's cotangents and activations, summed
    over time and space (percnn_tpu's ``_param_grads_direct``):

        cot_i      = g_o w_out[c] prod_{j != i} y_j
        dw_i       = dt conv_weight_grad(h, cot_i)   (periodic k x k)
        db_i       = dt sum cot_i
        dw_out[c]  = dt sum g_o prod_j y_j
        db_out     = dt sum g_o
        ddiff_o    = dt sum g_o Lap(h_o), times mu_up s (1 - s) for the
                     sigmoid parametrisation (s = sigmoid(diff))

    h_prev [T, H, W, 2] (the steps' inputs), g_ins [T, H, W, 2], ys
    [T, 2, nb, C, H, W] (JAX's takes them channels-last; here they stay in
    the layout the sweep writes).  dw_i and db_i together are the gradient
    of the branch matrix (pack_pi_matrix_2d): the product of the [T, M, H W]
    cotangents with the [T, H W, K] im2col stack of h, one batched matrix
    product in full f32 (a cuDNN weight-grad convolution may pick an
    algorithm that rounds this sum of 10^6 terms to about 1e-3).
    """
    C, nb, k, dt = cfg.hidden, cfg.n_branches, cfg.kernel_size, cfg.dt
    h32, g32 = h_prev.to(torch.float32), g_ins.to(torch.float32)
    draw = dt * (g32 * laplacian_2d(h32, cfg.dx)).sum((0, 1, 2))
    if cfg.diffusion == "raw":
        ddiff = draw
    else:
        s = torch.sigmoid(params["diff"].to(torch.float32))
        ddiff = cfg.mu_up * s * (1 - s) * draw
    w_out = torch.stack([params["pi"][o]["w_out"].reshape(C) for o in range(2)])
    w_out = w_out.to(torch.float32)[None, :, None, :, None, None]   # [1, 2, 1, C, 1, 1]
    go = g32.movedim(-1, 1)[:, :, None, None]                       # [T, 2, 1, 1, H, W]
    cot = _leave_one_out_prod(ys, 2) * (go * w_out)                 # [T, 2, nb, C, H, W]
    with full_f32():
        dmat = torch.bmm(cot.flatten(1, 3).flatten(2), im2col_2d(h32, cfg).flatten(1, 2))
    dmat = dt * dmat.sum(0)                                          # [M, K]
    taps = k * k * 2
    dw = dmat[:, :taps].reshape(2, nb, C, k, k, 2)                   # [o, i, c, ki, kj, cin]
    db = dmat[:, taps].reshape(2, nb, C)
    dwout = dt * (go[:, :, 0] * torch.prod(ys, dim=2)).sum((0, 3, 4))   # [2, C]
    dbout = dt * g32.sum((0, 1, 2))
    pi_bar = []
    for o in range(2):
        br = params["pi"][o]
        bar = {"w_out": dwout[o].reshape(br["w_out"].shape), "b_out": dbout[o:o + 1]}
        for i in range(nb):
            bar[f"w{i}"] = dw[o, i].permute(1, 2, 3, 0).reshape(br[f"w{i}"].shape)
            bar[f"b{i}"] = db[o, i]
        pi_bar.append({key: v.to(br[key].dtype) for key, v in bar.items()})
    return {"diff": ddiff.to(params["diff"].dtype), "pi": pi_bar}


def _param_grads_stream(params: dict, h_prev: torch.Tensor, g_ins: torch.Tensor,
                        ys_stream: torch.Tensor, cfg: PiCellConfig) -> dict:
    """``_param_grads_direct`` on the sweep's ys [T, M, H, W] (rows
    (o nb + i) C + c), read as a [T, 2, nb, C, H, W] view, without a copy."""
    return _param_grads_direct(params, h_prev, g_ins,
                               ys_stream.unflatten(1, (2, cfg.n_branches, cfg.hidden)), cfg)


YS_PATH_ENABLED = True
"""Route a k x k backward with MXU_BWD_ENABLED off through _precompute_ys and
ys_plan's sweep (adj2d_ys_persistent_kernel or adj2d_ys_kernel); off,
through adj2d_kernel and chunked_param_grads.  Looked up at every call."""

MXU_BWD_ENABLED = os.environ.get("PERCNN_DISABLE_MXU", "") != "1"
"""Route a k x k backward through adj2d_kxk_kernel, which forms the
activations as a product with the branch matrix and streams them out for
the parameter gradients.  Read from PERCNN_DISABLE_MXU=1 at import, as
percnn_tpu does, and looked up at every call."""


def _ys_path_ok(cfg: PiCellConfig, n_steps: int, H: int, W: int) -> bool:
    """The activation-streaming backwards hold [T, 2 nb C, H, W] f32 in
    device memory: at most 8 GiB of it, as in percnn_tpu (768 MB for
    Burgers at T = 200)."""
    return YS_PATH_ENABLED and mxu_rows(cfg) * n_steps * H * W * 4 <= 8 * 1024 ** 3


def backward_route(cfg: PiCellConfig, n_steps: int, H: int, W: int) -> str:
    """The reverse sweep fused_rollout_tp_2d takes, as percnn_tpu's
    ``_fused_tp_bwd`` picks it (without its TPU memory guards):
    'mxu' (kxk_adj_plan's sweep) for a k x k cell with MXU_BWD_ENABLED and
    _ys_path_ok; else 'ys' (ys_plan's sweep) for a k x k cell with
    _ys_path_ok; else 'adjoint' (adj2d_kernel and chunked_param_grads)."""
    if cfg.kernel_size > 1 and _ys_path_ok(cfg, n_steps, H, W):
        return "mxu" if MXU_BWD_ENABLED else "ys"
    return "adjoint"


def _cell_leaves(params: dict) -> list:
    """The cell's tensors in a fixed order: diff, then per equation its keys sorted."""
    return [params["diff"]] + [br[key] for br in params["pi"] for key in sorted(br)]


def _cell_tree(like: dict, leaves) -> dict:
    """A cell tree of `like`'s structure holding `leaves` (_cell_leaves order)."""
    it = iter(leaves)
    out = {"diff": next(it), "pi": []}
    for br in like["pi"]:
        out["pi"].append({key: next(it) for key in sorted(br)})
    return out


class FusedRolloutTP2d(torch.autograd.Function):
    """frames = the rollout of a 2D cell from h0, by kxk_plan's k x k kernel
    (a k x k cell with MXU_FWD_ENABLED) or cell2d._rollout_cuda's route;
    backward by the sweep of backward_route, then the parameter gradients."""

    @staticmethod
    def forward(ctx, h0, cfg, n_steps, pgrad_chunk, like, *leaves):
        params = _cell_tree(like, leaves)
        cpu = h0.device.type == "cpu"
        if cfg.kernel_size > 1 and cell2d.MXU_FWD_ENABLED:
            wmat, tail = pack_pi_matrix_2d(params, cfg), pi_tail_2d(params, cfg)
            frames = (fused_rollout_kxk_2d_plain(wmat, tail, h0, cfg, n_steps) if cpu
                      else _rollout_kxk_cuda(wmat, tail, h0, cfg, n_steps))
        else:
            packed = pack_pi_params_2d(params, cfg)
            frames = (fused_rollout_2d_plain(packed, h0, cfg, n_steps) if cpu
                      else _rollout_cuda(packed, h0, cfg, n_steps))
        ctx.cfg, ctx.pgrad_chunk, ctx.like = cfg, pgrad_chunk, like
        ctx.save_for_backward(frames, *leaves)
        return frames

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, frames_bar):
        frames, *leaves = ctx.saved_tensors
        cfg, params = ctx.cfg, _cell_tree(ctx.like, leaves)
        n_steps, H, W = frames.shape[0] - 1, frames.shape[1], frames.shape[2]
        route = backward_route(cfg, n_steps, H, W)
        if route == "mxu":
            wmat = pack_pi_matrix_2d(params, cfg)
            g_ins, g0, ys = fused_phase1_kxk_2d(wmat, pi_tail_2d(params, cfg), frames,
                                                frames_bar, cfg)
            bar = _param_grads_stream(params, frames[:-1], g_ins, ys, cfg)
        elif route == "ys":
            ys = _precompute_ys(params, frames[:-1], cfg)
            g_ins, g0 = fused_phase1_ys_2d(pack_pi_params_2d(params, cfg), frames_bar, ys, cfg)
            bar = _param_grads_stream(params, frames[:-1], g_ins, ys, cfg)
        else:
            g_ins, g0 = fused_phase1_2d(pack_pi_params_2d(params, cfg), frames, frames_bar, cfg)
            bar = chunked_param_grads(lambda p, h: pi_cell_step(p, h, cfg), params,
                                      frames[:-1], g_ins, n_steps, ctx.pgrad_chunk)
        return (g0 + frames_bar[0], None, None, None, None, *_cell_leaves(bar))


def fused_rollout_tp_2d(params: dict, h0: torch.Tensor, cfg: PiCellConfig,
                        n_steps: int, pgrad_chunk: int = 64) -> torch.Tensor:
    """Differentiable rollout of a 2D cell of any odd kernel_size <= 5:
    [H, W, 2] -> [n_steps+1, H, W, 2] f32, percnn_tpu's
    ``fused_rollout_tp_2d``.  The kernels on CUDA, their plain versions on
    the CPU, by the routes of MXU_FWD_ENABLED and backward_route;
    pgrad_chunk is chunked_param_grads' steps a batch on the 'adjoint'
    route.  Gradients reach the cell's tensors and h0."""
    _check_fusable(cfg)
    return FusedRolloutTP2d.apply(h0.to(torch.float32).contiguous(), cfg, n_steps, pgrad_chunk,
                                  params, *_cell_leaves(params))


fused_rollout_tp_2d.launches = 0
fused_rollout_tp_2d.steps = 0
fused_phase1_2d.launches = 0
fused_phase1_2d.steps = 0
fused_phase1_ys_2d.launches = 0
fused_phase1_ys_2d.steps = 0
