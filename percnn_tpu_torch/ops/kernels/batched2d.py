"""Member-batched fused 2D rollout and backward (ensemble training): CUDA
kernels for Hopper and their plain versions.

Counterpart of percnn_tpu/ops/pallas/batched2d.py.  An ensemble's M members
are M independent 2D Pi cells, each with its own parameters and initial
state.  Their parameters are stacked, a leading member axis on every leaf,
and packed per member into one [M, P] table (``pack_pi_params_2d_batched``,
row m = ``pack_pi_params_2d`` of member m).  Every launch covers all M
members:

- the forward (in place of ``_rollout_kernel_b``), frames [M, T+1, H, W,
  2], by ``rollout_b_plan``: for the GS2D cell's widths
  ``rollout2d_cluster_kernel`` (csrc/cell2d.cu) with a member axis, the
  whole rollout of every member in one launch of M clusters, one a member
  (16 CTAs while the card holds all M at once, else 8); for a k x k cell
  of the widths built (k = 3 or 5, 1 to 4 branches, C <= 16)
  ``rollout2d_ffma_persistent_kernel`` (csrc/cell2d_ffma.cu) with a member
  axis, every member's rollout in one cooperative launch, n_sm // M blocks
  a member, one grid barrier a step; any other cell or field, any odd
  kernel_size <= 5, ``rollout2d_batched_kernel`` (csrc/batched2d.cu), one
  launch a step, each member's step the step of rollout2d_kernel.  At
  k > 1 every route takes the tap-by-tap form in full f32 FFMA, whatever
  cell2d.MXU_FWD_ENABLED says, as percnn_tpu's batched kernels use
  ``_pi_poly``.  At k = 1 the frames are the same bits by either route;
  at k > 1 each member's frames by the one-launch route are the single
  model's rollout2d_ffma_persistent_kernel's on that member to the bit,
  and the two routes sum in other orders (both held to the plain version
  at the forward bars);
- the streaming reverse sweep (in place of ``_phase1_kernel_b``), g_ins
  [M, T, H, W, 2] and g0 [M, H, W, 2], every member's sweep in one
  cooperative launch, n_sm // M blocks a member, one grid barrier a step:
  for a 1x1 cell of 1 to 4 branches on any field ``adj1_b_plan`` admits,
  ``adj2d_batched_persistent_kernel`` (adj2d_persistent_kernel's three
  passes with a member axis, each member's outputs that kernel's on the
  member to the bit); for a k x k cell of the widths built (k = 3 or 5, 1
  to 4 branches, C <= 16) on any field ``adj_b_plan`` admits,
  ``adj2d_batched_ffma_persistent_kernel``, full f32 FFMA (the forward's
  register-tiled product recomputes the activations from frame t in the
  block, the ys sweep's product forms zw from them; on an NVIDIA H100 80GB
  HBM3 at 700 W, 5.142 ms per T = 200 for the Burgers cell at M = 2,
  100 x 100, against 9.432 for the per-step pair); past the plans
  ``adj2d_batched_kernel``, each member's step that of adj2d_kernel (one
  launch a step at k = 1, the activation and gather pair at k > 1); the
  parameter gradients follow per member by
  ``core.rollout.chunked_param_grads``, as ``_fused_tp_b_bwd`` leaves them
  to XLA;
- the fully fused reverse sweep of a 1x1 cell (in place of
  ``_phase1_pg_kernel_b``): on any field and cell ``pg_b_plan`` admits
  (1 to 4 branches, C <= 8), ``pg2d_batched_persistent_kernel``, every
  member's sweep in one cooperative launch, n_sm // M blocks a member, each
  thread's gradient sums in registers, one partial sum a block; else
  ``pg2d_batched_kernel``, one launch a step, each member's step that of
  pg2d_kernel, the gradients in [M, A, H, W] planes.  Either way
  ``fused_phase1_pg_2d_batched`` returns (g0, sums [M, A]), which
  ``_pg_unpack`` turns into each member's gradients.

``fused_rollout_tp_2d_batched`` (forward + streaming sweep) and
``fused_rollout_tp_2d_batched_pg`` (forward + fused sweep) are the
differentiable rollouts: stacked params and h0 [M, H, W, 2] in, frames
[M, n_steps+1, H, W, 2] f32 out.

A CPU tensor takes the plain versions, loops over members of the single
model's plain sweeps (``fused_rollout_2d_batched_plain``,
``fused_phase1_2d_batched_plain``, ``fused_phase1_pg_2d_batched_plain``); a
CUDA tensor launches the kernel or raises.  Launch counters, one a launch
(each launch covers all M members), beside the steps run on the card:
``fused_rollout_2d_batched.launches`` and ``.steps`` (k = 1: one launch a
call by the clusters, none for no steps, one a step past the plan) and
``.launches_kxk`` and ``.steps_kxk`` (k > 1: the same by the one-launch
FFMA kernel and rollout2d_batched_kernel); ``fused_phase1_2d_batched.launches``
(k = 1) and ``.launches_kxk`` (k > 1), one a sweep by the persistent
kernels (none for no steps), one (k = 1) or two (k > 1) a reverse step past
their plans, beside ``.steps``;
``fused_phase1_pg_2d_batched.launches`` and ``.steps`` (one a call
by the persistent sweep, none for no steps, one a step past the plan).
"""

from __future__ import annotations

import ctypes

import torch

from percnn_tpu_torch.bridge import _map_tree
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step
from percnn_tpu_torch.core.rollout import chunked_param_grads
from percnn_tpu_torch.ops.kernels import _build, cell2d
from percnn_tpu_torch.ops.kernels.backward2d import (
    _MAX_BRANCHES,
    _cell_leaves,
    _cell_tree,
    _pg_layout,
    _ffma_sweep_b,
    _pg_unpack,
    adj_b_grid,
    adj_b_plan,
    adj_smem_bytes,
    fused_phase1_2d_plain,
    fused_phase1_pg_2d_plain,
)
from percnn_tpu_torch.ops.kernels.cell2d import (
    _MAX_PARAMS,
    _MAX_SMEM,
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
    # params, n_params, frames, frames_bar, g0, scratch, partial, M, n_steps,
    # H, W, hidden, n_branches, dt, inv_dx2, per_member, threads, stream,
    # blocks an SM (out)
    "batched2d_pg_persistent": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                                _I, _P, ctypes.POINTER(_I)],
    # n_params, H, W, hidden, n_branches, per_member, threads, blocks an SM (out)
    "batched2d_pg_occupancy": [_I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    # n_branches, kernel_size, threads, smem, blocks an SM (out)
    "batched2d_adj_ffma_occupancy": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    # params, n_params, frames, frames_bar, g0, scratch, g_ins, M, n_steps, H,
    # W, hidden, n_branches, dt, inv_dx2, per_member, stream, blocks an SM (out)
    "batched2d_adj_persistent": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                                 _I, _P, ctypes.POINTER(_I)],
    # n_params, H, W, hidden, n_branches, per_member, blocks an SM (out)
    "batched2d_adj_persistent_occupancy": [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)],
}
# pg2d_batched_persistent_kernel (csrc/batched2d.cu): the most threads of a
# block (16 warps), the widest cell it takes (2 C groups within 16 warps),
# and the floats of its end's reduction scratch (16 warps x 17).
_PG_B_THREADS = 512
_PG_B_MAX_HIDDEN = _PG_B_THREADS // 64
_PG_B_RED_FLOATS = 16 * (5 + 3 * _MAX_BRANCHES)
# adj2d_batched_persistent_kernel (csrc/batched2d.cu): adj2d_persistent_kernel's
# threads a block.
_ADJ1_B_THREADS = 512
# The cluster size rollout_b_plan takes when the card cannot hold all M
# clusters of rollout_plan's 16 CTAs at once: the largest portable size.
_CLUSTER_SMALL = 8


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


def rollout_b_smem_bytes(cfg: PiCellConfig, H: int, W: int, per_member: int) -> int:
    """Shared memory of a block of rollout2d_ffma_persistent_kernel with the
    member axis and per_member blocks a member (backward2d.adj_b_grid's
    layout): the member's forward operand (pack_ffma_fwd_2d), the tail, the
    round's im2col stack [k*k*2][rc] and the most rows a block stages (csrc
    cell2d_ffma.cu: persistent_smem on per_member blocks)."""
    grid = adj_b_grid(H, W, per_member)
    return (4 * (cell2d._ffma_fwd_floats(cfg) + cell2d._FFMA_TAIL
                 + cfg.kernel_size ** 2 * 2 * grid["rc"]) + grid["tile_bytes"])


def rollout_b_plan(M: int, H: int, W: int, cfg: PiCellConfig, held: int = 0,
                   n_sm: int = 0) -> dict:
    """The route of the member-batched frames rollout of M members on an
    H x W field, by a rule on the cell, the shape and what the card holds.

    A 1x1 cell: where cell2d.rollout_plan takes rollout2d_cluster_kernel
    (the GS2D cell's widths, strips that fit), all M members run in one
    launch of M clusters, one a member ('cluster', with n_cta, threads, smem
    and members).  `held` is how many clusters of rollout_plan's size (16
    CTAs at most) the card holds at once (cell2d.cluster_occupancy).  While
    M <= held the plan takes that size; past it, clusters of 8 CTAs (twice
    the rows a CTA), which the card holds about twice as many of, so that
    no member waits a whole rollout for a free GPC; a field whose strips of
    8 do not fit keeps the 16-CTA clusters and their waves.  The rule from
    chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W (it holds 7
    clusters of 16 CTAs and 15 of 8 at 100 x 100), T = 800, the sizes in
    turns: M = 4, one wave of 16-CTA clusters 1.742 ms against 3.366 for
    8-CTA ones; M = 8, 16-CTA clusters (two waves) 3.456 ms against 3.363
    for 8-CTA ones (one wave).

    A k x k cell of the widths the FFMA kernels are built for (k = 3 or 5,
    1 to 4 branches, C <= 16) on a card of n_sm SMs: all M members in one
    cooperative launch of rollout2d_ffma_persistent_kernel with the member
    axis ('persistent', with blocks, blocks_a_member, threads and smem),
    when every member gets at least one block (n_sm // M each, at most one
    a cell: one block an SM) and a block fits its shared memory; a block's
    cells go in the fewest rounds of at most 8 tiles of 16, the same
    number each (backward2d.adj_b_grid).  For the Burgers cell (k = 5,
    C = 16, 3 branches) at 100 x 100 on 132 SMs: M = 1, 132 blocks of 75 or
    76 cells, one round of 5 tiles (320 threads), 47 248 bytes (ffma_plan's
    grid); M = 2, 66 blocks a member of 151 or 152 cells, 2 rounds of 5
    tiles (320 threads), 48 080 bytes; M = 4, 33 of 303 or 304 cells, 3
    rounds of 7 tiles (448 threads), 56 144 bytes; M = 8, 16 of 625 (128
    blocks), 5 rounds of 8 (512 threads), 61 840 bytes; the largest square
    fields it admits are 1056 x 1056 at M = 2 and 774 x 774 at M = 4.

    Any other cell or field takes rollout2d_batched_kernel, one launch a
    step for all members ('per_step')."""
    if cfg.kernel_size > 1:
        if not cell2d._ffma_widths_ok(cfg) or not 1 <= M <= n_sm:
            return {"route": "per_step"}
        per_member = min(n_sm // M, H * W)
        smem = rollout_b_smem_bytes(cfg, H, W, per_member)
        if smem > _MAX_SMEM:
            return {"route": "per_step"}
        return {"route": "persistent", "blocks": M * per_member, "blocks_a_member": per_member,
                "threads": adj_b_grid(H, W, per_member)["threads"], "smem": smem}
    base = cell2d.rollout_plan(H, W, cfg)
    if base["route"] != "cluster" or M < 1:
        return {"route": "per_step"}
    if M > held and base["n_cta"] > _CLUSTER_SMALL:
        small = cell2d.cluster_shape(cfg, H, W, _CLUSTER_SMALL)
        if small is not None:
            return {"route": "cluster", **small, "members": M}
    return {**base, "members": M}


def pg_b_threads(cfg: PiCellConfig) -> int:
    """Threads a block of pg2d_batched_persistent_kernel: the 2 C (equation,
    hidden channel) groups, 16 // (2 C) warps each (512 for C = 8, 4 or 2;
    384 for C = 3)."""
    groups = 2 * cfg.hidden
    return 32 * groups * (_PG_B_THREADS // 32 // groups)


def pg_b_smem_bytes(cfg: PiCellConfig, H: int, W: int, per_member: int) -> int:
    """Shared memory of a block of pg2d_batched_persistent_kernel: the packed
    parameters rounded up to 4 floats, then for each of the most cells a
    block owns 6 floats of its state and 2 x 2 C shares of the Jacobian's
    transpose, then the reduction's 272 floats (csrc: pg_b_smem_bytes).  No
    accumulator: the sums live in registers."""
    cap = -(-(H * W) // per_member)
    n_params = 2 + 2 * _param_block(cfg)
    return 4 * (-(-n_params // 4) * 4 + (6 + 4 * cfg.hidden) * cap + _PG_B_RED_FLOATS)


def pg_b_plan(M: int, H: int, W: int, cfg: PiCellConfig, n_sm: int) -> dict:
    """The route of the member-batched fused reverse sweep of M members on an
    H x W field on a card of n_sm SMs, by a rule on the cell, the shape and
    the card's limits: a 1x1 cell of 1 to 4 branches and C <= 8 takes
    pg2d_batched_persistent_kernel, one cooperative launch a sweep
    ('persistent', with blocks, blocks_a_member, threads and smem), when
    every member gets at least one block of the n_sm (n_sm // M each, at
    most one a cell: one block an SM) and a block's scratch fits its shared
    memory; else pg2d_batched_kernel, one launch a step ('per_step').  At
    100 x 100 on 132 SMs: M = 1, 132 blocks of 75 or 76 cells, 13 296
    bytes; M = 4, 33 blocks a member of 303 or 304 cells, 47 952 bytes;
    M = 8, 16 of 625, 96 744 bytes."""
    if (cfg.kernel_size != 1 or not 1 <= cfg.n_branches <= _MAX_BRANCHES
            or not 1 <= cfg.hidden <= _PG_B_MAX_HIDDEN or not 1 <= M <= n_sm):
        return {"route": "per_step"}
    per_member = min(n_sm // M, H * W)
    smem = pg_b_smem_bytes(cfg, H, W, per_member)
    if smem > _MAX_SMEM:
        return {"route": "per_step"}
    return {"route": "persistent", "blocks": M * per_member, "blocks_a_member": per_member,
            "threads": pg_b_threads(cfg), "smem": smem}


def adj1_b_plan(M: int, H: int, W: int, cfg: PiCellConfig, n_sm: int) -> dict:
    """The route of the member-batched 1x1 streaming sweep of M members on
    an H x W field on a card of n_sm SMs, by a rule on the cell, the shape
    and the card's limits: a 1x1 cell of 1 to 4 branches and at most 256
    hidden channels (a thread for each of the 2 C groups of a block's 512)
    takes adj2d_batched_persistent_kernel, one cooperative launch a sweep for all
    members ('persistent', with blocks, blocks_a_member, threads and smem),
    when every member gets at least one block of the n_sm (n_sm // M each,
    at most one a cell: one block an SM) and a block (the packed parameters
    and 6 + 4 C floats a cell of its share: backward2d.adj_smem_bytes) fits
    its shared memory; else adj2d_batched_kernel, one launch a step
    ('per_step').  For the GS2D cell (C = 8) at 100 x 100 on 132 SMs: M = 4,
    33 blocks a member of 303 or 304 cells, 46 864 bytes; M = 8, 16 of 625,
    95 656 bytes; the largest square fields it admits are 224 x 224 at M = 4
    and 156 x 156 at M = 8."""
    if (cfg.kernel_size != 1 or not 1 <= cfg.n_branches <= _MAX_BRANCHES
            or not 1 <= 2 * cfg.hidden <= _ADJ1_B_THREADS or not 1 <= M <= n_sm):
        return {"route": "per_step"}
    per_member = min(n_sm // M, H * W)
    smem = adj_smem_bytes(cfg, H, W, per_member)
    if smem > _MAX_SMEM:
        return {"route": "per_step"}
    return {"route": "persistent", "blocks": M * per_member, "blocks_a_member": per_member,
            "threads": _ADJ1_B_THREADS, "smem": smem}


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


def _check_rollout_inputs(name, packed, h0, cfg, n_steps):
    _check_inputs(name, packed, h0, cfg, any_branches=cfg.kernel_size == 1)
    if h0.dim() != 4 or n_steps < 0:
        raise ValueError(f"h0 must be [M, H, W, 2] and n_steps >= 0, got "
                         f"{tuple(h0.shape)} and {n_steps}")


def _rollout_b_steps_cuda(packed, h0, cfg, n_steps):
    """rollout2d_batched_kernel: one launch a step for all members, the loop in C."""
    fn = _kernel_fn("batched2d_rollout")
    _check_rollout_inputs("rollout2d_batched_kernel", packed, h0, cfg, n_steps)
    M, H, W = h0.shape[0], h0.shape[1], h0.shape[2]
    frames = torch.empty((M, n_steps + 1, H, W, 2), dtype=torch.float32, device=h0.device)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.shape[1], h0.data_ptr(), frames.data_ptr(),
                           M, n_steps, H, W, cfg.hidden, cfg.n_branches, cfg.kernel_size,
                           cfg.dt, 1.0 / (cfg.dx * cfg.dx), stream), "batched2d_rollout")
    if cfg.kernel_size == 1:
        fused_rollout_2d_batched.launches += n_steps
        fused_rollout_2d_batched.steps += n_steps
    else:
        fused_rollout_2d_batched.launches_kxk += n_steps
        fused_rollout_2d_batched.steps_kxk += n_steps
    return frames


def _rollout_b_ffma_cuda(packed, h0, cfg, n_steps):
    """rollout2d_ffma_persistent_kernel with the member axis: every member's
    k x k rollout in one cooperative launch, by rollout_b_plan's
    configuration, full f32 FFMA whatever cell2d.MXU_FWD_ENABLED says.  No
    launch at n_steps = 0 (frame 0 is a copy of h0).  Raises if the plan
    refuses the shape or the card cannot hold the grid."""
    _check_rollout_inputs("rollout2d_ffma_persistent_kernel", packed, h0, cfg, n_steps)
    M, H, W = h0.shape[0], h0.shape[1], h0.shape[2]
    plan = rollout_b_plan(M, H, W, cfg, n_sm=cell2d._sm_count(h0.device))
    if plan["route"] != "persistent":
        raise ValueError(f"{M} members of a {H} x {W} field take no one-launch rollout: {cfg}")
    fn = cell2d._kernel_fn("cell2d_ffma_rollout_members", "cell2d_ffma")
    members = [packed[m] for m in range(M)]
    wf = torch.stack([cell2d.pack_ffma_fwd_2d(p, cfg) for p in members]).contiguous()
    tail = torch.stack([cell2d.pack_ffma_tail_2d(p, cfg) for p in members]).contiguous()
    frames = torch.empty((M, n_steps + 1, H, W, 2), dtype=torch.float32, device=h0.device)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(wf.data_ptr(), tail.data_ptr(), h0.data_ptr(), frames.data_ptr(), M,
                           n_steps, H, W, cfg.n_branches, cfg.kernel_size, cfg.dt,
                           1.0 / (cfg.dx * cfg.dx), plan["blocks_a_member"], plan["threads"],
                           plan["smem"], stream, ctypes.byref(per_sm)),
                        "cell2d_ffma_rollout_members")
    fused_rollout_2d_batched.launches_kxk += 1 if n_steps else 0
    fused_rollout_2d_batched.steps_kxk += n_steps
    return frames


def rollout_b_occupancy(cfg: PiCellConfig, M: int, H: int, W: int,
                        device: torch.device) -> int:
    """How many blocks of rollout_b_plan's k x k configuration an SM of the
    card holds."""
    return cell2d.ffma_occupancy(
        cfg, H, W, device, plan=rollout_b_plan(M, H, W, cfg, n_sm=cell2d._sm_count(device)),
        fn_name="cell2d_ffma_members_occupancy")


def _clusters_held(cfg, H, W) -> int:
    """How many clusters of rollout_plan's size the current card holds at once."""
    return cell2d.cluster_occupancy(cfg, H, W)


def _rollout_b_cluster_cuda(packed, h0, cfg, n_steps, n_cta=None):
    """rollout2d_cluster_kernel with a member axis: every member's rollout in
    one launch of M clusters, by rollout_b_plan's configuration (or, given
    n_cta, cell2d.cluster_shape's).  No launch at n_steps = 0 (frame 0 is a
    copy of h0).  Raises if the card cannot hold one cluster."""
    fn = cell2d._kernel_fn("cell2d_rollout_cluster")
    _check_rollout_inputs("rollout2d_cluster_kernel", packed, h0, cfg, n_steps)
    M, H, W = h0.shape[0], h0.shape[1], h0.shape[2]
    plan = rollout_b_plan(M, H, W, cfg, _clusters_held(cfg, H, W))
    if plan["route"] == "cluster" and n_cta is not None:
        plan = {**plan, **(cell2d.cluster_shape(cfg, H, W, n_cta) or {"route": "per_step"})}
    if plan["route"] != "cluster":
        raise ValueError(f"a {H} x {W} field of this cell takes no cluster of "
                         f"{n_cta or 'any'} CTAs: {cfg}")
    frames = torch.empty((M, n_steps + 1, H, W, 2), dtype=torch.float32, device=h0.device)
    if n_steps == 0:
        frames[:, 0].copy_(h0)
        return frames
    clusters = ctypes.c_int(0)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.shape[1], h0.data_ptr(), frames.data_ptr(),
                           n_steps, 0, H, W, cfg.hidden, cfg.n_branches, cfg.dt,
                           1.0 / (cfg.dx * cfg.dx), plan["n_cta"], plan["threads"], M, stream,
                           ctypes.byref(clusters)), "cell2d_rollout_cluster")
    fused_rollout_2d_batched.launches += 1
    fused_rollout_2d_batched.steps += n_steps
    return frames


def _rollout_b_cuda(packed, h0, cfg, n_steps):
    """The member-batched frames rollout on CUDA by rollout_b_plan's route:
    at k = 1 one launch of M clusters of rollout2d_cluster_kernel
    ('cluster'), at k > 1 one cooperative launch of
    rollout2d_ffma_persistent_kernel with the member axis ('persistent'),
    else one rollout2d_batched_kernel launch a step ('per_step')."""
    if h0.dim() == 4:
        M, H, W = h0.shape[0], h0.shape[1], h0.shape[2]
        if cfg.kernel_size == 1 and cell2d.rollout_plan(H, W, cfg)["route"] == "cluster":
            return _rollout_b_cluster_cuda(packed, h0, cfg, n_steps)
        if cfg.kernel_size > 1 and h0.device.type == "cuda" and rollout_b_plan(
                M, H, W, cfg, n_sm=cell2d._sm_count(h0.device))["route"] == "persistent":
            return _rollout_b_ffma_cuda(packed, h0, cfg, n_steps)
    return _rollout_b_steps_cuda(packed, h0, cfg, n_steps)


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


def _phase1_b_steps_cuda(packed, frames, frames_bar, cfg):
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
    fused_phase1_2d_batched.steps += n_steps
    return g_ins, g


def _phase1_b_persistent_cuda(packed, frames, frames_bar, cfg):
    """adj2d_batched_persistent_kernel: the 1x1 streaming sweep of every
    member in one cooperative launch, by adj1_b_plan's configuration;
    (g_ins, g0).  No launch at n_steps = 0.  Raises if the card cannot hold
    the grid."""
    frames_bar, (M, n_steps, H, W) = _sweep_shapes("adj2d_batched_persistent_kernel", packed,
                                                   frames, frames_bar, cfg)
    dev = frames.device
    plan = adj1_b_plan(M, H, W, cfg, cell2d._sm_count(dev))
    if plan["route"] != "persistent":
        raise ValueError(f"{M} members of a {H} x {W} field take no one-launch sweep: {cfg}")
    fn = _kernel_fn("batched2d_adj_persistent")
    g0 = torch.zeros((M, H, W, 2), dtype=torch.float32, device=dev)
    scratch = torch.zeros_like(g0)
    g_ins = torch.empty((M, n_steps, H, W, 2), dtype=torch.float32, device=dev)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.shape[1], frames.data_ptr(),
                           frames_bar.data_ptr(), g0.data_ptr(), scratch.data_ptr(),
                           g_ins.data_ptr(), M, n_steps, H, W, cfg.hidden, cfg.n_branches,
                           cfg.dt, 1.0 / (cfg.dx * cfg.dx), plan["blocks_a_member"], stream,
                           ctypes.byref(per_sm)), "batched2d_adj_persistent")
    fused_phase1_2d_batched.launches += 1 if n_steps else 0
    fused_phase1_2d_batched.steps += n_steps
    return g_ins, g0


def adj1_b_occupancy(cfg: PiCellConfig, M: int, H: int, W: int, device: torch.device) -> int:
    """How many blocks of adj1_b_plan's configuration an SM of the card holds."""
    plan = adj1_b_plan(M, H, W, cfg, cell2d._sm_count(device))
    if plan["route"] != "persistent":
        raise ValueError(f"{M} members of a {H} x {W} field take no one-launch sweep: {cfg}")
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise_on_error(_kernel_fn("batched2d_adj_persistent_occupancy")(
            2 + 2 * _param_block(cfg), H, W, cfg.hidden, cfg.n_branches,
            plan["blocks_a_member"], ctypes.byref(per_sm)), "batched2d_adj_persistent_occupancy")
    return per_sm.value


def _phase1_b_ffma_persistent_cuda(packed, frames, frames_bar, cfg):
    """adj2d_batched_ffma_persistent_kernel: the k x k streaming sweep of
    every member in one cooperative launch (backward2d._ffma_sweep_b, by
    adj_b_plan's configuration); (g_ins, g0).  No launch at n_steps = 0."""
    frames_bar, (M, n_steps, H, W) = _sweep_shapes("adj2d_batched_ffma_persistent_kernel",
                                                   packed, frames, frames_bar, cfg)
    g_ins, g = _ffma_sweep_b(packed, frames, frames_bar, cfg)
    fused_phase1_2d_batched.launches_kxk += 1 if n_steps else 0
    fused_phase1_2d_batched.steps += n_steps
    return g_ins, g


def adj_b_occupancy(cfg: PiCellConfig, M: int, H: int, W: int, device: torch.device) -> int:
    """How many blocks of adj_b_plan's configuration an SM of the card holds."""
    plan = adj_b_plan(M, H, W, cfg, cell2d._sm_count(device))
    if plan["route"] != "persistent":
        raise ValueError(f"{M} members of a {H} x {W} field take no one-launch sweep: {cfg}")
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise_on_error(_kernel_fn("batched2d_adj_ffma_occupancy")(
            cfg.n_branches, cfg.kernel_size, plan["threads"], plan["smem"],
            ctypes.byref(per_sm)), "batched2d_adj_ffma_occupancy")
    return per_sm.value


def _phase1_b_cuda(packed, frames, frames_bar, cfg):
    """The member-batched streaming sweep on CUDA: at k = 1 by adj1_b_plan's
    route, one launch of adj2d_batched_persistent_kernel ('persistent') or
    one adj2d_batched_kernel launch a step ('per_step'); at k > 1 by
    adj_b_plan's, one launch of adj2d_batched_ffma_persistent_kernel
    ('persistent') or two, adj2d_batched_act_kernel and
    adj2d_batched_gather_kernel, a step ('per_step')."""
    if frames.dim() == 5 and frames.device.type == "cuda":
        M, H, W = frames.shape[0], frames.shape[2], frames.shape[3]
        n_sm = cell2d._sm_count(frames.device)
        if cfg.kernel_size == 1 and adj1_b_plan(M, H, W, cfg, n_sm)["route"] == "persistent":
            return _phase1_b_persistent_cuda(packed, frames, frames_bar, cfg)
        if adj_b_plan(M, H, W, cfg, n_sm)["route"] == "persistent":
            return _phase1_b_ffma_persistent_cuda(packed, frames, frames_bar, cfg)
    return _phase1_b_steps_cuda(packed, frames, frames_bar, cfg)


def _pg_b_steps_cuda(packed, frames, frames_bar, cfg):
    """pg2d_batched_kernel: one launch a reverse step for all members, the
    loop in C; (g0, acc [M, A, H, W] planes)."""
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
    fused_phase1_pg_2d_batched.steps += n_steps
    return g0, acc


def _pg_b_persistent_cuda(packed, frames, frames_bar, cfg):
    """pg2d_batched_persistent_kernel: the sweep of every member in one
    cooperative launch, by pg_b_plan's configuration; (g0, sums [M, A]), the
    sum of the blocks' partial sums.  No launch at n_steps = 0.  Raises if
    the card cannot hold the grid."""
    fn = _kernel_fn("batched2d_pg_persistent")
    frames_bar, (M, n_steps, H, W) = _sweep_shapes("pg2d_batched_persistent_kernel", packed,
                                                   frames, frames_bar, cfg)
    dev = frames.device
    plan = pg_b_plan(M, H, W, cfg, cell2d._sm_count(dev))
    if plan["route"] != "persistent":
        raise ValueError(f"{M} members of a {H} x {W} field take no persistent sweep: {cfg}")
    g0 = torch.zeros((M, H, W, 2), dtype=torch.float32, device=dev)
    scratch = torch.zeros_like(g0)
    partial = torch.empty((M, _pg_layout(cfg)["A"], plan["blocks_a_member"]),
                          dtype=torch.float32, device=dev)
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(packed.data_ptr(), packed.shape[1], frames.data_ptr(),
                           frames_bar.data_ptr(), g0.data_ptr(), scratch.data_ptr(),
                           partial.data_ptr(), M, n_steps, H, W, cfg.hidden, cfg.n_branches,
                           cfg.dt, 1.0 / (cfg.dx * cfg.dx), plan["blocks_a_member"],
                           plan["threads"], stream, ctypes.byref(per_sm)),
                        "batched2d_pg_persistent")
    fused_phase1_pg_2d_batched.launches += 1 if n_steps else 0
    fused_phase1_pg_2d_batched.steps += n_steps
    return g0, partial.sum(-1)


def pg_b_occupancy(cfg: PiCellConfig, M: int, H: int, W: int, device: torch.device) -> int:
    """How many blocks of pg_b_plan's configuration an SM of the card holds."""
    plan = pg_b_plan(M, H, W, cfg, cell2d._sm_count(device))
    if plan["route"] != "persistent":
        raise ValueError(f"{M} members of a {H} x {W} field take no persistent sweep")
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise_on_error(_kernel_fn("batched2d_pg_occupancy")(
            2 + 2 * _param_block(cfg), H, W, cfg.hidden, cfg.n_branches,
            plan["blocks_a_member"], plan["threads"], ctypes.byref(per_sm)),
            "batched2d_pg_occupancy")
    return per_sm.value


def _pg_b_cuda(packed, frames, frames_bar, cfg):
    """The member-batched fused sweep on CUDA by pg_b_plan's route, (g0,
    sums [M, A]): one cooperative launch of pg2d_batched_persistent_kernel
    ('persistent'), or one pg2d_batched_kernel launch a step ('per_step'),
    its planes summed here."""
    if frames.dim() == 5 and frames.device.type == "cuda" and pg_b_plan(
            frames.shape[0], frames.shape[2], frames.shape[3], cfg,
            cell2d._sm_count(frames.device))["route"] == "persistent":
        return _pg_b_persistent_cuda(packed, frames, frames_bar, cfg)
    g0, acc = _pg_b_steps_cuda(packed, frames, frames_bar, cfg)
    return g0, acc.sum((2, 3))


def fused_rollout_2d_batched(packed: torch.Tensor, h0: torch.Tensor, cfg: PiCellConfig,
                             n_steps: int) -> torch.Tensor:
    """Frames [M, n_steps+1, H, W, 2] of every member from packed [M, P] and
    h0 [M, H, W, 2]: _rollout_b_cuda's kernel on CUDA, the plain version on
    the CPU."""
    if h0.device.type == "cpu":
        return fused_rollout_2d_batched_plain(packed, h0, cfg, n_steps)
    return _rollout_b_cuda(packed, h0, cfg, n_steps)


def fused_phase1_2d_batched(packed, frames, frames_bar, cfg):
    """(g_ins, g0): _phase1_b_cuda's kernel on CUDA, the plain version on the
    CPU."""
    if frames.device.type == "cpu":
        return fused_phase1_2d_batched_plain(packed, frames, frames_bar.to(torch.float32), cfg)
    return _phase1_b_cuda(packed, frames, frames_bar, cfg)


def fused_phase1_pg_2d_batched(packed, frames, frames_bar, cfg):
    """(g0 [M, H, W, 2] without frames_bar[:, 0], sums [M, A]: each member's
    gradient sums over its cells and steps, before _pg_unpack):
    pg_b_plan's kernel on CUDA, the plain version's planes summed on the
    CPU."""
    if frames.device.type == "cpu":
        g0, acc = fused_phase1_pg_2d_batched_plain(packed, frames, frames_bar.to(torch.float32),
                                                   cfg)
        return g0, acc.sum((2, 3))
    return _pg_b_cuda(packed, frames, frames_bar, cfg)


class FusedRolloutTP2dBatched(torch.autograd.Function):
    """frames = every member's rollout by _rollout_b_cuda's route; backward
    by _phase1_b_cuda's sweep, then each member's parameter gradients by
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
        g0, sums = fused_phase1_pg_2d_batched(packed, frames, frames_bar, ctx.cfg)
        d_packed = torch.stack([_pg_unpack(sums[m], packed[m], ctx.cfg)
                                for m in range(packed.shape[0])])
        return d_packed, g0 + frames_bar[:, 0], None, None


def fused_rollout_tp_2d_batched(params: dict, h0: torch.Tensor, cfg: PiCellConfig,
                                n_steps: int, pgrad_chunk: int = 64) -> torch.Tensor:
    """Differentiable member-batched rollout of a 2D cell, any odd
    kernel_size <= 5: stacked params (a leading member axis M on every leaf)
    and h0 [M, H, W, 2] -> [M, n_steps+1, H, W, 2] f32.  The forward
    (_rollout_b_cuda's route) and the streaming sweep (_phase1_b_cuda's: one
    launch a call within the plans) for all members on CUDA, their plain
    versions on the CPU; pgrad_chunk is
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
fused_rollout_2d_batched.steps = 0
fused_rollout_2d_batched.launches_kxk = 0
fused_rollout_2d_batched.steps_kxk = 0
fused_phase1_2d_batched.launches = 0
fused_phase1_2d_batched.launches_kxk = 0
fused_phase1_2d_batched.steps = 0
fused_phase1_pg_2d_batched.launches = 0
fused_phase1_pg_2d_batched.steps = 0
