"""Fused 2D Pi-cell rollout: CUDA kernels for Hopper and their plain versions.

Counterpart of percnn_tpu/ops/pallas/cell2d.py.  ``fused_rollout_2d``
streams every frame of a 1x1 cell (the GS2D model) through
``rollout2d_cluster_kernel`` (in place of ``_rollout_kernel``): the whole
rollout in one launch of one thread-block cluster that holds the field in
shared memory, as the TPU kernel holds it on chip, for any field that fits
(``rollout_plan``; the kernel is compiled for the GS2D cell's widths).  A
k x k cell (k = 3 or 5: the Burgers and lambda-omega Stage-1 models) with
``MXU_FWD_ENABLED`` off takes ``rollout2d_ffma_persistent_kernel``, the
whole rollout in one cooperative launch, its branch convs tap by tap in
FFMA from a register tile of 4 cells x 2 hidden channels a thread, for any
field and cell ``ffma_plan`` admits.  Any other field or cell takes
``rollout2d_kernel``, one launch a step, which takes the packed parameters
and any odd kernel_size <= 5: a 1x1 cell one thread a cell, a k x k cell
from a block's staged tile.  With ``MXU_FWD_ENABLED`` on (the default) a
k x k cell goes instead to ``fused_rollout_kxk_2d``, the
branch convs as one product with the branch matrix (in place of
``_rollout_kernel_mxu``): ``rollout2d_kxk_persistent_kernel``, the whole
rollout in one cooperative launch with the product on the tensor cores in
3xTF32, for any field and cell ``kxk_plan`` admits, else
``rollout2d_kxk_kernel``, one launch a step in FFMA.
``fused_rollout_final_2d`` returns the final state of any cell (in place of
``_final_kernel``) by ``final_plan``'s route: the same three one-launch
kernels in their final-state mode, which stores no frame and gives the last
frame to the bit (rollout2d_cluster_kernel for the GS2D cell's fields,
rollout2d_kxk_persistent_kernel for a k x k cell with ``MXU_FWD_ENABLED``,
rollout2d_ffma_persistent_kernel without), else ``final2d_kernel``, one
launch a step.  The kernels are in csrc/cell2d.cu, csrc/cell2d_kxk.cu (+
csrc/kxk_mma.cuh) and csrc/cell2d_ffma.cu, with their bound on the card and
their design.

A CPU tensor takes the plain PyTorch version of the same arithmetic
(``fused_rollout_2d_plain``, ``fused_rollout_final_2d_plain``,
``fused_rollout_kxk_2d_plain``); a CUDA tensor launches the kernel or
raises.  Each public wrapper counts the kernel launches it makes, one a
call by a one-launch kernel (none for no steps, but for the cluster's
frames), one a step otherwise, beside the steps run on the card:
``fused_rollout_2d.launches`` and ``.steps`` for a 1x1 cell;
``fused_rollout_2d.launches_kxk`` and ``.steps_kxk`` for a k x k cell from
the packed parameters (rollout2d_ffma_persistent_kernel or the k x k
contract of rollout2d_kernel); ``fused_rollout_kxk_2d.launches`` and
``.steps``;
``fused_rollout_final_2d.launches`` and ``.steps`` for a 1x1 cell,
``.launches_kxk`` and ``.steps_kxk`` for a k x k one.
"""

from __future__ import annotations

import ctypes
import os

import torch

from percnn_tpu_torch.core.cell import PiCellConfig, effective_diffusion
from percnn_tpu_torch.ops.kernels import _build
from percnn_tpu_torch.ops.stencils import laplacian_2d

MXU_FWD_ENABLED = os.environ.get("PERCNN_DISABLE_MXU", "") != "1"
"""Route a k x k rollout of ``fused_rollout_2d`` (and the forward of
backward2d.fused_rollout_tp_2d, and the final state) through the branch
matrix product (kxk_plan's kernels); off, through the tap-by-tap form
(ffma_plan's: rollout2d_ffma_persistent_kernel, or rollout2d_kernel).  Read
from PERCNN_DISABLE_MXU=1 at import, as percnn_tpu does, and looked up at
every call, so a caller may set it in-process."""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # params, n_params, h0, frames, n_steps, H, W, hidden, n_branches,
    # kernel_size, dt, inv_dx2, stream
    "cell2d_rollout": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    # params, n_params, h0, out, scratch, n_steps, H, W, hidden, n_branches,
    # kernel_size, dt, inv_dx2, stream
    "cell2d_final": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    # wmat, tail, h0, frames, n_steps, H, W, hidden, n_branches, kernel_size,
    # dt, inv_dx2, stream
    "cell2d_kxk_rollout": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    # params, n_params, h0, frames (or out), n_steps, final_only, H, W, hidden,
    # n_branches, dt, inv_dx2, n_cta, threads, members, stream, clusters (out)
    "cell2d_rollout_cluster": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _P,
                               ctypes.POINTER(_I)],
    # H, W, n_cta, threads, clusters (out)
    "cell2d_cluster_occupancy": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    # bfrag, tail, h0, frames (or out), scratch, n_steps, final_only, H, W,
    # hidden, n_branches, kernel_size, ch, dt, inv_dx2, blocks, threads, smem,
    # stream, blocks an SM (out)
    "cell2d_kxk_rollout_persistent": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                      _F, _I, _I, _I, _P, ctypes.POINTER(_I)],
    # n_branches, kernel_size, ch, threads, smem, blocks an SM (out)
    "cell2d_kxk_occupancy": [_I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    # wf, tail, h0, frames (or out), scratch, n_steps, final_only, H, W,
    # n_branches, kernel_size, dt, inv_dx2, blocks, threads, smem, stream,
    # blocks an SM (out)
    "cell2d_ffma_rollout_persistent": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                                       _I, _I, _P, ctypes.POINTER(_I)],
    # n_branches, kernel_size, threads, smem, blocks an SM (out)
    "cell2d_ffma_occupancy": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    # wf [M, ...], tail [M, 36], h0, frames, M, n_steps, H, W, n_branches,
    # kernel_size, dt, inv_dx2, per_member, threads, smem, stream, blocks an SM (out)
    "cell2d_ffma_rollout_members": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I,
                                    _P, ctypes.POINTER(_I)],
}
_SIGNATURES["cell2d_ffma_members_occupancy"] = _SIGNATURES["cell2d_ffma_occupancy"]
# rollout2d_kernel and final2d_kernel stage the packed parameters in shared
# memory, at most 48 KB of them (4932 floats for the Burgers cell); the
# branch-matrix kernels stage the matrix instead (_kxk_smem_bytes).
_MAX_PARAMS = 48 * 1024 // 4


# A block's dynamic shared memory on an H100 (cudaFuncSetAttribute's ceiling).
_MAX_SMEM = 227 * 1024
# rollout2d_cluster_kernel (csrc/cell2d.cu): the most CTAs of one cluster on
# an H100 (16, a non-portable size), the most threads of a CTA, the cells a
# thread takes at once, and the cell widths (hidden, n_branches) it is
# compiled for, the GS2D cell's.
_CLUSTER_MAX = 16
_CLUSTER_THREADS = 512
_CLUSTER_CELLS = 2
_CLUSTER_WIDTHS = (8, 3)


def split_evenly(n: int, parts: int) -> list[tuple[int, int]]:
    """(start, count) of each of `parts` consecutive runs that cover
    range(n) once, the first n % parts one longer: the rows each CTA of
    rollout2d_cluster_kernel owns, and the cells each block of
    pg2d_persistent_kernel owns (csrc: strip_of, the persistent kernel's
    split)."""
    if n < 0 or parts < 1:
        raise ValueError(f"cannot split {n} into {parts} parts")
    q, m = divmod(n, parts)
    return [(r * q + min(r, m), q + (1 if r < m else 0)) for r in range(parts)]


def cluster_smem_bytes(cfg: PiCellConfig, H: int, W: int, n_cta: int) -> int:
    """Shared memory of a CTA of rollout2d_cluster_kernel: the packed
    parameters staged with each equation's block at a 16-byte boundary
    (4 + 2 round_up(block, 4) floats: 172 for the GS2D cell) and two
    [rows_max + 4, W] float2 buffers of its strip and the 2-row halos
    (csrc: cluster_smem_bytes)."""
    rows_max = -(-H // n_cta)
    return 4 * (4 + 2 * _round_up(_param_block(cfg), 4)) + 2 * (rows_max + 4) * W * 8


def cluster_shape(cfg: PiCellConfig, H: int, W: int, n_cta: int) -> dict | None:
    """A cluster of n_cta CTAs of rollout2d_cluster_kernel on an H x W
    field: its threads (two cells of the tallest strip a thread, up to 512)
    and bytes a CTA, or None where a strip would be under 2 rows or the
    bytes pass a block's shared memory."""
    if n_cta < 1 or 2 * n_cta > H:
        return None
    smem = cluster_smem_bytes(cfg, H, W, n_cta)
    if smem > _MAX_SMEM:
        return None
    strip_cells = -(-H // n_cta) * W
    threads = min(_CLUSTER_THREADS, _round_up(-(-strip_cells // _CLUSTER_CELLS), 32))
    return {"n_cta": n_cta, "threads": threads, "smem": smem}


def rollout_plan(H: int, W: int, cfg: PiCellConfig) -> dict:
    """The route of a frames rollout of an H x W field on CUDA, by a rule on
    the cell, the shape and the card's limits: a 1x1 cell of the widths the
    cluster kernel is compiled for (C = 8, 3 branches: GS2D's) whose strips
    fit the shared memory of one cluster of min(16, H // 2) CTAs (so that
    every strip has the 2 rows a neighbour's halo takes) takes
    rollout2d_cluster_kernel, one launch a rollout ('cluster', with n_cta,
    threads and smem); any other cell or field, one row high included,
    takes rollout2d_kernel, one launch a step ('per_step').  A thread takes
    two cells of its strip at once.  At 100 x 100 the cluster is 16 CTAs
    of 6 or 7 rows, 18 288 bytes and 352 threads each; the largest square
    field that fits is 448 x 448."""
    if cfg.kernel_size != 1 or (cfg.hidden, cfg.n_branches) != _CLUSTER_WIDTHS or H < 2:
        return {"route": "per_step"}
    shape = cluster_shape(cfg, H, W, min(_CLUSTER_MAX, H // 2))
    return {"route": "per_step"} if shape is None else {"route": "cluster", **shape}


def _param_block(cfg: PiCellConfig) -> int:
    """Per-output-channel length of the packed parameter vector."""
    wsize = cfg.kernel_size ** 2 * cfg.channels * cfg.hidden
    return cfg.n_branches * (wsize + cfg.hidden) + cfg.hidden + 1


def pack_pi_params_2d(params: dict, cfg: PiCellConfig) -> torch.Tensor:
    """Flatten cell params to one f32 vector, the layout of percnn_tpu's.

    [Du, Dv] then per output channel: per branch (w_i row-major, [2, C] for
    a 1x1 cell and [k, k, 2, C] for a k x k one, then b_i [C]), then w_out
    [C], b_out [1].  The diffusion reparametrisation (mu_up * sigmoid) is
    applied here, so the kernel sees plain coefficients.  164 floats for
    the GS2D cell, 4932 for the Burgers cell.
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
    if cfg.kernel_size % 2 == 0 or cfg.kernel_size > 5:
        raise NotImplementedError(f"the fused 2D kernels take odd kernel_size <= 5, "
                                  f"got {cfg.kernel_size}")


def n_taps(cfg: PiCellConfig) -> int:
    """im2col rows of a k x k cell: k*k taps x 2 channels, plus a ones row
    that folds the branch biases into the product."""
    return cfg.kernel_size ** 2 * 2 + 1


def mxu_rows(cfg: PiCellConfig) -> int:
    """Rows M of the branch matrix: one per (equation, branch, hidden channel)."""
    return cfg.channels * cfg.n_branches * cfg.hidden


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pack_pi_matrix_2d(params: dict, cfg: PiCellConfig) -> torch.Tensor:
    """The branch convs of a k x k cell as one [M, K] f32 matrix.

    Row (o*nb + i)*C + c holds branch i of equation o, hidden channel c:
    column (ki*k + kj)*2 + cin is its conv tap, column k*k*2 its bias (the
    ones row of the im2col stack) and the columns up to K, the next
    multiple of 8, are zero.  The layout of percnn_tpu's.
    """
    k, C, nb = cfg.kernel_size, cfg.hidden, cfg.n_branches
    K = _round_up(n_taps(cfg), 8)
    blocks = []
    for o in range(cfg.channels):
        br = params["pi"][o]
        for i in range(nb):
            w = br[f"w{i}"].to(torch.float32).reshape(k, k, 2, C)
            b = br[f"b{i}"].to(torch.float32).reshape(C, 1)
            pad = torch.zeros((C, K - k * k * 2 - 1), dtype=torch.float32, device=w.device)
            blocks.append(torch.cat([w.movedim(-1, 0).reshape(C, k * k * 2), b, pad], dim=1))
    return torch.cat(blocks, dim=0)


def _padded_matrix(wmat: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """[2 nb C8, K]: wmat's rows with C padded to C8 = 8 ceil(C / 8) by zero
    rows, row (o nb + i) C8 + c."""
    C, nb = cfg.hidden, cfg.n_branches
    C8 = _round_up(C, 8)
    w = wmat.reshape(2 * nb, C, wmat.shape[-1])
    return torch.cat([w, w.new_zeros((2 * nb, C8 - C, wmat.shape[-1]))], dim=1).reshape(
        2 * nb * C8, wmat.shape[-1])


def pack_mma_fwd_2d(wmat: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """The branch matrix as the B operand of the forward's m16n8k8 product
    y^T = im2col^T Wm^T (csrc/kxk_mma.cuh), in fragment order: [K / 8,
    2 nb C8 / 8, 32, 2] f32, entry [ks, n, lane, h] = Wm_pad[8 n + lane // 4,
    8 ks + lane % 4 + 4 h] (Wm_pad: _padded_matrix, K = wmat's columns).
    A permutation of pack_pi_matrix_2d's entries and zeros."""
    w = _padded_matrix(wmat, cfg)                    # [J, K], j = 8 n + g, k = 8 ks + 4 h + t
    J, K = w.shape
    return w.reshape(J // 8, 8, K // 8, 2, 4).permute(2, 0, 1, 4, 3).reshape(
        K // 8, J // 8, 32, 2).contiguous()


def pack_mma_adj_2d(wmat: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """The tap columns of the branch matrix as the B operand of the adjoint's
    product zw^T = z^T Wm_taps, in fragment order: [2 nb C8 / 8, Q / 8, 32, 2]
    f32 (Q the k*k*2 taps padded to 8), entry [js, n, lane, h] =
    Wm_pad[8 js + 2 (lane % 4) + h, 8 n + lane // 4]: within each group of 8
    rows the order 0, 2, 4, 6, 1, 3, 5, 7, so that the A operand is z^T as
    the forward product's accumulator holds it (A's column t is the
    accumulator's column 2 t, column t + 4 its 2 t + 1)."""
    taps = cfg.kernel_size ** 2 * 2
    Q = _round_up(taps, 8)
    w = _padded_matrix(wmat, cfg)[:, :taps]
    w = torch.cat([w, w.new_zeros((w.shape[0], Q - taps))], dim=1)   # [J, Q]
    J = w.shape[0]
    # j = 8 js + 2 t + h, q = 8 n + g
    return w.reshape(J // 8, 4, 2, Q // 8, 8).permute(0, 3, 4, 1, 2).reshape(
        J // 8, Q // 8, 32, 2).contiguous()


def pi_tail_2d(params: dict, cfg: PiCellConfig) -> torch.Tensor:
    """What the k x k kernels read besides the matrix, f32: [Du, Dv] (after
    the diffusion reparametrisation), w_out of equations 0 and 1 [C each],
    then b_out of equations 0 and 1."""
    pi = params["pi"]
    parts = ([effective_diffusion(params, cfg)] + [pi[o]["w_out"] for o in range(2)]
             + [pi[o]["b_out"] for o in range(2)])
    return torch.cat([t.reshape(-1).to(torch.float32) for t in parts])


def im2col_2d(h: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """[..., H, W, 2] -> [..., H, W, K]: the k x k neighbourhood of each cell
    (periodic) in the column order of pack_pi_matrix_2d, then the ones
    column and zeros."""
    k = cfg.kernel_size
    r = k // 2
    dims = (h.ndim - 3, h.ndim - 2)
    cols = [torch.roll(h, shifts=(r - ki, r - kj), dims=dims)
            for ki in range(k) for kj in range(k)]
    extra = torch.zeros(h.shape[:-1] + (_round_up(n_taps(cfg), 8) - k * k * 2,),
                        dtype=h.dtype, device=h.device)
    extra[..., 0] = 1.0
    return torch.cat(cols + [extra], dim=-1)


def pi_from_activations(y: torch.Tensor, tail: torch.Tensor,
                        cfg: PiCellConfig) -> torch.Tensor:
    """[..., M] branch activations -> [..., 2] Pi outputs:
    Pi_o = sum_c w_out[c] prod_i y[(o*nb + i)*C + c] + b_out."""
    C, nb = cfg.hidden, cfg.n_branches
    y = y.unflatten(-1, (2, nb, C))
    w_out = tail[2:2 + 2 * C].reshape(2, C)
    return (torch.prod(y, dim=-2) * w_out).sum(-1) + tail[2 + 2 * C:]


def _packed_equation(packed: torch.Tensor, o: int, cfg: PiCellConfig) -> tuple:
    """Equation o's block of the packed vector: (w [nb, k*k*2, C] with rows
    (ki*k + kj)*2 + cin, b [nb, C], w_out [C], b_out [1])."""
    C, nb, taps = cfg.hidden, cfg.n_branches, cfg.kernel_size ** 2 * 2
    block = _param_block(cfg)
    p = packed[2 + o * block: 2 + (o + 1) * block]
    br = p[: nb * (taps + 1) * C].reshape(nb, taps + 1, C)   # per branch: w_i, then b_i
    return br[:, :taps], br[:, taps], p[nb * (taps + 1) * C: -1], p[-1:]


def _plain_step(packed: torch.Tensor, h: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """One Euler step from the packed parameters, the kernels' arithmetic
    written with tensor ops.  h: [H, W, 2]."""
    inv_dx2 = 1.0 / (cfg.dx * cfg.dx)
    s1 = (torch.roll(h, -1, 0) + torch.roll(h, 1, 0)
          + torch.roll(h, -1, 1) + torch.roll(h, 1, 1))
    s2 = (torch.roll(h, -2, 0) + torch.roll(h, 2, 0)
          + torch.roll(h, -2, 1) + torch.roll(h, 2, 1))
    lap = (-5.0 * h + (4.0 / 3.0) * s1 - (1.0 / 12.0) * s2) * inv_dx2
    cols = h if cfg.kernel_size == 1 else im2col_2d(h, cfg)[..., :cfg.kernel_size ** 2 * 2]
    pis = []
    for o in range(2):
        w, b, w_out, b_out = _packed_equation(packed, o, cfg)
        y = torch.einsum("...q,iqc->...ic", cols, w) + b          # [H, W, nb, C]
        pis.append(torch.prod(y, dim=-2) @ w_out + b_out)
    return h + cfg.dt * (packed[:2] * lap + torch.stack(pis, dim=-1))


def fused_rollout_2d_plain(packed: torch.Tensor, h0: torch.Tensor,
                           cfg: PiCellConfig, n_steps: int) -> torch.Tensor:
    """Plain version of rollout2d_kernel: [H, W, 2] -> [n_steps+1, H, W, 2],
    any odd kernel_size <= 5."""
    frames = [h0]
    for _ in range(n_steps):
        frames.append(_plain_step(packed, frames[-1], cfg))
    return torch.stack(frames)


def fused_rollout_final_2d_plain(packed: torch.Tensor, h0: torch.Tensor,
                                 cfg: PiCellConfig, n_steps: int) -> torch.Tensor:
    """Plain version of final2d_kernel: [H, W, 2] -> [H, W, 2], any odd
    kernel_size <= 5."""
    h = h0
    for _ in range(n_steps):
        h = _plain_step(packed, h, cfg)
    return h


def fused_rollout_kxk_2d_plain(wmat: torch.Tensor, tail: torch.Tensor, h0: torch.Tensor,
                               cfg: PiCellConfig, n_steps: int) -> torch.Tensor:
    """Plain version of rollout2d_kxk_kernel: [H, W, 2] -> [n_steps+1, H, W, 2].

    Each step: y = im2col(h) @ wmat^T, the branch product and the 1x1
    aggregation (pi_from_activations), the Laplacian and the Euler update.
    """
    frames = [h0]
    for _ in range(n_steps):
        h = frames[-1]
        y = im2col_2d(h, cfg) @ wmat.T
        frames.append(h + cfg.dt * (tail[:2] * laplacian_2d(h, cfg.dx)
                                    + pi_from_activations(y, tail, cfg)))
    return torch.stack(frames)


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
            cfg.hidden, cfg.n_branches, cfg.kernel_size, cfg.dt, 1.0 / (cfg.dx * cfg.dx))


def _kernel_fn(fn_name: str, library: str = "cell2d"):
    """A C entry point of a kernel library, built on first use."""
    fn = getattr(_build.load_library(library), fn_name)
    fn.argtypes = _SIGNATURES[fn_name]
    fn.restype = ctypes.c_int
    return fn


def _raise_on_error(err: int, fn_name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {err}")


def _rollout_steps_cuda(packed, h0, cfg, n_steps):
    """rollout2d_kernel: one launch per step, the loop in C."""
    fn = _kernel_fn("cell2d_rollout")
    p_ptr, n_params, h_ptr, n, H, W, C, nb, k, dt, inv_dx2 = _launch_args(
        packed, h0, cfg, n_steps)
    frames = torch.empty((n + 1, H, W, 2), dtype=torch.float32, device=h0.device)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(p_ptr, n_params, h_ptr, frames.data_ptr(), n, H, W,
                           C, nb, k, dt, inv_dx2, stream), "cell2d_rollout")
    if k == 1:
        fused_rollout_2d.launches += n
        fused_rollout_2d.steps += n
    else:
        fused_rollout_2d.launches_kxk += n
        fused_rollout_2d.steps_kxk += n
    return frames


def _rollout_cluster_cuda(packed, h0, cfg, n_steps, *, final_only=False):
    """rollout2d_cluster_kernel: the whole rollout of a 1x1 cell in one
    launch of one cluster, by rollout_plan's configuration: the frames, or
    with ``final_only`` the final state alone (no launch at n_steps = 0,
    a copy of h0).  Raises if the card cannot hold the cluster."""
    fn = _kernel_fn("cell2d_rollout_cluster")
    p_ptr, n_params, h_ptr, n, H, W, C, nb, k, dt, inv_dx2 = _launch_args(
        packed, h0, cfg, n_steps)
    plan = rollout_plan(H, W, cfg)
    if plan["route"] != "cluster":
        raise ValueError(f"a {H} x {W} field of this cell takes no cluster: {cfg}")
    shape = (H, W, 2) if final_only else (n + 1, H, W, 2)
    out = torch.empty(shape, dtype=torch.float32, device=h0.device)
    clusters = ctypes.c_int(0)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(p_ptr, n_params, h_ptr, out.data_ptr(), n, int(final_only), H, W, C,
                           nb, dt, inv_dx2, plan["n_cta"], plan["threads"], 1, stream,
                           ctypes.byref(clusters)), "cell2d_rollout_cluster")
    if final_only:
        fused_rollout_final_2d.launches += 1 if n else 0
        fused_rollout_final_2d.steps += n
    else:
        fused_rollout_2d.launches += 1
        fused_rollout_2d.steps += n
    return out


def cluster_occupancy(cfg: PiCellConfig, H: int, W: int, n_cta: int | None = None) -> int:
    """How many clusters of rollout_plan's configuration (or of n_cta CTAs,
    cluster_shape's) the current card holds at once (0: none, and the
    launch is refused)."""
    plan = rollout_plan(H, W, cfg)
    if plan["route"] == "cluster" and n_cta is not None:
        shape = cluster_shape(cfg, H, W, n_cta)
        plan = plan if shape is None else {"route": "cluster", **shape}
    if plan["route"] != "cluster" or (n_cta is not None and plan["n_cta"] != n_cta):
        raise ValueError(f"a {H} x {W} field takes no cluster of {n_cta or 'any'} CTAs")
    clusters = ctypes.c_int(0)
    _raise_on_error(_kernel_fn("cell2d_cluster_occupancy")(
        H, W, plan["n_cta"], plan["threads"], ctypes.byref(clusters)),
        "cell2d_cluster_occupancy")
    return clusters.value


def _rollout_cuda(packed, h0, cfg, n_steps):
    """The frames rollout on CUDA from the packed parameters: a 1x1 cell by
    rollout_plan's route (one launch of rollout2d_cluster_kernel, 'cluster'),
    a k x k cell by ffma_plan's (one launch of
    rollout2d_ffma_persistent_kernel, 'persistent'), else one
    rollout2d_kernel launch a step ('per_step')."""
    if h0.dim() == 3:
        H, W = h0.shape[0], h0.shape[1]
        if cfg.kernel_size == 1 and rollout_plan(H, W, cfg)["route"] == "cluster":
            return _rollout_cluster_cuda(packed, h0, cfg, n_steps)
        if cfg.kernel_size > 1 and h0.device.type == "cuda" and ffma_plan(
                H, W, cfg, _sm_count(h0.device))["route"] == "persistent":
            return _rollout_ffma_persistent_cuda(packed, h0, cfg, n_steps)
    return _rollout_steps_cuda(packed, h0, cfg, n_steps)


def _kxk_smem_bytes(cfg: PiCellConfig) -> int:
    """Shared memory of rollout2d_kxk_kernel (csrc/cell2d_kxk.cu): the matrix,
    the tail rounded to 4 floats, and a (8 + 4) x (16 + 4) float2 state tile."""
    K = _round_up(n_taps(cfg), 8)
    return 4 * (mxu_rows(cfg) * K + _round_up(2 * cfg.hidden + 4, 4)) + 8 * 12 * 20


# The k x k kernels are compiled for 1 to 4 branches and kernel_size 3 or 5.
_KXK_BRANCHES = (1, 2, 3, 4)
_KXK_SIZES = (3, 5)


def _check_kxk_inputs(wmat: torch.Tensor, tail: torch.Tensor, h0: torch.Tensor,
                      cfg: PiCellConfig, n_steps: int, smem_bytes: int) -> None:
    """Check the inputs of the k x k kernels (both directions)."""
    tensors = (wmat, tail, h0)
    if h0.device.type != "cuda" or any(t.device != h0.device for t in tensors):
        raise ValueError("the k x k kernels take CUDA tensors on one device; got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"the k x k kernels take float32, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the k x k kernels take contiguous tensors")
    if h0.dim() != 3 or h0.shape[-1] != 2:
        raise ValueError(f"state must be [H, W, 2], got {tuple(h0.shape)}")
    K = _round_up(n_taps(cfg), 8)
    if tuple(wmat.shape) != (mxu_rows(cfg), K) or wmat.data_ptr() % 16:
        raise ValueError(f"matrix must be [{mxu_rows(cfg)}, {K}] and 16-byte aligned, "
                         f"got {tuple(wmat.shape)}")
    if tail.numel() != 2 * cfg.hidden + 4:
        raise ValueError(f"tail has {tail.numel()} floats, expected {2 * cfg.hidden + 4}")
    if cfg.kernel_size not in _KXK_SIZES or cfg.n_branches not in _KXK_BRANCHES:
        raise ValueError(f"the k x k kernels take kernel_size {_KXK_SIZES} and "
                         f"{_KXK_BRANCHES} branches, got {cfg.kernel_size}, {cfg.n_branches}")
    if smem_bytes > _MAX_SMEM:
        raise ValueError(f"{smem_bytes} bytes of shared memory a block, over {_MAX_SMEM}")
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")


def _rollout_kxk_steps_cuda(wmat, tail, h0, cfg, n_steps):
    """rollout2d_kxk_kernel: one launch per step, the loop in C."""
    _check_kxk_inputs(wmat, tail, h0, cfg, n_steps, _kxk_smem_bytes(cfg))
    fn = _kernel_fn("cell2d_kxk_rollout", "cell2d_kxk")
    H, W = h0.shape[0], h0.shape[1]
    frames = torch.empty((n_steps + 1, H, W, 2), dtype=torch.float32, device=h0.device)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(wmat.data_ptr(), tail.data_ptr(), h0.data_ptr(), frames.data_ptr(),
                           n_steps, H, W, cfg.hidden, cfg.n_branches, cfg.kernel_size, cfg.dt,
                           1.0 / (cfg.dx * cfg.dx), stream), "cell2d_kxk_rollout")
    fused_rollout_kxk_2d.launches += n_steps
    fused_rollout_kxk_2d.steps += n_steps
    return frames


# The one-launch k x k kernels (csrc/kxk_mma.cuh): at most 6 warp pairs a
# block, a pair to a 16-cell tile, and built for C up to 16 (ch = C8 / 8 of
# 1 or 2: the accumulators of nb ch n-tiles an equation stay in registers).
_KXK_MMA_PAIRS = 6
_KXK_MMA_CH = (1, 2)


def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        raise ValueError(f"the one-launch kernels take CUDA tensors, got a tensor on {device}")
    return torch.cuda.get_device_properties(device).multi_processor_count


def kxk_grid(H: int, W: int, n_sm: int) -> dict:
    """The one-launch k x k kernels' grid on a card of n_sm SMs: one block an
    SM (min(n_sm, H W) blocks, each owning split_evenly's run of at most cap
    cells), two warps (one an equation) for each 16-cell tile, at most
    _KXK_MMA_PAIRS pairs, and the bytes of the most rows a block stages (the
    rows its cells span, 2 halo rows on each side, W + 4 float2 a row;
    csrc: tile_bytes)."""
    blocks = min(n_sm, H * W)
    cap = -(-(H * W) // blocks)
    threads = 64 * min(-(-cap // 16), _KXK_MMA_PAIRS)
    rows = (cap + W - 2) // W + 1 + 4
    return {"blocks": blocks, "cap": cap, "threads": threads, "tile_bytes": 8 * rows * (W + 4)}


def _mma_shape(cfg: PiCellConfig) -> dict:
    """Fragment counts of the one-launch kernels: ch = C8 / 8, the forward's
    k-steps K / 8 and n-tiles 2 nb ch, the adjoint's n-tiles Q / 8, and the
    padded tail (Du, Dv, w_out 2 x C8, b_out) rounded to 4 floats."""
    ch = _round_up(cfg.hidden, 8) // 8
    return {"ch": ch, "k8": _round_up(n_taps(cfg), 8) // 8, "nt2": 2 * cfg.n_branches * ch,
            "qt": _round_up(cfg.kernel_size ** 2 * 2, 8) // 8,
            "tail": _round_up(4 + 16 * ch, 4)}


def _mma_widths_ok(cfg: PiCellConfig) -> bool:
    return (cfg.ndim == 2 and cfg.channels == 2 and cfg.kernel_size in _KXK_SIZES
            and cfg.n_branches in _KXK_BRANCHES
            and _round_up(cfg.hidden, 8) // 8 in _KXK_MMA_CH)


def kxk_smem_bytes(cfg: PiCellConfig, H: int, W: int, n_sm: int) -> int:
    """Shared memory of a block of rollout2d_kxk_persistent_kernel: the
    forward operand split into hi and lo (16 bytes a fragment pair), the
    padded tail and kxk_grid's staged rows (csrc: persistent_smem)."""
    m = _mma_shape(cfg)
    return 16 * m["k8"] * m["nt2"] * 32 + 4 * m["tail"] + kxk_grid(H, W, n_sm)["tile_bytes"]


def kxk_plan(H: int, W: int, cfg: PiCellConfig, n_sm: int) -> dict:
    """The route of a k x k frames rollout of an H x W field on a card of
    n_sm SMs, by a rule on the cell, the shape and the card's limits: a cell
    of the widths the one-launch kernel is built for (k = 3 or 5, 1 to 4
    branches, C <= 16) whose block fits a block's shared memory takes
    rollout2d_kxk_persistent_kernel, one cooperative launch a rollout
    ('persistent', with blocks, threads and smem); else rollout2d_kxk_kernel,
    one launch a step ('per_step').  At 100 x 100, C = 16, 3 branches, k = 5
    on 132 SMs: 132 blocks of 75 or 76 cells, 320 threads, 48 144 bytes."""
    if not _mma_widths_ok(cfg):
        return {"route": "per_step"}
    smem = kxk_smem_bytes(cfg, H, W, n_sm)
    if smem > _MAX_SMEM:
        return {"route": "per_step"}
    grid = kxk_grid(H, W, n_sm)
    return {"route": "persistent", "blocks": grid["blocks"], "threads": grid["threads"],
            "smem": smem}


def kxk_occupancy(cfg: PiCellConfig, H: int, W: int, device: torch.device,
                  plan: dict | None = None, library: str = "cell2d_kxk",
                  fn_name: str = "cell2d_kxk_occupancy") -> int:
    """How many blocks of kxk_plan's one-launch forward (or of another plan
    of the same widths, from another library: backward2d.kxk_adj_occupancy)
    an SM of the card holds, at the plan's threads and bytes (0: none, and
    the launch is refused)."""
    plan = plan or kxk_plan(H, W, cfg, _sm_count(device))
    if plan["route"] != "persistent":
        raise ValueError(f"a {H} x {W} field takes no one-launch k x k kernel: {cfg}")
    fn = getattr(_build.load_library(library), fn_name)
    fn.argtypes = _SIGNATURES["cell2d_kxk_occupancy"]
    fn.restype = ctypes.c_int
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise_on_error(fn(cfg.n_branches, cfg.kernel_size, _mma_shape(cfg)["ch"],
                           plan["threads"], plan["smem"], ctypes.byref(per_sm)), fn_name)
    return per_sm.value


def _rollout_kxk_persistent_cuda(wmat, tail, h0, cfg, n_steps, *, final_only=False):
    """rollout2d_kxk_persistent_kernel: the whole rollout in one cooperative
    launch, by kxk_plan's configuration: the frames, or with ``final_only``
    the final state alone, the steps ping-ponging between it and a scratch
    buffer (final_schedule).  No launch at n_steps = 0.  Raises if the card
    cannot hold the grid."""
    H, W = h0.shape[0], h0.shape[1]
    plan = kxk_plan(H, W, cfg, _sm_count(h0.device))
    if plan["route"] != "persistent":
        raise ValueError(f"a {H} x {W} field of this cell takes no one-launch rollout: {cfg}")
    _check_kxk_inputs(wmat, tail, h0, cfg, n_steps, plan["smem"])
    fn = _kernel_fn("cell2d_kxk_rollout_persistent", "cell2d_kxk")
    bfrag = pack_mma_fwd_2d(wmat, cfg)
    shape = (H, W, 2) if final_only else (n_steps + 1, H, W, 2)
    out = torch.empty(shape, dtype=torch.float32, device=h0.device)
    scratch = torch.empty((H, W, 2), dtype=torch.float32, device=h0.device) if (
        final_only) else None
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(bfrag.data_ptr(), tail.data_ptr(), h0.data_ptr(), out.data_ptr(),
                           None if scratch is None else scratch.data_ptr(), n_steps,
                           int(final_only), H, W, cfg.hidden, cfg.n_branches, cfg.kernel_size,
                           _mma_shape(cfg)["ch"], cfg.dt, 1.0 / (cfg.dx * cfg.dx),
                           plan["blocks"], plan["threads"], plan["smem"], stream,
                           ctypes.byref(per_sm)), "cell2d_kxk_rollout_persistent")
    if final_only:
        fused_rollout_final_2d.launches_kxk += 1 if n_steps else 0
        fused_rollout_final_2d.steps_kxk += n_steps
    elif n_steps:
        fused_rollout_kxk_2d.launches += 1
        fused_rollout_kxk_2d.steps += n_steps
    return out


def _rollout_kxk_cuda(wmat, tail, h0, cfg, n_steps):
    """The k x k frames rollout on CUDA by kxk_plan's route: one launch of
    rollout2d_kxk_persistent_kernel ('persistent') or one rollout2d_kxk_kernel
    launch a step ('per_step')."""
    if h0.dim() == 3 and h0.device.type == "cuda" and kxk_plan(
            h0.shape[0], h0.shape[1], cfg, _sm_count(h0.device))["route"] == "persistent":
        return _rollout_kxk_persistent_cuda(wmat, tail, h0, cfg, n_steps)
    return _rollout_kxk_steps_cuda(wmat, tail, h0, cfg, n_steps)


# The one-launch FFMA kernels of a k x k cell (csrc/cell2d_ffma.cu and
# adj2d_ys_persistent_kernel in csrc/adj2d.cu): a warp pair (one an
# equation) for each 16-cell tile of a round, at most 8 tiles; 8 lanes of a
# warp split the hidden channels (two each: C <= 16) or the taps, 4 the
# tile's cells (four each).
_FFMA_TILE = 16
_FFMA_TILES = 8
_FFMA_LANE_GROUPS = 8
_FFMA_MAX_HIDDEN = 16
_FFMA_TAIL = 36


def _ffma_widths_ok(cfg: PiCellConfig) -> bool:
    return (cfg.ndim == 2 and cfg.channels == 2 and cfg.kernel_size in _KXK_SIZES
            and cfg.n_branches in _KXK_BRANCHES and cfg.hidden <= _FFMA_MAX_HIDDEN)


def ffma_grid(H: int, W: int, n_sm: int) -> dict:
    """The one-launch FFMA kernels' grid on a card of n_sm SMs: one block an SM
    (min(n_sm, H W) blocks, each owning split_evenly's run of at most cap
    cells, the split of kxk_grid), a warp pair for each 16-cell tile of a
    round of at most 8 tiles (rc cells), and the bytes of the most rows a
    block stages (kxk_grid's)."""
    k = kxk_grid(H, W, n_sm)
    tiles = min(-(-k["cap"] // _FFMA_TILE), _FFMA_TILES)
    return {"blocks": k["blocks"], "cap": k["cap"], "threads": 64 * tiles,
            "rc": _FFMA_TILE * tiles, "tile_bytes": k["tile_bytes"]}


def _ffma_fwd_floats(cfg: PiCellConfig) -> int:
    """Floats of pack_ffma_fwd_2d's operand: [k*k*2 + 1, 2, W / 4, 8, 4], W
    = 2 nb rounded up to 4."""
    return (cfg.kernel_size ** 2 * 2 + 1) * 2 * _round_up(2 * cfg.n_branches, 4) * 8


def _ffma_adj_taps(cfg: PiCellConfig) -> int:
    """Taps a lane of the ys sweep's product holds: the k*k*2 taps over 8
    lanes (7 at k = 5, 3 at k = 3)."""
    return -(-(cfg.kernel_size ** 2 * 2) // _FFMA_LANE_GROUPS)


def ffma_smem_bytes(cfg: PiCellConfig, H: int, W: int, n_sm: int) -> int:
    """Shared memory of a block of rollout2d_ffma_persistent_kernel: the
    forward operand, the tail, the im2col stack of a round [k*k*2][rc] and
    ffma_grid's staged rows (csrc: persistent_smem)."""
    grid = ffma_grid(H, W, n_sm)
    return (4 * (_ffma_fwd_floats(cfg) + _FFMA_TAIL + cfg.kernel_size ** 2 * 2 * grid["rc"])
            + grid["tile_bytes"])


def ffma_plan(H: int, W: int, cfg: PiCellConfig, n_sm: int) -> dict:
    """The route of a k x k frames rollout from the packed parameters (the
    MXU switch off) of an H x W field on a card of n_sm SMs, by a rule on the
    cell, the shape and the card's limits: a cell of the widths
    rollout2d_ffma_persistent_kernel is built for (k = 3 or 5, 1 to 4
    branches, C <= 16) whose block fits a block's shared memory takes it, one
    cooperative launch a rollout ('persistent', with blocks, threads and
    smem); else rollout2d_kernel, one launch a step ('per_step').  At
    100 x 100, C = 16, 3 branches, k = 5 on 132 SMs: 132 blocks of 75 or 76
    cells, 320 threads, 47 248 bytes."""
    if not _ffma_widths_ok(cfg):
        return {"route": "per_step"}
    smem = ffma_smem_bytes(cfg, H, W, n_sm)
    if smem > _MAX_SMEM:
        return {"route": "per_step"}
    grid = ffma_grid(H, W, n_sm)
    return {"route": "persistent", "blocks": grid["blocks"], "threads": grid["threads"],
            "smem": smem}


def ffma_occupancy(cfg: PiCellConfig, H: int, W: int, device: torch.device,
                   plan: dict | None = None, library: str = "cell2d_ffma",
                   fn_name: str = "cell2d_ffma_occupancy") -> int:
    """How many blocks of ffma_plan's one-launch forward (or of another plan
    of the same widths, from another library: backward2d.ys_occupancy) an SM
    of the card holds, at the plan's threads and bytes (0: none, and the
    launch is refused)."""
    plan = plan or ffma_plan(H, W, cfg, _sm_count(device))
    if plan["route"] != "persistent":
        raise ValueError(f"a {H} x {W} field takes no one-launch FFMA kernel: {cfg}")
    fn = getattr(_build.load_library(library), fn_name)
    fn.argtypes = _SIGNATURES["cell2d_ffma_occupancy"]
    fn.restype = ctypes.c_int
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise_on_error(fn(cfg.n_branches, cfg.kernel_size, plan["threads"], plan["smem"],
                           ctypes.byref(per_sm)), fn_name)
    return per_sm.value


def pack_ffma_fwd_2d(packed: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """The branch weights and biases of the packed vector (pack_pi_params_2d)
    in the lane order of rollout2d_ffma_persistent_kernel: [k*k*2 + 1, 2,
    W / 4, 8, 4] f32 (W = 2 nb rounded up to 4), entry [q, o, h, p, e] =
    w_i^o[q, c] (q < k*k*2; at q = k*k*2 the bias b_i^o[c]) with c = 2 p +
    f // nb, i = f % nb for f = 4 h + e < 2 nb, and zero past 2 nb and for c
    >= C: lane pair p's weights of tap q, a float4 each h, the 8 pairs'
    contiguous."""
    k, C, nb = cfg.kernel_size, cfg.hidden, cfg.n_branches
    taps, w4 = k * k * 2, _round_up(2 * nb, 4)
    eqs = []
    for o in range(2):
        w, b, _, _ = _packed_equation(packed, o, cfg)                 # [nb, taps, C], [nb, C]
        wb = torch.cat([w, b[:, None, :]], dim=1)                     # [nb, taps + 1, C]
        wb = torch.nn.functional.pad(wb, (0, 2 * _FFMA_LANE_GROUPS - C))
        wb = wb.reshape(nb, taps + 1, _FFMA_LANE_GROUPS, 2).permute(1, 2, 3, 0)
        wb = torch.nn.functional.pad(wb.reshape(taps + 1, _FFMA_LANE_GROUPS, 2 * nb),
                                     (0, w4 - 2 * nb))                # [q, p, f]
        eqs.append(wb.reshape(taps + 1, _FFMA_LANE_GROUPS, w4 // 4, 4).permute(0, 2, 1, 3))
    return torch.stack(eqs, dim=1).contiguous()


def pack_ffma_tail_2d(packed: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """What the FFMA one-launch kernels read besides their operand, f32 [36]:
    [Du, Dv], w_out of equations 0 and 1 padded to 16 with zeros, then
    b_out of equations 0 and 1."""
    C = cfg.hidden
    w_out, b_out = [], []
    for o in range(2):
        _, _, wo, bo = _packed_equation(packed, o, cfg)
        w_out.append(torch.nn.functional.pad(wo, (0, _FFMA_MAX_HIDDEN - C)))
        b_out.append(bo)
    return torch.cat([packed[:2]] + w_out + b_out).contiguous()


def pack_ffma_adj_2d(packed: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """The tap weights of the packed vector in the lane order of
    adj2d_ys_persistent_kernel's product: [M, R4 / 4, 8, 4] f32 (M = 2 nb C,
    R = _ffma_adj_taps, R4 = R rounded up to 4), entry [m, h, g, e] =
    w[g R + 4 h + e, m] (w: _packed_equation's taps, row m = (o nb + i) C + c)
    for 4 h + e < R and g R + 4 h + e < k*k*2, else zero: lane group g's
    taps of row m, a float4 each h, the 8 groups' contiguous."""
    taps, C, nb = cfg.kernel_size ** 2 * 2, cfg.hidden, cfg.n_branches
    r = _ffma_adj_taps(cfg)
    w = torch.cat([torch.cat(list(_packed_equation(packed, o, cfg)[0]), dim=1)
                   for o in range(2)], dim=1)                         # [taps, M]
    w = torch.nn.functional.pad(w, (0, 0, 0, _FFMA_LANE_GROUPS * r - taps))
    w = w.T.reshape(2 * nb * C, _FFMA_LANE_GROUPS, r)
    w = torch.nn.functional.pad(w, (0, _round_up(r, 4) - r))
    return w.reshape(2 * nb * C, _FFMA_LANE_GROUPS, -1, 4).permute(0, 2, 1, 3).contiguous()


def _rollout_ffma_persistent_cuda(packed, h0, cfg, n_steps, *, final_only=False):
    """rollout2d_ffma_persistent_kernel: the whole k x k rollout in one
    cooperative launch, by ffma_plan's configuration: the frames, or with
    ``final_only`` the final state alone, the steps ping-ponging between it
    and a scratch buffer (final_schedule).  No launch at n_steps = 0.
    Raises if the card cannot hold the grid."""
    p_ptr, n_params, h_ptr, n, H, W, C, nb, k, dt, inv_dx2 = _launch_args(
        packed, h0, cfg, n_steps)
    plan = ffma_plan(H, W, cfg, _sm_count(h0.device))
    if plan["route"] != "persistent":
        raise ValueError(f"a {H} x {W} field of this cell takes no one-launch FFMA rollout: {cfg}")
    fn = _kernel_fn("cell2d_ffma_rollout_persistent", "cell2d_ffma")
    wf, tail = pack_ffma_fwd_2d(packed, cfg), pack_ffma_tail_2d(packed, cfg)
    out = torch.empty((H, W, 2) if final_only else (n + 1, H, W, 2), dtype=torch.float32,
                      device=h0.device)
    scratch = torch.empty((H, W, 2), dtype=torch.float32, device=h0.device) if (
        final_only) else None
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(wf.data_ptr(), tail.data_ptr(), h_ptr, out.data_ptr(),
                           None if scratch is None else scratch.data_ptr(), n,
                           int(final_only), H, W, nb, k, dt, inv_dx2, plan["blocks"],
                           plan["threads"], plan["smem"], stream, ctypes.byref(per_sm)),
                        "cell2d_ffma_rollout_persistent")
    f = fused_rollout_final_2d if final_only else fused_rollout_2d
    f.launches_kxk += 1 if n else 0
    f.steps_kxk += n
    return out


def final_schedule(n_steps: int) -> list[tuple[str, str]]:
    """The (read, write) buffers of each step of a final-state rollout that
    ping-pongs between two [H, W, 2] buffers, 'out' and 'scratch'
    (final2d_kernel's loop and rollout2d_kxk_persistent_kernel's final-state
    mode keep this order in C): step s writes 'out' when n_steps - 1 - s is
    even, else 'scratch', and reads what step s - 1 wrote ('h0' at s = 0),
    so the last step writes 'out' and no step writes what it reads.  No
    steps is one copy, [('h0', 'out')], and no launch."""
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    if n_steps == 0:
        return [("h0", "out")]
    order, src = [], "h0"
    for s in range(n_steps):
        dst = "out" if (n_steps - 1 - s) % 2 == 0 else "scratch"
        order.append((src, dst))
        src = dst
    return order


def final_plan(H: int, W: int, cfg: PiCellConfig, n_sm: int, mxu: bool | None = None) -> dict:
    """The route of a final-state rollout of an H x W field on a card of n_sm
    SMs: a 1x1 cell takes rollout_plan's ('cluster': rollout2d_cluster_kernel
    in its final-state mode, one launch a request, for the GS2D cell up to
    448 x 448); a k x k cell with the MXU switch on (``mxu``, None: the
    current MXU_FWD_ENABLED) takes kxk_plan's ('persistent':
    rollout2d_kxk_persistent_kernel in its final-state mode, one cooperative
    launch a request, the branch product in 3xTF32, up to 1452 x 1452 for
    the Burgers cell on 132 SMs), with the switch off ffma_plan's
    ('persistent': rollout2d_ffma_persistent_kernel in its final-state mode,
    the tap-by-tap form that the TPU's _final_kernel computes, in FFMA); any
    other cell or field takes final2d_kernel, one launch a step
    ('per_step')."""
    if cfg.kernel_size == 1:
        return rollout_plan(H, W, cfg)
    if MXU_FWD_ENABLED if mxu is None else mxu:
        return kxk_plan(H, W, cfg, n_sm)
    return ffma_plan(H, W, cfg, n_sm)


def _final_steps_cuda(packed, h0, cfg, n_steps):
    """final2d_kernel: one launch per step, the loop in C."""
    fn = _kernel_fn("cell2d_final")
    p_ptr, n_params, h_ptr, n, H, W, C, nb, k, dt, inv_dx2 = _launch_args(
        packed, h0, cfg, n_steps)
    out = torch.empty((H, W, 2), dtype=torch.float32, device=h0.device)
    scratch = torch.empty_like(out)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(p_ptr, n_params, h_ptr, out.data_ptr(),
                           scratch.data_ptr(), n, H, W, C, nb, k, dt, inv_dx2,
                           stream), "cell2d_final")
    if k == 1:
        fused_rollout_final_2d.launches += n
        fused_rollout_final_2d.steps += n
    else:
        fused_rollout_final_2d.launches_kxk += n
        fused_rollout_final_2d.steps_kxk += n
    return out


def _final_cuda(params, h0, cfg, n_steps):
    """The final state on CUDA by final_plan's route: one launch of
    rollout2d_cluster_kernel ('cluster'), of rollout2d_kxk_persistent_kernel
    (the MXU switch on) or of rollout2d_ffma_persistent_kernel (off)
    ('persistent') in its final-state mode, or one final2d_kernel launch a
    step ('per_step')."""
    mxu = MXU_FWD_ENABLED
    n_sm = _sm_count(h0.device) if cfg.kernel_size > 1 else 0
    route = (final_plan(h0.shape[0], h0.shape[1], cfg, n_sm, mxu=mxu)["route"]
             if h0.dim() == 3 else "per_step")
    if route == "persistent" and mxu:
        return _rollout_kxk_persistent_cuda(pack_pi_matrix_2d(params, cfg),
                                            pi_tail_2d(params, cfg), h0, cfg, n_steps,
                                            final_only=True)
    packed = pack_pi_params_2d(params, cfg)
    if route == "persistent":
        return _rollout_ffma_persistent_cuda(packed, h0, cfg, n_steps, final_only=True)
    if route == "cluster":
        return _rollout_cluster_cuda(packed, h0, cfg, n_steps, final_only=True)
    return _final_steps_cuda(packed, h0, cfg, n_steps)


def fused_rollout_kxk_2d(params: dict, h0: torch.Tensor, cfg: PiCellConfig,
                         n_steps: int) -> torch.Tensor:
    """Full rollout of a k x k cell: [H, W, 2] -> [n_steps+1, H, W, 2] f32.

    On CUDA, kxk_plan's route (one rollout2d_kxk_persistent_kernel launch a
    rollout, or one rollout2d_kxk_kernel launch a step); on the CPU, the
    plain version.
    """
    _check_fusable(cfg)
    if cfg.kernel_size == 1:
        raise ValueError("a 1x1 cell takes fused_rollout_2d's rollout2d_kernel")
    wmat = pack_pi_matrix_2d(params, cfg)
    tail = pi_tail_2d(params, cfg)
    h0 = h0.to(torch.float32).contiguous()
    if h0.device.type == "cpu":
        return fused_rollout_kxk_2d_plain(wmat, tail, h0, cfg, n_steps)
    return _rollout_kxk_cuda(wmat, tail, h0, cfg, n_steps)


def fused_rollout_2d(params: dict, h0: torch.Tensor, cfg: PiCellConfig,
                     n_steps: int) -> torch.Tensor:
    """Full rollout: [H, W, 2] -> [n_steps+1, H, W, 2] f32 (frame 0 = h0).

    A k x k cell with MXU_FWD_ENABLED goes to fused_rollout_kxk_2d; any
    other cell, on CUDA, takes _rollout_cuda's route (one launch a rollout
    of rollout2d_cluster_kernel or rollout2d_ffma_persistent_kernel, or one
    rollout2d_kernel launch a step) and, on the CPU, the plain version.
    """
    _check_fusable(cfg)
    if cfg.kernel_size > 1 and MXU_FWD_ENABLED:
        return fused_rollout_kxk_2d(params, h0, cfg, n_steps)
    packed = pack_pi_params_2d(params, cfg)
    h0 = h0.to(torch.float32).contiguous()
    if h0.device.type == "cpu":
        return fused_rollout_2d_plain(packed, h0, cfg, n_steps)
    return _rollout_cuda(packed, h0, cfg, n_steps)


def fused_rollout_final_2d(params: dict, h0: torch.Tensor, cfg: PiCellConfig,
                           n_steps: int) -> torch.Tensor:
    """Final state only: [H, W, 2] -> [H, W, 2] f32 after n_steps, any odd
    kernel_size <= 5.

    On CUDA, final_plan's route (one launch a request of the one-launch
    frames kernel in its final-state mode, or one final2d_kernel launch a
    step); on the CPU, the plain version.
    """
    _check_fusable(cfg)
    h0 = h0.to(torch.float32).contiguous()
    if h0.device.type == "cpu":
        return fused_rollout_final_2d_plain(pack_pi_params_2d(params, cfg), h0, cfg, n_steps)
    return _final_cuda(params, h0, cfg, n_steps)


fused_rollout_2d.launches = 0
fused_rollout_2d.steps = 0
fused_rollout_2d.launches_kxk = 0
fused_rollout_2d.steps_kxk = 0
fused_rollout_final_2d.launches = 0
fused_rollout_final_2d.steps = 0
fused_rollout_final_2d.launches_kxk = 0
fused_rollout_final_2d.steps_kxk = 0
fused_rollout_kxk_2d.launches = 0
fused_rollout_kxk_2d.steps = 0
