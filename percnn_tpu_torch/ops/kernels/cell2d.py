"""Fused 2D Pi-cell rollout: CUDA kernels for Hopper and their plain versions.

Counterpart of percnn_tpu/ops/pallas/cell2d.py.  ``fused_rollout_2d``
streams every frame through ``rollout2d_kernel`` (in place of
``_rollout_kernel``), which takes the packed parameters and any odd
kernel_size <= 5: a 1x1 cell (the GS2D model) one thread a cell, a k x k
cell (k = 3 or 5: the Burgers and lambda-omega Stage-1 models) from a
block's staged tile, its branch convs tap by tap.  With ``MXU_FWD_ENABLED``
on (the default) a k x k cell goes instead to ``fused_rollout_kxk_2d`` and
``rollout2d_kxk_kernel`` (in place of ``_rollout_kernel_mxu``), the branch
convs as one product with the branch matrix.  ``fused_rollout_final_2d``
returns the final state of any cell through ``final2d_kernel`` (in place
of ``_final_kernel``).  The kernels are in csrc/cell2d.cu and
csrc/cell2d_kxk.cu, with their bound on the card and their design.

A CPU tensor takes the plain PyTorch version of the same arithmetic
(``fused_rollout_2d_plain``, ``fused_rollout_final_2d_plain``,
``fused_rollout_kxk_2d_plain``); a CUDA tensor launches the kernel or
raises.  Each public wrapper counts the kernel launches it makes, one per
time step: ``launches`` for a 1x1 cell, ``launches_kxk`` for the k x k
contract of rollout2d_kernel and final2d_kernel.
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
backward2d.fused_rollout_tp_2d) through rollout2d_kxk_kernel, the branch
matrix product; off, through rollout2d_kernel's tap-by-tap form.  Read
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
}
# rollout2d_kernel and final2d_kernel stage the packed parameters in shared
# memory, at most 48 KB of them (4932 floats for the Burgers cell); the
# branch-matrix kernels stage the matrix instead (_kxk_smem_bytes).
_MAX_PARAMS = 48 * 1024 // 4


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


def _count(wrapper, cfg: PiCellConfig, n: int) -> None:
    """Add n launches to the wrapper's counter of cfg's contract."""
    if cfg.kernel_size == 1:
        wrapper.launches += n
    else:
        wrapper.launches_kxk += n


def _rollout_cuda(packed, h0, cfg, n_steps):
    """rollout2d_kernel: one launch per step, the loop in C."""
    fn = _kernel_fn("cell2d_rollout")
    p_ptr, n_params, h_ptr, n, H, W, C, nb, k, dt, inv_dx2 = _launch_args(
        packed, h0, cfg, n_steps)
    frames = torch.empty((n + 1, H, W, 2), dtype=torch.float32, device=h0.device)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(p_ptr, n_params, h_ptr, frames.data_ptr(), n, H, W,
                           C, nb, k, dt, inv_dx2, stream), "cell2d_rollout")
    _count(fused_rollout_2d, cfg, n)
    return frames


def _kxk_smem_bytes(cfg: PiCellConfig) -> int:
    """Shared memory of rollout2d_kxk_kernel (csrc/cell2d_kxk.cu): the matrix,
    the tail rounded to 4 floats, and a (8 + 4) x (16 + 4) float2 state tile."""
    K = _round_up(n_taps(cfg), 8)
    return 4 * (mxu_rows(cfg) * K + _round_up(2 * cfg.hidden + 4, 4)) + 8 * 12 * 20


# A block's dynamic shared memory on an H100 (cudaFuncSetAttribute's ceiling).
_MAX_SMEM = 227 * 1024
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


def _rollout_kxk_cuda(wmat, tail, h0, cfg, n_steps):
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
    return frames


def _final_cuda(packed, h0, cfg, n_steps):
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
    _count(fused_rollout_final_2d, cfg, n)
    return out


def fused_rollout_kxk_2d(params: dict, h0: torch.Tensor, cfg: PiCellConfig,
                         n_steps: int) -> torch.Tensor:
    """Full rollout of a k x k cell: [H, W, 2] -> [n_steps+1, H, W, 2] f32.

    On CUDA, one rollout2d_kxk_kernel launch per step; on the CPU, the
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
    other cell, on CUDA, takes one rollout2d_kernel launch per step and, on
    the CPU, the plain version.
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
fused_rollout_2d.launches_kxk = 0
fused_rollout_final_2d.launches = 0
fused_rollout_final_2d.launches_kxk = 0
fused_rollout_kxk_2d.launches = 0
