"""Fused 3D Pi-cell rollout: a CUDA kernel for Hopper and its plain version.

Counterpart of percnn_tpu/ops/pallas/cell3d.py for 1x1 Pi cells with three
branches (the GS3D model).  ``fused_rollout_3d`` runs ``rollout3d_kernel``
(csrc/cell3d.cu, in place of ``_rollout3d_kernel``): one forward-Euler step
per launch on a periodic [D, H, W, 2] field, with the 13-point 4th-order
Laplacian and the Pi block in its expanded-cubic form
(``pack_pi_expanded_3d``).  Every frame, or with ``final_only`` the final
state alone.  The kernel's bound on the card and its design are in the
source.

A CPU tensor takes the plain PyTorch version of the same arithmetic
(``fused_rollout_3d_plain``); a CUDA tensor launches the kernel or raises.
``fused_rollout_3d.launches`` counts the kernel launches: one per time step.
"""

from __future__ import annotations

import ctypes

import torch

from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.ops.kernels import _build
from percnn_tpu_torch.ops.kernels.cell2d import (
    _param_block,
    _raise_on_error,
    pack_pi_params_2d,
)

# The literal packing is the same in 2D and 3D (44 floats for the GS3D cell).
pack_pi_params_3d = pack_pi_params_2d

# Per equation: [k1, k2, const, u, v, u2, uv, v2, u3, u2v, uv2, v3].
EXPANDED_ROW = 12

_P = ctypes.c_void_p
_I = ctypes.c_int
# coef, h0, out, scratch, n_steps, D, H, W, final_only, stream
_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


def _check_fusable(cfg: PiCellConfig) -> None:
    if cfg.ndim != 3 or cfg.channels != 2:
        raise NotImplementedError("the fused 3D kernels take 3D cells with 2 state "
                                  "channels (u, v)")
    if cfg.kernel_size != 1 or cfg.n_branches != 3:
        raise NotImplementedError(
            "the fused 3D kernels take kernel_size=1, n_branches=3 Pi cells "
            f"(got kernel_size={cfg.kernel_size}, n_branches={cfg.n_branches})")


def expand_packed_3d(packed: torch.Tensor, cfg: PiCellConfig) -> torch.Tensor:
    """Literal pack (``pack_pi_params_3d``) -> the expanded update coefficients.

    The k=1 Pi block is a product of three affine forms in (u, v) summed
    over hidden channels: one bivariate cubic per equation.  Returns f32
    [2 * EXPANDED_ROW]: per equation eq,
      k1 = dt * nu_eq / dx^2 * 4/3, k2 = -dt * nu_eq / dx^2 / 12 (the
      stencil weights of the +-1 and +-2 neighbour sums),
      then the dt-scaled cubic coefficients [const, u, v, u^2, uv, v^2, u^3,
      u^2 v, u v^2, v^3], with the Laplacian's centre tap
      (-15/2 * dt * nu_eq / dx^2) folded into the linear coefficient of the
      equation's own field.
    Computed in f32 in the order of percnn_tpu's pack_pi_expanded_3d.
    """
    C, nb = cfg.hidden, cfg.n_branches
    block = _param_block(cfg)
    packed = packed.to(torch.float32)
    nu = packed[:2]
    inv_dx2 = 1.0 / (cfg.dx * cfg.dx)
    dt = cfg.dt
    rows = []
    for eq in range(cfg.channels):
        p = packed[2 + eq * block: 2 + (eq + 1) * block]
        br = p[: nb * 3 * C].reshape(nb, 3, C)    # per branch: w[0], w[1], b
        a, b, c = br[:, 0], br[:, 1], br[:, 2]
        # y1*y2 = A u^2 + B uv + Cq v^2 + Dq u + E v + F   (per hidden ch)
        A = a[0] * a[1]
        B = a[0] * b[1] + b[0] * a[1]
        Cq = b[0] * b[1]
        Dq = a[0] * c[1] + c[0] * a[1]
        E = b[0] * c[1] + c[0] * b[1]
        F = c[0] * c[1]
        mono = {  # (y1*y2)*y3 expanded, per hidden channel
            "u3": A * a[2],
            "u2v": A * b[2] + B * a[2],
            "uv2": B * b[2] + Cq * a[2],
            "v3": Cq * b[2],
            "u2": A * c[2] + Dq * a[2],
            "uv": B * c[2] + Dq * b[2] + E * a[2],
            "v2": Cq * c[2] + E * b[2],
            "u": Dq * c[2] + F * a[2],
            "v": E * c[2] + F * b[2],
            "const": F * c[2],
        }
        w_out = p[nb * 3 * C: nb * 3 * C + C]
        coef = {k: dt * torch.dot(w_out, v) for k, v in mono.items()}
        coef["const"] = coef["const"] + dt * p[-1]
        k = dt * nu[eq] * inv_dx2
        own = "u" if eq == 0 else "v"
        coef[own] = coef[own] + k * 3.0 * (-5.0 / 2.0)
        rows.append(torch.stack([
            k * (4.0 / 3.0), k * (-1.0 / 12.0), coef["const"],
            coef["u"], coef["v"], coef["u2"], coef["uv"], coef["v2"],
            coef["u3"], coef["u2v"], coef["uv2"], coef["v3"],
        ]))
    return torch.cat(rows)


def pack_pi_expanded_3d(params: dict, cfg: PiCellConfig) -> torch.Tensor:
    """Cell params -> the 24 expanded update coefficients (``expand_packed_3d``)."""
    _check_fusable(cfg)
    return expand_packed_3d(pack_pi_params_3d(params, cfg), cfg)


def _neighbour_sums(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the six +-1 neighbours, sum of the six +-2 neighbours) of a
    periodic [D, H, W] field, in the order of the kernel."""
    s1 = (torch.roll(x, -1, 0) + torch.roll(x, 1, 0) + torch.roll(x, -1, 1)
          + torch.roll(x, 1, 1) + torch.roll(x, -1, 2) + torch.roll(x, 1, 2))
    s2 = (torch.roll(x, -2, 0) + torch.roll(x, 2, 0) + torch.roll(x, -2, 1)
          + torch.roll(x, 2, 1) + torch.roll(x, -2, 2) + torch.roll(x, 2, 2))
    return s1, s2


def _plain_step(e: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One Euler step from the expanded coefficients: [D, H, W, 2] -> same."""
    u, v = h[..., 0], h[..., 1]
    u2, uv, v2 = u * u, u * v, v * v
    u3, u2v, uv2, v3 = u2 * u, u2 * v, u * v2, v2 * v

    def upd(eq, x):
        s1, s2 = _neighbour_sums(x)
        c = e[EXPANDED_ROW * eq: EXPANDED_ROW * (eq + 1)]
        return (x + c[0] * s1 + c[1] * s2 + c[2] + c[3] * u + c[4] * v + c[5] * u2
                + c[6] * uv + c[7] * v2 + c[8] * u3 + c[9] * u2v + c[10] * uv2
                + c[11] * v3)

    return torch.stack([upd(0, u), upd(1, v)], dim=-1)


def fused_rollout_3d_plain(expanded: torch.Tensor, h0: torch.Tensor, n_steps: int,
                           *, final_only: bool = False) -> torch.Tensor:
    """Plain version of rollout3d_kernel: expanded [24], h0 [D, H, W, 2] ->
    [n_steps+1, D, H, W, 2] frames, or the final [D, H, W, 2] state."""
    h = h0
    frames = [h0]
    for _ in range(n_steps):
        h = _plain_step(expanded, h)
        if not final_only:
            frames.append(h)
    return h if final_only else torch.stack(frames)


def _kernel_fn():
    fn = _build.load_library("cell3d").cell3d_rollout
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(expanded: torch.Tensor, h0: torch.Tensor, n_steps: int) -> None:
    if h0.device.type != "cuda" or expanded.device != h0.device:
        raise ValueError(f"rollout3d_kernel takes CUDA tensors on one device; got "
                         f"state on {h0.device}, coefficients on {expanded.device}")
    if h0.dtype != torch.float32 or expanded.dtype != torch.float32:
        raise ValueError(f"rollout3d_kernel takes float32, got {h0.dtype}, {expanded.dtype}")
    if h0.dim() != 4 or h0.shape[-1] != 2 or min(h0.shape[:3]) < 5:
        raise ValueError(f"state must be [D, H, W, 2] with D, H, W >= 5, got "
                         f"{tuple(h0.shape)}")
    if not (h0.is_contiguous() and expanded.is_contiguous()):
        raise ValueError("rollout3d_kernel takes contiguous tensors")
    if expanded.numel() != 2 * EXPANDED_ROW:
        raise ValueError(f"expanded coefficients have {expanded.numel()} floats, "
                         f"expected {2 * EXPANDED_ROW}")
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")


def _rollout_cuda(expanded: torch.Tensor, h0: torch.Tensor, n_steps: int, *,
                  final_only: bool = False) -> torch.Tensor:
    """rollout3d_kernel: one launch per step, the loop in C."""
    fn = _kernel_fn()
    _check_inputs(expanded, h0, n_steps)
    D, H, W = h0.shape[:3]
    if final_only:
        out = torch.empty_like(h0)
        scratch = torch.empty_like(h0)
    else:
        out = torch.empty((n_steps + 1,) + tuple(h0.shape), dtype=torch.float32,
                          device=h0.device)
        scratch = None
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on_error(fn(expanded.data_ptr(), h0.data_ptr(), out.data_ptr(),
                           None if scratch is None else scratch.data_ptr(), n_steps,
                           D, H, W, int(final_only), stream), "cell3d_rollout")
    fused_rollout_3d.launches += n_steps
    return out


def fused_rollout_3d(params: dict, h0: torch.Tensor, cfg: PiCellConfig, n_steps: int,
                     *, final_only: bool = False) -> torch.Tensor:
    """[D, H, W, 2] -> [n_steps+1, D, H, W, 2] f32 frames (frame 0 = h0), or
    with ``final_only`` the final [D, H, W, 2] state without frame writes.

    On CUDA, one rollout3d_kernel launch per step; on the CPU, the plain
    version.  Any D, H, W >= 5 is taken: the TPU kernel's tile-alignment
    guard (D % 8, H*W % 128) has no counterpart here.  percnn_tpu's
    ``unroll`` (steps fused per TPU grid iteration) is a TPU grid-overhead
    knob and is not carried over, nor is its literal-form option
    (``expanded=False``): the kernel always runs the expanded cubic.
    """
    expanded = pack_pi_expanded_3d(params, cfg)
    h0 = h0.to(torch.float32).contiguous()
    if h0.device.type == "cpu":
        return fused_rollout_3d_plain(expanded, h0, n_steps, final_only=final_only)
    return _rollout_cuda(expanded.contiguous(), h0, n_steps, final_only=final_only)


fused_rollout_3d.launches = 0
