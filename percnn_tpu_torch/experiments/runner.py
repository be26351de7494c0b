"""Experiment runner, the part that serving needs: model init and inference.

Counterpart of ``init_model`` and ``inference_rollout`` in
percnn_tpu/experiments/runner.py.  ``inference_rollout`` takes the request
(the low-res IC, or the full-res IC when the model has no ISG) directly,
instead of a truth-carrying Problem.
"""

from __future__ import annotations

import torch

from percnn_tpu_torch._device import full_f32, resolve_device
from percnn_tpu_torch.core.cell import init_pi_cell
from percnn_tpu_torch.core.isg import init_isg, isg_apply
from percnn_tpu_torch.experiments.configs import ExperimentConfig
from percnn_tpu_torch.ops.kernels.cell2d import fused_rollout_2d


def init_model(exp: ExperimentConfig, gen: torch.Generator, dtype=torch.float32,
               *, device: str | torch.device = "cuda") -> dict:
    """Random model parameters {'cell', 'isg'} drawn from `gen` (CPU)."""
    dev = resolve_device(device)
    params = {"cell": init_pi_cell(gen, exp.cell, dtype, device=dev)}
    if exp.isg is not None:
        params["isg"] = init_isg(gen, exp.isg, dtype, device=dev)
    return params


def inference_rollout(params: dict, exp: ExperimentConfig, x, n_steps: int, *,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """ISG (if the model has one), then the fused 2D rollout:
    [n_steps+1, H, W, 2] f32 frames on `device`.

    x: the low-res IC [H/s, W/s, 2] when ``exp.isg`` is set, else the IC.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    with torch.inference_mode(), full_f32():
        h0 = isg_apply(params["isg"], x[None], exp.isg)[0] if exp.isg else x
        return fused_rollout_2d(params["cell"], h0, exp.cell, n_steps)
