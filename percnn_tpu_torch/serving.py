"""Serving: a weights-baked callable from a low-res IC to the rollout.

Counterpart of ``build_serving_fn`` in percnn_tpu/serving.py with
``use_pallas=True``: the ISG upsamples the request in-graph, then the fused
rollout runs on the card: a 2D cell through ``cell2d.fused_rollout_2d`` for
frames (``rollout2d_kernel``, or for a k x k cell with MXU_FWD_ENABLED
``rollout2d_kxk_kernel``) and ``fused_rollout_final_2d`` for the final
state (``final2d_kernel``, any kernel size), a 3D cell through
``rollout3d_kernel`` (frames, or the final state without frame writes).  For 3D the JAX package serves with its jnp rollout; the
math is the same.  Export and load of a serialized model come later.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from percnn_tpu_torch._device import full_f32, resolve_device
from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.core.isg import ISGConfig, isg_apply
from percnn_tpu_torch.ops.kernels.cell2d import (
    fused_rollout_2d,
    fused_rollout_final_2d,
)
from percnn_tpu_torch.ops.kernels.cell3d import fused_rollout_3d


def build_serving_fn(params: dict, cell_cfg: PiCellConfig, n_steps: int, *,
                     isg_cfg: ISGConfig | None = None, final_only: bool = False,
                     device: str | torch.device = "cuda") -> Callable:
    """Weights-baked inference callable: request -> rollout, in float32.

    `params` is a model tree ``{'cell': ..., 'isg': ...}`` (or a bare cell
    tree without an ISG), with numpy or tensor leaves; it is put on `device`
    once, here.  The request is the initial state [*spatial, 2], or the
    low-res measured IC [*spatial/s, 2] when `isg_cfg` is given.  The answer
    is a tensor on `device`: [n_steps+1, *spatial, 2] frames, or the final
    state [*spatial, 2] with `final_only=True`.
    """
    if not (isinstance(cell_cfg, PiCellConfig) and cell_cfg.ndim in (2, 3)):
        raise NotImplementedError("serving takes 2D and 3D Pi cells; the discovery "
                                  "pipeline's SymbolicCell is queued in ROADMAP.md A5")
    dev = resolve_device(device)
    params = params_from_numpy(params, device=dev, dtype=torch.float32)
    cell_params = params.get("cell", params)
    if cell_cfg.ndim == 2:
        roll = fused_rollout_final_2d if final_only else fused_rollout_2d
    else:
        def roll(p, h0, cfg, n):
            return fused_rollout_3d(p, h0, cfg, n, final_only=final_only)

    def fn(x: np.ndarray | torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        with torch.inference_mode(), full_f32():
            h0 = isg_apply(params["isg"], x[None], isg_cfg)[0] if isg_cfg else x
            return roll(cell_params, h0, cell_cfg, n_steps)

    return fn
