"""Serving: a weights-baked callable from a low-res IC to the rollout, and
its export as a self-contained artifact.

Counterpart of percnn_tpu/serving.py with ``use_pallas=True``: the ISG
upsamples the request in-graph, then the fused rollout runs on the card,
one launch a request on the models' shapes: a 2D cell through
``cell2d.fused_rollout_2d`` for frames and ``cell2d.fused_rollout_final_2d``
for the final state, both by the same one-launch kernels
(``rollout2d_cluster_kernel`` for the GS2D cell,
``rollout2d_kxk_persistent_kernel`` for a k x k cell with MXU_FWD_ENABLED,
``rollout2d_ffma_persistent_kernel`` without; the final state without frame
writes, equal to the last frame), or past their plans one launch a step
(``rollout2d_kernel``, ``final2d_kernel``); a 3D cell through
``cell3d.fused_rollout_3d`` (frames, or the final state without frame
writes).  For 3D the JAX package serves with its jnp rollout; the math is
the same.  The discovery pipeline's symbolic cell (``SymbolicCellConfig``)
is served by the eager rollout of its step, Euler or RK4, as in the JAX
package: no kernel stands behind it.

``export_model`` traces the same model with ``torch.export``: the weights
are buffers of the program, the ISG is its aten convolutions, and the
rollout is one node of the operator ``percnn_tpu_torch::serve_rollout``
(ops/kernels/serve_ops.py), whatever the number of steps.  The artifact is
the JAX package's: an ``.npz`` with the serialized program (``blob``) and
a JSON ``config``.  ``load_model`` gives a callable that runs the program
on any device: the operator picks the kernel or the plain version by the
request's device, so unlike the JAX package's Pallas artifacts (bound to
the TPU generation they were traced on) the artifact is not bound to a
device, but it needs this package to register the operator.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Callable

import numpy as np
import torch

from percnn_tpu_torch._device import full_f32, repeatable, resolve_device
from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig, SymbolicCellConfig
from percnn_tpu_torch.core.isg import ISGConfig, isg_apply
from percnn_tpu_torch.ops.kernels import serve_ops


def build_serving_fn(params: dict, cell_cfg: PiCellConfig | SymbolicCellConfig,
                     n_steps: int, *, isg_cfg: ISGConfig | None = None,
                     final_only: bool = False,
                     device: str | torch.device = "cuda") -> Callable:
    """Weights-baked inference callable: request -> rollout, in float32.

    `params` is a model tree ``{'cell': ..., 'isg': ...}`` (or a bare cell
    tree without an ISG), with numpy or tensor leaves; it is put on `device`
    once, here.  The request is the initial state [*spatial, 2], or the
    low-res measured IC [*spatial/s, 2] when `isg_cfg` is given.  The answer
    is a tensor on `device`: [n_steps+1, *spatial, 2] frames, or the final
    state [*spatial, 2] with `final_only=True`.  It runs in full float32 and
    with cuDNN's deterministic algorithms (``_device.repeatable``), so the
    same request gets the same answer, to the bit.
    """
    serve_ops.check_servable(cell_cfg)
    dev = resolve_device(device)
    params = params_from_numpy(params, device=dev, dtype=torch.float32)
    cell_params = params.get("cell", params)

    def fn(x: np.ndarray | torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        with torch.inference_mode(), full_f32(), repeatable():
            h0 = isg_apply(params["isg"], x[None], isg_cfg)[0] if isg_cfg else x
            return serve_ops.serve_rollout_eager(cell_params, h0, cell_cfg, n_steps,
                                                 final_only)

    return fn


def _own(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone(memory_format=torch.contiguous_format)


class _ServedModel(torch.nn.Module):
    """The exported model: the ISG's convolutions, then one serve_rollout
    node.  Every weight is a buffer, a contiguous copy with a storage of its
    own (torch.export.save writes each storage whole)."""

    def __init__(self, params: dict, cell_cfg, n_steps: int, isg_cfg: ISGConfig | None,
                 final_only: bool):
        super().__init__()
        self.cell_json, leaves = serve_ops.cell_spec(cell_cfg, params.get("cell", params))
        self.n_cell = len(leaves)
        for i, leaf in enumerate(leaves):
            self.register_buffer(f"cell_{i}", _own(leaf))
        self.isg_cfg = isg_cfg
        self.isg_keys = sorted(params["isg"]) if isg_cfg is not None else []
        for k in self.isg_keys:
            self.register_buffer(f"isg_{k}", _own(params["isg"][k]))
        self.n_steps = n_steps
        self.final_only = final_only

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0 = x
        if self.isg_cfg is not None:
            isg = {k: getattr(self, f"isg_{k}") for k in self.isg_keys}
            h0 = isg_apply(isg, x[None], self.isg_cfg)[0]
        leaves = [getattr(self, f"cell_{i}") for i in range(self.n_cell)]
        return serve_ops.serve_rollout(leaves, h0, self.cell_json, self.n_steps,
                                       self.final_only)


def export_program(params: dict, cell_cfg: PiCellConfig | SymbolicCellConfig, n_steps: int,
                   input_shape: tuple, *, isg_cfg: ISGConfig | None = None,
                   final_only: bool = False, device: str | torch.device = "cuda"):
    """The ``torch.export.ExportedProgram`` of the weights-baked model,
    traced on `device` with the weights cast to float32, then moved to the
    CPU (so it loads on a machine without a card)."""
    serve_ops.check_servable(cell_cfg)
    dev = resolve_device(device)
    params = params_from_numpy(params, device=dev, dtype=torch.float32)
    model = _ServedModel(params, cell_cfg, n_steps, isg_cfg, final_only)
    spec = torch.zeros(tuple(input_shape), dtype=torch.float32, device=dev)
    with torch.no_grad():
        ep = torch.export.export(model, (spec,), strict=False)
    if dev.type != "cpu":
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, "cpu")
    return ep


def export_model(params: dict, cell_cfg: PiCellConfig | SymbolicCellConfig, n_steps: int,
                 input_shape: tuple, *, isg_cfg: ISGConfig | None = None,
                 final_only: bool = False, path: str | None = None,
                 device: str | torch.device = "cuda") -> bytes:
    """Trace and serialize the weights-baked rollout; returns the bytes of
    ``torch.export.save``.

    input_shape: the shape of the serving input ([*spatial, C], low-res
    when an ISG is baked in).  If `path` is given, writes the artifact
    ``.npz``: ``blob`` and a JSON ``config`` with the JAX package's keys
    (``cell``, ``cell_kind``, ``isg``, ``n_steps``, ``input_shape``,
    ``dtype``, ``final_only``), ``torch_version`` and ``traced_on`` (the
    device type of the trace).
    """
    ep = export_program(params, cell_cfg, n_steps, input_shape, isg_cfg=isg_cfg,
                        final_only=final_only, device=device)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()
    if path is not None:
        cfg_json = {
            "cell": dataclasses.asdict(cell_cfg),
            "cell_kind": type(cell_cfg).__name__,
            "isg": dataclasses.asdict(isg_cfg) if isg_cfg else None,
            "n_steps": n_steps,
            "input_shape": list(input_shape),
            "dtype": "float32",
            "final_only": final_only,
            "torch_version": torch.__version__,
            "traced_on": resolve_device(device).type,
        }
        np.savez(path, blob=np.frombuffer(blob, np.uint8),
                 config=np.asarray(json.dumps(cfg_json)))
    return blob


def load_model(path_or_blob: str | bytes,
               device: str | torch.device = "cuda") -> tuple[Callable, dict]:
    """Deserialize an exported artifact; returns (callable, config dict),
    the config {} for bare bytes.

    The callable takes the request (numpy or tensor) and answers on
    `device`, as build_serving_fn does: in full float32 and with cuDNN's
    deterministic algorithms (``_device.full_f32``, ``repeatable``: global
    state that the program does not carry).  The rollout node launches the
    hand-written kernel on the card and the plain version on the CPU.
    """
    dev = resolve_device(device)
    if isinstance(path_or_blob, (bytes, bytearray)):
        blob, cfg = bytes(path_or_blob), {}
    else:
        with np.load(path_or_blob, allow_pickle=False) as z:
            blob = z["blob"].tobytes()
            cfg = json.loads(str(z["config"]))
    ep = torch.export.load(io.BytesIO(blob))
    if dev.type != "cpu":
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, dev)
    module = ep.module()

    def fn(x: np.ndarray | torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        with torch.no_grad(), full_f32(), repeatable():
            return module(x)

    return fn, cfg
