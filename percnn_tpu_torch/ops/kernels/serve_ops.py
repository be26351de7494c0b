"""The serving rollout as one PyTorch operator, so that an exported model
graph still launches the hand-written kernels.

A ctypes launch is opaque to ``torch.export``, and tracing the rollout's
Python loop would unroll it into a graph that grows with the number of
steps.  ``percnn_tpu_torch::serve_rollout`` (a ``torch.library.custom_op``)
holds the whole rollout as one node:

    serve_rollout(Tensor[] leaves, Tensor h0, str cell_json, int n_steps,
                  bool final_only) -> Tensor

``leaves`` are the cell's parameter leaves in ``flatten_with_paths``
order; ``cell_json`` (from ``cell_spec``) holds the cell's config and the
leaves' keypaths.  The operator rebuilds the parameter tree and runs the
rollout that ``serving.build_serving_fn`` runs: ``cell2d.fused_rollout_2d``
or ``fused_rollout_final_2d`` for a 2D Pi cell (rows 1 and 2 at k = 1; 3
and 2 at k = 5), ``cell3d.fused_rollout_3d`` for a 3D one (row 8), and the
eager rollout of ``symbolic_cell_step`` for a symbolic cell (no kernel).
So a CUDA tensor launches the kernel or raises and a CPU tensor takes the
plain version, by the rule every wrapper follows; each launch is counted by
the wrapper's own counter.  The fake (meta) implementation gives the
answer's shape only: it builds and launches nothing.

Importing this module registers the operator; ``serving.load_model``
imports it before it loads a program.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import torch

from percnn_tpu_torch.core.cell import PiCellConfig, SymbolicCellConfig, symbolic_cell_step
from percnn_tpu_torch.core.checkpoint import flatten_with_paths, unflatten_paths
from percnn_tpu_torch.core.rollout import rollout, rollout_final
from percnn_tpu_torch.ops.kernels.cell2d import fused_rollout_2d, fused_rollout_final_2d
from percnn_tpu_torch.ops.kernels.cell3d import fused_rollout_3d

_CELL_KINDS = {"PiCellConfig": PiCellConfig, "SymbolicCellConfig": SymbolicCellConfig}


def _tuples(v):
    """JSON lists back to the tuples the frozen configs hold."""
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def config_from_dict(kind: str, fields: dict):
    """A cell or ISG config from ``dataclasses.asdict`` output read back
    from JSON (lists become tuples again)."""
    return _CELL_KINDS[kind](**{k: _tuples(v) for k, v in fields.items()})


def cell_spec(cell_cfg, cell_params: dict) -> tuple[str, list]:
    """(cell_json, leaves) of a cell: its config and its parameter leaves'
    keypaths as JSON, and the leaves in that order."""
    pairs = flatten_with_paths(cell_params)
    spec = {"kind": type(cell_cfg).__name__, "cfg": dataclasses.asdict(cell_cfg),
            "paths": [p for p, _ in pairs]}
    return json.dumps(spec), [leaf for _, leaf in pairs]


@functools.lru_cache(maxsize=64)
def _parse_spec(cell_json: str) -> tuple:
    """(config, keypaths) of a cell_json, parsed once per string: the
    operator reads it on every request."""
    spec = json.loads(cell_json)
    return config_from_dict(spec["kind"], spec["cfg"]), tuple(spec["paths"])


def check_servable(cfg) -> None:
    """Raise unless serving takes the cell: a 2D or 3D Pi cell, or a
    symbolic cell."""
    if not (isinstance(cfg, SymbolicCellConfig)
            or isinstance(cfg, PiCellConfig) and cfg.ndim in (2, 3)):
        raise NotImplementedError(f"serving takes 2D and 3D Pi cells and symbolic cells, "
                                  f"not {cfg!r}")


def serve_rollout_eager(params: dict, h0: torch.Tensor, cfg, n_steps: int,
                        final_only: bool) -> torch.Tensor:
    """The rollout of build_serving_fn: frames [n_steps+1, *spatial, 2], or
    the final state with `final_only`."""
    check_servable(cfg)
    if isinstance(cfg, SymbolicCellConfig):
        step = lambda h: symbolic_cell_step(params, h, cfg)  # noqa: E731
        return rollout_final(step, h0, n_steps) if final_only else rollout(
            step, h0, n_steps, remat=False)
    if cfg.ndim == 3:
        return fused_rollout_3d(params, h0, cfg, n_steps, final_only=final_only)
    roll = fused_rollout_final_2d if final_only else fused_rollout_2d
    return roll(params, h0, cfg, n_steps)


@torch.library.custom_op("percnn_tpu_torch::serve_rollout", mutates_args=())
def serve_rollout(leaves: list[torch.Tensor], h0: torch.Tensor, cell_json: str,
                  n_steps: int, final_only: bool) -> torch.Tensor:
    cfg, paths = _parse_spec(cell_json)
    out = serve_rollout_eager(unflatten_paths(paths, list(leaves)), h0, cfg, n_steps, final_only)
    # an operator's output may not alias its input (the final state of
    # zero steps is h0 itself)
    return out.clone() if out.untyped_storage().data_ptr() == h0.untyped_storage().data_ptr() \
        else out


@serve_rollout.register_fake
def _serve_rollout_fake(leaves, h0, cell_json, n_steps, final_only):
    shape = tuple(h0.shape) if final_only else (n_steps + 1, *h0.shape)
    return h0.new_empty(shape, dtype=torch.float32)
