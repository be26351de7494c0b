"""Parameters between the JAX package's numpy trees and the port's tensors.

The trees keep the JAX package's layout (channels-last weights):

- cell: ``{'diff': [2], 'pi': [{'w0'..'w{N-1}': [Cin, C] (or [*k, Cin, C]),
  'b0'..: [C], 'w_out': [C, 1], 'b_out': [1]}, ...]}`` (percnn_tpu/core/cell.py);
- ISG: ``{'up{i}_w': [*k, Cin, Cout], 'up{i}_b': [Cout], 'out_w': [Cin, 2],
  'out_b': [2]}`` (percnn_tpu/core/isg.py);
- a model: ``{'cell': cell tree, 'isg': ISG tree}``.

So weights trained by either package load into the other unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from percnn_tpu_torch._device import resolve_device


def _map_tree(fn, tree: Any):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(tree: Any, *, device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None) -> dict:
    """numpy (or tensor) leaves -> tensors on `device`, as `dtype` if given.

    Dicts stay dicts and sequences become lists.
    """
    dev = resolve_device(device)

    def leaf(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        return t.to(device=dev, dtype=dtype)

    return _map_tree(leaf, tree)


def params_to_numpy(tree: Any) -> dict:
    """Tensor leaves -> numpy arrays on the host (the inverse of
    `params_from_numpy`)."""
    return _map_tree(lambda t: t.detach().cpu().numpy(), tree)


def unflatten_dotted(arrays, prefix: str):
    """Rebuild a parameter tree from dotted keys such as ``cell.pi.0.w0``.

    `arrays` maps key -> array (an ``np.load`` result or a dict).  Keys
    that start with `prefix` are split on dots after it; a level whose keys
    are all digits becomes a list.  Returns None when no key has the
    prefix.  This is the layout of the committed goldens
    ``tests/golden/pt_*.npz``.
    """
    names = arrays.files if hasattr(arrays, "files") else list(arrays)
    keys = [k for k in names if k.startswith(prefix)]
    if not keys:
        return None
    tree: dict = {}
    for k in keys:
        parts = k[len(prefix):].split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(arrays[k])

    def listify(node):
        if isinstance(node, dict):
            if node and all(p.isdigit() for p in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)
