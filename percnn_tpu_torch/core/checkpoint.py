"""Read the JAX package's npz checkpoints without JAX.

The format (percnn_tpu/core/checkpoint.py) stores each pytree leaf as
``leaf_{i}``, the leaves' keypaths as a JSON list under ``__paths__`` (in
``jax.tree_util.keystr`` form: ``['cell']['pi'][0]['w0']``) and JSON
metadata under ``__meta__``.  The tree comes back as nested dicts and
lists of numpy arrays; ``bridge.params_from_numpy`` puts it on a device.
"""

from __future__ import annotations

import json
import re

import numpy as np

# keystr segments: ['key'] (dict), [3] (sequence), .attr (named field)
_KEY_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.([A-Za-z_][A-Za-z0-9_]*)")


def _parse_keypath(p: str) -> list:
    keys = []
    covered = 0
    for m in _KEY_RE.finditer(p):
        if m.start() != covered:
            break
        covered = m.end()
        name, idx, attr = m.groups()
        keys.append(int(idx) if idx is not None
                    else (name if name is not None else attr))
    if not keys or covered != len(p):
        raise ValueError(f"unparseable checkpoint keypath {p!r}")
    return keys


def load_checkpoint_tree(path: str) -> tuple[dict, dict]:
    """Rebuild nested dicts and lists from the stored keypaths.

    Returns (tree, meta).  Integer keys become list slots; named fields
    (such as an optimizer state's ``.mu``) become dict keys.
    """
    with np.load(path, allow_pickle=False) as z:
        paths = json.loads(str(z["__paths__"]))
        meta = json.loads(str(z["__meta__"]))
        leaves = [z[f"leaf_{i}"] for i in range(len(paths))]

    root: dict = {}
    for p, leaf in zip(paths, leaves):
        keys = _parse_keypath(p)
        node = root
        for a in keys[:-1]:
            node = node.setdefault(a, {})
            if not isinstance(node, dict):
                raise ValueError(f"keypath {p!r} descends into a leaf")
        node[keys[-1]] = leaf

    def listify(node):
        if isinstance(node, dict):
            if node and all(isinstance(k, int) for k in node):
                if sorted(node) != list(range(len(node))):
                    raise ValueError("non-contiguous sequence keypaths")
                return [listify(node[i]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root), meta
