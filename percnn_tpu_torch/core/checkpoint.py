"""Atomic npz checkpoints in the JAX package's format, without JAX.

The format (percnn_tpu/core/checkpoint.py) stores each tree leaf as
``leaf_{i}``, the leaves' keypaths as a JSON list under ``__paths__`` (in
``jax.tree_util.keystr`` form: ``['cell']['pi'][0]['w0']``) and JSON
metadata under ``__meta__``.  Trees are nested dicts and lists; dict keys
are flattened in sorted order, as JAX flattens them.  A file is written
under a temporary name and renamed, so a reader never sees half of one.
Either package reads the other's parameter checkpoints.
"""

from __future__ import annotations

import functools
import json
import os
import re
import tempfile
from typing import Any

import numpy as np
import torch

# keystr segments: ['key'] (dict), [3] (sequence), .attr (named field)
_KEY_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.([A-Za-z_][A-Za-z0-9_]*)")


@functools.lru_cache(maxsize=4096)
def _parse_keypath(p: str) -> tuple:
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
    return tuple(keys)


def flatten_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(keystr path, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten_with_paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in flatten_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, meta: dict | None = None) -> None:
    """Atomically save a tree of tensors or arrays (+ JSON-able metadata)."""
    pairs = flatten_with_paths(tree)
    payload = {f"leaf_{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(pairs)}
    payload["__paths__"] = np.asarray(json.dumps([p for p, _ in pairs]))
    payload["__meta__"] = np.asarray(json.dumps(meta or {}))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def peek_meta(path: str) -> dict:
    """Only the JSON metadata of a checkpoint."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))


def load_checkpoint(path: str, like: Any) -> tuple[Any, dict]:
    """Load into the structure of `like`, matching leaves by keypath;
    returns (tree, meta).  Tensor leaves of `like` give tensors of its
    dtype on its device; other leaves give numpy arrays."""
    with np.load(path, allow_pickle=False) as z:
        paths = json.loads(str(z["__paths__"]))
        meta = json.loads(str(z["__meta__"]))
        by_path = {p: z[f"leaf_{i}"] for i, p in enumerate(paths)}
    missing = [p for p, _ in flatten_with_paths(like) if p not in by_path]
    if missing:
        raise KeyError(f"checkpoint {path} missing leaves: {missing[:5]}")

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}['{k}']") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rebuild(v, f"{prefix}[{i}]") for i, v in enumerate(node)]
        arr = by_path[prefix]
        if isinstance(node, torch.Tensor):
            return torch.as_tensor(arr, dtype=node.dtype).to(node.device)
        return arr

    return rebuild(like, ""), meta


def unflatten_paths(paths: list[str], leaves: list) -> Any:
    """Rebuild nested dicts and lists from keystr paths and their leaves
    (the inverse of flatten_with_paths).  Integer keys become list slots;
    named fields (such as an optimizer state's ``.mu``) become dict keys."""
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

    return listify(root)


def load_checkpoint_tree(path: str) -> tuple[dict, dict]:
    """Rebuild nested dicts and lists from the stored keypaths
    (``unflatten_paths``).  Returns (tree, meta)."""
    with np.load(path, allow_pickle=False) as z:
        paths = json.loads(str(z["__paths__"]))
        meta = json.loads(str(z["__meta__"]))
        leaves = [z[f"leaf_{i}"] for i in range(len(paths))]
    return unflatten_paths(paths, leaves), meta
