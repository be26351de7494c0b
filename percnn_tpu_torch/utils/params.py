"""Parameter inspection (the reference's count_parameters /
summary_parameters, percnn_LO_eqn.py:396-472).

Counterpart of percnn_tpu/utils/params.py over the port's trees: nested
dicts and lists whose leaves are tensors or numpy arrays.  Keypaths and
their order are those of core.checkpoint.flatten_with_paths, which are
JAX's, so both packages print the same summary for the same tree.
"""

from __future__ import annotations

import math

from percnn_tpu_torch.core.checkpoint import flatten_with_paths


def _leaves(tree) -> list:
    # None is an empty subtree in JAX's flattening, not a leaf
    return [(p, x) for p, x in flatten_with_paths(tree) if x is not None]


def _shape(x) -> tuple:
    return tuple(getattr(x, "shape", ()))


def count_parameters(tree) -> int:
    return sum(math.prod(_shape(x)) for _, x in _leaves(tree))


def summary_parameters(tree) -> str:
    lines = [f"{path}: {_shape(leaf)}" for path, leaf in _leaves(tree)]
    lines.append(f"total: {count_parameters(tree)}")
    return "\n".join(lines)
