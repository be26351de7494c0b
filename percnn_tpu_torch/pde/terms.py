"""Candidate-term registry shared by the symbolic (Stage-3) cell and the
Stage-2 discovery library.

Counterpart of percnn_tpu/pde/terms.py.  Every term name maps to an explicit
callable ``(h, grads) -> field``, where `grads` is the precomputed
derivative dict of ``eval_grads``.  The terms are products of the dict's
entries, so they take torch tensors and numpy arrays alike (the Stage-2
library evaluates them on f64 numpy windows, discovery/library.py).

Term naming follows the reference, so coefficient indices keep their
meaning (must_have=5 means 'ones*lap_u'):
  LIST_A = [ones, u, v, u**2, u*v, v**2, u**3, u**2*v, u*v**2, v**3]
  LIST_B = [ones, u_x, u_y, v_x, v_y, lap_u, lap_v]
  library = [A + '*' + B for A in LIST_A for B in LIST_B]   (70 terms)
"""

from __future__ import annotations

import torch

from percnn_tpu_torch.ops.stencils import grad_x, grad_y, laplacian

LIST_A = ("ones", "u", "v", "u**2", "u*v", "v**2", "u**3", "u**2*v", "u*v**2", "v**3")
LIST_B = ("ones", "u_x", "u_y", "v_x", "v_y", "lap_u", "lap_v")


def gen_library() -> list[str]:
    """The 70-term library in the reference's order."""
    return [a + "*" + b for a in LIST_A for b in LIST_B]


def eval_grads(h: torch.Tensor, dx: float, ndim: int = 2) -> dict:
    """The derivative fields the terms draw from (4th-order central,
    periodic).

    h: [..., *spatial, C>=2]; returns a dict of [..., *spatial] fields.
    """
    dims = [h.ndim - 1 - ndim + i for i in range(ndim)]
    lap = laplacian(h, dx, dims=dims)
    u, v = h[..., 0], h[..., 1]
    return {
        "ones": torch.ones_like(u),
        "u": u,
        "v": v,
        "u_x": grad_x(h[..., 0:1], dx)[..., 0],
        "u_y": grad_y(h[..., 0:1], dx)[..., 0],
        "v_x": grad_x(h[..., 1:2], dx)[..., 0],
        "v_y": grad_y(h[..., 1:2], dx)[..., 0],
        "lap_u": lap[..., 0],
        "lap_v": lap[..., 1],
    }


def _poly(name: str):
    """Polynomial factor A(u, v) as a callable on grads."""
    if name == "ones":
        return lambda g: g["ones"]
    if name == "u":
        return lambda g: g["u"]
    if name == "v":
        return lambda g: g["v"]
    if name == "u**2":
        return lambda g: g["u"] * g["u"]
    if name == "u*v":
        return lambda g: g["u"] * g["v"]
    if name == "v**2":
        return lambda g: g["v"] * g["v"]
    if name == "u**3":
        return lambda g: g["u"] * g["u"] * g["u"]
    if name == "u**2*v":
        return lambda g: g["u"] * g["u"] * g["v"]
    if name == "u*v**2":
        return lambda g: g["u"] * g["v"] * g["v"]
    if name == "v**3":
        return lambda g: g["v"] * g["v"] * g["v"]
    raise KeyError(name)


def _make_term(a: str, b: str):
    pa = _poly(a)

    def term(h, grads):
        f = pa(grads)
        if b != "ones":
            f = f * grads[b]
        return f

    return term


TERM_REGISTRY = {}
for _a in LIST_A:
    for _b in LIST_B:
        TERM_REGISTRY[_a + "*" + _b] = _make_term(_a, _b)
# bare aliases for readability in experiment configs ('u' == 'u*ones', ...)
for _a in LIST_A[1:]:
    TERM_REGISTRY[_a] = _make_term(_a, "ones")
for _b in LIST_B[1:]:
    TERM_REGISTRY[_b] = _make_term("ones", _b)
