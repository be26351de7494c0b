"""Symbolic extraction: recover the closed-form polynomial a trained
Pi-block represents.

A copy of percnn_tpu/discovery/symbolic.py (the reference `get_expression`,
train_3drd.py:442-468), except that sympy is imported inside the functions:
the package imports without sympy, and only a caller of these functions
needs it.  With 1x1 branches the Pi-block is exactly
    W_out . ( (W_0 X + b_0) o (W_1 X + b_1) o ... ) + b_out
an elementwise product of affine forms in X = (u, v), i.e. a polynomial of
degree n_branches; it is expanded with sympy and its coefficients read off.
"""

from __future__ import annotations

import numpy as np


def pi_block_expression(branch: dict, var_names=("u", "v"), simplify: bool = True):
    """branch: the per-channel Pi params ({w0, b0, ..., w_out, b_out}) with
    1x1 weights [Cin, hidden], as numpy arrays.  Returns an expanded sympy
    expression."""
    import sympy as sp

    X = sp.Matrix([sp.Symbol(n) for n in var_names])
    n_branches = len([k for k in branch if k.startswith("w") and k != "w_out"])
    hidden = np.asarray(branch["w0"]).shape[1]
    prod = sp.ones(hidden, 1)
    for i in range(n_branches):
        W = sp.Matrix(np.asarray(branch[f"w{i}"], np.float64)).T  # [hidden, Cin]
        b = sp.Matrix(np.asarray(branch[f"b{i}"], np.float64))
        affine = W * X + b
        prod = prod.multiply_elementwise(affine)
    Wo = sp.Matrix(np.asarray(branch["w_out"], np.float64)).T  # [1, hidden]
    expr = (Wo * prod)[0, 0] + float(np.asarray(branch["b_out"])[0])
    return sp.expand(sp.nsimplify(expr, rational=False)) if simplify else expr


def expression_coefficients(expr, var_names=("u", "v"), max_order: int = 3) -> dict:
    """Coefficient dict {monomial-string: float} of an expanded expression,
    e.g. {'1': c0, 'u': c1, 'u*v**2': c5, ...}."""
    import sympy as sp

    syms = [sp.Symbol(n) for n in var_names]
    poly = sp.Poly(expr, *syms)
    out = {}
    for monom, coef in poly.terms():
        if sum(monom) > max_order:
            continue
        key_parts = []
        for s, p in zip(syms, monom):
            if p == 1:
                key_parts.append(str(s))
            elif p > 1:
                key_parts.append(f"{s}**{p}")
        out["*".join(key_parts) if key_parts else "1"] = float(coef)
    return out
