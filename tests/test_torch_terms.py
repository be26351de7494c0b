"""percnn_tpu_torch.pde.terms on the CPU against percnn_tpu.pde.terms: the
library's order, the derivative dict of ``eval_grads`` (2D and 3D) and every
entry of ``TERM_REGISTRY``, on fields drawn by numpy from a seed.

Bars: f64 rtol 1e-12 (atol 1e-12); f32 rtol 2e-4, atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.pde import terms as jterms

from percnn_tpu_torch.pde import terms

DX = 0.2
BARS = {np.float64: dict(rtol=1e-12, atol=1e-12), np.float32: dict(rtol=2e-4, atol=1e-5)}


def _field(shape=(2, 16, 12, 2), seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) * 0.7 + 0.1


def _grads(h, dtype, ndim=2):
    x = h.astype(dtype)
    got = terms.eval_grads(torch.from_numpy(x), DX, ndim)
    want = jterms.eval_grads(jnp.asarray(x), DX, ndim)
    return got, want


def test_library_order_and_lists_match_jax():
    assert terms.gen_library() == jterms.gen_library()
    assert (terms.LIST_A, terms.LIST_B) == (jterms.LIST_A, jterms.LIST_B)
    assert list(terms.TERM_REGISTRY) == list(jterms.TERM_REGISTRY)
    assert terms.gen_library()[5] == "ones*lap_u" and len(terms.gen_library()) == 70


@pytest.mark.parametrize("ndim,shape", [(2, (2, 16, 12, 2)), (3, (6, 8, 10, 2))])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_eval_grads_matches_jax(ndim, shape, dtype):
    got, want = _grads(_field(shape), dtype, ndim)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **BARS[dtype],
                                   err_msg=k)


@pytest.mark.parametrize("name", list(jterms.TERM_REGISTRY))
def test_term_matches_jax(name):
    h = _field(seed=1)
    for dtype in (np.float64, np.float32):
        got_g, want_g = _grads(h, dtype)
        got = terms.TERM_REGISTRY[name](torch.from_numpy(h.astype(dtype)), got_g)
        want = jterms.TERM_REGISTRY[name](jnp.asarray(h.astype(dtype)), want_g)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BARS[dtype], err_msg=name)
    # the terms are products of the dict's entries: numpy in, numpy out
    grads_np = {k: np.asarray(v) for k, v in want_g.items()}
    got_np = terms.TERM_REGISTRY[name](h, grads_np)
    assert isinstance(got_np, np.ndarray)
    np.testing.assert_array_equal(got_np, jterms.TERM_REGISTRY[name](h, grads_np))
