"""The Stage-3 symbolic cell of percnn_tpu_torch on the CPU against
percnn_tpu's: one step (Euler and RK4, raw and sigmoid diffusion, the
Burgers and lambda-omega term lists), the gradients of a 10-step rollout
loss in nu and the coefficients, the cell's init, and its serving through
``build_serving_fn`` against percnn_tpu.serving's.

Bars: a step f64 rtol 1e-10 (atol 1e-10), f32 rtol 2e-4, atol 1e-5;
gradients rtol 2e-4, atol 2e-6; serving the f32 forward bar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import SymbolicCellConfig as JSymbolicCellConfig
from percnn_tpu.core.cell import init_symbolic_cell as j_init_symbolic_cell
from percnn_tpu.core.cell import symbolic_cell_step as j_symbolic_cell_step
from percnn_tpu.core.isg import ISGConfig as JISGConfig, init_isg as j_init_isg
from percnn_tpu.core.rollout import rollout as j_rollout
from percnn_tpu.serving import build_serving_fn as j_build_serving_fn

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import (
    SymbolicCellConfig,
    init_symbolic_cell,
    symbolic_cell_step,
)
from percnn_tpu_torch.core.isg import ISGConfig
from percnn_tpu_torch.core.rollout import rollout
from percnn_tpu_torch.serving import build_serving_fn

TERMS = {
    "burgers": (("u*u_x", "v*u_y"), ("u*v_x", "v*v_y")),
    "lambda_omega": (("u", "u**3", "u**2*v", "u*v**2", "v**3"),
                     ("v", "v**3", "u**3", "u*v**2", "u**2*v")),
}
DT_DX = {"burgers": (0.00025, 0.01), "lambda_omega": (0.0125, 0.2)}
ISG = dict(ndim=2, hidden=4, strides=(2,), activation="tanh")


def _cfg(system, integrator="euler", diffusion="raw"):
    dt, dx = DT_DX[system]
    return dict(ndim=2, dt=dt, dx=dx, terms=TERMS[system], integrator=integrator,
                diffusion=diffusion, mu_up=0.01 if system == "burgers" else 0.2)


def _params(cfg, seed=0, dtype=jnp.float64):
    jp = j_init_symbolic_cell(jax.random.PRNGKey(seed), JSymbolicCellConfig(**cfg), dtype=dtype)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _state(n=16, seed=1):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    smooth = np.stack([np.sin(x)[:, None] * np.cos(x)[None, :],
                       np.cos(2 * x)[:, None] * np.ones(n)[None, :]], axis=-1)
    return 0.6 * smooth + 0.05 * rng.standard_normal((n, n, 2))


CASES = [(s, i, d) for s in TERMS for i in ("euler", "rk4") for d in ("raw", "sigmoid")]


@pytest.mark.parametrize("system,integrator,diffusion", CASES)
def test_symbolic_step_matches_jax(system, integrator, diffusion):
    cfg = _cfg(system, integrator, diffusion)
    h = _state()
    for jdtype, dtype, bar in ((jnp.float64, torch.float64, dict(rtol=1e-10, atol=1e-10)),
                               (jnp.float32, torch.float32, dict(rtol=2e-4, atol=1e-5))):
        jp, npp = _params(cfg, dtype=jdtype)
        want = np.asarray(j_symbolic_cell_step(jp, jnp.asarray(h, jdtype),
                                               JSymbolicCellConfig(**cfg)))
        got = symbolic_cell_step(params_from_numpy(npp, device="cpu"),
                                 torch.as_tensor(h, dtype=dtype), SymbolicCellConfig(**cfg))
        assert got.dtype == dtype and got.shape == h.shape
        np.testing.assert_allclose(got.numpy(), want, **bar)


@pytest.mark.parametrize("system,integrator,diffusion", CASES)
def test_rollout_gradients_match_jax(system, integrator, diffusion):
    """d/d(nu, coef) of mean((frames[1:] - target)^2) over a 10-step rollout
    in float32, against jax.grad through percnn_tpu's rollout."""
    cfg = _cfg(system, integrator, diffusion)
    h = _state().astype(np.float32)
    target = (_state(seed=2) * 0.5).astype(np.float32)
    jp, npp = _params(cfg, seed=3, dtype=jnp.float32)
    jcfg, tcfg = JSymbolicCellConfig(**cfg), SymbolicCellConfig(**cfg)

    def jloss(p):
        frames = j_rollout(lambda x: j_symbolic_cell_step(p, x, jcfg), jnp.asarray(h), 10,
                           remat=False)
        return jnp.mean((frames[1:] - target) ** 2)

    jg = jax.grad(jloss)(jp)
    tp = params_from_numpy(npp, device="cpu")
    leaves = [tp["nu"], *tp["coef"]]
    for t in leaves:
        t.requires_grad_(True)
    frames = rollout(lambda x: symbolic_cell_step(tp, x, tcfg), torch.from_numpy(h), 10)
    loss = ((frames[1:] - torch.from_numpy(target)) ** 2).mean()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jp)), rtol=2e-4)
    grads = torch.autograd.grad(loss, leaves)
    for got, want in zip(grads, [jg["nu"], *jg["coef"]]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-6)


def test_init_symbolic_cell_layout_and_draws():
    cfg = SymbolicCellConfig(**_cfg("lambda_omega"))
    jp = j_init_symbolic_cell(jax.random.PRNGKey(0), JSymbolicCellConfig(**_cfg("lambda_omega")))
    p = init_symbolic_cell(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert p["nu"].shape == jp["nu"].shape == (2,)
    assert [c.shape for c in p["coef"]] == [c.shape for c in jp["coef"]] == [(5,), (5,)]
    assert all(t.dtype == torch.float32 for t in (p["nu"], *p["coef"]))
    draws = torch.cat([p["nu"], *p["coef"]])
    assert float(draws.abs().max()) <= 1.0 and float(draws.std()) > 0.1
    # the Stage-2 initial values pass through as given (an empty term list too)
    q = init_symbolic_cell(torch.Generator(), dataclasses.replace(cfg, terms=(("u",), ())),
                           coef_init=((0.5,), ()), nu_init=(0.1, 0.2), dtype=torch.float64,
                           device="cpu")
    assert q["nu"].tolist() == [0.1, 0.2] and q["coef"][0].tolist() == [0.5]
    assert q["coef"][1].shape == (0,) and q["coef"][0].dtype == torch.float64


@pytest.mark.parametrize("final_only", [False, True])
@pytest.mark.parametrize("with_isg", [False, True])
def test_symbolic_serving_matches_jax(final_only, with_isg):
    cfg = _cfg("lambda_omega", "rk4" if final_only else "euler")
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    jcell = j_init_symbolic_cell(k1, JSymbolicCellConfig(**cfg))
    jm = {"cell": jcell, "isg": j_init_isg(k2, JISGConfig(**ISG))} if with_isg else jcell
    nm = jax.tree_util.tree_map(np.asarray, jm)
    x = (_state(n=8 if with_isg else 16) * 0.5).astype(np.float32)
    isg = (JISGConfig(**ISG), ISGConfig(**ISG)) if with_isg else (None, None)
    want = np.asarray(j_build_serving_fn(jm, JSymbolicCellConfig(**cfg), 6, isg_cfg=isg[0],
                                         final_only=final_only)(jnp.asarray(x)))
    fn = build_serving_fn(nm, SymbolicCellConfig(**cfg), 6, isg_cfg=isg[1],
                          final_only=final_only, device="cpu")
    got = fn(x)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == ((16, 16, 2) if final_only else (7, 16, 16, 2)) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)

