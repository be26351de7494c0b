"""percnn_tpu_torch.discovery on the CPU against percnn_tpu.discovery: the
design matrix, STRidge, the Pareto selection, the metrics, the symbolic
extraction and the residual diagnostic on the same inputs, and the cases of
tests/test_discovery.py run through the port.

Bars: the design matrix rtol 1e-12 (atol 1e-12); STRidge, pareto_select and
discovery_metrics to the bit (the port keeps a copy of the numpy module);
pi_block_expression the same string.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from percnn_tpu.core.cell import init_pi_cell as j_init_pi_cell
from percnn_tpu.discovery import library as jlibrary
from percnn_tpu.discovery import stridge as jstridge
from percnn_tpu.discovery import symbolic as jsymbolic
from percnn_tpu.experiments import configs as jconfigs
from percnn_tpu.pde.systems import PDE_SYSTEMS as J_PDE_SYSTEMS

from percnn_tpu_torch.data.noise import add_noise
from percnn_tpu_torch.data.simulate import default_ic, simulate
from percnn_tpu_torch.discovery import library, stridge, symbolic
from percnn_tpu_torch.discovery.library import build_design_matrix
from percnn_tpu_torch.discovery.stridge import STRidge, discovery_metrics, pareto_sweep
from percnn_tpu_torch.discovery.symbolic import expression_coefficients, pi_block_expression
from percnn_tpu_torch.experiments.configs import BURGERS_STAGE1, LO_STAGE1
from percnn_tpu_torch.pde.systems import PDE_SYSTEMS
from percnn_tpu_torch.pde.terms import gen_library


def _recon(seed=0, shape=(24, 16, 16, 2)):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, shape[0])[:, None, None, None]
    base = np.sin(np.linspace(0, 2 * np.pi, shape[1], endpoint=False))[None, :, None, None]
    return (0.5 * base * np.cos(3 * t) + 0.1 * rng.standard_normal(shape)).astype(np.float32)


def _lo_sim(n=16, frames=24):
    h0 = simulate("lambda_omega", default_ic("lambda_omega", n, seed=1), 20, 0.0125, 0.2,
                  device="cpu")[-1]
    return simulate("lambda_omega", h0, frames - 1, 0.0125, 0.2, device="cpu")


@pytest.mark.parametrize("frames,subsample,seed", [(slice(0, 20), 0.2, 0), (slice(2, 24), 1.0, 0),
                                                    (slice(0, 24), 0.5, 3)])
def test_design_matrix_matches_jax(frames, subsample, seed):
    recon = _recon()
    got = build_design_matrix(recon, 0.0125, 0.2, frames=frames, subsample=subsample, seed=seed)
    want = jlibrary.build_design_matrix(recon, 0.0125, 0.2, frames=frames,
                                        subsample=subsample, seed=seed)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_eval_grads_np_matches_jax():
    win = _recon().astype(np.float64)
    got, want = library._eval_grads_np(win, 0.2), jlibrary._eval_grads_np(win, 0.2)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12, err_msg=k)


def test_reconstruction_residual_mse_matches_jax():
    roll = _lo_sim()
    got = library.reconstruction_residual_mse(roll, PDE_SYSTEMS["lambda_omega"], 0.0125, 0.2,
                                              device="cpu")
    want = jlibrary.reconstruction_residual_mse(roll, J_PDE_SYSTEMS["lambda_omega"], 0.0125, 0.2)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def _matrices():
    roll = add_noise(_lo_sim(), 0.01, seed=7)
    return build_design_matrix(roll, 0.0125, 0.2, frames=slice(0, 24), subsample=0.5, seed=1)


@pytest.mark.parametrize("kwargs", [
    dict(maxit=20, stridge_iters=10, lam=1e-4, d_tol=5.0),
    dict(maxit=20, stridge_iters=10, lam=1e-4, d_tol=5.0, l0_penalty=1e-6, must_have=5),
    dict(maxit=10, stridge_iters=10, lam=0.0, d_tol=2.0, must_have=[5, 1]),
])
def test_stridge_equals_jax_to_the_bit(kwargs):
    R, Ut, Vt, _ = _matrices()
    for y in (Ut, Vt):
        got = STRidge(R, y).train(**kwargs)
        want = jstridge.STRidge(R, y).train(**kwargs)
        np.testing.assert_array_equal(got, want)


def test_pareto_select_and_metrics_equal_jax_to_the_bit():
    R, Ut, _, names = _matrices()
    gammas = np.array([0.01 * 1.5 ** i for i in range(6)])
    kw = dict(gammas=gammas, maxit=8, stridge_iters=8, lam=1e-4, d_tol=5.0)
    w, info = stridge.pareto_select(STRidge(R, Ut), **kw)
    jw, jinfo = jstridge.pareto_select(jstridge.STRidge(R, Ut), **kw)
    np.testing.assert_array_equal(w, jw)
    assert info["selected_index"] == jinfo["selected_index"]
    for k in ("gammas", "ls_loss", "l0_count"):
        np.testing.assert_array_equal(info[k], jinfo[k])
    truth = np.zeros((len(names), 1))
    truth[names.index("ones*lap_u")], truth[names.index("u*ones")] = 0.1, 1.0
    assert discovery_metrics(w, truth) == jstridge.discovery_metrics(jw, truth)
    ls, l0 = info["ls_loss"], info["l0_count"]
    assert stridge.pareto_knee(ls, l0) == jstridge.pareto_knee(ls, l0)


def test_pi_block_expression_of_a_transferred_branch_matches_jax():
    cell = jax.tree_util.tree_map(np.asarray, j_init_pi_cell(
        jax.random.PRNGKey(3), jconfigs.FORWARD_SIM_LO.cell, jnp.float64))
    for c in range(2):
        branch = cell["pi"][c]
        got, want = pi_block_expression(branch), jsymbolic.pi_block_expression(branch)
        assert str(got) == str(want)
        assert expression_coefficients(got) == jsymbolic.expression_coefficients(want)


def test_discovery_imports_without_sympy():
    """Without sympy, the discovery package and the pipeline still import:
    only discovery.symbolic's functions need it."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['sympy'] = None; "
            "import percnn_tpu_torch.discovery, percnn_tpu_torch.experiments.pipeline; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "ok"


# ---- the cases of tests/test_discovery.py, through the port --------------


def _synthetic(case):
    if case == "sparse":
        rng = np.random.RandomState(3)
        X = rng.randn(4000, 30)
        w_true = np.zeros((30, 1))
        w_true[[2, 7, 19]] = [[1.5], [-0.8], [0.3]]
        return X, X @ w_true + 0.01 * rng.randn(4000, 1), w_true
    rng = np.random.RandomState(4)
    X = rng.randn(2000, 10)
    w_true = np.zeros((10, 1))
    w_true[0] = 2.0
    if case == "must_have":
        w_true[5] = 1e-3
    else:
        w_true[3] = w_true[5] = 1e-3
    return X, X @ w_true, w_true


@pytest.mark.parametrize("case", ["sparse", "must_have", "must_have_multi"])
def test_stridge_synthetic_cases(case):
    X, y, w_true = _synthetic(case)
    tr = STRidge(X, y, normalize=2)
    if case == "sparse":
        w = tr.train(maxit=50, stridge_iters=20, lam=1e-4, d_tol=2.0)
        m = discovery_metrics(w, w_true)
        assert m["precision"] == 1.0 and m["recall"] == 1.0 and m["rel_l2"] < 0.05, m
    elif case == "must_have":
        w = tr.train(maxit=30, stridge_iters=20, lam=1e-5, d_tol=5.0, must_have=5)
        assert w[5] != 0.0
    else:
        w = tr.train(maxit=30, stridge_iters=20, lam=1e-5, d_tol=5.0, must_have=[3, 5])
        assert w[3] != 0.0 and w[5] != 0.0


@pytest.mark.parametrize(
    "system,dt,dx,noise,stridge_kwargs,truth_terms",
    [
        ("burgers", 0.00025, 0.01, 0.001,
         dict(maxit=50, stridge_iters=40, lam=0.01, d_tol=20, kappa=1.0, must_have=5),
         {"ones*lap_u": 1 / 200, "u*u_x": -1.0, "v*u_y": -1.0}),
        ("lambda_omega", 0.0125, 0.2, 0.0,
         dict(maxit=50, stridge_iters=40, lam=1e-4, d_tol=5, l0_penalty=1e-6),
         {"u*ones": 1.0, "ones*lap_u": 0.1, "u**3*ones": -1.0,
          "u**2*v*ones": 1.0, "u*v**2*ones": -1.0, "v**3*ones": 1.0}),
    ],
)
def test_discovery_on_simulation(system, dt, dx, noise, stridge_kwargs, truth_terms):
    """Stage 2 on the port's simulation of the true PDE recovers the
    u-equation with perfect precision and recall."""
    n = 64
    h0 = default_ic(system, n, seed=1)
    if system == "lambda_omega":
        h0 = simulate(system, h0, 40, dt, dx, device="cpu")[-1]
    roll = simulate(system, h0, 60, dt, dx, device="cpu")
    if noise:
        roll = add_noise(roll, noise, seed=7)
    lib = gen_library()
    R, Ut, _, _ = build_design_matrix(roll, dt, dx, frames=slice(0, 60), subsample=0.2, seed=0)
    coef_true = np.zeros((len(lib), 1))
    for t, c in truth_terms.items():
        coef_true[lib.index(t)] = c
    w = STRidge(R, Ut, normalize=2, split_ratio=0.8).train(**stridge_kwargs)
    m = discovery_metrics(w, coef_true)
    assert m["recall"] == 1.0 and m["precision"] == 1.0 and m["rel_l2"] < 0.05, m


@pytest.mark.parametrize("protocol", ["high_noise_lo", "stable_burgers"])
def test_stage2_protocols_on_simulation(protocol):
    """run_stage2 at lambda-omega noise_pct >= 0.25 (the off-attractor
    weighted sweep with [lap, linear] protected) and run_stage2_stable on a
    noisy Burgers simulation recover the true supports."""
    from percnn_tpu_torch.experiments.pipeline import TRUTH_TERMS, run_stage2, run_stage2_stable

    if protocol == "high_noise_lo":
        exp = dataclasses.replace(LO_STAGE1, grid=64, noise_pct=0.3)
        h0 = simulate("lambda_omega", default_ic("lambda_omega", 64, seed=1), 40, exp.dt,
                      exp.dx, device="cpu")[-1]
        roll = simulate("lambda_omega", h0, 60, exp.dt, exp.dx, device="cpu")
        s2 = run_stage2(exp, roll, frames=slice(0, 60), subsample=1.0,
                        kwargs=dict(maxit=10, stridge_iters=10))
        for eq in ("u", "v"):
            sup = {s2["names"][i] for i in np.flatnonzero(np.abs(np.ravel(s2[f"w_{eq}"])) > 1e-12)}
            assert f"ones*lap_{eq}" in sup and f"{eq}*ones" in sup, (eq, sup)
            assert not set(TRUTH_TERMS["lambda_omega"][eq]) - sup, (eq, sup)
        return
    exp = dataclasses.replace(BURGERS_STAGE1, grid=64)
    roll = simulate("burgers", default_ic("burgers", 64, seed=1), 60, exp.dt, exp.dx,
                    device="cpu")
    roll = add_noise(roll, 0.001, seed=7)
    s2 = run_stage2_stable(exp, roll, draws=4, frames=slice(0, 60),
                           kwargs=dict(lam=0.01, d_tol=20), seed=0)
    names = s2["names"]
    for eq in ("u", "v"):
        votes, w = s2[f"votes_{eq}"], np.ravel(s2[f"w_{eq}"])
        for term in TRUTH_TERMS["burgers"][eq]:
            assert votes[names.index(term)] == 1.0, (eq, term, votes)
        np.testing.assert_array_equal(np.abs(w) > 1e-12, votes >= 0.5)
        assert s2[f"metrics_{eq}"]["recall"] == 1.0 and s2[f"metrics_{eq}"]["rel_l2"] < 0.1


@pytest.mark.parametrize("system,pct,want", [
    ("lambda_omega", 0.0, slice(0, 100)), ("lambda_omega", 0.1, slice(0, 100)),
    ("lambda_omega", 0.2, slice(50, 150)), ("lambda_omega", 0.3, slice(50, 150)),
    ("burgers", 0.0, slice(50, 150)), ("burgers", 0.3, slice(50, 150))])
def test_default_stage2_frames_noise_aware(system, pct, want):
    from percnn_tpu_torch.experiments.pipeline import default_stage2_frames

    base = LO_STAGE1 if system == "lambda_omega" else BURGERS_STAGE1
    assert default_stage2_frames(dataclasses.replace(base, noise_pct=pct)) == want


def test_pareto_sweep_and_knee():
    rng = np.random.RandomState(5)
    X = rng.randn(500, 8)
    w_true = np.zeros((8, 1))
    w_true[1] = 1.0
    y = X @ w_true + 0.01 * rng.randn(500, 1)
    _, ls, l0, _ = pareto_sweep(STRidge(X, y), gammas=np.array([0.01, 0.1, 1.0]), maxit=10)
    assert len(ls) == 3 and (l0 >= 0).all()
    rng = np.random.RandomState(6)
    X = rng.randn(3000, 20)
    w_true = np.zeros((20, 1))
    w_true[[2, 7, 13]] = [[1.2], [-0.9], [0.5]]
    y = X @ w_true + 0.02 * rng.randn(3000, 1)
    gammas = np.array([0.01 * 1.5 ** i for i in range(20)])
    w, info = stridge.pareto_select(STRidge(X, y), gammas=gammas, maxit=15, stridge_iters=15,
                                    lam=1e-4, d_tol=2.0)
    assert set(np.nonzero(w[:, 0])[0]) == {2, 7, 13} and info["selected_gamma"] in gammas


@pytest.mark.parametrize("ls,l0,want", [
    ([3.0, 1.0, 2.0], [0, 0, 0], 1), ([2.0e-4, 1.3e-4, 1.0e-4, 1e-2], [8, 5, 10, 3], 1),
    ([1e-6, 1e-4, 1.0], [10, 3, 1], 1), ([1.0, 2.0], [4, 4], 0),
    ([8.06e-5, 1.52e-4, 4.13e-4, 6.05e-3], [48, 10, 6, 1], 2)])
def test_pareto_knee_degenerate_inputs(ls, l0, want):
    assert stridge.pareto_knee(np.array(ls), np.array(l0)) == want


def test_symbolic_extraction_roundtrip():
    """(u+1)(2u-v)(3v) = 6u^2 v - 3uv^2 + 6uv - 3v^2 from a hand-built branch."""
    branch = {"w0": np.array([[1.0], [0.0]]), "b0": np.array([1.0]),
              "w1": np.array([[2.0], [-1.0]]), "b1": np.array([0.0]),
              "w2": np.array([[0.0], [3.0]]), "b2": np.array([0.0]),
              "w_out": np.array([[1.0]]), "b_out": np.array([0.0])}
    coefs = expression_coefficients(symbolic.pi_block_expression(branch))
    want = {"u**2*v": 6.0, "u*v**2": -3.0, "u*v": 6.0, "v**2": -3.0}
    got = {k: v for k, v in coefs.items() if abs(v) > 1e-9}
    assert set(got) == set(want) and all(abs(got[k] - want[k]) < 1e-9 for k in want)
