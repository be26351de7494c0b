"""The gspmd route for k x k cells: the periodic halo exchange between
ranks (percnn_tpu_torch/ops/spmd_halo.py) and the 5x5 Pi cells trained on
DTensors cut over a 2 x 2 mesh of CPU ranks (gloo), against the whole-tensor
ops, percnn_tpu's unsharded step and the port's unsharded runs.

The ranks' targets live in percnn_tpu_torch/parallel/_spmd_examples.py
(a spawned rank imports the module of its target, and this file imports
JAX).  Bars: the halo primitive's forward to the bit, its adjoint at atol
1e-7 in f64 (in f32 the reference's sum over the ranks' windows rounds in
another order); test_parallel.py's for the SPMD step (loss rtol 1e-5,
leaves rtol 1e-4 atol 1e-6) and for the decomposed run (the first losses
at rtol 1e-4, the rel-L2 within 2e-2); the ensemble's history and members'
rel-L2 at rtol 1e-3 (test_torch_spmd_runner.py).
"""

import dataclasses
import functools
import multiprocessing
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig
from percnn_tpu.core.cell import init_pi_cell as j_init_pi_cell
from percnn_tpu.core.cell import pi_cell_step as j_pi_cell_step
from percnn_tpu.core.rollout import rollout as j_rollout

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.experiments import ensemble, runner
from percnn_tpu_torch.experiments.configs import BURGERS_STAGE1
from percnn_tpu_torch.parallel import P, launch, make_mesh
from percnn_tpu_torch.parallel._spmd_examples import halo_against_whole, spmd_fit_step

LIMIT = 180.0   # seconds a launch may take here

EXP = dataclasses.replace(
    BURGERS_STAGE1, grid=16, train_steps=6, infer_steps=6, isg_pretrain_iters=5,
    cell=dataclasses.replace(BURGERS_STAGE1.cell, hidden=4),
    isg=dataclasses.replace(BURGERS_STAGE1.isg, hidden=4),
    data=dataclasses.replace(BURGERS_STAGE1.data, time_stride=2),
    train=dataclasses.replace(BURGERS_STAGE1.train, n_iters=5, log_every=1000,
                              steps_per_call=5))


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    """No figures and no pi_expressions in this process (torch._dynamo,
    which torch.optim imports at its first step, imports sympy first)."""
    import torch._dynamo  # noqa: F401

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "sympy", None)


def _cpu_mesh(names=("x", "y"), shape=(2, 2)):
    return make_mesh(names, shape=shape, devices=["cpu"] * int(np.prod(shape)))


def test_pad_and_roll_match_the_whole_tensor_ops():
    """pad_periodic and roll of a field cut over 2 x 2 ranks against
    F.pad(mode="circular") and torch.roll of the whole field, widths 1 and
    2: a 2D field cut on both grid dims and a 3D field cut on its first and
    last (the middle one wraps within the rank), in f32 and f64.  Every
    forward equals the whole op's to the bit on every rank; the adjoints
    match plain autograd (f64: atol 1e-7; the roll's exactly in both); a
    pad thicker than a block raises ValueError on every rank."""
    rs = np.random.RandomState(0)
    cases = [(torch.as_tensor(rs.standard_normal(shape), dtype=dt), spec)
             for dt in (torch.float32, torch.float64)
             for shape, spec in (((16, 16, 2), P("x", "y", None)),
                                 ((8, 8, 8, 2), P("x", None, "y", None)))]
    got = launch(halo_against_whole, _cpu_mesh(), cases, _cpu_mesh(), timeout=LIMIT)
    assert len(got) == len(cases)
    for (x, _), ranks in zip(cases, got):
        assert len(ranks) == 4
        for r, res in enumerate(ranks):
            assert "each block needs at least" in res.pop("thick_pad"), r
            adjoint = {k: v for k, v in res.items() if k.endswith("_adjoint")}
            forward = {k: v for k, v in res.items() if k not in adjoint}
            assert len(forward) == 2 * (1 + 2 * (x.ndim - 1)), forward
            assert all(forward.values()), (x.dtype, r, forward)
            assert all(v == 0.0 for k, v in adjoint.items() if k.startswith("roll")), adjoint
            if x.dtype == torch.float64:
                assert max(adjoint.values()) <= 1e-7, (r, adjoint)


def test_spmd_step_of_a_5x5_cell_matches_jax():
    """One scale_by_adam step of make_train_step_spmd on the rollout fit of
    a 5x5 Pi cell (hidden 4, 16 x 16, T = 5) on DTensors cut over 2 x 2
    CPU ranks, against percnn_tpu's unsharded step from the same params
    (carried across by the bridge)."""
    jcfg = JPiCellConfig(ndim=2, hidden=4, kernel_size=5, dt=0.01, dx=0.1,
                         diffusion="raw", diff_init=0.05, init_scale=0.1)
    cfg = PiCellConfig(**dataclasses.asdict(jcfg))
    jparams = j_init_pi_cell(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(5)
    h0 = (0.3 * rs.standard_normal((16, 16, 2))).astype(np.float32)
    target = (0.3 * rs.standard_normal((5, 16, 16, 2))).astype(np.float32)

    def loss_fn(p):
        frames = j_rollout(lambda x: j_pi_cell_step(p, x, jcfg), jnp.asarray(h0), 5,
                           remat=False)
        return jnp.mean((frames[1:] - jnp.asarray(target)) ** 2)

    tx = optax.scale_by_adam()
    want_loss, grads = jax.value_and_grad(loss_fn)(jparams)
    upd, _ = tx.update(grads, tx.init(jparams), jparams)
    want = jax.tree_util.tree_map(lambda p, u: np.asarray(p - 1e-3 * u), jparams, upd)

    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    got, loss = launch(spmd_fit_step, _cpu_mesh(), params, torch.from_numpy(h0),
                       torch.from_numpy(target), cfg, 5, _cpu_mesh(), 1e-3, timeout=LIMIT)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), got))
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) == 1 + 2 * (2 * 3 + 2)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("entry", ["run_experiment", "run_ensemble"])
def test_burgers_gspmd_matches_unsharded(tmp_path, entry):
    """BURGERS_STAGE1 shrunk (16 x 16, hidden 4, T = 6) with its fields
    cut over 2 x 2 CPU ranks against the same run without a mesh:
    run_experiment(parallel_impl="gspmd") (the first losses at rtol 1e-4,
    the rel-L2 within 2e-2, the frames left cut on both grid dims), and
    run_ensemble of two members on a (data, x, y) = (1, 2, 2) mesh with
    spatial_axes ("x", "y"), which trains by two_phase on the spatial
    sub-mesh (history and members' rel-L2 at rtol 1e-3)."""
    kw = dict(cache_dir=str(tmp_path / "c"), seed=0, device="cpu")
    if entry == "run_experiment":
        kw["isg_pretrain_override"] = 10
        ref = runner.run_experiment(EXP, out_dir=str(tmp_path / "single"), **kw)
        got = runner.run_experiment(EXP, out_dir=str(tmp_path / "gspmd"),
                                    parallel_impl="gspmd", mesh=_cpu_mesh(), **kw)
        np.testing.assert_allclose(got["history"][:5], ref["history"][:5], rtol=1e-4)
        assert len(got["history"]) == EXP.train.n_iters and np.isfinite(got["history"]).all()
        assert abs(got["rel_l2"] - ref["rel_l2"]) < 2e-2
        assert got["placements"]["frames"] == "(Shard(dim=1), Shard(dim=2))"
        return
    exp = dataclasses.replace(EXP, train=dataclasses.replace(EXP.train, n_iters=3))
    mesh = _cpu_mesh(("data", "x", "y"), (1, 2, 2))
    assert ensemble.auto_bptt(exp, mesh=mesh) == "two_phase"
    kw["isg_pretrain_override"] = 5
    ref = ensemble.run_ensemble(exp, 2, out_dir=str(tmp_path / "single"), bptt="two_phase",
                                **kw)
    got = ensemble.run_ensemble(exp, 2, out_dir=str(tmp_path / "mesh"), mesh=mesh,
                                spatial_axes=("x", "y"), **kw)
    np.testing.assert_allclose(got["history"], ref["history"], rtol=1e-3)
    np.testing.assert_allclose(got["rel_l2_members"], ref["rel_l2_members"], rtol=1e-3)


def test_blocks_thinner_than_the_halo_are_refused_before_any_rank_starts(tmp_path):
    """A mesh that cuts the 16-cell grid into blocks of 1 cell, thinner
    than the 2-cell halo that the stencils and the 5x5 branches hand on,
    raises ValueError in the launching process: no rank is started."""
    kw = dict(cache_dir=None, out_dir=str(tmp_path), device="cpu", parallel_impl="gspmd")
    for shape in ((16, 1), (2, 16)):
        with pytest.raises(ValueError, match="thinner than the 2-cell halo"):
            runner.run_experiment(EXP, mesh=_cpu_mesh(("x", "y"), shape), **kw)
    assert multiprocessing.active_children() == []
    truth = torch.zeros(7, 16, 16, 2)
    prob = runner.Problem(EXP, truth, truth[0], None, None)
    with pytest.raises(ValueError, match="thinner than the 2-cell halo"):
        runner.make_mesh_rollout_fn(prob, 6, _cpu_mesh(("x", "y"), (16, 1)), impl="gspmd")
    assert not list(tmp_path.iterdir())
