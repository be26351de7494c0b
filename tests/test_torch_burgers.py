"""The Burgers and lambda-omega Stage-1 path of percnn_tpu_torch on the CPU,
against the JAX package: both systems' rhs and initial conditions, the
ground truth, the two configurations, a shrunk BURGERS_STAGE1 loss, its
gradients and a few training iterations, one LO_STAGE1 loss-and-gradient
check, the runner's dispatch to the fused k x k rollout, and the fused
gradients with raw diffusion against percnn_tpu's ``fused_rollout_tp_2d``.

Bars: the loss terms rtol 2e-4; gradients rtol 2e-4 / atol 2e-6 (the JAX
package's fused-kernel bar); trajectories under Adam rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core import train as jtrain
from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.core.cell import pi_cell_step as j_pi_cell_step
from percnn_tpu.core.rollout import rollout as j_rollout
from percnn_tpu.data.simulate import default_ic as j_default_ic, simulate as j_simulate
from percnn_tpu.experiments import configs as jconfigs
from percnn_tpu.experiments import runner as jrunner
from percnn_tpu.ops.pallas import backward2d as jbackward2d
from percnn_tpu.pde.systems import PDE_SYSTEMS as J_PDE_SYSTEMS, physics_residual as j_residual

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core import checkpoint
from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.core.train import train
from percnn_tpu_torch.data.simulate import default_ic, simulate
from percnn_tpu_torch.experiments import configs, runner
from percnn_tpu_torch.ops.kernels import backward2d
from percnn_tpu_torch.pde.systems import PDE_SYSTEMS, physics_residual

RTOL, ATOL = 2e-4, 2e-6


@pytest.mark.parametrize("system,dx", [("burgers", 0.01), ("lambda_omega", 0.2)])
def test_rhs_and_residual_match_jax(system, dx):
    roll = np.random.RandomState(0).standard_normal((5, 12, 10, 2))
    want = np.asarray(j_residual(J_PDE_SYSTEMS[system], jnp.asarray(roll), 0.001, dx))
    got = physics_residual(PDE_SYSTEMS[system], torch.from_numpy(roll), 0.001, dx).numpy()
    assert PDE_SYSTEMS[system].ndim == 2 and got.shape == want.shape == (3, 12, 10, 2)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("system", ["burgers", "lambda_omega"])
@pytest.mark.parametrize("seed", [66, 3])
def test_default_ic_matches_jax(system, seed):
    np.testing.assert_array_equal(default_ic(system, 20, seed=seed),
                                  j_default_ic(system, 20, seed=seed))


def test_unknown_system_ic_raises():
    with pytest.raises(KeyError):
        default_ic("no_such_system", 8)


def test_burgers_truth_matches_jax():
    h0 = default_ic("burgers", 16)
    want = j_simulate("burgers", h0, 4, 0.00025, 0.01)
    got = simulate("burgers", h0, 4, 0.00025, 0.01, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("name", ["BURGERS_STAGE1", "LO_STAGE1"])
def test_stage1_configs_match_jax(name):
    exp, jexp = getattr(configs, name), getattr(jconfigs, name)
    for f in dataclasses.fields(jexp):
        got, want = getattr(exp, f.name), getattr(jexp, f.name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    assert exp.interp_align_corners and exp.interp_periodic_extend and exp.train.best_val


def _small(base):
    """A shrunk Stage-1 problem: 16 x 16, hidden 3, ISG hidden 4, T = 10."""
    return dataclasses.replace(
        base, grid=16, train_steps=10, infer_steps=10, isg_pretrain_iters=0,
        cell=dataclasses.replace(base.cell, hidden=3),
        isg=dataclasses.replace(base.isg, hidden=4),
        data=dataclasses.replace(base.data, time_stride=2, space_stride=2),
        train=dataclasses.replace(base.train, n_iters=4, steps_per_call=2, log_every=100))


def _setup(name, seed=0):
    exp, jexp = _small(getattr(configs, name)), _small(getattr(jconfigs, name))
    truth = simulate(exp.system, default_ic(exp.system, exp.grid), exp.train_steps, exp.dt,
                     exp.dx, device="cpu")
    jp = jrunner.init_model(jexp, jax.random.PRNGKey(seed))
    return (exp, runner.setup_problem(exp, truth, device="cpu"),
            jexp, jrunner.setup_problem(jexp, truth), jp)


def _flat(tree):
    return [leaf for _, leaf in checkpoint.flatten_with_paths(tree)]


@pytest.mark.parametrize("name", ["BURGERS_STAGE1", "LO_STAGE1"])
def test_stage1_loss_and_gradients_match_jax(name):
    """The composite loss (data, IC with the wrap-extended target, phy) and
    its gradients over every leaf of the model, the cell's through the
    fused k x k Function."""
    exp, prob, jexp, jprob, jp = _setup(name, seed=1)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    jtotal, jaux = jrunner.build_loss_fn(jprob, exp.train_steps)(jp)
    jg = jax.grad(lambda p: jrunner.build_loss_fn(jprob, exp.train_steps)(p)[0])(jp)
    tp = params_from_numpy(npp, device="cpu")
    leaves = _flat(tp)
    for t in leaves:
        t.requires_grad_(True)
    total, aux = runner.build_loss_fn(prob, exp.train_steps)(tp)
    assert "FusedRolloutTP2d" in type(runner.forward_rollout(
        tp, prob, 2, device="cpu").grad_fn).__name__
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=2e-4)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=2e-4, err_msg=k)
    grads = torch.autograd.grad(total, leaves)
    jleaves = _flat(jax.tree_util.tree_map(np.asarray, jg))
    assert len(grads) == len(jleaves)
    for (path, _), got, want in zip(checkpoint.flatten_with_paths(tp), grads, jleaves):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=path)


def test_burgers_training_matches_jax():
    """A few Adam iterations with best-val selection: the loss trajectory
    and the selected params follow the JAX package's."""
    exp, prob, jexp, jprob, jp = _setup("BURGERS_STAGE1", seed=2)
    jparams, jhist = jtrain.train(jrunner.build_loss_fn(jprob, exp.train_steps), jp, jexp.train)
    params, hist = train(runner.build_loss_fn(prob, exp.train_steps),
                         jax.tree_util.tree_map(np.asarray, jp), exp.train, device="cpu")
    assert len(hist) == len(jhist) == 4
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    for got, want in zip(_flat(params), _flat(jax.tree_util.tree_map(np.asarray, jparams))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def test_run_experiment_burgers_on_cpu(tmp_path):
    """The whole pipeline on the CPU: truth, ISG pretrain, training with
    best-val checkpoints, the evaluation; every result finite."""
    small = _small(configs.BURGERS_STAGE1)
    exp = dataclasses.replace(small, infer_steps=16,
                              train=dataclasses.replace(small.train, n_iters=6))
    res = runner.run_experiment(exp, out_dir=str(tmp_path), cache_dir=None,
                                isg_pretrain_override=5, device="cpu")
    assert len(res["history"]) == 6 and np.isfinite(res["history"]).all()
    assert np.isfinite(res["rel_l2"]) and res["frames"].shape == (17, 16, 16, 2)
    assert (tmp_path / f"{exp.name}.ckpt.npz.best").exists()


def test_fused_gradients_raw_diffusion_match_jax():
    """Raw diffusion (no sigmoid chain rule): the Function against
    percnn_tpu's fused_rollout_tp_2d and against jax.grad through the jnp
    rollout."""
    kw = dict(ndim=2, hidden=3, kernel_size=5, dt=0.05, dx=0.2, diffusion="raw",
              diff_init=0.05, init_scale=0.3)
    jcfg, cfg = JPiCellConfig(**kw), PiCellConfig(**kw)
    jp = j_init_pi_cell(jax.random.PRNGKey(3), jcfg)
    rng = np.random.RandomState(4)
    h0 = (0.3 * rng.standard_normal((8, 10, 2))).astype(np.float32)
    tgt = rng.standard_normal((4, 8, 10, 2)).astype(np.float32)

    def loss(fr, t):
        return ((fr - t) ** 2).sum()

    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    leaves = backward2d._cell_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    th0 = torch.from_numpy(h0).requires_grad_(True)
    grads = torch.autograd.grad(loss(backward2d.fused_rollout_tp_2d(tp, th0, cfg, 3),
                                     torch.from_numpy(tgt)), leaves + [th0])
    for roll in (lambda p, h: jbackward2d.fused_rollout_tp_2d(p, h, jcfg, 3),
                 lambda p, h: j_rollout(lambda x: j_pi_cell_step(p, x, jcfg), h, 3, remat=False)):
        jg_p, jg_h = jax.grad(lambda p, h: loss(roll(p, h), jnp.asarray(tgt)),
                              argnums=(0, 1))(jp, jnp.asarray(h0))
        want = [np.asarray(jg_p["diff"])] + [np.asarray(jg_p["pi"][o][k]) for o in range(2)
                                             for k in sorted(jg_p["pi"][o])] + [np.asarray(jg_h)]
        for got, w in zip(grads, want):
            np.testing.assert_allclose(got.numpy(), w, rtol=RTOL, atol=ATOL)


def test_forward_rollout_dispatch_kxk():
    """'auto' takes the fused k x k Function; 'remat' agrees with it;
    'two_phase' (rollout_tp) agrees with it too, and its gradients with
    percnn_tpu's forward_rollout(bptt='two_phase')."""
    exp, prob, _, jprob, jp = _setup("BURGERS_STAGE1", seed=5)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for t in _flat(tp):
        t.requires_grad_(True)
    fused = runner.forward_rollout(tp, prob, 4, device="cpu")
    assert "FusedRolloutTP2d" in type(fused.grad_fn).__name__
    plain = runner.forward_rollout(tp, prob, 4, bptt="remat", device="cpu")
    np.testing.assert_allclose(fused.detach().numpy(), plain.detach().numpy(),
                               rtol=2e-4, atol=1e-5)
    two = runner.forward_rollout(tp, prob, 4, bptt="two_phase", device="cpu")
    assert type(two.grad_fn).__name__.startswith("_RolloutTP")
    np.testing.assert_allclose(two.detach().numpy(), plain.detach().numpy(),
                               rtol=2e-4, atol=1e-5)
    grads = torch.autograd.grad(two.square().mean(), _flat(tp))
    jg = jax.grad(lambda p: jnp.mean(jrunner.forward_rollout(p, jprob, 4, bptt="two_phase")
                                     ** 2))(jp)
    for got, want in zip(grads, _flat(jax.tree_util.tree_map(np.asarray, jg))):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    frames = runner.inference_rollout(tp, exp, prob.ic_low[0], 4, device="cpu")
    np.testing.assert_allclose(frames.numpy(), plain.detach().numpy(), rtol=2e-4, atol=1e-5)
