"""Training in both packages on the CPU from one init: GS2D's curriculum,
the lambda-omega Stage-1 reconstruction at 20% noise and Burgers Stage-1.

run_experiment's training, stage by stage: the ISG pretrain, then the
T curriculum with a fresh Adam at each stage and the StepLR staircase
running on, through each package's own build_loss_fn (the checkpointed
"remat" route; the JAX package's default takes its Pallas kernels, which
run interpreted here) and train().  The JAX package's init is carried
across, so the loss histories must agree iteration by iteration.  This is
the check that a full-budget run missing its bar starts from: whether the
port's training departs from the JAX package's.
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest

from percnn_tpu.core import train as jtrain
from percnn_tpu.experiments import runner as jrunner
from percnn_tpu.experiments.configs import BURGERS_STAGE1 as J_BURGERS_STAGE1
from percnn_tpu.experiments.configs import GS2D_RECON as J_GS2D_RECON
from percnn_tpu.experiments.configs import LO_STAGE1 as J_LO_STAGE1

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.train import pretrain_isg, train
from percnn_tpu_torch.experiments import runner
from percnn_tpu_torch.experiments.configs import BURGERS_STAGE1, GS2D_RECON, LO_STAGE1

ISG_PRETRAIN = 40


def _gs2d(base):
    """16 x 16, the GS2D cell's widths (C = 8), three stages of T."""
    return dataclasses.replace(
        base, grid=16, curriculum=(8, 16), train_steps=24, infer_steps=24,
        data=dataclasses.replace(base.data, time_stride=4, space_stride=4),
        train=dataclasses.replace(base.train, n_iters=90, log_every=10 ** 9))


def _stage1(base, steps_per_call=None, **changes):
    """16 x 16, the 5x5 Stage-1 cell's widths (C = 16), one stage with
    best-val selection."""
    return dataclasses.replace(
        base, grid=16, train_steps=15, infer_steps=15, **changes,
        train=dataclasses.replace(base.train, n_iters=40, log_every=10 ** 9,
                                  steps_per_call=steps_per_call or base.train.steps_per_call))


# lambda-omega at 20% noise with steps_per_call 20, as the full run's
LO20 = {"noise_pct": 0.2, "steps_per_call": 20}
CASES = {"gs2d": (_gs2d(GS2D_RECON), _gs2d(J_GS2D_RECON)),
         "lo20": (_stage1(LO_STAGE1, **LO20), _stage1(J_LO_STAGE1, **LO20)),
         "burgers": (_stage1(BURGERS_STAGE1), _stage1(J_BURGERS_STAGE1))}


@pytest.fixture(autouse=True)
def _figures_skipped(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)


@pytest.mark.parametrize("case", sorted(CASES))
def test_curriculum_history_matches_jax(case):
    exp, jexp = CASES[case]
    stages = list(exp.curriculum) + [exp.train_steps]
    per_stage = exp.train.n_iters // len(stages)
    warmup = 100 if exp.system == "lambda_omega" else 0
    truth = runner.make_dataset(exp, warmup=warmup, device="cpu")
    jprob = jrunner.setup_problem(jexp, truth)
    prob = runner.setup_problem(exp, truth, device="cpu")
    jp = jrunner.init_model(jexp, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jp["isg"] = jtrain.pretrain_isg(jrunner.build_isg_pretrain_loss(jprob), jp["isg"],
                                    n_iters=ISG_PRETRAIN)
    tp["isg"] = pretrain_isg(runner.build_isg_pretrain_loss(prob), tp["isg"],
                             n_iters=ISG_PRETRAIN, device="cpu")
    jhist, hist = [], []
    for steps in stages:
        tcfg = dataclasses.replace(jexp.train, n_iters=per_stage)
        jp, h = jtrain.train(jrunner.build_loss_fn(jprob, steps, bptt="remat"), jp, tcfg)
        jhist += [float(x) for x in h]
        tcfg = dataclasses.replace(exp.train, n_iters=per_stage)
        tp, h = train(runner.build_loss_fn(prob, steps, bptt="remat"), tp, tcfg, device="cpu")
        hist += h
    assert len(hist) == len(jhist) == exp.train.n_iters
    # each stage falls from where it starts
    for k in range(len(stages)):
        stage = jhist[k * per_stage:(k + 1) * per_stage]
        assert stage[-1] < stage[0]
    # f32 on both sides: rounding apart, one trajectory
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
