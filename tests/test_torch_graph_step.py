"""The trainer's iteration as a step over static buffers (core/train.py,
core/graph.py), on the CPU, where the same step runs eagerly that CUDA
captures into a graph:

- after the first iteration (the warm-up on the card), an iteration makes
  no host read and copies nothing from the host, for the GS2D, GS3D,
  Burgers, FORWARD_SIM_LO (float64), lambda-omega Stage-3 and ensemble
  losses, the ISG pretrain and an RK4 frame of each system (what a CUDA
  graph capture refuses);
- the params, the Adam moments and count, the lr and the loss buffers keep
  their addresses through a NaN rollback, a fresh Adam state, a checkpoint
  reload and a resume, while the run follows percnn_tpu's trainer (rtol
  1e-5, the watchdog tests' bar);
- the StepLR staircase on the device with a chunk length that does not
  divide the run and an lr step inside a chunk, against optax (rtol 1e-5,
  atol 1e-7, test_train_schedule_matches_optax's bar);
- the kernel counters under capture and replay, with the capture faked.
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from percnn_tpu.core import train as jtrain
from percnn_tpu.utils.metrics import MetricsLogger as JMetricsLogger

from percnn_tpu_torch.core import graph as graph_mod
from percnn_tpu_torch.core import train as train_mod
from percnn_tpu_torch.core.train import TrainConfig, TrainStep, pretrain_isg, train
from percnn_tpu_torch.data import simulate as simulate_mod
from percnn_tpu_torch.data.simulate import default_ic, simulate
from percnn_tpu_torch.experiments import ensemble, runner, stage3
from percnn_tpu_torch.experiments.configs import (BURGERS_STAGE1, FORWARD_SIM_LO, GS2D_RECON,
                                                  GS3D_RECON, LO_STAGE1)
from percnn_tpu_torch.ops.kernels import backward2d, cell2d
from percnn_tpu_torch.utils.metrics import MetricsLogger

CPU = torch.device("cpu")
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _figures_skipped(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)


class _NoHostTraffic(TorchDispatchMode):
    """Fails on a host read (``float(t)``, ``.item()``, a tensor in an
    ``if``) or a copy of host data into a new tensor (``torch.tensor`` of
    numpy), the ops a CUDA graph capture refuses."""

    BANNED = ("aten::_local_scalar_dense", "aten::lift_fresh", "aten::item",
              "aten::is_nonzero")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self.BANNED:
            raise AssertionError(f"host traffic inside an iteration: {func._schema.name}")
        return func(*args, **(kwargs or {}))


class _Watched(graph_mod.Replayer):
    """The Replayer with every call after the first (the warm-up) under
    _NoHostTraffic; records each call's step."""

    calls: list = []

    def __call__(self):
        if any(c is self.step for c in _Watched.calls):
            with _NoHostTraffic():
                super().__call__()
        else:
            super().__call__()
        _Watched.calls.append(self.step)


@pytest.fixture
def watched(monkeypatch):
    _Watched.calls = []
    monkeypatch.setattr(train_mod, "Replayer", _Watched)
    monkeypatch.setattr(simulate_mod, "Replayer", _Watched)
    return _Watched.calls


def _shrunk(exp, grid, steps, **cell):
    return dataclasses.replace(
        exp, grid=grid, train_steps=steps, infer_steps=steps, curriculum=(),
        isg_pretrain_iters=0,
        **({"cell": dataclasses.replace(exp.cell, **cell)} if cell else {}),
        **({"isg": dataclasses.replace(exp.isg, hidden=4)} if cell else {}),
        data=dataclasses.replace(exp.data, time_stride=2, space_stride=2),
        train=dataclasses.replace(exp.train, n_iters=3, steps_per_call=3, log_every=100,
                                  probe_every=0))


def _problem(exp, seed=0):
    rng = np.random.default_rng(seed)
    shape = (exp.train_steps + 1,) + (exp.grid,) * exp.cell.ndim + (2,)
    return runner.setup_problem(exp, (rng.standard_normal(shape) * 0.1 + 0.4), device="cpu")


def _params(exp, seed=0):
    return runner.init_model(exp, torch.Generator().manual_seed(seed), device="cpu")


def _count_calls(calls, n):
    assert len(calls) == n and len({id(c) for c in calls}) == 1


@pytest.mark.parametrize("name", ["gs2d", "gs3d", "burgers"])
def test_model_iteration_has_no_host_traffic(name, watched):
    exp = {"gs2d": _shrunk(GS2D_RECON, 16, 6, hidden=4),
           "gs3d": _shrunk(GS3D_RECON, 12, 4),
           "burgers": _shrunk(BURGERS_STAGE1, 16, 4, hidden=3)}[name]
    prob = _problem(exp)
    _, hist = train(runner.build_loss_fn(prob, exp.train_steps), _params(exp),
                    exp.train, device="cpu")
    _count_calls(watched, 3)
    assert len(hist) == 3 and np.isfinite(hist).all()


def test_forward_sim_iteration_has_no_host_traffic(watched):
    """FORWARD_SIM_LO in float64: the two-phase rollout's backward."""
    exp = dataclasses.replace(FORWARD_SIM_LO, grid=16, train_steps=4, infer_steps=4,
                              train=dataclasses.replace(FORWARD_SIM_LO.train, n_iters=3,
                                                        steps_per_call=3))
    rng = np.random.default_rng(0)
    prob = runner.setup_problem(exp, rng.standard_normal((5, 16, 16, 2)) * 0.5, torch.float64,
                                device="cpu")
    params = runner.init_model(exp, torch.Generator().manual_seed(0), torch.float64,
                               device="cpu")
    _, hist = train(runner.build_loss_fn(prob, exp.train_steps), params, exp.train,
                    device="cpu")
    _count_calls(watched, 3)
    assert np.isfinite(hist).all()


def test_stage3_iteration_has_no_host_traffic(watched):
    exp = dataclasses.replace(_shrunk(LO_STAGE1, 16, 4), isg=LO_STAGE1.isg)
    cfg = stage3.lambda_omega_stage3(exp)
    prob = _problem(exp)
    params = {"cell": stage3.init_symbolic_cell(torch.Generator().manual_seed(0), cfg.cell,
                                                coef_init=cfg.coef_init, nu_init=cfg.nu_init,
                                                device="cpu"),
              "isg": _params(exp)["isg"]}
    tcfg = dataclasses.replace(cfg.train, n_iters=3, steps_per_call=3, log_every=100)
    _, hist = train(stage3.build_stage3_loss_fn(cfg), params, tcfg, device="cpu",
                    loss_args=({"ic_low": prob.ic_low, "meas": prob.measurement},))
    _count_calls(watched, 3)
    assert np.isfinite(hist).all()


@pytest.mark.parametrize("bptt", ["batched_pg", "fused_pg"])
def test_ensemble_iteration_has_no_host_traffic(bptt, watched):
    exp = _shrunk(GS2D_RECON, 16, 4, hidden=4)
    probs = [_problem(dataclasses.replace(exp, seed=exp.seed + k), seed=k) for k in range(2)]
    params = ensemble._stack_trees([_params(exp, seed=k) for k in range(2)])
    _, hist = train(ensemble.build_ensemble_loss_fn(exp, probs, exp.train_steps, bptt),
                    params, exp.train, device="cpu")
    _count_calls(watched, 3)
    assert np.isfinite(hist).all()


def test_isg_pretrain_step_has_no_host_traffic(watched):
    exp = _shrunk(GS2D_RECON, 16, 4, hidden=4)
    prob = _problem(exp)
    pretrain_isg(runner.build_isg_pretrain_loss(prob), _params(exp)["isg"], n_iters=3,
                 steps_per_call=2, device="cpu")
    _count_calls(watched, 3)


@pytest.mark.parametrize("system,n", [("gray_scott_2d", 16), ("gray_scott_3d", 8),
                                      ("burgers", 16), ("lambda_omega", 16)])
def test_rk4_frame_has_no_host_traffic(system, n, watched):
    exp = {"gray_scott_2d": GS2D_RECON, "gray_scott_3d": GS3D_RECON,
           "burgers": BURGERS_STAGE1, "lambda_omega": LO_STAGE1}[system]
    got = simulate(system, default_ic(system, n), 3, exp.dt, exp.dx, device="cpu")
    _count_calls(watched, 3)
    want = simulate(system, default_ic(system, n), 3, exp.dt, exp.dx, device="cpu",
                    graph=False)
    np.testing.assert_array_equal(got, want)


# -- addresses and values through the watchdog, a reload and a resume --------

def _nan_mid_run(lib):
    """(w - 3)^2 with a NaN watch metric once w passes 0.75
    (tests/test_torch_watchdog.py)."""
    def loss(p):
        l = lib.sum((p["w"] - 3.0) ** 2)
        return l, {"phy": lib.where(lib.max(p["w"]) > 0.75, float("nan"), l)}
    return loss


def _quad(lib):
    def loss(p):
        l = lib.sum((p["w"] - 3.0) ** 2)
        return l, {"phy": l}
    return loss


def _pointers(step: TrainStep) -> list:
    st = step.state
    return [t.data_ptr() for t in (*st.leaves, *st.exp_avg, *st.exp_avg_sq, st.count,
                                   step.lr, step.lrs, step.totals, *step.auxs.values())]


class _Pointers(graph_mod.Replayer):
    """The Replayer, recording the addresses of the step's state after each
    call."""

    seen: list = []

    def __call__(self):
        super().__call__()
        _Pointers.seen.append(_pointers(self.step))


def test_state_keeps_its_addresses_through_rollback_reload_and_resume(tmp_path, monkeypatch):
    monkeypatch.setattr(train_mod, "Replayer", _Pointers)
    runs = []
    for tag, lib, run, cfg_cls, logger in (
            ("jax", jnp, lambda f, p, c, lg, r: jtrain.train(
                f, {"w": jnp.asarray(p)}, c, logger=lg, resume=r), jtrain.TrainConfig,
             JMetricsLogger),
            ("port", torch, lambda f, p, c, lg, r: train(
                f, {"w": p}, c, logger=lg, resume=r, device="cpu"), TrainConfig,
             MetricsLogger)):
        kw = dict(n_iters=10, lr=0.1, steps_per_call=5, watchdog=True, watchdog_key="phy",
                  spike_reset_opt=True, log_every=1, ckpt_path=str(tmp_path / f"{tag}.npz"),
                  ckpt_every=5)
        lg = logger()
        _Pointers.seen = []
        p1, h1 = run(_nan_mid_run(lib), np.zeros(1, np.float32), cfg_cls(**kw), lg, False)
        first = list(_Pointers.seen)
        _Pointers.seen = []
        # the resume trains on without the NaN switch
        p2, h2 = run(_quad(lib), np.zeros(1, np.float32),
                     cfg_cls(**dict(kw, n_iters=17, watchdog=False)), lg, True)
        runs.append((np.asarray(p1["w"]), h1, np.asarray(p2["w"]), h2,
                     [{k: v for k, v in r.items() if k != "time"} for r in lg.history]))
        if tag == "port":
            for seen in (first, _Pointers.seen):
                assert len(seen) >= 7 and all(s == seen[0] for s in seen)
    (jp1, jh1, jp2, jh2, jrec), (tp1, th1, tp2, th2, trec) = runs
    events = [r.get("event") for r in trec]
    assert events == [r.get("event") for r in jrec]
    assert events.count("nan_watchdog") >= 2 and any(r.get("opt_reset") for r in trec)
    assert len(th1) == 10 and len(th2) == 7
    for got, want in ((tp1, jp1), (th1, jh1), (tp2, jp2), (th2, jh2)):
        np.testing.assert_allclose(got, want, rtol=RTOL)
    for g, w in zip(trec, jrec):
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=RTOL, err_msg=k)


def test_schedule_across_ragged_chunks_matches_optax():
    """n_iters = 23 in chunks of 5 (the last of 3), lr_step 7: lr steps fall
    inside chunks; the losses and the logged lr follow optax."""
    target = np.array([1.0, -2.0, 3.0], np.float32)

    def jloss(p):
        l = jnp.sum((p["w"] - target) ** 2)
        return l, {"val": l}

    def loss(p):
        l = torch.sum((p["w"] - torch.from_numpy(target)) ** 2)
        return l, {"val": l}

    kw = dict(n_iters=23, lr=0.1, lr_step=7, lr_gamma=0.5, steps_per_call=5, log_every=1)
    jlg, lg = JMetricsLogger(), MetricsLogger()
    _, jhist = jtrain.train(jloss, {"w": jnp.zeros(3, jnp.float32)}, jtrain.TrainConfig(**kw),
                            logger=jlg)
    _, hist = train(loss, {"w": np.zeros(3, np.float32)}, TrainConfig(**kw), logger=lg,
                    device="cpu")
    np.testing.assert_allclose(hist, jhist, rtol=1e-5, atol=1e-7)
    lrs, jlrs = [r["lr"] for r in lg.history], [r["lr"] for r in jlg.history]
    assert [r["step"] for r in lg.history] == [r["step"] for r in jlg.history] == [4, 9, 14,
                                                                                  19, 22]
    np.testing.assert_allclose(lrs, jlrs, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(lrs, [0.1 * 0.5 ** (s // 7) for s in (4, 9, 14, 19, 22)],
                               rtol=1e-6)


# -- counters under capture and replay ---------------------------------------

def test_kernel_counters_lists_every_wrapper_counter():
    found = {(f.__name__, a) for f, a in graph_mod.kernel_counters()}
    assert {("fused_rollout_2d", "launches"), ("fused_rollout_2d", "steps_kxk"),
            ("fused_rollout_tp_2d_pg", "launches"), ("fused_rollout_3d", "steps"),
            ("fused_rollout_tp_3d_pg", "launches"), ("fused_rollout_2d_batched", "launches_kxk"),
            ("fused_phase1_pg_2d_batched", "steps"), ("rollout_blocks_2d", "launches")} <= found
    assert len(found) == 36


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a capture runs the step's Python
    (as a real capture does) and a replay runs nothing on the host."""

    replays = 0

    def replay(self):
        _FakeGraph.replays += 1

    def reset(self):
        pass


def test_counters_count_what_replays_ran(monkeypatch):
    """A warm-up counts its launches; the capture's are taken off; each
    replay adds one iteration's."""
    import contextlib

    stream = type("Stream", (), {"wait_stream": lambda self, other: None})
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, **kw: contextlib.nullcontext())
    _FakeGraph.replays = 0
    saved = (cell2d.fused_rollout_2d.launches, cell2d.fused_rollout_2d.steps,
             backward2d.fused_rollout_tp_2d_pg.launches)
    try:
        cell2d.fused_rollout_2d.launches = cell2d.fused_rollout_2d.steps = 0
        backward2d.fused_rollout_tp_2d_pg.launches = 0

        def step():
            cell2d.fused_rollout_2d.launches += 1
            cell2d.fused_rollout_2d.steps += 200
            backward2d.fused_rollout_tp_2d_pg.launches += 1

        run = graph_mod.Replayer(step, torch.device("cuda", 0))
        run()                     # the warm-up
        assert cell2d.fused_rollout_2d.launches == 1 and run.graph is None
        for _ in range(4):        # a capture, then a replay each
            run()
        assert _FakeGraph.replays == 4 and run.capture_seconds is not None
        assert (cell2d.fused_rollout_2d.launches, cell2d.fused_rollout_2d.steps,
                backward2d.fused_rollout_tp_2d_pg.launches) == (5, 1000, 5)
        run.close()
        assert run.graph is None
    finally:
        (cell2d.fused_rollout_2d.launches, cell2d.fused_rollout_2d.steps,
         backward2d.fused_rollout_tp_2d_pg.launches) = saved
