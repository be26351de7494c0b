"""The trainer's robustness family against percnn_tpu's, on the toy losses of
tests/test_train.py: the NaN watchdog with and without a checkpoint, the
spike watchdog, lr_recover, spike_reset_opt, abort_policy="stop", the
stability probe with its .stable checkpoint and the candidate selection,
the best-params policies when no finite best is ever seen, and the runner's
probe wiring and restarts.

Each toy run goes through both trainers from the same f32 start; the
returned params, the loss histories and the logged records (events and
loss lines) must agree: floats at rtol 1e-5, event names and flags exactly.
Where a toy loss switches on a threshold, the threshold sits between two
iterates (0.51 where tests/test_train.py has 0.5, which the iterates reach
exactly), so the two packages' last-bit rounding cannot pick different
sides of it.
"""

import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core import checkpoint as jcheckpoint
from percnn_tpu.core import train as jtrain
from percnn_tpu.experiments import runner as jrunner
from percnn_tpu.experiments.configs import GS2D_RECON as J_GS2D_RECON
from percnn_tpu.utils.metrics import MetricsLogger as JMetricsLogger

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core import checkpoint
from percnn_tpu_torch.core.train import TrainConfig, train
from percnn_tpu_torch.experiments import runner
from percnn_tpu_torch.experiments.configs import GS2D_RECON
from percnn_tpu_torch.utils.metrics import MetricsLogger


@pytest.fixture(autouse=True)
def _figures_skipped(monkeypatch):
    """run_experiment's figures (tested in test_torch_viz.py) are skipped
    here, as where matplotlib is not installed: neither package's runs draw."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)


RTOL = 1e-5


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _records(logger):
    return [{k: v for k, v in r.items() if k != "time"} for r in logger.history]


def _assert_records_match(got, want):
    assert [r.get("event") for r in got] == [r.get("event") for r in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), (g, w)
        for k in w:
            if isinstance(w[k], str) or w[k] is None:
                assert g[k] == w[k], (k, g, w)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=f"{k}: {g} vs {w}")


def _both(jloss, loss, w0, tmp_path, *, raises=None, jprobe=None, probe=None, **kw):
    """Train from w0 with both packages; return ((params, history, records),
    ...) for JAX then the port.  Each gets its own checkpoint path (under
    tmp_path) when kw has ckpt_path=True."""
    out = []
    for tag, fn, lg, cfg_cls, run in (
            ("jax", jloss, JMetricsLogger(), jtrain.TrainConfig,
             lambda f, p, c, lg, pr: jtrain.train(f, {"w": jnp.asarray(p)}, c, logger=lg,
                                                    probe=pr)),
            ("port", loss, MetricsLogger(), TrainConfig,
             lambda f, p, c, lg, pr: train(f, {"w": p}, c, logger=lg, probe=pr,
                                           device="cpu"))):
        ckw = dict(kw)
        if ckw.get("ckpt_path"):
            ckw["ckpt_path"] = str(tmp_path / f"{tag}.npz")
        pr = jprobe if tag == "jax" else probe
        if raises is not None:
            with pytest.raises(raises, match="watchdog"):
                run(fn, w0.copy(), cfg_cls(**ckw), lg, pr)
            out.append((None, None, _records(lg)))
        else:
            params, hist = run(fn, w0.copy(), cfg_cls(**ckw), lg, pr)
            out.append((_np(params["w"]), np.asarray(hist), _records(lg)))
    return out


def _assert_runs_match(runs):
    (jp, jh, jr), (tp, th, tr) = runs
    _assert_records_match(tr, jr)
    if jp is not None:
        np.testing.assert_allclose(th, jh, rtol=RTOL)
        np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=1e-7)


# -- C1: the best-params policies start from the starting params ------------

@pytest.mark.parametrize("policy", [dict(best_val=True), dict(best_key="val")])
def test_best_policies_return_the_start_when_no_finite_best(policy, tmp_path):
    """loss = sum w^2 from w = [1, 2], aux val = NaN, lr 0.1, 5 iterations:
    no finite val is ever seen, so both packages return the starting params."""
    def jloss(p):
        return jnp.sum(p["w"] ** 2), {"val": jnp.float32(jnp.nan)}

    def loss(p):
        return torch.sum(p["w"] ** 2), {"val": torch.tensor(float("nan"))}

    runs = _both(jloss, loss, np.array([1.0, 2.0], np.float32), tmp_path,
                 n_iters=5, lr=0.1, **policy)
    for params, hist, _ in runs:
        np.testing.assert_array_equal(params, [1.0, 2.0])
        assert len(hist) == 5 and hist[-1] < hist[0]   # training did move
    _assert_runs_match(runs)


# -- NaN watchdog ---------------------------------------------------------

def _nan_from_start(lib):
    """tests/test_train.py:34: the loss is NaN where sum w^2 > 1 and the
    watch metric where sum w^2 > 25."""
    def loss(p):
        s = lib.sum(p["w"] ** 2)
        l = s + lib.sqrt(1.0 - s) * 0.0
        return l, {"phy": lib.where(s > 25.0, float("nan"), l)}
    return loss


def test_watchdog_exhausts_and_raises_from_a_nan_start(tmp_path):
    """Every chunk fails and no checkpoint is ever written: 50 rollbacks of
    LR * 0.9, each replaying the starting params, then FloatingPointError."""
    runs = _both(_nan_from_start(jnp), _nan_from_start(torch), np.full(3, 6.0, np.float32),
                 tmp_path, raises=FloatingPointError, n_iters=20, lr=1e-2, watchdog=True,
                 watchdog_key="phy", ckpt_path=True)
    assert len(runs[1][2]) == 50
    _assert_runs_match(runs)


def test_watchdog_recoverable_run_matches(tmp_path):
    runs = _both(_nan_from_start(jnp), _nan_from_start(torch), np.full(3, 0.1, np.float32),
                 tmp_path, n_iters=10, lr=1e-3, watchdog=True, watchdog_key="phy",
                 ckpt_path=True, ckpt_every=1)
    assert len(runs[1][1]) == 10 and np.isfinite(runs[1][0]).all()
    _assert_runs_match(runs)


def _nan_mid_run(lib):
    """(w - 3)^2 with a NaN watch metric once w passes 0.75: the second chunk
    of 5 Adam steps (lr 0.1) reaches past it until the watchdog has cut the
    LR enough, so it fails, is rolled back and replayed."""
    def loss(p):
        l = lib.sum((p["w"] - 3.0) ** 2)
        return l, {"phy": lib.where(lib.max(p["w"]) > 0.75, float("nan"), l)}
    return loss


@pytest.mark.parametrize("ckpt", [False, True], ids=["no_checkpoint", "checkpoint"])
def test_watchdog_rolls_back_a_failed_chunk(ckpt, tmp_path):
    """Without a checkpoint the port must drop the failed chunk's in-place
    Adam updates (params and moments) as the JAX trainer drops its
    functional ones; with one, the reload gives the same state."""
    runs = _both(_nan_mid_run(jnp), _nan_mid_run(torch), np.zeros(1, np.float32), tmp_path,
                 n_iters=10, lr=0.1, steps_per_call=5, watchdog=True, watchdog_key="phy",
                 log_every=1, **({"ckpt_path": True, "ckpt_every": 5} if ckpt else {}))
    events = [r.get("event") for r in runs[1][2]]
    assert events.count("nan_watchdog") >= 2 and len(runs[1][1]) == 10
    assert np.all(runs[1][0] < 0.75 + 0.2)
    _assert_runs_match(runs)


# -- spike watchdog, lr_recover, spike_reset_opt, abort_policy ---------------

def _spike(lib):
    """tests/test_train.py:154: the loss drives w up; the watch metric jumps
    from 1 to 1e4 once sum w passes 0.51."""
    def loss(p):
        s = lib.sum(p["w"])
        return -s, {"phy": lib.where(s > 0.51, 1e4, 1.0)}
    return loss


_SPIKE_BASE = dict(n_iters=200, lr=0.01, watchdog=True, watchdog_key="phy",
                   ckpt_path=True, ckpt_every=1, log_every=10 ** 9)


@pytest.mark.parametrize("spike_mult", [10.0, None], ids=["on", "off"])
def test_spike_watchdog_matches(spike_mult, tmp_path):
    runs = _both(_spike(jnp), _spike(torch), np.zeros(2, np.float32), tmp_path,
                 spike_mult=spike_mult, spike_warmup=0, **_SPIKE_BASE)
    events = [r.get("event") for r in runs[1][2]]
    assert len(runs[1][1]) == 200
    if spike_mult is None:
        assert not any(events)
    else:
        assert events.count("spike_watchdog") == 5 and "spike_accepted" in events
    _assert_runs_match(runs)


@pytest.mark.parametrize("lr_recover", [1.0, 1.05])
def test_lr_recover_matches(lr_recover, tmp_path):
    runs = _both(_spike(jnp), _spike(torch), np.zeros(2, np.float32), tmp_path,
                 spike_mult=10.0, spike_warmup=0, lr_recover=lr_recover,
                 **dict(_SPIKE_BASE, n_iters=400))
    _assert_runs_match(runs)
    j_scale = jcheckpoint.peek_meta(str(tmp_path / "jax.npz"))["lr_scale"]
    t_scale = checkpoint.peek_meta(str(tmp_path / "port.npz"))["lr_scale"]
    np.testing.assert_allclose(t_scale, j_scale, rtol=1e-12)
    assert (t_scale == 1.0) if lr_recover > 1.0 else (t_scale < 0.95)


@pytest.mark.parametrize("reset", [True, False])
def test_spike_reset_opt_matches(reset, tmp_path):
    """From a NaN start every rollback after the first resets Adam with
    spike_reset_opt, none without; both raise at the cap."""
    runs = _both(_nan_from_start(jnp), _nan_from_start(torch), np.full(3, 6.0, np.float32),
                 tmp_path, raises=FloatingPointError, n_iters=20, lr=1e-2, watchdog=True,
                 watchdog_key="phy", spike_reset_opt=reset, ckpt_path=True)
    flags = [bool(r.get("opt_reset")) for r in runs[1][2]]
    assert flags == ([False] + [True] * 49 if reset else [False] * 50)
    _assert_runs_match(runs)


def test_spike_reset_opt_gives_fresh_adam_state(tmp_path):
    """A mid-run rollback with spike_reset_opt replays from fresh moments and
    step 0 (optax's tx.init), in both packages."""
    runs = _both(_nan_mid_run(jnp), _nan_mid_run(torch), np.zeros(1, np.float32), tmp_path,
                 n_iters=10, lr=0.1, steps_per_call=5, watchdog=True, watchdog_key="phy",
                 spike_reset_opt=True, log_every=1)
    assert any(r.get("opt_reset") for r in runs[1][2])
    _assert_runs_match(runs)


def test_abort_policy_stop_matches(tmp_path):
    runs = _both(_nan_from_start(jnp), _nan_from_start(torch), np.full(3, 6.0, np.float32),
                 tmp_path, n_iters=20, lr=1e-2, watchdog=True, watchdog_key="phy",
                 abort_policy="stop", ckpt_path=True)
    (_, _, jr), (params, hist, records) = runs
    np.testing.assert_array_equal(params, np.full(3, 6.0, np.float32))
    assert len(hist) == 0 and records[-1]["event"] == "aborted"
    _assert_runs_match(runs)


# -- the stability probe and the candidate selection -------------------------

def _quad(lib):
    def loss(p):
        l = lib.sum((p["w"] - 3.0) ** 2)
        return l, {"val": l}
    return loss


def _probe(p):
    """tests/test_train.py:470: stable while mean w < 2, scored by |mean w|."""
    w = float(np.mean(_np(p["w"])))
    return abs(w) if w < 2.0 else float("inf")


def test_probe_checkpoints_the_stable_iterate(tmp_path):
    runs = _both(_quad(jnp), _quad(torch), np.zeros(3, np.float32), tmp_path,
                 jprobe=_probe, probe=_probe, n_iters=60, lr=0.2, lr_step=1000,
                 probe_every=5, ckpt_path=True, ckpt_every=5, steps_per_call=5)
    _assert_runs_match(runs)
    (jp, _, _), (tp, _, _) = runs
    assert float(np.mean(tp)) > 2.5
    jtree, jmeta = jcheckpoint.load_checkpoint_tree(str(tmp_path / "jax.npz.stable"))
    tree, meta = checkpoint.load_checkpoint_tree(str(tmp_path / "port.npz.stable"))
    np.testing.assert_allclose(tree["params"]["w"], jtree["params"]["w"], rtol=RTOL)
    np.testing.assert_allclose(meta["probe_score"], jmeta["probe_score"], rtol=RTOL)
    assert meta["iteration"] == jmeta["iteration"] and float(np.mean(tree["params"]["w"])) < 2.0

    # candidate selection: 'stable' wins when the others probe unstable, and
    # the lowest finite score wins when every candidate is stable
    for probe, want in ((_probe, "stable"), (lambda p: float(np.mean(_np(p["w"]))), "stable")):
        _, jrep = jrunner.select_stable_candidate({"w": jnp.asarray(jp)}, None,
                                                  str(tmp_path / "jax.npz"), probe)
        chosen, rep = runner.select_stable_candidate({"w": torch.from_numpy(tp)},
                                                     str(tmp_path / "port.npz"), probe)
        assert rep["candidate"] == jrep["candidate"] == want
        assert sorted(rep["probe_scores"]) == sorted(jrep["probe_scores"])
        for k, s in jrep["probe_scores"].items():
            np.testing.assert_allclose(rep["probe_scores"][k], s, rtol=RTOL)
        np.testing.assert_array_equal(_np(chosen["w"]), tree["params"]["w"])


def test_probe_competition_carries_across_calls(tmp_path):
    """A second train() on the same checkpoint path starts from the
    .stable file's probe_score, so a worse later probe does not replace it."""
    loss = _quad(torch)
    cfg = TrainConfig(n_iters=20, lr=0.2, probe_every=5, ckpt_path=str(tmp_path / "c.npz"),
                      steps_per_call=5)
    train(loss, {"w": np.zeros(3, np.float32)}, cfg, probe=_probe, device="cpu")
    first = checkpoint.peek_meta(cfg.ckpt_path + ".stable")
    train(loss, {"w": np.full(3, 0.5, np.float32)}, cfg, probe=_probe, device="cpu")
    assert checkpoint.peek_meta(cfg.ckpt_path + ".stable") == first


# -- the six options that the trainer used to refuse -------------------------

def _spike_probe(p):
    s = float(np.sum(_np(p["w"])))
    return s if s < 0.41 else float("inf")


@pytest.mark.parametrize("option", [dict(watchdog=True), dict(spike_mult=3.0),
                                    dict(lr_recover=1.002), dict(spike_reset_opt=True),
                                    dict(abort_policy="stop"), dict(probe_every=10)])
def test_train_options_match_jax(option, tmp_path):
    """Each option on top of a spiking run with the watchdog on: the params,
    histories and records of both packages agree."""
    kw = dict(_SPIKE_BASE, n_iters=60, steps_per_call=2, spike_mult=10.0, spike_warmup=0,
              spike_max_retries=3, log_every=10)
    runs = _both(_spike(jnp), _spike(torch), np.zeros(2, np.float32), tmp_path,
                 jprobe=_spike_probe, probe=_spike_probe, **{**kw, **option})
    _assert_runs_match(runs)


# -- the runner: probe wiring and restarts ----------------------------------

def _small(base):
    """tests/test_train.py:510's GS2D problem: 16 x 16, T = 8, 12 iterations,
    probe every 4 over a 10-step horizon."""
    return dataclasses.replace(
        base, grid=16, train_steps=8, infer_steps=10, curriculum=(),
        train=dataclasses.replace(base.train, n_iters=12, steps_per_call=4, ckpt_every=4,
                                  probe_every=4, best_key=None, best_val=False,
                                  log_every=100),
        data=dataclasses.replace(base.data, time_stride=2, space_stride=2),
        isg_pretrain_iters=4)


def test_run_experiment_probe_selects_stable_like_jax(tmp_path, monkeypatch):
    """Both runners from the same init: the histories, the candidate and its
    probe scores agree, and the .stable checkpoint is written."""
    exp, jexp = _small(GS2D_RECON), _small(J_GS2D_RECON)
    jinit = jax.tree_util.tree_map(np.asarray, jrunner.init_model(jexp, jax.random.PRNGKey(0)))
    monkeypatch.setattr(runner, "init_model",
                        lambda exp, gen, dtype=torch.float32, device="cuda":
                        params_from_numpy(jinit, device=device, dtype=dtype))
    jres = jrunner.run_experiment(jexp, out_dir=str(tmp_path / "jax"), cache_dir=None, seed=0)
    res = runner.run_experiment(exp, out_dir=str(tmp_path / "port"), cache_dir=None, seed=0,
                                device="cpu")
    np.testing.assert_allclose(res["history"], jres["history"], rtol=1e-4)
    assert res["candidate"] == jres["candidate"]
    assert sorted(res["probe_scores"]) == sorted(jres["probe_scores"])
    for k, s in jres["probe_scores"].items():
        np.testing.assert_allclose(res["probe_scores"][k], s, rtol=1e-3)
    assert np.isfinite(res["probe_scores"][res["candidate"]])
    assert os.path.exists(str(tmp_path / "port" / "gs2d_recon.ckpt.npz.stable"))
    np.testing.assert_allclose(res["rel_l2"], jres["rel_l2"], rtol=1e-3)


def _restart_exp():
    exp = _small(GS2D_RECON)
    return dataclasses.replace(exp, train=dataclasses.replace(exp.train, n_iters=8))


def test_restarts_gate_and_record(tmp_path):
    """An unreachable loss gate: two attempts, the second with the init seed
    shifted and its own directory; the lower final-stage loss is returned."""
    res = runner.run_experiment_with_restarts(
        _restart_exp(), out_dir=str(tmp_path / "r"), seed=0, max_restarts=1,
        loss_gate=1e-30, cache_dir=None, device="cpu")
    att = res["attempts"]
    assert [a["init_seed"] for a in att] == [0, 1000]
    assert att[1]["out_dir"].endswith(".retry1")
    losses = [a["final_stage_min_loss"] for a in att]
    assert all(np.isfinite(l) for l in losses)
    assert res["final_stage_min_loss"] == min(losses)
    assert np.isfinite(res["rel_l2"]) and att[0]["candidate"] in ("best", "latest", "stable")


def test_restarts_stop_when_healthy_and_resume_after_a_crash(tmp_path):
    """No gate: one attempt and no retry directory; called again on the same
    directory, the attempt resumes from its checkpoint (training already
    done: no final-stage loss) and is not retried."""
    kw = dict(out_dir=str(tmp_path / "r"), seed=0, max_restarts=2, loss_gate=None,
              cache_dir=None, device="cpu")
    first = runner.run_experiment_with_restarts(_restart_exp(), **kw)
    assert len(first["attempts"]) == 1 and not os.path.exists(str(tmp_path / "r.retry1"))
    again = runner.run_experiment_with_restarts(_restart_exp(), **kw)
    assert len(again["attempts"]) == 1 and again["history"] == []
    assert again["final_stage_min_loss"] is None
    assert not os.path.exists(str(tmp_path / "r.retry1"))
    assert np.isfinite(again["rel_l2"])


def test_restarts_retry_after_floating_point_error(tmp_path, monkeypatch):
    """An attempt that raises FloatingPointError is recorded and retried; when
    every attempt raises, so does the ladder."""
    calls = []

    def fake_run(exp, *, out_dir, seed, **kw):
        calls.append(seed)
        if seed == 0:
            raise FloatingPointError("watchdog: 50 consecutive failed chunks")
        return {"final_stage_min_loss": 1.0, "diverged": False, "rel_l2": 0.1,
                "candidate": "best"}

    monkeypatch.setattr(runner, "run_experiment", fake_run)
    res = runner.run_experiment_with_restarts(GS2D_RECON, out_dir=str(tmp_path / "r"))
    assert calls == [0, 1000] and "error" in res["attempts"][0]
    monkeypatch.setattr(runner, "run_experiment",
                        lambda exp, **kw: (_ for _ in ()).throw(FloatingPointError("x")))
    with pytest.raises(FloatingPointError, match="all 3 attempts"):
        runner.run_experiment_with_restarts(GS2D_RECON, out_dir=str(tmp_path / "s"))


# The restart ladder's policy against percnn_tpu's: both packages'
# run_experiment_with_restarts drive the same scripted run_experiment.  Each
# attempt's outcome is a result (final-stage loss, divergence) or "raise"
# (FloatingPointError); `ckpt` names the attempt directories that hold a
# checkpoint before the ladder starts (an interrupted attempt).
_LADDER_CASES = {
    "gate_unreachable": dict(outcomes=[2.0, 1.0], kw=dict(max_restarts=1, loss_gate=1e-30)),
    "healthy": dict(outcomes=[1.0], kw=dict(max_restarts=2, loss_gate=None)),
    "gate_met_second": dict(outcomes=[3.0, 0.5, 0.1], kw=dict(loss_gate=1.0)),
    "diverged_then_clean": dict(outcomes=[(0.5, True), 1.0], kw=dict()),
    "raise_then_clean": dict(outcomes=["raise", 1.0], kw=dict()),
    "all_raise": dict(outcomes=["raise"] * 3, kw=dict()),
    "resumed_without_gate": dict(outcomes=[None], ckpt=[0], kw=dict(loss_gate=None)),
    "resumed_under_gate": dict(outcomes=[None, 0.5], ckpt=[0, 1], kw=dict(loss_gate=1.0)),
    "resume_given": dict(outcomes=[None, 2.0, 1.5], ckpt=[0],
                         kw=dict(loss_gate=1.0, resume=False)),
}


def _drive_ladder(mod, name, exp, root, case, monkeypatch):
    """Run ``mod.run_experiment_with_restarts`` under a scripted
    run_experiment; return the calls it made, its result (or error) and its
    attempt log, with ``root`` taken out of every directory."""
    os.makedirs(root)
    for a in case.get("ckpt", []):
        d = os.path.join(root, "r" if a == 0 else f"r.retry{a}")
        os.makedirs(d)
        open(os.path.join(d, f"{name}.ckpt.npz"), "wb").close()
    calls, outcomes = [], list(case["outcomes"])

    def fake_run(exp, *, out_dir, seed, **kw):
        calls.append((os.path.relpath(out_dir, root), seed, sorted(kw.items())))
        out = outcomes.pop(0)
        if out == "raise":
            raise FloatingPointError(f"watchdog: attempt at seed {seed} aborted")
        ml, diverged = out if isinstance(out, tuple) else (out, False)
        return {"final_stage_min_loss": ml, "diverged": diverged, "rel_l2": 0.1 * seed,
                "candidate": "best", "tag": len(calls) - 1}

    monkeypatch.setattr(mod, "run_experiment", fake_run)
    try:
        res = mod.run_experiment_with_restarts(exp, out_dir=os.path.join(root, "r"), seed=7,
                                               cache_dir=None, **case["kw"])
    except FloatingPointError as e:
        return calls, ("raised", str(e).replace(root + os.sep, "")), None
    attempts = [{**a, "out_dir": os.path.relpath(a["out_dir"], root)}
                for a in res.pop("attempts")]
    return calls, res, attempts


@pytest.mark.parametrize("case", list(_LADDER_CASES))
def test_restart_ladder_matches_jax(tmp_path, monkeypatch, case):
    """The seeds and directories of each attempt, when resume is passed, the
    attempt log, the gating and the choice of result (or the error when
    every attempt aborts) are those of percnn_tpu's ladder."""
    spec = _LADDER_CASES[case]
    want = _drive_ladder(jrunner, J_GS2D_RECON.name, J_GS2D_RECON, str(tmp_path / "jax"),
                         spec, monkeypatch)
    got = _drive_ladder(runner, GS2D_RECON.name, GS2D_RECON, str(tmp_path / "port"),
                        spec, monkeypatch)
    assert got == want
