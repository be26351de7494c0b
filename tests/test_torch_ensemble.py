"""percnn_tpu_torch.experiments.ensemble on the CPU: ``run_ensemble`` against
percnn_tpu's ``run_ensemble`` on a shrunk GS2D (grid 16, T = 6, no
curriculum, M = 2, ISG pretrain 5, 2 iterations) in the batched modes (the
per-member modes are in tests/test_torch_ensemble_modes.py, which shares
this file's set-up), and the mode choice, the guards, the checkpoint and the
``ensemble`` CLI verb.

Both packages' ``init_model`` are patched here to return the same
per-member numpy params (their RNGs draw different numbers); the noise
comes from the same numpy ``add_noise``, so both see the same data.  The
truth is each package's RK4 (equal to 1e-12, tests/test_torch_simulate.py).
percnn_tpu's fused and batched modes run its Pallas kernels in interpret
mode; the port's run their plain versions.  Bar: the loss histories and the
members' rel-L2 at rtol 1e-4, as tests/test_ensemble.py holds percnn_tpu's
own modes to each other.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.checkpoint import load_checkpoint_tree
from percnn_tpu.experiments import ensemble as jensemble
from percnn_tpu.experiments.configs import GS2D_RECON as J_GS2D
from percnn_tpu.experiments.runner import init_model as j_init_model

import percnn_tpu_torch.__main__ as cli
from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.experiments import ensemble
from percnn_tpu_torch.experiments.configs import (
    BURGERS_STAGE1,
    GS2D_RECON,
    GS3D_RECON,
    LO_STAGE1,
)

M = 2


def _shrink(exp):
    return dataclasses.replace(
        exp, grid=16, train_steps=6, infer_steps=6, curriculum=(),
        data=dataclasses.replace(exp.data, time_stride=2),
        train=dataclasses.replace(exp.train, n_iters=2, log_every=10),
        isg_pretrain_iters=5)


JEXP, EXP = _shrink(J_GS2D), _shrink(GS2D_RECON)


@pytest.fixture(scope="module")
def members():
    """Member m's params from percnn_tpu's init_model(PRNGKey(100 + m)), numpy."""
    return [jax.tree_util.tree_map(np.asarray, j_init_model(JEXP, jax.random.PRNGKey(100 + m)))
            for m in range(M)]


def _patch_inits(monkeypatch, members):
    """Both packages' init_model return members[k] on the k-th call."""
    jit, pit = iter(members), iter(members)
    monkeypatch.setattr(jensemble, "init_model",
                        lambda exp, key, dtype=jnp.float32: jax.tree_util.tree_map(
                            lambda a: jnp.asarray(a, dtype), next(jit)))
    monkeypatch.setattr(ensemble, "init_model",
                        lambda exp, gen, dtype=torch.float32, *, device="cuda":
                        params_from_numpy(next(pit), device=device, dtype=dtype))


def _port_run(monkeypatch, members, tmp_path, bptt, **kw):
    _patch_inits(monkeypatch, members)
    return ensemble.run_ensemble(EXP, M, out_dir=str(tmp_path / f"torch_{bptt}"), cache_dir=None,
                                 bptt=bptt, seed=0, device="cpu", **kw)


def check_matches_jax(monkeypatch, members, tmp_path, bptt):
    """run_ensemble of both packages in mode bptt: the same history and
    members' rel-L2."""
    _patch_inits(monkeypatch, members)
    want = jensemble.run_ensemble(JEXP, M, out_dir=str(tmp_path / "jax"), cache_dir=None,
                                  bptt=bptt, seed=0)
    got = _port_run(monkeypatch, members, tmp_path, bptt)
    assert len(got["history"]) == EXP.train.n_iters
    np.testing.assert_allclose(got["history"], want["history"], rtol=1e-4)
    np.testing.assert_allclose(got["rel_l2_members"], want["rel_l2_members"], rtol=1e-4)
    assert got["rel_l2_mean"] == pytest.approx(float(np.mean(got["rel_l2_members"])))
    assert got["rel_l2_std"] == pytest.approx(float(np.std(got["rel_l2_members"])))
    assert got["params"]["cell"]["diff"].shape == (M, 2)


@pytest.mark.parametrize("bptt", ["batched", "batched_pg"])
def test_run_ensemble_matches_jax(monkeypatch, members, tmp_path, bptt):
    check_matches_jax(monkeypatch, members, tmp_path, bptt)


def test_auto_picks_as_percnn_tpu_on_its_kernels():
    """percnn_tpu's 'auto' with its TPU-only conditions mapped as
    runner.forward_rollout maps them: fused_pg for a float32 1x1 2D cell,
    fused for a 5x5 one, two_phase for anything else."""
    assert ensemble.auto_bptt(GS2D_RECON) == "fused_pg"
    assert ensemble.auto_bptt(BURGERS_STAGE1) == "fused"
    assert ensemble.auto_bptt(LO_STAGE1) == "fused"
    assert ensemble.auto_bptt(GS3D_RECON) == "two_phase"
    assert ensemble.auto_bptt(GS2D_RECON, torch.float64) == "two_phase"
    k3 = dataclasses.replace(GS2D_RECON, cell=dataclasses.replace(GS2D_RECON.cell, kernel_size=3))
    assert ensemble.auto_bptt(k3) == "fused"


def test_auto_trains_as_fused_pg(monkeypatch, members, tmp_path):
    auto = _port_run(monkeypatch, members, tmp_path / "a", "auto")
    fused_pg = _port_run(monkeypatch, members, tmp_path / "f", "fused_pg")
    assert auto["history"] == fused_pg["history"]


def test_members_draw_their_inits_from_seed_plus_k(monkeypatch, tmp_path):
    """Member k's init is init_model(Generator(seed + k)), as percnn_tpu's is
    init_model(PRNGKey(seed + k)): the members differ, and the pooled spread
    of their weights is that of percnn_tpu's members (the two RNGs draw
    different numbers, so parity holds only in distribution)."""
    monkeypatch.setattr(ensemble, "pretrain_isg", lambda loss, params, **kw: params)
    monkeypatch.setattr(ensemble, "train", lambda loss, params, tcfg, **kw: (params, [0.0]))
    monkeypatch.setattr(ensemble, "evaluate", lambda params, prob, n: {"rel_l2": 0.0})
    n, seed = 3, 5
    res = ensemble.run_ensemble(EXP, n, out_dir=str(tmp_path), cache_dir=None, seed=seed,
                                device="cpu")
    got = res["params"]
    for k in range(n):
        want = ensemble.init_model(EXP, torch.Generator().manual_seed(seed + k), device="cpu")
        torch.testing.assert_close(got["cell"]["pi"][1]["w2"][k], want["cell"]["pi"][1]["w2"])
        torch.testing.assert_close(got["isg"]["out_w"][k], want["isg"]["out_w"])
    assert not torch.equal(got["cell"]["pi"][0]["w0"][0], got["cell"]["pi"][0]["w0"][1])
    jw = np.concatenate([np.asarray(j_init_model(JEXP, jax.random.PRNGKey(seed + k))["isg"][key])
                         .ravel() for k in range(n) for key in ("up0_w", "up1_w")])
    tw = torch.cat([got["isg"][key].reshape(-1) for key in ("up0_w", "up1_w")]).numpy()
    assert abs(tw.std() / jw.std() - 1) < 0.1


def test_mesh_and_unknown_mode_raise(tmp_path):
    """A mesh the members cannot shard over, and spatial axes without a
    mesh, are refused before any rank starts."""
    from percnn_tpu_torch.parallel import make_mesh

    data3 = make_mesh(("data",), devices=["cpu"] * 3)
    for kw, msg in ((dict(mesh=data3), "do not split"),
                    (dict(mesh=data3, member_axis="batch"), "not one of"),
                    (dict(mesh=make_mesh(("data", "x"), shape=(1, 2), devices=["cpu"] * 2),
                          spatial_axes=("data",)), "cannot cut the field"),
                    (dict(spatial_axes=("x",)), "pass mesh=")):
        with pytest.raises(ValueError, match=msg):
            ensemble.run_ensemble(EXP, M, out_dir=str(tmp_path), device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown bptt mode"):
        ensemble.run_ensemble(EXP, M, out_dir=str(tmp_path), bptt="vmap", device="cpu")
    with pytest.raises(ValueError, match="unknown bptt mode"):
        ensemble.build_ensemble_loss_fn(EXP, [], 4, "vmap")


def test_checkpoint_loads_in_percnn_tpu(monkeypatch, members, tmp_path):
    """The .ens.ckpt.npz holds the stacked params in percnn_tpu's format;
    the metrics log ends with the members' mean and spread."""
    res = _port_run(monkeypatch, members, tmp_path, "batched_pg")
    out = tmp_path / "torch_batched_pg"
    tree, meta = load_checkpoint_tree(str(out / f"{EXP.name}.ens.ckpt.npz"))
    assert meta["iteration"] == EXP.train.n_iters
    want = res["params"]
    np.testing.assert_array_equal(tree["params"]["cell"]["diff"],
                                  want["cell"]["diff"].detach().numpy())
    for o in range(2):
        for k, v in want["cell"]["pi"][o].items():
            assert tree["params"]["cell"]["pi"][o][k].shape == (M,) + tuple(v.shape[1:])
    for k, v in want["isg"].items():
        np.testing.assert_array_equal(tree["params"]["isg"][k], v.detach().numpy())
    with open(out / f"{EXP.name}.ens.metrics.jsonl") as f:
        last = json.loads(f.readlines()[-1])
    assert last["rel_l2_mean"] == pytest.approx(res["rel_l2_mean"])


def test_cli_ensemble_verb(monkeypatch, capsys):
    """`python -m percnn_tpu_torch ensemble` reaches run_ensemble with the
    parsed arguments (stubbed here: no 100 x 100 truth on the CPU) and prints
    percnn_tpu's JSON line; --shard passes a ("data",) mesh (one CPU rank
    with --cpu); an unknown experiment is refused."""
    calls = []

    def stub(exp, n_members, **kw):
        calls.append((exp, n_members, kw))
        return {"rel_l2_members": [0.1, 0.3], "rel_l2_mean": 0.2, "rel_l2_std": 0.1}

    monkeypatch.setattr(ensemble, "run_ensemble", stub)
    assert cli.main(["ensemble", "gs2d_recon", "--members", "2", "--iters", "6",
                     "--isg-iters", "3", "--out", "o", "--cache", "c", "--cpu",
                     "--seed", "5", "--steps-per-call", "2"]) == 0
    exp, n, kw = calls[-1]
    assert exp is GS2D_RECON and n == 2
    assert kw == dict(out_dir="o", cache_dir="c", n_iters_override=6, isg_pretrain_override=3,
                      steps_per_call=2, seed=5, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"experiment": "gs2d_recon", "rel_l2_members": [0.1, 0.3],
                    "rel_l2_mean": 0.2, "rel_l2_std": 0.1}
    cli.main(["ensemble", "burgers_stage1"])
    assert calls[-1][0] is BURGERS_STAGE1 and calls[-1][1] == 4
    assert calls[-1][2]["device"] == "cuda"
    cli.main(["ensemble", "gs2d_recon", "--shard", "--cpu"])
    kw = calls[-1][2]
    assert kw["mesh"].shape == {"data": 1} and kw["device"] == torch.device("cpu")
    with pytest.raises(SystemExit) as e:
        cli.main(["ensemble", "no_such_experiment"])
    assert e.value.code == 2 and "unknown experiment" in capsys.readouterr().err
    assert len(calls) == 3
