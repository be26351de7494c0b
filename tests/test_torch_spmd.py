"""The port's GSPMD counterparts (percnn_tpu_torch/parallel/spmd.py and the
helpers of parallel/sharded.py) on the CPU, against percnn_tpu's GSPMD
helpers on the 8-virtual-device mesh.

The port's ranks are gloo processes that ``launch`` spawns on meshes of
"cpu" (2 x 2 here); JAX runs in this test process.  The ranks' targets live
in percnn_tpu_torch (spawned processes import the module of their target,
and this file imports JAX).  Bars: test_parallel.py's (loss rtol 1e-5,
leaves rtol 1e-4 atol 1e-6 after one Adam step; frames rtol 2e-4 atol 1e-5,
the port's f32 bar against the JAX package).
"""

import dataclasses
import functools
import multiprocessing
import operator
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig
from percnn_tpu.core.cell import init_pi_cell as j_init_pi_cell
from percnn_tpu.core.cell import pi_cell_step as j_pi_cell_step
from percnn_tpu.core.rollout import rollout as j_rollout
from percnn_tpu.experiments.configs import GS2D_RECON as J_GS2D
from percnn_tpu.experiments.runner import init_model as j_init_model
from percnn_tpu.experiments.runner import make_dataset as j_make_dataset
from percnn_tpu.experiments.runner import make_mesh_rollout_fn as j_make_mesh_rollout_fn
from percnn_tpu.experiments.runner import setup_problem as j_setup_problem
from percnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from percnn_tpu.parallel.sharded import make_train_step_spmd as j_make_train_step_spmd
from percnn_tpu.parallel.sharded import replicate as j_replicate
from percnn_tpu.parallel.sharded import shard_array as j_shard_array
from percnn_tpu.parallel.sharded import sharded_rollout_nd as j_sharded_rollout_nd

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.experiments import runner
from percnn_tpu_torch.experiments.configs import GS2D_RECON
from percnn_tpu_torch.parallel import (
    P,
    launch,
    make_mesh,
    make_train_step_spmd,
    replicate,
    scale_by_adam,
    shard_array,
    spmd,
)
from percnn_tpu_torch.parallel._spmd_examples import spmd_fit_step

LIMIT = 120.0   # seconds a launch may take here


def _cpu_mesh(names=("x", "y"), shape=(2, 2)):
    return make_mesh(names, shape=shape, devices=["cpu"] * int(np.prod(shape)))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("route", ["gspmd", "halo"])
def test_train_step_spmd_matches_jax(route):
    """One scale_by_adam step of make_train_step_spmd: the eager rollout on
    DTensors (test_parallel.py::test_gspmd_train_step_matches_single_device)
    or a loss over sharded_rollout_nd (::test_halo_train_step_matches_single_device),
    against percnn_tpu's step on its 2 x 4 mesh."""
    jcfg = JPiCellConfig(ndim=2, hidden=4, kernel_size=1, dt=0.01, dx=0.1,
                         diffusion="raw", diff_init=0.05, init_scale=0.1)
    cfg = PiCellConfig(**dataclasses.asdict(jcfg))
    jparams = j_init_pi_cell(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(3)
    h0 = (0.3 * rs.standard_normal((16, 16, 2))).astype(np.float32)
    target = (0.3 * rs.standard_normal((5, 16, 16, 2))).astype(np.float32)

    jmesh = j_make_mesh(("x", "y"), shape=(2, 4))

    def loss_fn(p, batch):
        h, tgt = batch
        frames = (j_rollout(lambda x: j_pi_cell_step(p, x, jcfg), h, 5, remat=False)
                  if route == "gspmd" else j_sharded_rollout_nd(p, h, jcfg, 5, jmesh))
        loss = jnp.mean((frames[1:] - tgt) ** 2)
        return loss, {"l": loss}

    tx = optax.scale_by_adam()
    p_s = j_replicate(jparams, jmesh)
    step = j_make_train_step_spmd(loss_fn, tx, jmesh)
    want, _, want_loss, _ = step(p_s, tx.init(p_s), (j_shard_array(h0, jmesh, JP("x", "y", None)),
                                                     j_shard_array(target, jmesh,
                                                                   JP(None, "x", "y", None))),
                                 1e-3)

    params = params_from_numpy(_numpy(jparams), device="cpu")
    got, loss = launch(functools.partial(spmd_fit_step, halo=route == "halo"),
                       _cpu_mesh(), params, torch.from_numpy(h0), torch.from_numpy(target),
                       cfg, 5, _cpu_mesh(), 1e-3, timeout=LIMIT)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for g, w in zip(_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), got)), _leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_mesh_rollout_fn_gspmd_matches_jax():
    """make_mesh_rollout_fn(impl="gspmd"): outside a process group its
    rollout_fn(params) runs on the mesh's ranks and returns the whole
    frames; against percnn_tpu's gspmd rollout (ISG, then the rollout of a
    shrunk GS2D, 16 x 16, T = 6) with the same params and data."""
    jexp = dataclasses.replace(J_GS2D, grid=16, train_steps=6, infer_steps=6, curriculum=())
    exp = dataclasses.replace(GS2D_RECON, grid=16, train_steps=6, infer_steps=6, curriculum=())
    truth = np.asarray(j_make_dataset(jexp))
    jprob = j_setup_problem(jexp, truth)
    jparams = j_init_model(jexp, jax.random.PRNGKey(0))
    want = j_make_mesh_rollout_fn(jprob, 6, j_make_mesh(("x", "y"), shape=(2, 4)),
                                  impl="gspmd")(jparams)
    prob = runner.Problem(exp, truth, None, torch.from_numpy(np.array(jprob.ic_low)),
                          torch.from_numpy(np.array(jprob.measurement)))
    got = runner.make_mesh_rollout_fn(prob, 6, _cpu_mesh(), impl="gspmd")(
        params_from_numpy(_numpy(jparams), device="cpu"))
    assert got.shape == (7, 16, 16, 2) and got.device == torch.device("cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)


def test_scale_by_adam_matches_optax():
    """Three updates of the port's scale_by_adam against optax's on a tree of
    random leaves (f64, so the two agree to rounding)."""
    rs = np.random.RandomState(0)
    params = {"a": rs.standard_normal((3, 4)), "b": [rs.standard_normal(5)]}
    grads = [{"a": rs.standard_normal((3, 4)), "b": [rs.standard_normal(5)]} for _ in range(3)]
    jtx, tx = optax.scale_by_adam(), scale_by_adam()
    jstate, state = jtx.init(params), tx.init(params_from_numpy(params, device="cpu"))
    for g in grads:
        want, jstate = jtx.update(g, jstate, params)
        got, state = tx.update(params_from_numpy(g, device="cpu"), state)
        for x, y in zip(_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), got)), _leaves(want)):
            np.testing.assert_allclose(x, y, rtol=1e-12)
    assert state.count == 3 == int(jstate.count)


def test_placements_of_specs():
    """P -> DTensor placements: Shard(d) on the mesh dims the spec names,
    Replicate elsewhere; a tuple entry cuts one dim over several axes in
    mesh order; bad specs raise."""
    mesh = _cpu_mesh(("data", "x", "y"), (1, 2, 2))
    assert spmd.placements(mesh, P()) == (Replicate(),) * 3
    assert spmd.placements(mesh, P("data")) == (Shard(0), Replicate(), Replicate())
    assert spmd.placements(mesh, P(None, "x", "y", None)) == (Replicate(), Shard(1), Shard(2))
    assert spmd.placements(mesh, P(("x", "y"), None)) == (Replicate(), Shard(0), Shard(0))
    assert repr(P("x", None)) == "P('x', None)"
    for bad, msg in ((P("z"), "not one of"), (P("x", "x"), "twice"),
                     (P(("y", "x")), "mesh order")):
        with pytest.raises(ValueError, match=msg):
            spmd.placements(mesh, bad)


def test_backends_and_no_group_errors():
    """gloo for a CPU mesh, NCCL for distinct CUDA devices, and a mesh that
    repeats a CUDA device refused before any rank starts; the SPMD helpers
    raise outside a process group."""
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert spmd.backend_for(_cpu_mesh()) == "gloo"
    assert spmd.backend_for(spmd_mesh(cuda)) == "nccl"
    assert spmd.backend_for(spmd_mesh(cuda[:1])) == "nccl"
    with pytest.raises(ValueError, match="repeats a CUDA device"):
        launch(operator.add, spmd_mesh([cuda[0]] * 2), 1, 2)
    assert multiprocessing.active_children() == []
    with pytest.raises(ValueError, match="CPU or CUDA"):
        spmd.backend_for(spmd_mesh([torch.device("meta")] * 2))
    with pytest.raises(RuntimeError, match="no process group"):
        shard_array(np.zeros((4, 4)), _cpu_mesh(), P("x"))
    with pytest.raises(RuntimeError, match="no process group"):
        replicate({"w": np.zeros(3)}, _cpu_mesh())
    step = make_train_step_spmd(lambda p, b: (p["w"].sum(), {}), scale_by_adam(), _cpu_mesh())
    with pytest.raises(RuntimeError, match="no process group"):
        step({"w": torch.zeros(3)}, None, None, 1e-3)


def spmd_mesh(devices):
    """A one-axis Mesh of the given devices, built without make_mesh's
    resolution (which needs the devices to exist)."""
    from percnn_tpu_torch.parallel.mesh import Mesh

    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return Mesh(arr, ("x",))


@pytest.mark.parametrize("case", ["rank_error", "timeout"])
def test_launch_failures_leave_no_rank(case):
    """A rank's error raises with that rank's traceback; the time limit
    raises TimeoutError; either way every rank is gone."""
    mesh = _cpu_mesh()
    t0 = time.perf_counter()
    if case == "rank_error":
        with pytest.raises(RuntimeError, match="ZeroDivisionError") as e:
            launch(operator.truediv, mesh, 1, 0, timeout=LIMIT)
        assert "failed first" in str(e.value)
    else:
        with pytest.raises(TimeoutError, match="did not end within 3"):
            launch(time.sleep, mesh, 60, timeout=3)
        assert time.perf_counter() - t0 < 30
    assert multiprocessing.active_children() == []


def test_launch_returns_rank0_result_and_ranks_import_no_jax():
    """A launched rank runs the port without JAX or percnn_tpu: after
    importing the runner and the ensemble it has neither (this process has
    both)."""
    probe = ("__import__('percnn_tpu_torch.experiments.runner') and "
             "__import__('percnn_tpu_torch.experiments.ensemble') and "
             "sorted(m for m in ('jax', 'percnn_tpu') if m in __import__('sys').modules)")
    assert launch(eval, _cpu_mesh(("x",), (2,)), probe, timeout=LIMIT) == []
