"""The gspmd route's training as CUDA graphs (core/graph.py, core/train.py
on DTensor parameters), on the CPU, where the step runs eagerly that a
CUDA rank captures:

- train() on replicated DTensor parameters over two gloo ranks updates
  them in place (their local blocks at the same addresses at every probe)
  and follows percnn_tpu's trainer on the same data sharded over two
  virtual CPU devices (rtol 1e-4, test_torch_spmd_runner.py's bar);
- train() and pretrain_isg() hand a Replayer graph=True for DTensor
  leaves, and a Replayer on a CUDA device graphs them;
- a host read (``_device.host``) inside a capture raises;
- the halo exchange's send and byte counters under capture and replay,
  with the capture faked.

The ranks' target lives in percnn_tpu_torch/parallel/_spmd_examples.py (a
spawned rank imports the module of its target, and this file imports JAX).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from percnn_tpu.core import train as jtrain
from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig
from percnn_tpu.core.cell import init_pi_cell as j_init_pi_cell
from percnn_tpu.core.cell import pi_cell_step as j_pi_cell_step
from percnn_tpu.core.rollout import rollout as j_rollout
from percnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from percnn_tpu.parallel.sharded import replicate as j_replicate
from percnn_tpu.parallel.sharded import shard_array as j_shard_array

from percnn_tpu_torch import _device
from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core import graph as graph_mod
from percnn_tpu_torch.core import train as train_mod
from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.core.train import TrainConfig, pretrain_isg, train
from percnn_tpu_torch.ops import spmd_halo
from percnn_tpu_torch.parallel import launch, make_mesh, replicate, spmd
from percnn_tpu_torch.parallel._spmd_examples import train_dtensor_probed

LIMIT = 120.0   # seconds the launch may take here
STEPS = 5       # the fitted rollout's length
ITERS = 6       # training iterations, in chunks of 3


def _leaves(tree):
    """A tree's leaves (torch or JAX arrays) as numpy arrays, in JAX's order."""
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in jax.tree_util.tree_leaves(tree)]


def _cpu_mesh(shape):
    return make_mesh(("x", "y"), shape=shape, devices=["cpu"] * int(np.prod(shape)))


def test_dtensor_training_in_place_matches_jax():
    jcfg = JPiCellConfig(ndim=2, hidden=4, kernel_size=1, dt=0.01, dx=0.1,
                         diffusion="raw", diff_init=0.05, init_scale=0.1)
    cfg = PiCellConfig(**dataclasses.asdict(jcfg))
    jparams = j_init_pi_cell(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(5)
    h0 = (0.3 * rs.standard_normal((16, 16, 2))).astype(np.float32)
    target = (0.3 * rs.standard_normal((STEPS, 16, 16, 2))).astype(np.float32)
    fields = dict(n_iters=ITERS, lr=1e-2, steps_per_call=3, log_every=10 ** 9)

    def jloss(p, batch):
        h, tgt = batch
        frames = j_rollout(lambda x: j_pi_cell_step(p, x, jcfg), h, STEPS, remat=False)
        loss = jnp.mean((frames[1:] - tgt) ** 2)
        return loss, {"l": loss}

    jmesh = j_make_mesh(("x", "y"), shape=(2, 1), devices=jax.devices()[:2])
    batch = (j_shard_array(h0, jmesh, JP("x", "y", None)),
             j_shard_array(target, jmesh, JP(None, "x", "y", None)))
    jtrained, jhist = jtrain.train(jloss, j_replicate(jparams, jmesh),
                                   jtrain.TrainConfig(**fields), loss_args=(batch,))

    mesh = _cpu_mesh((2, 1))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    trained, hist, ptrs = launch(train_dtensor_probed, mesh, params, torch.from_numpy(h0),
                                 torch.from_numpy(target), cfg, STEPS, mesh,
                                 TrainConfig(**fields, probe_every=3), timeout=LIMIT)
    assert len(hist) == ITERS
    # the probe fires after each chunk: both times the same local blocks
    assert len(ptrs) == 2 and ptrs[0] == ptrs[1]
    np.testing.assert_allclose(hist, np.asarray(jhist, np.float64), rtol=1e-4)
    for g, w in zip(_leaves(trained), _leaves(jtrained)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


@pytest.fixture
def one_rank_group(monkeypatch):
    """A gloo group of this process alone, destroyed after the test with
    the DeviceMesh made on it."""
    monkeypatch.setattr(spmd, "_DEVICE_MESHES", {})
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield _cpu_mesh((1, 1))
    finally:
        dist.destroy_process_group()


def test_dtensor_leaves_are_graphed(monkeypatch, one_rank_group):
    """The decision, not the capture: train() and pretrain_isg() on
    DTensor parameters hand their Replayer graph=True, and a Replayer on
    a CUDA device graphs whatever its step holds."""
    made = []

    class Recording(graph_mod.Replayer):
        def __init__(self, step, device, graph=True):
            made.append(graph)
            super().__init__(step, device, graph)

    monkeypatch.setattr(train_mod, "Replayer", Recording)
    params = replicate({"w": torch.linspace(-1.0, 1.0, 8).reshape(4, 2)}, one_rank_group)
    assert _device.is_dtensor(params["w"])

    def loss_fn(p):
        loss = (p["w"] ** 2).mean()
        return loss, {"l": loss}

    _, hist = train(loss_fn, params, TrainConfig(n_iters=2, lr=0.1, log_every=10 ** 9),
                    device="cpu")
    pretrain_isg(lambda p: (p["w"] ** 2).mean(), params, n_iters=2, device="cpu")
    assert made == [True, True] and len(hist) == 2 and hist[1] < hist[0]
    assert graph_mod.Replayer(lambda: None, torch.device("cuda", 0)).graphed


def test_host_read_inside_a_capture_raises(monkeypatch):
    x = torch.arange(3.0)
    np.testing.assert_array_equal(_device.host(x), [0.0, 1.0, 2.0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="captured into a CUDA graph"):
        _device.host(x)


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a capture runs the step's Python
    (as a real capture does) and a replay runs nothing on the host."""

    replays = 0

    def replay(self):
        _FakeGraph.replays += 1

    def reset(self):
        pass


def test_halo_counters_count_what_replays_ran(monkeypatch):
    """A warm-up counts its sends; the capture's are taken off; each
    replay adds one iteration's, beside the kernel counters."""
    stream = type("Stream", (), {"wait_stream": lambda self, other: None})
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, **kw: contextlib.nullcontext())
    monkeypatch.setattr(spmd_halo, "sends", 0)
    monkeypatch.setattr(spmd_halo, "bytes_sent", 0)
    _FakeGraph.replays = 0

    def step():
        # one iteration's exchanges: 4 sends of 256 B each
        spmd_halo.sends += 4
        spmd_halo.bytes_sent += 1024

    run = graph_mod.Replayer(step, torch.device("cuda", 0))
    run()                     # the warm-up
    assert (spmd_halo.sends, spmd_halo.bytes_sent) == (4, 1024) and run.graph is None
    for _ in range(4):        # a capture, then a replay each
        run()
    assert _FakeGraph.replays == 4
    assert (spmd_halo.sends, spmd_halo.bytes_sent) == (20, 5120)
    assert {(obj, attr) for obj, attr, _ in run.deltas} == set(graph_mod.halo_counters())
