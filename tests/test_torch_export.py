"""The port's serving export (serving.export_model / load_model) on the
CPU: the artifact's answer equals build_serving_fn's to the bit, agrees
with percnn_tpu's exported StableHLO artifact at the forward kernel bar
(rtol 2e-4, atol 1e-5), keeps the rollout as one serve_rollout node
whatever the number of steps, and loads in a process that can import
neither jax nor percnn_tpu."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig
from percnn_tpu.core.cell import SymbolicCellConfig as JSymbolicCellConfig
from percnn_tpu.core.cell import init_pi_cell as j_init_pi_cell
from percnn_tpu.core.cell import init_symbolic_cell as j_init_symbolic_cell
from percnn_tpu.core.isg import ISGConfig as JISGConfig, init_isg as j_init_isg
from percnn_tpu.serving import export_model as j_export_model, load_model as j_load_model

from percnn_tpu_torch.core.cell import PiCellConfig, SymbolicCellConfig
from percnn_tpu_torch.core.isg import ISGConfig
from percnn_tpu_torch.ops.kernels import cell2d
from percnn_tpu_torch.serving import (build_serving_fn, export_model, export_program,
                                      load_model)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL1 = dict(ndim=2, hidden=8, kernel_size=1, dt=0.5, dx=0.01, diffusion="sigmoid",
             mu_up=3.99e-5, init_scale=0.02)
CELL5 = dict(ndim=2, hidden=3, kernel_size=5, dt=0.05, dx=0.2, diffusion="sigmoid",
             mu_up=0.2, init_scale=0.3)
CELL3D = dict(ndim=3, hidden=2, kernel_size=1, dt=0.5, dx=100 / 48, diffusion="sigmoid",
              mu_up=0.274, init_scale=0.02)
SYMBOLIC = dict(ndim=2, dt=0.0125, dx=0.2, integrator="rk4", diffusion="raw", mu_up=0.2,
                terms=(("u", "u**3", "u*v**2"), ("v", "v**3", "u**2*v")))
ISG = dict(ndim=2, hidden=8, strides=(2, 2), activation="sigmoid")

# name: (cell kind, cell fields, with ISG, request side, steps, final_only)
CASES = {
    "k1_16": ("pi", CELL1, False, 16, 6, False),
    "k5": ("pi", CELL5, False, 12, 4, False),
    "3d_8": ("pi", CELL3D, False, 8, 4, False),
    "isg": ("pi", CELL1, True, 8, 4, False),
    "isg_final_only": ("pi", CELL1, True, 8, 5, True),
    "symbolic_rk4": ("symbolic", SYMBOLIC, False, 16, 4, False),
}


def _case(name, seed=0):
    kind, cell, with_isg, n, steps, final_only = CASES[name]
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    if kind == "pi":
        jcfg, cfg = JPiCellConfig(**cell), PiCellConfig(**cell)
        jcell = j_init_pi_cell(k1, jcfg, dtype=jnp.float32)
    else:
        jcfg, cfg = JSymbolicCellConfig(**cell), SymbolicCellConfig(**cell)
        jcell = j_init_symbolic_cell(k1, jcfg, dtype=jnp.float32)
    jm = {"cell": jcell}
    isg = (None, None)
    if with_isg:
        jm["isg"] = j_init_isg(k2, JISGConfig(**ISG), dtype=jnp.float32)
        isg = (JISGConfig(**ISG), ISGConfig(**ISG))
    rng = np.random.RandomState(seed + 1)
    shape = (n,) * cell["ndim"] + (2,)
    x = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    if kind == "symbolic":
        x = (0.5 * x).astype(np.float32)
    nm = jax.tree_util.tree_map(np.asarray, jm)
    return dict(jm=jm, nm=nm, jcfg=jcfg, cfg=cfg, jisg=isg[0], isg=isg[1], x=x,
                steps=steps, final_only=final_only)


@pytest.mark.parametrize("name", list(CASES))
def test_artifact_equals_serving_fn_and_matches_jax(name, tmp_path):
    c = _case(name)
    path = str(tmp_path / "model.npz")
    blob = export_model(c["nm"], c["cfg"], c["steps"], c["x"].shape, isg_cfg=c["isg"],
                        final_only=c["final_only"], path=path, device="cpu")
    fn, cfg = load_model(path, device="cpu")
    got = fn(c["x"])
    want = build_serving_fn(c["nm"], c["cfg"], c["steps"], isg_cfg=c["isg"],
                            final_only=c["final_only"], device="cpu")(c["x"])
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    # the bare blob loads too, without the config
    got_blob, cfg_blob = load_model(blob, device="cpu")
    assert cfg_blob == {} and torch.equal(got_blob(c["x"]), want)
    for key in ("cell", "cell_kind", "isg", "n_steps", "input_shape", "dtype", "final_only",
                "torch_version", "traced_on"):
        assert key in cfg
    assert cfg["n_steps"] == c["steps"] and cfg["input_shape"] == list(c["x"].shape)
    assert cfg["dtype"] == "float32" and cfg["traced_on"] == "cpu"
    jfn, _ = j_load_model(j_export_model(c["jm"], c["jcfg"], c["steps"], c["x"].shape,
                                         isg_cfg=c["jisg"], final_only=c["final_only"]))
    jwant = np.asarray(jfn(jnp.asarray(c["x"])))
    assert jwant.shape == tuple(got.shape)
    np.testing.assert_allclose(got.numpy(), jwant, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["isg", "3d_8", "symbolic_rk4"])
def test_graph_size_does_not_grow_with_steps(name):
    c = _case(name)
    graphs = [export_program(c["nm"], c["cfg"], n, c["x"].shape, isg_cfg=c["isg"],
                             device="cpu").graph for n in (5, 50)]
    assert len(graphs[0].nodes) == len(graphs[1].nodes)
    for g in graphs:
        rollouts = [node for node in g.nodes if node.op == "call_function"
                    and "serve_rollout" in str(node.target)]
        assert len(rollouts) == 1


def test_serve_rollout_counts_no_launch_on_the_cpu():
    """A CPU request takes the plain version: the row-1 counters stay put."""
    c = _case("k1_16")
    fn, _ = load_model(export_model(c["nm"], c["cfg"], 3, c["x"].shape, device="cpu"),
                       device="cpu")
    before = (cell2d.fused_rollout_2d.launches, cell2d.fused_rollout_2d.steps)
    fn(c["x"])
    assert (cell2d.fused_rollout_2d.launches, cell2d.fused_rollout_2d.steps) == before


def test_artifact_loads_in_a_process_without_jax(tmp_path):
    c = _case("isg")
    path = str(tmp_path / "model.npz")
    export_model(c["nm"], c["cfg"], c["steps"], c["x"].shape, isg_cfg=c["isg"], path=path,
                 device="cpu")
    np.save(tmp_path / "x.npy", c["x"])
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['percnn_tpu'] = None\n"
        "import numpy as np\n"
        "from percnn_tpu_torch.serving import load_model\n"
        f"fn, cfg = load_model({path!r}, device='cpu')\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, fn(np.load({str(tmp_path / 'x.npy')!r})).numpy())\n"
        "print(cfg['n_steps'])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip()) == c["steps"]
    want = build_serving_fn(c["nm"], c["cfg"], c["steps"], isg_cfg=c["isg"], device="cpu")(c["x"])
    assert np.array_equal(np.load(tmp_path / "y.npy"), want.numpy())


def test_export_raises_without_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    c = _case("k1_16")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model(c["nm"], c["cfg"], 2, c["x"].shape)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(b"", device="cuda")
