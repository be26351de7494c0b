"""The port's isolation rules, checked on the source.

percnn_tpu_torch and chip_smoke.py run where there is no JAX, so they must
import neither jax nor percnn_tpu, not even a numpy-only module of it.  The
check reads the source (an AST scan) rather than sys.modules, because a
session may have imported jax before the port.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "percnn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "percnn_tpu", "optax", "tests"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "percnn_tpu_torch/ops/kernels/cell2d.py" in names
    assert "percnn_tpu_torch/ops/kernels/backward2d.py" in names
    assert "percnn_tpu_torch/ops/kernels/cell3d.py" in names
    assert "percnn_tpu_torch/ops/kernels/backward3d.py" in names
    assert "percnn_tpu_torch/experiments/runner.py" in names
    assert "percnn_tpu_torch/ops/kernels/sharded_step2d.py" in names
    for module in ("__init__", "mesh", "halo", "sharded", "spmd", "_spmd_examples"):
        assert f"percnn_tpu_torch/parallel/{module}.py" in names
    for module in ("serving", "data/pt_import", "utils/params", "utils/profiling",
                   "utils/debug", "viz/__init__", "viz/plots", "ops/kernels/serve_ops"):
        assert f"percnn_tpu_torch/{module}.py" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_percnn_tpu(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_chip_smoke_reads_only_the_golden_file():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "runs/" not in src and '"runs"' not in src
    assert '"tests", "golden", "pt_gs2d.npz"' in src
    assert '"tests", "golden", "pt_gs3d.npz"' in src
    assert '"tests", "golden", "pt_burgers_s1.npz"' in src
    assert '"tests", "golden", "pt_lo_forward.npz"' in src
    assert '"tests", "golden", "jax_lo_stage1.ckpt.npz"' in src
    assert '"tests", "golden", "jax_lo_stage1.stage2_coefs.npz"' in src
