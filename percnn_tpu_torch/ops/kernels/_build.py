"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each source is compiled on first use in a process into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/percnn_tpu_torch/lib<name>.so csrc/<name>.cu

The library goes into ``build/percnn_tpu_torch/`` at the root of the
checkout, which ``.gitignore`` lists.  Nothing is built at import time.
``PTXAS[name]`` keeps ptxas's report of each kernel's registers and spills.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "percnn_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
PTXAS: dict[str, list[str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of percnn_tpu_torch "
                           "are built at first use and need the CUDA toolkit")
    return path


def build(name: str) -> Path:
    """Compile csrc/<name>.cu into build/percnn_tpu_torch/lib<name>.so.

    The library is written under a temporary name and renamed, so processes
    that build at once never load a half-written file.
    """
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    PTXAS[name] = [line.split(":", 1)[-1].strip() for line in proc.stderr.splitlines()
                   if "entry function" in line or "registers" in line or "spill" in line]
    print(f"percnn_tpu_torch: built {out.name} in {seconds:.2f} s", file=sys.stderr)
    return out


_PATHS: dict[str, str] = {}


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu once per process and load it (or load the
    library another process built, handed over by ``adopt``)."""
    if name not in _PATHS:
        _PATHS[name] = str(build(name))
    return ctypes.CDLL(_PATHS[name])


def built() -> dict[str, str]:
    """The libraries this process has built or adopted: name -> path."""
    return dict(_PATHS)


def adopt(paths: dict[str, str]) -> None:
    """Load these libraries (from ``built()`` of the process that built
    them, on this machine) instead of building them again."""
    _PATHS.update(paths)
