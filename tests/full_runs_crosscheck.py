"""Hold artifacts of the port's full-budget card runs against the JAX package
on the CPU (a script beside the tests, not collected by pytest).

    JAX_PLATFORMS=cpu python tests/full_runs_crosscheck.py t800 CKPT [N]
    JAX_PLATFORMS=cpu python tests/full_runs_crosscheck.py stage2 RECON

t800: from a GS2D_RECON state saved after the T = 400 stage
(examples/gs2d_stage_transition_torch.py writes one), the first N
iterations (default 8) of the T = 800 stage in the JAX package, its
checkpointed jnp route, a fresh Adam as its runner starts a stage, one host
read an iteration, on the full 2500-frame truth (the noise draw depends on
it); prints the losses, to stand beside the card's.

stage2: the JAX package's and the port's Stage 2 on one saved lambda-omega
reconstruction at 20% noise (``lo_stage1.stage1_recon.npz`` of a
run_discovery_pipeline run): each equation's support, coefficients,
precision, recall and coefficient rel-L2 by both.

Each prints one JSON line.
"""

import dataclasses
import json
import os
import sys
import time

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)   # the f64 truth, as the tests run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from percnn_tpu.core import train as jtrain  # noqa: E402
from percnn_tpu.core.checkpoint import load_checkpoint as jload_checkpoint  # noqa: E402
from percnn_tpu.experiments import pipeline as jpipeline  # noqa: E402
from percnn_tpu.experiments import runner as jrunner  # noqa: E402
from percnn_tpu.experiments.configs import GS2D_RECON as J_GS2D_RECON  # noqa: E402
from percnn_tpu.experiments.configs import LO_STAGE1 as J_LO_STAGE1  # noqa: E402

from percnn_tpu_torch.data.io import load_npz  # noqa: E402
from percnn_tpu_torch.experiments import pipeline  # noqa: E402
from percnn_tpu_torch.experiments.configs import LO_STAGE1  # noqa: E402


def t800(ckpt: str, n: int) -> dict:
    exp = J_GS2D_RECON
    t0 = time.perf_counter()
    truth = jrunner.make_dataset(exp)
    prob = jrunner.setup_problem(exp, truth)
    params, _ = jload_checkpoint(ckpt, jrunner.init_model(exp, jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(exp.train, n_iters=n, steps_per_call=1, log_every=10 ** 9)
    _, hist = jtrain.train(jrunner.build_loss_fn(prob, exp.train_steps, bptt="remat"),
                           params, cfg)
    return {"check": "t800", "checkpoint": ckpt, "T": exp.train_steps,
            "jax_loss": [float(x) for x in hist], "seconds": time.perf_counter() - t0}


def _supports(s2: dict) -> dict:
    names = list(s2["names"])
    out = {}
    for eq in ("u", "v"):
        w = np.ravel(np.asarray(s2[f"w_{eq}"]))
        out[eq] = {"support": {names[i]: float(w[i]) for i in range(len(names)) if w[i] != 0},
                   **(s2.get(f"metrics_{eq}") or {})}
    return out


def stage2(recon_path: str) -> dict:
    recon = load_npz(recon_path)
    got = _supports(pipeline.run_stage2(dataclasses.replace(LO_STAGE1, noise_pct=0.2), recon))
    want = _supports(jpipeline.run_stage2(dataclasses.replace(J_LO_STAGE1, noise_pct=0.2),
                                          recon))
    return {"check": "stage2", "recon": recon_path, "frames": recon.shape[0],
            "port": got, "jax": want,
            "same_support": all(set(got[eq]["support"]) == set(want[eq]["support"])
                                for eq in ("u", "v"))}


def main(argv: list) -> int:
    if argv[:1] == ["t800"] and len(argv) in (2, 3):
        out = t800(argv[1], int(argv[2]) if len(argv) == 3 else 8)
    elif argv[:1] == ["stage2"] and len(argv) == 2:
        out = stage2(argv[1])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
