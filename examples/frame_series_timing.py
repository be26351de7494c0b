"""Time the image series of run_experiment's figures on the CPU: the port's
viz.plots.frame_series (one figure redrawn a frame) against percnn_tpu's (a
figure a frame), 25 frames from 100 random frames, with and without the
measurement column, at 32 x 32 and 100 x 100.

    python examples/frame_series_timing.py [--jax]

Prints one JSON line of seconds per series.  Without --jax only the port is
timed.  matplotlib is imported and a first figure drawn before any clock
starts.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    from percnn_tpu_torch.viz import plots

    series = {"percnn_tpu_torch": plots.frame_series}
    if "--jax" in sys.argv[1:]:
        import importlib.util

        # the JAX package's viz module is numpy and matplotlib only: load it
        # by path, without the package's __init__ (which imports jax)
        spec = importlib.util.spec_from_file_location(
            "jax_plots", os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "percnn_tpu", "viz", "plots.py"))
        jax_plots = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jax_plots)
        series["percnn_tpu"] = jax_plots.frame_series
    plots.comparison_panel(np.zeros((8, 8, 2)), np.ones((8, 8, 2)),
                           os.path.join(tempfile.mkdtemp(), "warm.png"))
    rng = np.random.RandomState(0)
    out = {}
    for n in (32, 100):
        frames = rng.uniform(0.0, 1.0, (100, n, n, 2)).astype(np.float32)
        truth = rng.uniform(0.0, 1.0, (100, n, n, 2))
        meas = rng.uniform(0.0, 1.0, (5, n // 4, n // 4, 2))
        for name, fn in series.items():
            for tag, m in (("plain", None), ("measurement", meas)):
                d = tempfile.mkdtemp()
                t = time.perf_counter()
                paths = fn(frames, truth, d, meas_low=m)
                out[f"{name}/{n}/{tag}"] = {"seconds": time.perf_counter() - t,
                                            "frames": len(paths)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
