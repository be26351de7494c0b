"""Metrics: a JSONL sink and the relative L2 error.

A copy of percnn_tpu/utils/metrics.py (numpy only), so the records of both
packages have the same keys.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def rel_l2(pred: np.ndarray, truth: np.ndarray) -> float:
    """Relative L2 error, the reference's headline accuracy metric."""
    pred = np.asarray(pred, np.float64)
    truth = np.asarray(truth, np.float64)
    return float(np.linalg.norm(pred - truth) / np.linalg.norm(truth))


def _json_safe(v):
    """Recursively replace non-finite floats with None (strict-JSON-safe)."""
    if isinstance(v, float):
        return v if np.isfinite(v) else None
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_json_safe(x) for x in v]
    return v


class MetricsLogger:
    """Append-only JSONL metrics stream (one dict per step)."""

    def __init__(self, path: str | None = None, echo_every: int = 0):
        self.path = path
        self.echo_every = echo_every
        self.history: list[dict] = []
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        else:
            self._f = None

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            if isinstance(v, str):
                rec[k] = v
            elif np.ndim(v) != 0:
                rec[k] = np.asarray(v).tolist()
            else:
                rec[k] = float(v)
        self.history.append(rec)
        if self._f:
            # non-finite floats become null on disk (strict JSON); history
            # keeps the raw floats
            self._f.write(json.dumps(_json_safe(rec), allow_nan=False) + "\n")
        if self.echo_every:
            msg = ", ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                            for k, v in rec.items() if k != "time")
            print(f"[{step}] {msg}")

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
