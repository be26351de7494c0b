"""Dataset / artifact I/O: a copy of percnn_tpu/data/io.py (numpy and
scipy only).

The reference exchanges data between pipeline stages via .mat files with an
'uv' key shaped [2, T, H, W] or [T, 2, H, W] (train_2drd.py:603-613,
rcnn_Burgers...py:1012-1015).  The framework's native format is npz with the
library layout [T, *spatial, C], but .mat import/export is kept for drop-in
compatibility with reference datasets and downstream tooling.
"""

from __future__ import annotations

import numpy as np

try:
    import scipy.io as sio
except ImportError:  # pragma: no cover
    sio = None


def load_mat_uv(path: str, key: str = "uv") -> np.ndarray:
    """Load a reference-format .mat rollout -> [T, H, W, C] (or [T, D, H, W, C])."""
    if sio is None:
        raise ImportError("scipy is required for .mat I/O")
    arr = np.asarray(sio.loadmat(path)[key])
    # normalise [2, T, ...] vs [T, 2, ...] to channel-last
    if arr.shape[0] == 2 and arr.shape[1] != 2:
        arr = np.swapaxes(arr, 0, 1)  # -> [T, 2, ...]
    return np.moveaxis(arr, 1, -1)


def save_mat_uv(path: str, rollout: np.ndarray, key: str = "uv") -> None:
    """Save [T, *spatial, C] as the reference's [T, C, *spatial] .mat."""
    if sio is None:
        raise ImportError("scipy is required for .mat I/O")
    sio.savemat(path, {key: np.moveaxis(rollout, -1, 1)})


def save_npz(path: str, rollout: np.ndarray, **meta) -> None:
    np.savez_compressed(path, uv=rollout, **meta)


def load_npz(path: str) -> np.ndarray:
    return np.load(path)["uv"]
