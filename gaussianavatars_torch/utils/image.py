"""Image helpers (`utils/image_utils.py` parity: mse/psnr/error_map).

The port's own copy of the JAX package's `utils/image.py` (numpy only);
the train step's tensor PSNR is `training/loss.psnr`.
"""
from __future__ import annotations

import numpy as np


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    m = mse(a, b)
    return float("inf") if m == 0 else float(-10.0 * np.log10(m))


def error_map(img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
    """Seismic-colormapped per-pixel error (`utils/image_utils.py:20-26`)."""
    err = np.mean(np.abs(np.asarray(img1) - np.asarray(img2)), axis=-1)
    err = err / max(float(err.max()), 1e-12)
    try:
        import matplotlib

        return np.asarray(matplotlib.colormaps["seismic"](err))[..., :3]
    except ImportError:
        # matplotlib-free fallback: blue→white→red ramp
        r = np.clip(2 * err, 0, 1)
        b = np.clip(2 * (1 - err), 0, 1)
        g = 1 - np.abs(2 * err - 1)
        return np.stack([r, g, b], -1)
