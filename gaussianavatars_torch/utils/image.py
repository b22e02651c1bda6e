"""The TensorBoard error image (`utils/image_utils.py:20-26` parity).

The port's own copy of `error_map` from the JAX package's
`utils/image.py` (numpy only); its `mse` and `psnr` are
`training/loss.py`'s here.
"""
from __future__ import annotations

import numpy as np


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
