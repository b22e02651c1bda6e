"""Shared helpers for the PyTorch port's parity tests: numpy scenes handed to
both packages, and JAX state carried across as numpy."""
import dataclasses

import numpy as np
import torch

from gaussianavatars_tpu.data.cameras import look_at_camera as jax_look_at_camera
from gaussianavatars_torch.convert import camera_from_numpy

H, W = 64, 96
TILE_H, TILE_W = 8, 16


def np_scene(n=200, seed=0, opac_lo=0.2, opac_hi=0.9, spread=(0.8, 0.6, 0.3)):
    """A random splat scene as float32 numpy arrays (the raster_fixtures
    statistics, drawn with numpy so both packages get the same inputs)."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    means = (rng.randn(n, 3) * np.array(spread) + np.array([0.0, 0.0, 2.5])).astype(f32)
    scales = rng.uniform(0.01, 0.12, (n, 3)).astype(f32)
    quats = rng.randn(n, 4).astype(f32)
    opacity = rng.uniform(opac_lo, opac_hi, (n,)).astype(f32)
    colors = rng.uniform(0.0, 1.0, (n, 3)).astype(f32)
    return means, scales, quats, opacity, colors


def jax_camera(width=W, height=H, fovy=1.0):
    return jax_look_at_camera(
        eye=np.zeros(3), target=np.array([0.0, 0.0, 2.5]), fovy=fovy,
        width=width, height=height,
    )


def camera_dict(cam) -> dict:
    """A JAX Camera as numpy arrays plus its metadata."""
    return {
        f.name: (np.asarray(v) if hasattr(v, "shape") else v)
        for f in dataclasses.fields(cam)
        for v in [getattr(cam, f.name)]
    }


def torch_camera(cam):
    return camera_from_numpy(camera_dict(cam), device="cpu")


def dataclass_dict(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def t(x, dtype=None):
    """numpy (or JAX) array → CPU tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def n(x):
    """Tensor → numpy."""
    return x.detach().cpu().numpy()
