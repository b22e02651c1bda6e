"""Build the port's state from dicts of numpy arrays.

The port never sees a foreign framework's objects: state made elsewhere
(for example by the JAX package, for the parity tests) is handed over as
numpy arrays keyed by field name.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from .data.cameras import Camera
from .device import resolve_device
from .metrics.lpips import LpipsParams, params_from_hwio
from .models.flame.assets import FlameAssets
from .models.flame.flame_model import FlameParams
from .models.gaussians import GaussianAux, GaussianParams
from .training.innovations import ColorNetParams, ContrastiveCache
from .training.optim import AdamState
from .training.trainer import FlameStatic, FlameTrainable, TrainState

_CAMERA_META = ("fovx", "fovy", "width", "height", "timestep", "camera_id", "image_name")


def _tensor(x, dev, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=dev, dtype=dtype)


def gaussian_state_from_numpy(params: Mapping[str, np.ndarray], aux: Mapping[str, np.ndarray],
                              device="cuda") -> tuple[GaussianParams, GaussianAux]:
    """GaussianParams/GaussianAux from arrays keyed by their field names."""
    dev = resolve_device(device)
    f32 = torch.float32
    p = GaussianParams(**{
        k: _tensor(params[k], dev, f32)
        for k in ("means", "log_scales", "quats", "sh_dc", "sh_rest", "logit_opacity")
    })
    a = GaussianAux(
        alive=_tensor(aux["alive"], dev, torch.bool),
        binding=_tensor(aux["binding"], dev, torch.int64),
        grad_accum=_tensor(aux["grad_accum"], dev, f32),
        denom=_tensor(aux["denom"], dev, f32),
        max_radii2d=_tensor(aux["max_radii2d"], dev, f32),
    )
    return p, a


def flame_assets_from_numpy(d: Mapping) -> FlameAssets:
    """FlameAssets from arrays keyed by its field names (host numpy)."""
    arrays = {k: np.array(d[k]) for k in FlameAssets._fields
              if k not in ("n_shape", "vertex_masks")}
    return FlameAssets(
        **arrays, n_shape=int(d["n_shape"]),
        vertex_masks={k: np.array(v) for k, v in d["vertex_masks"].items()},
    )


def flame_params_from_numpy(d: Mapping[str, np.ndarray], device="cuda") -> FlameParams:
    """FlameParams from arrays keyed by its field names (None stays None)."""
    dev = resolve_device(device)
    return FlameParams(**{
        k: None if d.get(k) is None else _tensor(d[k], dev, torch.float32)
        for k in FlameParams._fields
    })


def camera_from_numpy(d: Mapping, device="cuda") -> Camera:
    """Camera from its four matrices as arrays plus its metadata values."""
    dev = resolve_device(device)
    mats = {k: _tensor(d[k], dev, torch.float32)
            for k in ("world_view", "proj", "full_proj", "camera_center")}
    meta = {k: d[k] for k in _CAMERA_META if k in d}
    return Camera(**mats, **meta)


def _flame_trainable(d: Mapping[str, np.ndarray], dev) -> FlameTrainable:
    return FlameTrainable(**{
        k: None if d.get(k) is None else _tensor(d[k], dev, torch.float32)
        for k in (f.name for f in dataclasses.fields(FlameTrainable))
    })


def _adam_state(d: Mapping, like, dev) -> AdamState:
    return AdamState(mu=like(d["mu"]), nu=like(d["nu"]), step=_tensor(d["step"], dev, torch.int32))


def color_net_from_numpy(d: Mapping, device="cuda") -> ColorNetParams:
    """The colour net from {"weights": [[in, out], ...], "biases": [[out], ...]}
    (the JAX package's `ColorNetParams` leaves, the same layout)."""
    dev = resolve_device(device)
    return ColorNetParams(weights=tuple(_tensor(w, dev, torch.float32) for w in d["weights"]),
                          biases=tuple(_tensor(b, dev, torch.float32) for b in d["biases"]))


def color_adam_from_numpy(d: Mapping, device="cuda") -> AdamState:
    """The colour net's Adam state from {"mu": {...}, "nu": {...}, "step"}
    with the moments as `color_net_from_numpy` takes them."""
    dev = resolve_device(device)
    return _adam_state(d, lambda m: color_net_from_numpy(m, device=dev), dev)


def contrastive_from_numpy(d: Mapping, device="cuda") -> ContrastiveCache:
    """The contrastive cache from {"images": [cache, d, d, 3], "count",
    "head"} (int32 scalars)."""
    dev = resolve_device(device)
    return ContrastiveCache(images=_tensor(d["images"], dev, torch.float32),
                            count=_tensor(d["count"], dev, torch.int32),
                            head=_tensor(d["head"], dev, torch.int32))


def train_state_from_numpy(params: Mapping[str, np.ndarray], aux: Mapping[str, np.ndarray],
                           adam: Mapping, flame: Mapping[str, np.ndarray],
                           flame_static: Mapping[str, np.ndarray], flame_adam: Mapping,
                           color_net: Optional[Mapping] = None,
                           color_adam: Optional[Mapping] = None,
                           contrastive: Optional[Mapping] = None,
                           device="cuda") -> TrainState:
    """TrainState from arrays keyed by field name.

    `adam` and `flame_adam` are {"mu": {...}, "nu": {...}, "step": int}
    with the moments keyed like `params` and `flame`; fields that are None
    (or missing) in `flame`/`flame_static` stay None. The innovations'
    leaves, when given, as `color_net_from_numpy`, `color_adam_from_numpy`
    and `contrastive_from_numpy` take them.
    """
    dev = resolve_device(device)
    p, a = gaussian_state_from_numpy(params, aux, device=dev)

    def adam_state(d, like):
        return _adam_state(d, like, dev)

    def gauss(d):
        return gaussian_state_from_numpy(d, aux, device=dev)[0]

    fl = _flame_trainable(flame, dev)
    so = flame_static.get("static_offset")
    return TrainState(
        params=p, aux=a, adam=adam_state(adam, gauss), flame=fl,
        flame_static=FlameStatic(shape=_tensor(flame_static["shape"], dev, torch.float32),
                                 static_offset=None if so is None
                                 else _tensor(so, dev, torch.float32)),
        flame_adam=adam_state(flame_adam, lambda d: _flame_trainable(d, dev)),
        color_net=None if color_net is None else color_net_from_numpy(color_net, device=dev),
        color_adam=None if color_adam is None else color_adam_from_numpy(color_adam, device=dev),
        contrastive=None if contrastive is None else contrastive_from_numpy(contrastive,
                                                                            device=dev),
    )


def lpips_params_from_numpy(d: Mapping, device="cuda") -> LpipsParams:
    """LPIPS weights from the JAX package's `LpipsParams` leaves as numpy
    arrays: {"conv_w": [HWIO, ...], "conv_b": [...], "lin_w": [...],
    "net_type": "vgg" | "alex"}."""
    return params_from_hwio(d["conv_w"], d["conv_b"], d["lin_w"], d["net_type"],
                            device=device)
