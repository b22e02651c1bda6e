"""Load trained avatars from disk (PLY + flame_param.npz sidecar).

The port of the JAX package's `models/io.py`, the reference load path of
`render.py` and the viewers (`scene/gaussian_model.py:288-338`,
`scene/flame_gaussian_model.py:225-268`): a `point_cloud.ply` with
per-Gaussian attributes (+ `binding_0` when bound) and, beside it,
`flame_param.npz` with the trained FLAME sequence. The arrays are padded to
a capacity with an alive mask, as the training state is. A model directory
written by either package loads to the same values in both.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.ply import load_gaussian_ply
from ..device import resolve_device
from .gaussians import SH_REST, GaussianAux, GaussianParams

MOTION_KEYS = ("expr", "rotation", "neck_pose", "jaw_pose", "eyes_pose", "translation")


def _pad(x: np.ndarray, capacity: int, dev) -> torch.Tensor:
    out = np.zeros((capacity,) + x.shape[1:], x.dtype)
    out[: x.shape[0]] = x
    return torch.from_numpy(out).to(dev)


def load_avatar(
    ply_path: str,
    capacity: Optional[int] = None,
    motion_path: str = "",
    disable_fid: Optional[np.ndarray] = None,
    device="cuda",
) -> Tuple[GaussianParams, GaussianAux, Optional[Dict[str, np.ndarray]]]:
    """Load (params, aux, flame_table|None) from a checkpoint PLY.

    The capacity defaults to the next power of two of the point count, at
    least 1,024; SH bands stored at a lower degree are zero-padded to
    degree 3. `motion_path`: override the FLAME pose sequence with another
    actor's `flame_param.npz` (cross-reenactment,
    `scene/flame_gaussian_model.py:236-249`). `disable_fid`: face ids whose
    Gaussians are hidden (`:259-266`). The flame table stays host numpy.
    """
    dev = resolve_device(device)
    raw = load_gaussian_ply(ply_path)
    n = raw["means"].shape[0]
    cap = capacity or max(1 << int(np.ceil(np.log2(max(n, 1)))), 1024)
    if n > cap:
        raise ValueError(f"capacity {cap} < point count {n}")

    sh_rest = raw["sh_rest"]
    k_rest = sh_rest.shape[1]
    if k_rest < SH_REST:  # stored with a lower SH degree: zero-pad the bands
        sh_rest = np.concatenate(
            [sh_rest, np.zeros((n, SH_REST - k_rest, 3), np.float32)], axis=1
        )
    params = GaussianParams(
        means=_pad(raw["means"], cap, dev),
        log_scales=_pad(raw["log_scales"], cap, dev),
        quats=_pad(raw["quats"], cap, dev),
        sh_dc=_pad(raw["sh_dc"], cap, dev),
        sh_rest=_pad(sh_rest.astype(np.float32), cap, dev),
        logit_opacity=_pad(raw["logit_opacity"], cap, dev),
    )
    alive = np.zeros((cap,), bool)
    alive[:n] = True
    binding = raw["binding"]
    if binding is not None and disable_fid is not None and len(disable_fid):
        alive[:n] &= ~np.isin(binding, np.asarray(disable_fid))
    zeros = torch.zeros((cap,), dtype=torch.float32, device=dev)
    aux = GaussianAux(
        alive=torch.from_numpy(alive).to(dev),
        binding=(_pad(binding.astype(np.int64), cap, dev) if binding is not None
                 else torch.zeros((cap,), dtype=torch.int64, device=dev)),
        grad_accum=zeros,
        denom=zeros.clone(),
        max_radii2d=zeros.clone(),
    )

    flame_table = None
    side = os.path.join(os.path.dirname(ply_path), "flame_param.npz")
    if binding is not None and os.path.exists(side):
        data = np.load(side, allow_pickle=True)
        flame_table = {k: data[k] for k in data.files}
        if motion_path:
            motion = np.load(motion_path, allow_pickle=True)
            for k in MOTION_KEYS:
                if k in motion.files:
                    flame_table[k] = motion[k]
    return params, aux, flame_table


def find_latest_iteration(model_path: str) -> int:
    """The highest `point_cloud/iteration_N` under a model directory
    (`searchForMaxIteration`, which `scene/__init__.py` uses for
    load_iteration=-1)."""
    pc_dir = os.path.join(model_path, "point_cloud")
    best = -1
    if os.path.isdir(pc_dir):
        for name in os.listdir(pc_dir):
            m = re.fullmatch(r"iteration_(\d+)", name)
            if m:
                best = max(best, int(m.group(1)))
    if best < 0:
        raise FileNotFoundError(f"no point_cloud/iteration_* under {model_path}")
    return best


def checkpoint_ply_path(model_path: str, iteration: int = -1) -> str:
    it = find_latest_iteration(model_path) if iteration == -1 else iteration
    return os.path.join(model_path, "point_cloud", f"iteration_{it}", "point_cloud.ply")
