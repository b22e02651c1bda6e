"""Gaussian avatar state as dataclasses of tensors.

Parameters live in fixed-capacity padded tensors with an `alive` mask, as in
the JAX package, so the two packages' state maps one to one. Activations
match the reference: scales = exp(log_scales), opacity = sigmoid(logit),
rotations normalised; bound Gaussians compose the per-face frame
(scale·face_scaling, face_quat ⊗ quat, R_face·x·face_scaling + face_center).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.knn import mean_sq_dist_3nn
from ..ops.quaternion import quat_mul, quat_normalize, quat_rotate
from ..ops.sh import num_sh_coeffs, rgb_to_sh0

SH_REST = num_sh_coeffs(3) - 1  # 15


@dataclasses.dataclass
class GaussianParams:
    """Trainable per-Gaussian parameters (padded to capacity N)."""

    means: torch.Tensor          # [N, 3] triangle-local if bound, world otherwise
    log_scales: torch.Tensor     # [N, 3]
    quats: torch.Tensor          # [N, 4] raw wxyz (normalised on use)
    sh_dc: torch.Tensor          # [N, 1, 3]
    sh_rest: torch.Tensor        # [N, SH_REST, 3]
    logit_opacity: torch.Tensor  # [N, 1]

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def sh(self) -> torch.Tensor:
        """Full SH coefficients [N, K, 3]."""
        return torch.cat([self.sh_dc, self.sh_rest], dim=1)


@dataclasses.dataclass
class GaussianAux:
    """Non-trainable per-Gaussian state (padded to capacity N)."""

    alive: torch.Tensor        # [N] bool
    binding: torch.Tensor      # [N] int64 triangle id (0 for unbound models)
    grad_accum: torch.Tensor   # [N] Σ‖∂L/∂mean2d‖ over recent steps
    denom: torch.Tensor        # [N] steps the Gaussian was visible
    max_radii2d: torch.Tensor  # [N] max screen radius seen


class FaceFrames(NamedTuple):
    """Per-triangle frame driving bound Gaussians (from the FLAME mesh)."""

    center: torch.Tensor      # [F, 3]
    orien_mat: torch.Tensor   # [F, 3, 3]
    orien_quat: torch.Tensor  # [F, 4] wxyz
    scaling: torch.Tensor     # [F, 1]


class WorldGaussians(NamedTuple):
    """Activated world-space Gaussians ready for the rasterizer."""

    means: torch.Tensor    # [N, 3]
    scales: torch.Tensor   # [N, 3]
    quats: torch.Tensor    # [N, 4] unit
    opacity: torch.Tensor  # [N]
    sh: torch.Tensor       # [N, K, 3]
    alive: torch.Tensor    # [N] bool


def world_gaussians(
    params: GaussianParams,
    aux: GaussianAux,
    frames: Optional[FaceFrames] = None,
) -> WorldGaussians:
    """Activate parameters and (if bound) compose triangle-local → world."""
    scales = torch.exp(params.log_scales)
    quats = quat_normalize(params.quats)
    opacity = torch.sigmoid(params.logit_opacity[:, 0])
    if frames is None:
        means = params.means
    else:
        b = aux.binding
        fs = frames.scaling[b]          # [N, 1]
        fq = frames.orien_quat[b]       # [N, 4]
        scales = scales * fs
        means = quat_rotate(fq, params.means) * fs + frames.center[b]
        quats = quat_mul(fq, quats)
    return WorldGaussians(
        means=means, scales=scales, quats=quats, opacity=opacity,
        sh=params.sh, alive=aux.alive,
    )


def local_scales(params: GaussianParams) -> torch.Tensor:
    """Activated scales in the local frame (before the face scaling)."""
    return torch.exp(params.log_scales)


def inverse_sigmoid(x):
    """logit; accepts a Python float or a tensor."""
    if isinstance(x, torch.Tensor):
        return torch.log(x / (1.0 - x))
    return math.log(x / (1.0 - x))


def init_bound(
    num_faces: int,
    capacity: int,
    generator: torch.Generator,
    per_face: int = 1,
    device="cuda",
) -> tuple[GaussianParams, GaussianAux]:
    """`per_face` Gaussians per mesh triangle, in the local frame (bound mode):
    local means at the face centre, unit local scale, identity rotation,
    random colour from `generator`, opacity 0.1."""
    dev = resolve_device(device)
    n = num_faces * per_face
    if n > capacity:
        raise ValueError(f"capacity {capacity} < initial count {n}")
    f32 = torch.float32
    colors = torch.rand((capacity, 3), generator=generator, dtype=f32).to(dev)
    quats = torch.zeros((capacity, 4), dtype=f32, device=dev)
    quats[:, 0] = 1.0
    params = GaussianParams(
        means=torch.zeros((capacity, 3), dtype=f32, device=dev),
        log_scales=torch.zeros((capacity, 3), dtype=f32, device=dev),
        quats=quats,
        sh_dc=rgb_to_sh0(colors)[:, None, :],
        sh_rest=torch.zeros((capacity, SH_REST, 3), dtype=f32, device=dev),
        logit_opacity=torch.full((capacity, 1), inverse_sigmoid(0.1), dtype=f32, device=dev),
    )
    binding = torch.zeros((capacity,), dtype=torch.int64, device=dev)
    binding[:n] = torch.arange(num_faces, device=dev).repeat(per_face)
    zeros = torch.zeros((capacity,), dtype=f32, device=dev)
    aux = GaussianAux(
        alive=torch.arange(capacity, device=dev) < n,
        binding=binding,
        grad_accum=zeros,
        denom=zeros.clone(),
        max_radii2d=zeros.clone(),
    )
    return params, aux


def init_from_points(
    points: np.ndarray,
    colors: np.ndarray,
    capacity: int,
    init_scale: Optional[np.ndarray] = None,
    device="cuda",
) -> tuple[GaussianParams, GaussianAux]:
    """Unbound init from a point cloud (`create_from_pcd`, unbound branch):
    log-scale from the 3-NN mean distance (`ops/knn.py`, on `device`) or,
    when given, from `init_scale` [n] (no 3-NN search), opacity 0.1,
    colour → SH DC, binding 0, padded to `capacity`."""
    dev = resolve_device(device)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"capacity {capacity} < point count {n}")
    f32 = torch.float32
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    if init_scale is None:
        log_s = torch.log(torch.sqrt(torch.clamp_min(mean_sq_dist_3nn(pts), 1e-7)))
    else:
        # The log in the scales' own precision, then float32 (JAX: numpy).
        log_s = torch.as_tensor(np.log(np.asarray(init_scale)).astype(np.float32), device=dev)

    def pad(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((capacity,) + tuple(x.shape[1:]), dtype=f32, device=dev)
        out[:n] = x
        return out

    quats = torch.zeros((n, 4), dtype=f32, device=dev)
    quats[:, 0] = 1.0
    # The colour → SH DC in the colours' own precision, then float32, as
    # the JAX package computes it (numpy arithmetic on the host).
    sh_dc = rgb_to_sh0(torch.as_tensor(np.asarray(colors))).to(device=dev, dtype=f32)
    # The JAX package takes the logit in float32: log(float32(0.1 / 0.9)).
    logit = torch.log(torch.tensor(0.1 / (1.0 - 0.1), dtype=f32))
    params = GaussianParams(
        means=pad(pts),
        log_scales=pad(log_s[:, None].repeat(1, 3)),
        quats=pad(quats),
        sh_dc=pad(sh_dc[:, None, :]),
        sh_rest=torch.zeros((capacity, SH_REST, 3), dtype=f32, device=dev),
        logit_opacity=pad(torch.full((n, 1), float(logit), dtype=f32, device=dev)),
    )
    zeros = torch.zeros((capacity,), dtype=f32, device=dev)
    aux = GaussianAux(
        alive=torch.arange(capacity, device=dev) < n,
        binding=torch.zeros((capacity,), dtype=torch.int64, device=dev),
        grad_accum=zeros,
        denom=zeros.clone(),
        max_radii2d=zeros.clone(),
    )
    return params, aux


def num_alive(aux: GaussianAux) -> torch.Tensor:
    """Live Gaussians, a 0-dim int32 tensor on the state's device."""
    return aux.alive.sum().to(torch.int32)


def binding_counter(aux: GaussianAux, num_faces: int) -> torch.Tensor:
    """Live Gaussians per face [F], int32."""
    return torch.zeros((num_faces,), dtype=torch.int32, device=aux.binding.device).index_add_(
        0, aux.binding, aux.alive.to(torch.int32))
