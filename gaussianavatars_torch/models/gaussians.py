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

import torch

from ..device import resolve_device
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
