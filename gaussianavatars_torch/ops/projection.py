"""EWA projection of 3D Gaussians to screen space (PyTorch).

Camera-space transform, near-plane cull, perspective projection of means,
first-order propagation of the 3D covariance to a 2D conic, and conservative
pixel radii — the math of the JAX package's `_project_core`. Everything is
elementwise over [N] tensors (structure of arrays), so no float32 product
goes through a matrix unit and TF32 settings cannot touch the geometry.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..data.cameras import Camera
from .quaternion import covariance_symm6_parts

# Low-pass filter added to the 2D covariance diagonal (every splat covers at
# least about one pixel), and the near-plane depth.
COV2D_FILTER = 0.3
NEAR_CLIP = 0.2


class Projected(NamedTuple):
    """Screen-space Gaussians. All tensors have leading dim N (padded)."""

    mean2d: torch.Tensor   # [N, 2] pixel coordinates
    depth: torch.Tensor    # [N] camera-space z
    conic: torch.Tensor    # [N, 3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor   # [N] int32 conservative pixel radius (0 = culled)
    mask: torch.Tensor     # [N] bool: in frustum, non-degenerate, alive
    cov2d: torch.Tensor    # [N, 3] the 2D covariance itself (a, b, c)


def ndc_to_pixel(ndc: torch.Tensor, size) -> torch.Tensor:
    """NDC [-1, 1] → pixel centre coordinates, 3DGS convention."""
    return ((ndc + 1.0) * size - 1.0) * 0.5


def project_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    camera: Camera,
    alive: torch.Tensor | None = None,
) -> Projected:
    """Project N Gaussians with world-space covariances [N, 3, 3] (from
    `covariance_from_scaling_rotation`, already scale-modified) into one
    camera; `alive`: optional [N] bool mask of the padding."""
    cv = cov3d.to(torch.float32)
    parts = (cv[..., 0, 0], cv[..., 0, 1], cv[..., 0, 2],
             cv[..., 1, 1], cv[..., 1, 2], cv[..., 2, 2])
    return _project_core(means3d, parts, camera, alive)


def _affine_rows(means3d: torch.Tensor, m: torch.Tensor):
    """Rows of m[:3, :3] @ p + m[:3, 3] as three [N] tensors (elementwise)."""
    x, y, z = means3d.unbind(-1)
    return [x * m[r, 0] + y * m[r, 1] + z * m[r, 2] + m[r, 3] for r in range(m.shape[0])]


def _project_core(
    means3d: torch.Tensor,
    cov_parts,
    camera: Camera,
    alive: torch.Tensor | None = None,
) -> Projected:
    """Projection core; covariance as six scalar tensors (SoA)."""
    f32 = torch.float32
    means3d = means3d.to(f32)
    w2v = camera.world_view.to(f32)
    full = camera.full_proj.to(f32)

    # Camera space + near cull.
    t0, t1, depth = _affine_rows(means3d, w2v[:3])
    in_front = depth > NEAR_CLIP

    # Clip space → NDC → pixels (3DGS pixel-centre convention).
    h0, h1, _h2, w = _affine_rows(means3d, full)
    inv_w = 1.0 / (w + 1e-7)
    ndc_x = h0 * inv_w
    ndc_y = h1 * inv_w
    mean2d = torch.stack(
        [ndc_to_pixel(ndc_x, camera.width), ndc_to_pixel(ndc_y, camera.height)], dim=-1)

    # EWA: cov2D = J W Σ Wᵀ Jᵀ with J at a frustum-clamped camera point.
    fx = float(camera.focal_x)
    fy = float(camera.focal_y)
    lim_x = 1.3 * camera.tan_half_fovx
    lim_y = 1.3 * camera.tan_half_fovy
    tz = torch.where(torch.abs(depth) < 1e-6, torch.full_like(depth, 1e-6), depth)
    tx = torch.clamp(t0 / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(t1 / tz, -lim_y, lim_y) * tz
    inv_tz = 1.0 / tz

    R = w2v[:3, :3]
    j00 = fx * inv_tz
    j11 = fy * inv_tz
    j02 = -fx * tx * inv_tz * inv_tz
    j12 = -fy * ty * inv_tz * inv_tz
    m00 = j00 * R[0, 0] + j02 * R[2, 0]
    m01 = j00 * R[0, 1] + j02 * R[2, 1]
    m02 = j00 * R[0, 2] + j02 * R[2, 2]
    m10 = j11 * R[1, 0] + j12 * R[2, 0]
    m11 = j11 * R[1, 1] + j12 * R[2, 1]
    m12 = j11 * R[1, 2] + j12 * R[2, 2]
    c00, c01, c02, c11, c12, c22 = (p.to(f32) for p in cov_parts)
    s00 = m00 * c00 + m01 * c01 + m02 * c02
    s01 = m00 * c01 + m01 * c11 + m02 * c12
    s02 = m00 * c02 + m01 * c12 + m02 * c22
    s10 = m10 * c00 + m11 * c01 + m12 * c02
    s11 = m10 * c01 + m11 * c11 + m12 * c12
    s12 = m10 * c02 + m11 * c12 + m12 * c22
    a = s00 * m00 + s01 * m01 + s02 * m02 + COV2D_FILTER
    b = s00 * m10 + s01 * m11 + s02 * m12
    c = s10 * m10 + s11 * m11 + s12 * m12 + COV2D_FILTER
    cov2d = torch.stack([a, b, c], dim=-1)

    det = a * c - b * b
    valid_det = det > 0.0
    inv_det = 1.0 / torch.where(valid_det, det, torch.ones_like(det))
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    # Conservative radius: 3σ of the major eigenvalue.
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1)).to(torch.int32)

    mask = in_front & valid_det & (radius > 0)
    if alive is not None:
        mask = mask & alive
    radius = torch.where(mask, radius, torch.zeros_like(radius))

    return Projected(
        mean2d=mean2d, depth=depth, conic=conic, radius=radius, mask=mask, cov2d=cov2d
    )


def project_from_params(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    camera: Camera,
    scale_modifier: float = 1.0,
    alive: torch.Tensor | None = None,
) -> Projected:
    """Build Σ from (scale, quaternion) and project — all SoA, no [N,3,3]."""
    parts = covariance_symm6_parts(scales * scale_modifier, quats)
    return _project_core(means3d, parts, camera, alive=alive)
