"""Camera and geometry transforms (PyTorch).

Conventions as in the JAX package: OpenCV-style camera (x right, y down,
z forward), column-vector matrices, ``p_view = W2V @ [p; 1]``, and the 3DGS
projection matrix with z_sign=+1.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def world_to_view(R, t, translate=(0.0, 0.0, 0.0), scale: float = 1.0,
                  device="cpu") -> torch.Tensor:
    """World→view 4x4 from COLMAP-convention (R, t), float32.

    R is the camera-to-world rotation, t the world-to-view translation;
    `translate`/`scale` recentre the scene like `getWorld2View2`.
    """
    f32 = torch.float32

    def f(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, f32)
        return torch.tensor(np.asarray(x), dtype=f32, device=device)

    R, t, translate = f(R), f(t), f(translate)
    Rt = torch.eye(4, dtype=f32, device=device)
    Rt[:3, :3] = R.T
    cam_center = -R @ t
    cam_center = (cam_center + translate) * scale
    Rt[:3, 3] = -R.T @ cam_center
    return Rt


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float,
                      device="cpu") -> torch.Tensor:
    """3DGS perspective projection (z forward, depth in [0, f/(f-n)])."""
    P = torch.zeros((4, 4), dtype=torch.float32, device=device)
    P[0, 0] = 1.0 / math.tan(fovx / 2)
    P[1, 1] = 1.0 / math.tan(fovy / 2)
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def fov_to_focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def _safe_normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v / torch.sqrt(torch.clamp_min(n2, eps))


def compute_face_orientation(verts: torch.Tensor, faces: torch.Tensor):
    """Per-triangle orthonormal frame + isotropic scale for mesh binding.

    axis0 = normalised first edge, axis1 = face normal, axis2 = the negated
    normalised cross of the two; scale = (|e1| + triangle height along
    axis2) / 2.

    Args:
      verts: [..., V, 3]; faces: [F, 3] integer.
    Returns:
      (R [..., F, 3, 3] column frames, scale [..., F, 1])
    """
    v0 = verts[..., faces[:, 0], :]
    v1 = verts[..., faces[:, 1], :]
    v2 = verts[..., faces[:, 2], :]

    a0 = _safe_normalize(v1 - v0)
    a1 = _safe_normalize(torch.linalg.cross(a0, v2 - v0))
    a2 = -_safe_normalize(torch.linalg.cross(a1, a0))
    R = torch.stack([a0, a1, a2], dim=-1)

    e1_len = torch.linalg.norm(v1 - v0, dim=-1, keepdim=True)
    height = torch.abs(torch.sum(a2 * (v2 - v0), dim=-1, keepdim=True))
    scale = (e1_len + height) / 2
    return R, scale


def compute_face_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Unnormalised per-face normals [..., F, 3]: (v1 - v0) × (v2 - v0)."""
    v0 = verts[..., faces[:, 0], :]
    v1 = verts[..., faces[:, 1], :]
    v2 = verts[..., faces[:, 2], :]
    return torch.linalg.cross(v1 - v0, v2 - v0)
