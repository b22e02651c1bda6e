"""Quaternion and rotation utilities (PyTorch, batched).

Quaternions are stored ``(w, x, y, z)`` (scalar first), as in the JAX
package. All functions broadcast over leading batch dimensions.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def quat_normalize(q: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Normalise quaternions to unit norm. q: [..., 4] wxyz."""
    norm = torch.sqrt(torch.clamp_min(torch.sum(q * q, dim=-1, keepdim=True), eps))
    return q / norm


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (b is applied first). Both [..., 4] wxyz."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] wxyz → rotation matrix [..., 3, 3]."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] → unit quaternion [..., 4] wxyz.

    Branch-free Shepperd-style selection over the four candidate
    constructions; the sign is canonicalised to w >= 0.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def _safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, _EPS))

    qw = _safe_sqrt(1.0 + tr) / 2.0
    qx = _safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    qy = _safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    qz = _safe_sqrt(1.0 - m00 - m11 + m22) / 2.0

    c_w = torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw), (m10 - m01) / (4 * qw)], -1)
    c_x = torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx), (m02 + m20) / (4 * qx)], -1)
    c_y = torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy, (m12 + m21) / (4 * qy)], -1)
    c_z = torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz), (m12 + m21) / (4 * qz), qz], -1)

    mags = torch.stack([qw, qx, qy, qz], -1)
    best = torch.argmax(mags, dim=-1)
    cands = torch.stack([c_w, c_x, c_y, c_z], dim=-2)  # [..., 4 cand, 4 comp]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = torch.linalg.cross(u, v)
    uuv = torch.linalg.cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def covariance_symm6_parts(scale: torch.Tensor, q: torch.Tensor):
    """Σ = R S² Rᵀ as six scalar tensors (c00, c01, c02, c11, c12, c22).

    Elementwise (SoA): Σ_ij = Σ_k r_ik s_k² r_jk with everything as [N]
    tensors, so no float32 product is routed through a matrix unit.
    """
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r00 = 1 - 2 * (yy + zz)
    r01 = 2 * (xy - wz)
    r02 = 2 * (xz + wy)
    r10 = 2 * (xy + wz)
    r11 = 1 - 2 * (xx + zz)
    r12 = 2 * (yz - wx)
    r20 = 2 * (xz - wy)
    r21 = 2 * (yz + wx)
    r22 = 1 - 2 * (xx + yy)
    s0 = scale[..., 0] * scale[..., 0]
    s1 = scale[..., 1] * scale[..., 1]
    s2 = scale[..., 2] * scale[..., 2]
    c00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    c01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    c02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    c11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    c12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    c22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return c00, c01, c02, c11, c12, c22
