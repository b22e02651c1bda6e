"""Linear blend skinning (SMPL/FLAME family) in PyTorch.

Axis-angle → rotation (Rodrigues), shape blendshapes, joint regression,
kinematic-chain rigid transforms and skinning, batched over a leading B
axis. FLAME's chain has 5 joints; it is unrolled as a Python loop over the
static `parents` array.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def batch_rodrigues(rot_vecs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle [..., 3] → rotation matrices [..., 3, 3]."""
    angle = torch.linalg.norm(rot_vecs + eps, dim=-1, keepdim=True)
    axis = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(rot_vecs.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return eye + sin * K + (1.0 - cos) * (K @ K)


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """[B, L] × [V, 3, L] → [B, V, 3]."""
    return torch.einsum("bl,mkl->bmk", betas, shape_disps)


def vertices2joints(j_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """[J, V] × [B, V, 3] → [B, J, 3]."""
    return torch.einsum("bik,ji->bjk", vertices, j_regressor)


def batch_rigid_transform(
    rot_mats: torch.Tensor,   # [B, J, 3, 3]
    joints: torch.Tensor,     # [B, J, 3] rest-pose joint locations
    parents: np.ndarray,      # [J] static int (parents[0] == -1)
):
    """Compose the kinematic chain.

    Returns (posed_joints [B, J, 3], rel_transforms [B, J, 4, 4]) where
    rel_transforms map rest-pose coordinates to posed space.
    """
    parents = np.asarray(parents)
    J = parents.shape[0]
    rel = [joints[:, 0]] + [joints[:, i] - joints[:, parents[i]] for i in range(1, J)]

    def tmat(R, t):
        B = R.shape[0]
        top = torch.cat([R, t[:, :, None]], dim=2)                     # [B, 3, 4]
        # [0, 0, 0, 1] made on R's device: a tensor from Python numbers
        # would be a synchronising host-to-device copy every joint.
        bot = F.pad(torch.ones_like(R[:, :1, :1]), (3, 0))                # [B, 1, 4]
        return torch.cat([top, bot], dim=1)

    chain = [tmat(rot_mats[:, 0], rel[0])]
    for i in range(1, J):
        chain.append(chain[parents[i]] @ tmat(rot_mats[:, i], rel[i]))
    transforms = torch.stack(chain, dim=1)  # [B, J, 4, 4]

    posed_joints = transforms[:, :, :3, 3]
    # Subtract the transported rest joint so the transform acts on rest-pose
    # world coordinates directly.
    transported = torch.einsum("bjrc,bjc->bjr", transforms[:, :, :3, :3], joints)
    rel_transforms = transforms.clone()
    rel_transforms[:, :, :3, 3] -= transported
    return posed_joints, rel_transforms


def lbs(
    full_pose: torch.Tensor,     # [B, J*3] axis-angle
    v_shaped: torch.Tensor,      # [B, V, 3] shaped template
    posedirs: torch.Tensor,      # [(J-1)*9, V*3]
    j_regressor: torch.Tensor,   # [J, V]
    parents: np.ndarray,         # [J] static
    lbs_weights: torch.Tensor,   # [V, J]
):
    """Full LBS. Returns (verts [B, V, 3], posed_joints [B, J, 3])."""
    B = full_pose.shape[0]
    J = len(parents)
    joints = vertices2joints(j_regressor, v_shaped)
    rot_mats = batch_rodrigues(full_pose.reshape(B, J, 3))
    eye = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)          # [B, (J-1)*9]
    pose_offsets = (pose_feature @ posedirs).reshape(B, -1, 3)
    v_posed = v_shaped + pose_offsets

    posed_joints, A = batch_rigid_transform(rot_mats, joints, parents)
    # Per-vertex transform T = Σ_j w_vj A_j.
    T = torch.einsum("vj,bjrc->bvrc", lbs_weights, A)
    verts = torch.einsum("bvrc,bvc->bvr", T[:, :, :3, :3], v_posed) + T[:, :, :3, 3]
    return verts, posed_joints


def vertices2landmarks(
    vertices: torch.Tensor,       # [B, V, 3]
    faces: torch.Tensor,          # [F, 3]
    lmk_faces_idx: torch.Tensor,  # [L]
    lmk_bary: torch.Tensor,       # [L, 3]
) -> torch.Tensor:
    """Barycentric landmark interpolation → [B, L, 3]."""
    tri = faces[lmk_faces_idx]               # [L, 3]
    pts = vertices[:, tri]                   # [B, L, 3, 3]
    return torch.einsum("blfc,lf->blc", pts, lmk_bary)
