"""Mesh binding: FLAME vertices → per-triangle frames driving Gaussians."""
from __future__ import annotations

import torch

from ..ops.quaternion import rotmat_to_quat
from ..ops.transforms import compute_face_orientation
from .gaussians import FaceFrames


def face_frames(verts: torch.Tensor, faces: torch.Tensor) -> FaceFrames:
    """Per-triangle binding frames for one timestep.

    Args:
      verts: [V, 3] posed FLAME vertices.
      faces: [F, 3] integer.
    """
    center = verts[faces].mean(dim=1)
    orien_mat, scaling = compute_face_orientation(verts, faces)
    return FaceFrames(
        center=center, orien_mat=orien_mat,
        orien_quat=rotmat_to_quat(orien_mat), scaling=scaling,
    )
