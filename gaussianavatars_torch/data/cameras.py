"""Camera: the view's matrices as float32 tensors plus Python metadata."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device
from ..ops.transforms import projection_matrix, world_to_view


@dataclasses.dataclass(frozen=True)
class Camera:
    """A single view. Column-vector convention: p_view = world_view @ [p;1]."""

    world_view: torch.Tensor     # [4,4] world→camera
    proj: torch.Tensor           # [4,4] camera→clip
    full_proj: torch.Tensor      # [4,4] world→clip (= proj @ world_view)
    camera_center: torch.Tensor  # [3] camera position in world
    fovx: float
    fovy: float
    width: int
    height: int
    timestep: int = 0
    camera_id: int = 0
    image_name: str = ""

    @property
    def device(self) -> torch.device:
        return self.world_view.device

    @property
    def tan_half_fovx(self) -> float:
        return math.tan(self.fovx / 2)

    @property
    def tan_half_fovy(self) -> float:
        return math.tan(self.fovy / 2)

    @property
    def focal_x(self) -> float:
        return self.width / (2 * self.tan_half_fovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2 * self.tan_half_fovy)


def make_camera(
    R: np.ndarray,
    T: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    znear: float = 0.01,
    zfar: float = 100.0,
    translate=(0.0, 0.0, 0.0),
    scale: float = 1.0,
    timestep: int = 0,
    camera_id: int = 0,
    image_name: str = "",
    device="cuda",
) -> Camera:
    """Build a Camera from COLMAP-convention extrinsics (R, T) and FoVs."""
    dev = resolve_device(device)
    w2v = world_to_view(R, T, translate, scale, device=dev)
    proj = projection_matrix(znear, zfar, fovx, fovy, device=dev)
    return Camera(
        world_view=w2v,
        proj=proj,
        full_proj=proj @ w2v,
        camera_center=-w2v[:3, :3].T @ w2v[:3, 3],
        fovx=float(fovx),
        fovy=float(fovy),
        width=int(width),
        height=int(height),
        timestep=int(timestep),
        camera_id=int(camera_id),
        image_name=image_name,
    )


def look_at_camera(
    eye,
    target=(0.0, 0.0, 0.0),
    up=(0.0, -1.0, 0.0),
    fovy: float = 0.6,
    width: int = 512,
    height: int = 512,
    device="cuda",
    **kw,
) -> Camera:
    """Camera at `eye` looking at `target`; `up` defaults to -y because the
    camera frame is OpenCV-style (y down)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)  # camera-to-world columns
    T = -R.T @ eye
    fovx = 2 * math.atan(math.tan(fovy / 2) * (width / height))
    return make_camera(R, T, fovx, fovy, width, height, device=device, **kw)
