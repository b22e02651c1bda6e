"""Scene orchestration: dataset → cameras at N scales → model init tables.

The port of the JAX package's `data/scene.py`: the reference `Scene`
(`scene/__init__.py:73-166`):
autodetects the dataset flavor by marker files, builds `Camera` pytrees at
every requested resolution scale, assembles the trainable FLAME parameter
table (`FlameGaussianModel.load_meshes`, `scene/flame_gaussian_model.py:42-88`)
and owns checkpoint export (`point_cloud/iteration_N/point_cloud.ply` +
sidecar `flame_param.npz`, `scene/__init__.py:155-157`).

The Scene holds **no pixels**: records carry image paths, and
`data/pipeline.py` decodes them (replacing the reference's DataLoader
worker processes, `scene/__init__.py:31-67`). Its cameras' tensors live on
the Scene's device.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .cameras import Camera, make_camera
from .ply import save_gaussian_ply
from .readers import (
    CameraRecord,
    SceneInfo,
    detect_scene_type,
    fov_to_focal,
    read_colmap_scene,
    read_dynamic_nerf,
    read_nerf_synthetic,
)

_WARNED_LARGE = False


def resolve_resolution(
    orig_w: int, orig_h: int, resolution: int, resolution_scale: float = 1.0
) -> Tuple[int, int]:
    """Reference resolution policy (`utils/camera_utils.py:20-49`):
    -1 → auto-downscale >1600px-wide images; 1/2/4/8 → divisors; other
    positive values → target width."""
    global _WARNED_LARGE
    if resolution in (1, 2, 4, 8):
        return (
            round(orig_w / (resolution_scale * resolution)),
            round(orig_h / (resolution_scale * resolution)),
        )
    if resolution == -1:
        if orig_w > 1600:
            if not _WARNED_LARGE:
                print("[ INFO ] large input images (>1.6K width); rescaling to 1.6K."
                      " Use --resolution 1 to disable.")
                _WARNED_LARGE = True
            down = orig_w / 1600
        else:
            down = 1.0
    else:
        down = orig_w / resolution
    scale = float(down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def record_to_camera(
    rec: CameraRecord, resolution: int = -1, resolution_scale: float = 1.0,
    uid: Optional[int] = None, device="cuda",
) -> Camera:
    w, h = resolve_resolution(rec.width, rec.height, resolution, resolution_scale)
    return make_camera(
        R=rec.R, T=rec.T, fovx=rec.fovx, fovy=rec.fovy, width=w, height=h,
        timestep=rec.timestep or 0,
        camera_id=rec.camera_id if rec.camera_id is not None else (uid or 0),
        image_name=rec.image_name, device=device,
    )


def camera_to_json(uid: int, rec: CameraRecord) -> dict:
    """`camera_to_JSON` (`utils/camera_utils.py:62-82`)."""
    rt = np.eye(4)
    rt[:3, :3] = rec.R.T
    rt[:3, 3] = rec.T
    c2w = np.linalg.inv(rt)
    pos = c2w[:3, 3]
    rot = c2w[:3, :3]
    return {
        "id": uid,
        "img_name": rec.image_name,
        "width": rec.width,
        "height": rec.height,
        "position": pos.tolist(),
        "rotation": [r.tolist() for r in rot],
        "fy": fov_to_focal(rec.fovy, rec.height),
        "fx": fov_to_focal(rec.fovx, rec.width),
    }


def assemble_flame_table(
    train_meshes: Dict[int, dict],
    test_meshes: Dict[int, dict],
    tgt_train_meshes: Dict[int, dict],
    tgt_test_meshes: Dict[int, dict],
    num_verts: int,
    disable_static_offset: bool = False,
) -> Dict[str, np.ndarray]:
    """Build the [T, ·] FLAME parameter table (`load_meshes`,
    `scene/flame_gaussian_model.py:42-88`): shape/static_offset from the
    *source* actor's first mesh, per-timestep pose/expr from the pose source
    (target actor when reenacting)."""
    meshes = {**train_meshes, **test_meshes}
    tgt = {**tgt_train_meshes, **tgt_test_meshes}
    pose_meshes = meshes if not tgt else tgt
    if not meshes:
        raise ValueError("no FLAME meshes in dataset")
    T = max(pose_meshes) + 1
    first = meshes[min(meshes)]

    if disable_static_offset or "static_offset" not in first:
        static_offset = np.zeros((num_verts, 3), np.float32)
    else:
        so = np.asarray(first["static_offset"], np.float32)
        so = so.reshape(-1, 3) if so.ndim == 3 else so
        if so.shape[0] != num_verts:
            # Pad (e.g. teeth vertices the dataset lacks) or truncate (an
            # offset saved WITH teeth loaded into a no-teeth topology) —
            # same clamping as viewers/local.py.
            so = np.pad(so, ((0, max(0, num_verts - so.shape[0])), (0, 0)))
            so = so[:num_verts]
        static_offset = so

    n_expr = int(np.asarray(first["expr"]).reshape(1, -1).shape[1])
    table = {
        "shape": np.asarray(first["shape"], np.float32).reshape(-1),
        "expr": np.zeros((T, n_expr), np.float32),
        "rotation": np.zeros((T, 3), np.float32),
        "neck_pose": np.zeros((T, 3), np.float32),
        "jaw_pose": np.zeros((T, 3), np.float32),
        "eyes_pose": np.zeros((T, 6), np.float32),
        "translation": np.zeros((T, 3), np.float32),
        "static_offset": static_offset,
        "dynamic_offset": np.zeros((T, 1, 3), np.float32),  # kept for format parity
    }
    for t, mesh in pose_meshes.items():
        for src, dst in (
            ("expr", "expr"), ("rotation", "rotation"), ("neck_pose", "neck_pose"),
            ("jaw_pose", "jaw_pose"), ("eyes_pose", "eyes_pose"),
            ("translation", "translation"),
        ):
            table[dst][t] = np.asarray(mesh[src], np.float32).reshape(-1)
    return table


class Scene:
    """Dataset + cameras + (optional) FLAME table, at N resolution scales."""

    def __init__(
        self,
        source_path: str,
        model_path: str = "",
        resolution: int = -1,
        white_background: bool = False,
        eval_split: bool = True,
        target_path: str = "",
        resolution_scales: Sequence[float] = (1.0,),
        select_camera_id: int = -1,
        num_verts_hint: int = 0,
        images_dir: Optional[str] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.source_path = source_path
        self.model_path = model_path
        self.resolution = resolution
        kind = detect_scene_type(source_path)
        self.kind = kind
        if kind == "colmap":
            info = read_colmap_scene(
                source_path, images_dir, eval_split, white_background=white_background
            )
        elif kind == "blender":
            info = read_nerf_synthetic(source_path, white_background, eval_split)
        else:
            info = read_dynamic_nerf(
                source_path, white_background, eval_split, target_path=target_path
            )
        self.info: SceneInfo = info
        self.cameras_extent = float(info.nerf_normalization["radius"])

        def keep(recs: List[CameraRecord]) -> List[CameraRecord]:
            if select_camera_id == -1:
                return recs
            return [r for r in recs if r.camera_id in (None, select_camera_id)]

        self._splits: Dict[str, List[CameraRecord]] = {
            "train": keep(info.train_cameras),
            "val": keep(info.val_cameras),
            "test": keep(info.test_cameras),
        }
        self._cams: Dict[Tuple[str, float], List[Camera]] = {}
        for scale in resolution_scales:
            for split, recs in self._splits.items():
                self._cams[(split, scale)] = [
                    record_to_camera(r, resolution, scale, uid=i, device=self.device)
                    for i, r in enumerate(recs)
                ]

        self.flame_table: Optional[Dict[str, np.ndarray]] = None
        self.num_timesteps = 0
        if info.train_meshes or info.tgt_train_meshes:
            num_verts = num_verts_hint
            if not num_verts:
                # Infer from any mesh that carries a static_offset; FLAME
                # npz files without one (it is optional everywhere else)
                # fall back to the FLAME-2023 vertex count.
                for m in [*info.train_meshes.values(),
                          *info.tgt_train_meshes.values()]:
                    if "static_offset" in m:
                        num_verts = np.asarray(
                            m["static_offset"]).reshape(-1, 3).shape[0]
                        break
                else:
                    num_verts = 5143  # FLAME 2023 + teeth
            self.flame_table = assemble_flame_table(
                info.train_meshes, info.test_meshes,
                info.tgt_train_meshes, info.tgt_test_meshes,
                num_verts=num_verts,
            )
            self.num_timesteps = self.flame_table["expr"].shape[0]

        if model_path:
            os.makedirs(model_path, exist_ok=True)
            allrecs = [*self._splits["train"], *self._splits["val"], *self._splits["test"]]
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump([camera_to_json(i, r) for i, r in enumerate(allrecs)], f)

    # -- accessors (`scene/__init__.py:159-166`) ---------------------------
    def records(self, split: str) -> List[CameraRecord]:
        return self._splits[split]

    def cameras(self, split: str, scale: float = 1.0) -> List[Camera]:
        return self._cams[(split, scale)]

    def train_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self._cams[("train", scale)]

    def val_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self._cams[("val", scale)]

    def test_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self._cams[("test", scale)]

    # -- checkpoint export (`scene/__init__.py:155-157`) --------------------
    def save(self, iteration: int, params, aux, flame_param: Optional[dict] = None,
             alive: Optional[np.ndarray] = None) -> str:
        out_dir = os.path.join(self.model_path, "point_cloud", f"iteration_{iteration}")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "point_cloud.ply")
        live = _np(alive if alive is not None else aux.alive)
        sel = np.nonzero(live)[0]
        binding = _np(aux.binding)[sel] if flame_param is not None else None
        save_gaussian_ply(
            path,
            means=_np(params.means)[sel],
            sh_dc=_np(params.sh_dc)[sel],
            sh_rest=_np(params.sh_rest)[sel],
            logit_opacity=_np(params.logit_opacity)[sel],
            log_scales=_np(params.log_scales)[sel],
            quats=_np(params.quats)[sel],
            binding=binding,
        )
        if flame_param is not None:
            np.savez(
                os.path.join(out_dir, "flame_param.npz"),
                **{k: _np(v) for k, v in flame_param.items()},
            )
        return path


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
