"""Dataset readers: COLMAP, NeRF-synthetic (Blender), DynamicNerf (avatars).

The port's own copy of the JAX package's `data/readers.py` (numpy only),
with the same on-disk formats as the reference
(`scene/dataset_readers.py:42-352`): readers return lightweight
`CameraRecord`s (paths + geometry, **no pixels**); decoding happens later
in `data/pipeline.py`. COLMAP scenes are parsed by `data/colmap.py`.

The avatar path (`read_dynamic_nerf`, reference `readDynamicNerfInfo`
`scene/dataset_readers.py:297-352`) reads `transforms_{train,val,test}.json`
with per-frame `timestep_index` / `camera_index` / `flame_param_path`, plus
cross-reenactment via `target_path` (cameras+meshes from the target actor,
all splits merged into train).
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from .colmap import (
    qvec_to_rotmat,
    read_cameras_binary,
    read_cameras_text,
    read_images_binary,
    read_images_text,
    read_points3d_binary,
    read_points3d_text,
)


def fov_to_focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal_to_fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


class CameraRecord(NamedTuple):
    """One view's geometry + image pointer (pixels decoded later)."""

    uid: int
    R: np.ndarray          # [3,3] camera-to-world rotation (COLMAP convention:
                           # world→cam rotation transposed, as the reference stores it)
    T: np.ndarray          # [3] world→camera translation
    fovx: float
    fovy: float
    width: int
    height: int
    image_path: str
    image_name: str
    bg: np.ndarray         # [3] background the image alpha-composites onto
    timestep: Optional[int] = None
    camera_id: Optional[int] = None


class PointCloud(NamedTuple):
    points: np.ndarray   # [N, 3]
    colors: np.ndarray   # [N, 3] in [0,1]
    normals: np.ndarray  # [N, 3]


class SceneInfo(NamedTuple):
    point_cloud: Optional[PointCloud]
    train_cameras: List[CameraRecord]
    val_cameras: List[CameraRecord]
    test_cameras: List[CameraRecord]
    nerf_normalization: dict          # {"translate": [3], "radius": float}
    ply_path: Optional[str]
    train_meshes: Dict[int, dict]     # timestep → flame_param dict (npz arrays)
    test_meshes: Dict[int, dict]
    tgt_train_meshes: Dict[int, dict]
    tgt_test_meshes: Dict[int, dict]


def _world_to_view(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = R.T
    m[:3, 3] = T
    return m


def nerfpp_norm(cams: List[CameraRecord]) -> dict:
    """Camera-sphere normalization → scene extent (`getNerfppNorm`,
    `scene/dataset_readers.py:54-75`)."""
    centers = []
    for c in cams:
        w2c = _world_to_view(c.R, c.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers, 0)
    avg = centers.mean(0)
    diagonal = float(np.linalg.norm(centers - avg, axis=1).max())
    radius = diagonal * 1.1
    return {"translate": -avg, "radius": radius if radius > 0 else 1.0}


def _image_size(path: str) -> tuple[int, int]:
    from .pipeline import image_size

    return image_size(path)  # (w, h)


# ---------------------------------------------------------------------------
# COLMAP scenes
# ---------------------------------------------------------------------------


def read_colmap_scene(
    path: str, images_dir: Optional[str] = None, eval_split: bool = True,
    llffhold: int = 8, white_background: bool = False,
) -> SceneInfo:
    """`readColmapSceneInfo` equivalent (`scene/dataset_readers.py:142-187`):
    PINHOLE and SIMPLE_PINHOLE cameras, every `llffhold`-th image (sorted
    by name) held out for test, the point cloud from `points3D.bin` or
    `.txt`."""
    sparse = os.path.join(path, "sparse", "0")
    if os.path.exists(os.path.join(sparse, "images.bin")):
        extr = read_images_binary(os.path.join(sparse, "images.bin"))
        intr = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    else:
        extr = read_images_text(os.path.join(sparse, "images.txt"))
        intr = read_cameras_text(os.path.join(sparse, "cameras.txt"))

    folder = os.path.join(path, images_dir or "images")
    bg = np.ones(3) if white_background else np.zeros(3)
    records = []
    for key in extr:
        im = extr[key]
        cam = intr[im.camera_id]
        R = qvec_to_rotmat(im.qvec).T
        T = np.array(im.tvec)
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        elif cam.model == "PINHOLE":
            fx, fy = cam.params[0], cam.params[1]
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {cam.model}; undistort first "
                "(PINHOLE/SIMPLE_PINHOLE only, as in the reference)"
            )
        image_path = os.path.join(folder, os.path.basename(im.name))
        w, h = _image_size(image_path) if os.path.exists(image_path) else (cam.width, cam.height)
        records.append(CameraRecord(
            uid=cam.id, R=R, T=T,
            fovx=focal_to_fov(fx, w), fovy=focal_to_fov(fy, h),
            width=w, height=h, image_path=image_path,
            image_name=os.path.basename(image_path).split(".")[0], bg=bg,
        ))
    records.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(records) if i % llffhold != 0]
        test = [c for i, c in enumerate(records) if i % llffhold == 0]
    else:
        train, test = records, []

    ply_path = os.path.join(sparse, "points3D.ply")
    pcd = None
    for cand in (
        os.path.join(sparse, "points3D.bin"),
        os.path.join(sparse, "points3D.txt"),
    ):
        if os.path.exists(cand):
            pts = (read_points3d_binary if cand.endswith(".bin") else read_points3d_text)(cand)
            pcd = PointCloud(
                points=pts.xyz, colors=pts.rgb / 255.0, normals=np.zeros_like(pts.xyz)
            )
            break

    return SceneInfo(
        point_cloud=pcd, train_cameras=train, val_cameras=[], test_cameras=test,
        nerf_normalization=nerfpp_norm(train), ply_path=ply_path,
        train_meshes={}, test_meshes={}, tgt_train_meshes={}, tgt_test_meshes={},
    )


# ---------------------------------------------------------------------------
# transforms.json scenes (Blender + DynamicNerf)
# ---------------------------------------------------------------------------


def read_cameras_from_transforms(
    path: str, transforms_file: str, white_background: bool, extension: str = ".png",
) -> List[CameraRecord]:
    """NeRF-style reader (`readCamerasFromTransforms`,
    `scene/dataset_readers.py:189-245`): camera-to-world `transform_matrix`
    in OpenGL axes (y up, z back), flipped to COLMAP (y down, z forward)."""
    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)
    fovx_shared = contents.get("camera_angle_x")
    bg = np.ones(3) if white_background else np.zeros(3)

    records = []
    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"]
        if extension not in file_path:
            file_path += extension
        image_path = os.path.join(path, file_path)

        c2w = np.array(frame["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL → COLMAP axes
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]

        if "w" in frame and "h" in frame:
            w, h = int(frame["w"]), int(frame["h"])
        else:
            w, h = _image_size(image_path)

        fovx = frame.get("camera_angle_x", fovx_shared)
        if fovx is None:
            # Intrinsics given as focal lengths (instant-ngp style).
            fovx = focal_to_fov(frame.get("fl_x", contents.get("fl_x")), w)
        fovy = focal_to_fov(fov_to_focal(fovx, w), h)

        records.append(CameraRecord(
            uid=idx, R=R, T=T, fovx=fovx, fovy=fovy, width=w, height=h,
            image_path=image_path,
            image_name=os.path.splitext(os.path.basename(file_path))[0], bg=bg,
            timestep=frame.get("timestep_index"),
            camera_id=frame.get("camera_index"),
        ))
    return records


def read_meshes_from_transforms(path: str, transforms_file: str) -> Dict[int, dict]:
    """Per-timestep FLAME params (`readMeshesFromTransforms`,
    `scene/dataset_readers.py:283-295`)."""
    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)
    meshes: Dict[int, dict] = {}
    for frame in contents["frames"]:
        t = frame.get("timestep_index")
        if t is None or t in meshes:
            continue
        npz = np.load(os.path.join(path, frame["flame_param_path"]), allow_pickle=True)
        meshes[t] = {k: npz[k] for k in npz.files}
    return meshes


def read_nerf_synthetic(
    path: str, white_background: bool = False, eval_split: bool = True,
    extension: str = ".png", rng: Optional[np.random.Generator] = None,
) -> SceneInfo:
    """`readNerfSyntheticInfo` (`scene/dataset_readers.py:247-281`)."""
    train = read_cameras_from_transforms(path, "transforms_train.json", white_background, extension)
    test = read_cameras_from_transforms(path, "transforms_test.json", white_background, extension)
    if not eval_split:
        train = train + test
        test = []

    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        from .ply import load_point_ply

        xyz, rgb = load_point_ply(ply_path)
        pcd = PointCloud(points=xyz, colors=rgb, normals=np.zeros_like(xyz))
    else:
        rng = rng or np.random.default_rng(0)
        num_pts = 100_000
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        pcd = PointCloud(
            points=xyz, colors=rng.random((num_pts, 3)), normals=np.zeros_like(xyz)
        )

    return SceneInfo(
        point_cloud=pcd, train_cameras=train, val_cameras=[], test_cameras=test,
        nerf_normalization=nerfpp_norm(train), ply_path=ply_path,
        train_meshes={}, test_meshes={}, tgt_train_meshes={}, tgt_test_meshes={},
    )


def read_dynamic_nerf(
    path: str, white_background: bool = False, eval_split: bool = True,
    extension: str = ".png", target_path: str = "",
) -> SceneInfo:
    """The avatar path (`readDynamicNerfInfo`, `scene/dataset_readers.py:297-352`).

    With `target_path` (cross-reenactment) cameras come from the target actor
    and all splits merge into train; FLAME params are read from both actors
    (source → train/test_meshes, target → tgt_*_meshes).
    """
    cam_root = target_path if target_path else path
    train = read_cameras_from_transforms(cam_root, "transforms_train.json", white_background, extension)
    val = read_cameras_from_transforms(cam_root, "transforms_val.json", white_background, extension)
    test = read_cameras_from_transforms(cam_root, "transforms_test.json", white_background, extension)

    train_meshes = read_meshes_from_transforms(path, "transforms_train.json")
    test_meshes = read_meshes_from_transforms(path, "transforms_test.json")
    tgt_train_meshes = (
        read_meshes_from_transforms(target_path, "transforms_train.json") if target_path else {}
    )
    tgt_test_meshes = (
        read_meshes_from_transforms(target_path, "transforms_test.json") if target_path else {}
    )

    if target_path or not eval_split:
        train = train + val + test
        val, test = [], []
        train_meshes.update(test_meshes)
        test_meshes = {}

    return SceneInfo(
        point_cloud=None, train_cameras=train, val_cameras=val, test_cameras=test,
        nerf_normalization=nerfpp_norm(train), ply_path=None,
        train_meshes=train_meshes, test_meshes=test_meshes,
        tgt_train_meshes=tgt_train_meshes, tgt_test_meshes=tgt_test_meshes,
    )


def detect_scene_type(path: str) -> str:
    """Marker-file autodetection (`scene/__init__.py:89-99`)."""
    if os.path.exists(os.path.join(path, "sparse")):
        return "colmap"
    if os.path.exists(os.path.join(path, "transforms_val.json")):
        return "dynamic_nerf"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "blender"
    raise ValueError(f"could not recognise scene type at {path}")
