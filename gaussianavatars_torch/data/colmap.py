"""COLMAP sparse-reconstruction readers and writers (binary and text).

The port's own copy of the JAX package's `data/colmap.py` (pure numpy),
equivalent in behaviour to the reference's `scene/colmap_loader.py:43-294`
(itself derived from COLMAP's own `read_write_model.py`): reads
`cameras.bin/txt`, `images.bin/txt`, `points3D.bin/txt` into plain
records, and writes both formats (the JAX package writes binary only).
Implemented from the COLMAP format specification (binary little-endian;
see COLMAP docs).
"""
from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple

import numpy as np

# model_id -> (name, num_params) per the COLMAP camera-model table.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray   # [4] wxyz world→camera rotation
    tvec: np.ndarray   # [3] world→camera translation
    camera_id: int
    name: str
    xys: np.ndarray    # [P, 2] keypoints
    point3d_ids: np.ndarray  # [P]


class ColmapPoints(NamedTuple):
    xyz: np.ndarray    # [N, 3]
    rgb: np.ndarray    # [N, 3] uint8
    errors: np.ndarray  # [N]


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (wxyz) → rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → unit quaternion (wxyz), Shepperd's method."""
    K = (
        np.array(
            [
                [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
                [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
                [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
                [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
                 R[0, 0] + R[1, 1] + R[2, 2]],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def _read(f, fmt: str):
    size = struct.calcsize("<" + fmt)  # "<" disables native padding
    return struct.unpack("<" + fmt, f.read(size))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "iiQQ")
            name, nparam = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "d" * nparam))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return cams


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            cam_id, model = int(toks[0]), toks[1]
            width, height = int(toks[2]), int(toks[3])
            params = np.array([float(t) for t in toks[4:]])
            cams[cam_id] = ColmapCamera(cam_id, model, width, height, params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            vals = _read(f, "idddddddi")
            img_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "Q")
            data = np.frombuffer(f.read(24 * npts), dtype=np.float64).reshape(npts, 3)
            xys = data[:, :2].copy()
            pids = data[:, 2].copy().view(np.int64) if npts else np.zeros((0,), np.int64)
            images[img_id] = ColmapImage(
                img_id, qvec, tvec, camera_id, name.decode("utf-8"), xys, pids
            )
    return images


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        # Keep blank lines: the format is strictly two lines per image and
        # an image with zero observations has an EMPTY second line —
        # dropping it would shift every following (header, points) pair.
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    while lines and not lines[0]:
        lines.pop(0)
    for i in range(0, len(lines), 2):
        toks = lines[i].split()
        img_id = int(toks[0])
        qvec = np.array([float(t) for t in toks[1:5]])
        tvec = np.array([float(t) for t in toks[5:8]])
        camera_id = int(toks[8])
        name = toks[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        trip = np.array([float(t) for t in pts]).reshape(-1, 3) if pts else np.zeros((0, 3))
        images[img_id] = ColmapImage(
            img_id, qvec, tvec, camera_id, name, trip[:, :2], trip[:, 2].astype(np.int64)
        )
    return images


def read_points3d_binary(path: str) -> ColmapPoints:
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty((n,))
        for i in range(n):
            vals = _read(f, "QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(f, "Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return ColmapPoints(xyz, rgb, err)


def read_points3d_text(path: str) -> ColmapPoints:
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            xyz.append([float(t) for t in toks[1:4]])
            rgb.append([int(t) for t in toks[4:7]])
            err.append(float(toks[7]))
    return ColmapPoints(
        np.array(xyz).reshape(-1, 3),
        np.array(rgb, np.uint8).reshape(-1, 3),
        np.array(err),
    )


def write_cameras_binary(cams: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            f.write(struct.pack("<iiQQ", c.id, CAMERA_MODEL_IDS[c.model], c.width, c.height))
            f.write(struct.pack("<" + "d" * len(c.params), *c.params))


def write_images_binary(images: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            npts = len(im.xys)
            f.write(struct.pack("<Q", npts))
            if npts:
                data = np.empty((npts, 3), np.float64)
                data[:, :2] = im.xys
                data[:, 2] = im.point3d_ids.astype(np.int64).view(np.float64)
                f.write(data.tobytes())


def write_points3d_binary(pts: ColmapPoints, path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts.xyz)))
        for i in range(len(pts.xyz)):
            f.write(struct.pack(
                "<QdddBBBd", i, *pts.xyz[i], *pts.rgb[i].tolist(), pts.errors[i]
            ))
            f.write(struct.pack("<Q", 0))


def _num(v) -> str:
    """A number as text that reads back to the same float64."""
    return repr(float(v))


def write_cameras_text(cams: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cams)}\n")
        for c in cams.values():
            f.write(" ".join([str(c.id), c.model, str(c.width), str(c.height),
                              *map(_num, c.params)]) + "\n")


def write_images_text(images: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for im in images.values():
            f.write(" ".join([str(im.id), *map(_num, im.qvec), *map(_num, im.tvec),
                              str(im.camera_id), im.name]) + "\n")
            f.write(" ".join(f"{_num(x)} {_num(y)} {int(p)}"
                             for (x, y), p in zip(im.xys, im.point3d_ids)) + "\n")


def write_points3d_text(pts: ColmapPoints, path: str) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(pts.xyz)}\n")
        for i in range(len(pts.xyz)):
            f.write(" ".join([str(i), *map(_num, pts.xyz[i]), *map(str, pts.rgb[i].tolist()),
                              _num(pts.errors[i])]) + "\n")
