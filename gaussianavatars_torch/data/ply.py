"""3DGS PLY checkpoint I/O, byte-compatible with the reference format.

Writes/reads the exact attribute layout of `GaussianModel.save_ply/load_ply`
(`scene/gaussian_model.py:242-338`): binary little-endian PLY, one `vertex`
element with float32 properties x,y,z, nx,ny,nz, f_dc_0..2,
f_rest_0..(3K-4), opacity, scale_0..2, rot_0..3 and the optional `binding_0`
for mesh-bound avatars — so checkpoints interchange with the CUDA
implementation in both directions. Self-contained (no plyfile dependency).

The port's own copy of the JAX package's `data/ply.py` (numpy only): the
two write byte-identical files from the same arrays.
"""
from __future__ import annotations

import io
import os
from typing import Optional

import numpy as np


def _header(n: int, names: list[str]) -> bytes:
    lines = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    lines += [f"property float {name}" for name in names]
    lines.append("end_header")
    return ("\n".join(lines) + "\n").encode("ascii")


def attribute_names(sh_rest_coeffs: int, with_binding: bool) -> list[str]:
    names = ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
    names += [f"f_rest_{i}" for i in range(3 * sh_rest_coeffs)]
    names += ["opacity", "scale_0", "scale_1", "scale_2"]
    names += [f"rot_{i}" for i in range(4)]
    if with_binding:
        names.append("binding_0")
    return names


def save_gaussian_ply(
    path: str,
    means: np.ndarray,        # [N, 3] (local coords when bound)
    sh_dc: np.ndarray,        # [N, 1, 3]
    sh_rest: np.ndarray,      # [N, K-1, 3]
    logit_opacity: np.ndarray,  # [N, 1]
    log_scales: np.ndarray,   # [N, 3]
    quats: np.ndarray,        # [N, 4] raw
    binding: Optional[np.ndarray] = None,  # [N] int
) -> None:
    n = means.shape[0]
    k_rest = sh_rest.shape[1]
    # Channel-major SH flattening, as the reference writes it
    # (transpose(1,2).flatten: [N, K, 3] → [N, 3, K] → [N, 3K]).
    f_dc = np.transpose(sh_dc, (0, 2, 1)).reshape(n, -1)
    f_rest = np.transpose(sh_rest, (0, 2, 1)).reshape(n, -1)
    cols = [
        means.astype(np.float32),
        np.zeros((n, 3), np.float32),  # normals
        f_dc.astype(np.float32),
        f_rest.astype(np.float32),
        logit_opacity.reshape(n, 1).astype(np.float32),
        log_scales.astype(np.float32),
        quats.astype(np.float32),
    ]
    if binding is not None:
        cols.append(binding.reshape(n, 1).astype(np.float32))
    data = np.concatenate(cols, axis=1).astype("<f4")

    names = attribute_names(k_rest, binding is not None)
    assert data.shape[1] == len(names)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_header(n, names))
        f.write(data.tobytes())


def load_gaussian_ply(path: str) -> dict:
    """Returns dict with means, sh_dc [N,1,3], sh_rest [N,K-1,3],
    logit_opacity [N,1], log_scales [N,3], quats [N,4], binding ([N] or None).
    """
    with open(path, "rb") as f:
        raw = f.read()
    head_end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:head_end].decode("ascii").splitlines()
    n = 0
    names: list[str] = []
    fmt_le = True
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt_le = t[1] == "binary_little_endian"
        elif t[0] == "element" and t[1] == "vertex":
            n = int(t[2])
        elif t[0] == "property" and len(t) == 3:
            names.append(t[2])
    if not fmt_le:
        raise ValueError("only binary_little_endian PLY supported")
    data = np.frombuffer(raw, dtype="<f4", count=n * len(names), offset=head_end)
    data = data.reshape(n, len(names))
    col = {name: data[:, i] for i, name in enumerate(names)}

    means = np.stack([col["x"], col["y"], col["z"]], axis=1)
    sh_dc = np.stack([col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]], axis=1)[:, None, :]
    rest_names = sorted(
        [nm for nm in names if nm.startswith("f_rest_")], key=lambda s: int(s.split("_")[-1])
    )
    k_rest = len(rest_names) // 3
    if rest_names:
        rest = np.stack([col[nm] for nm in rest_names], axis=1).reshape(n, 3, k_rest)
        sh_rest = np.transpose(rest, (0, 2, 1))
    else:
        sh_rest = np.zeros((n, 0, 3), np.float32)
    scale_names = sorted(
        [nm for nm in names if nm.startswith("scale_")], key=lambda s: int(s.split("_")[-1])
    )
    rot_names = sorted(
        [nm for nm in names if nm.startswith("rot_")], key=lambda s: int(s.split("_")[-1])
    )
    out = dict(
        means=means,
        sh_dc=sh_dc.astype(np.float32),
        sh_rest=sh_rest.astype(np.float32),
        logit_opacity=col["opacity"][:, None].astype(np.float32),
        log_scales=np.stack([col[nm] for nm in scale_names], axis=1).astype(np.float32),
        quats=np.stack([col[nm] for nm in rot_names], axis=1).astype(np.float32),
        binding=col["binding_0"].astype(np.int32) if "binding_0" in col else None,
    )
    return out


def save_point_ply(path: str, xyz: np.ndarray, rgb01: np.ndarray) -> None:
    """Point-cloud PLY with uchar colors (`storePly`,
    `scene/dataset_readers.py:126-140` format)."""
    n = xyz.shape[0]
    lines = [
        "ply", "format binary_little_endian 1.0", f"element vertex {n}",
        "property float x", "property float y", "property float z",
        "property float nx", "property float ny", "property float nz",
        "property uchar red", "property uchar green", "property uchar blue",
        "end_header",
    ]
    header = ("\n".join(lines) + "\n").encode("ascii")
    dt = np.dtype([
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1"),
    ])
    rec = np.zeros(n, dt)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rgb = np.clip(rgb01 * 255.0, 0, 255).astype(np.uint8)
    rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rec.tobytes())


def load_point_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load a point-cloud PLY → (xyz [N,3], rgb01 [N,3]) (`fetchPly`,
    `scene/dataset_readers.py:117-124`). Handles float + uchar properties."""
    with open(path, "rb") as f:
        raw = f.read()
    head_end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:head_end].decode("ascii").splitlines()
    n = 0
    props: list[tuple[str, str]] = []
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "element" and t[1] == "vertex":
            n = int(t[2])
        elif t[0] == "property" and len(t) == 3 and n > 0:
            props.append((t[2], t[1]))
        elif t[0] == "element" and t[1] != "vertex":
            break
    typemap = {"float": "<f4", "float32": "<f4", "double": "<f8",
               "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4"}
    dt = np.dtype([(name, typemap[ty]) for name, ty in props])
    rec = np.frombuffer(raw, dtype=dt, count=n, offset=head_end)
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], 1).astype(np.float64)
    if "red" in rec.dtype.names:
        scale = 255.0 if rec.dtype["red"] == np.uint8 else 1.0
        rgb = np.stack([rec["red"], rec["green"], rec["blue"]], 1).astype(np.float64) / scale
    else:
        rgb = np.full((n, 3), 0.5)
    return xyz, rgb
