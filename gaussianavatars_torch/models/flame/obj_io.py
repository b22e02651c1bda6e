"""Minimal OBJ mesh loader (numpy).

Replaces the vendored pytorch3d loader the reference carries
(`utils/pytorch3d_load_obj.py`) with the ~40 lines actually needed: vertex
positions, UVs, and triangle faces (v and vt indices). Quads are fan-
triangulated. Materials/normals are ignored (the template head needs none).
"""
from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Returns (verts [V,3], verts_uvs [Vt,2], faces [F,3], faces_uv [F,3])."""
    verts, uvs, faces, faces_uv = [], [], [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                toks = line.split()[1:]
                vi, ti = [], []
                for t in toks:
                    parts = t.split("/")
                    vi.append(int(parts[0]) - 1)
                    if len(parts) > 1 and parts[1]:
                        ti.append(int(parts[1]) - 1)
                for k in range(1, len(vi) - 1):  # triangle fan
                    faces.append([vi[0], vi[k], vi[k + 1]])
                    if ti:
                        faces_uv.append([ti[0], ti[k], ti[k + 1]])
    return (
        np.asarray(verts, np.float32),
        np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32),
        np.asarray(faces, np.int32),
        np.asarray(faces_uv, np.int32) if faces_uv else np.zeros((0, 3), np.int32),
    )
