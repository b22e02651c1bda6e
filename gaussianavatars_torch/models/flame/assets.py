"""FLAME asset data: loading and synthesis (numpy).

`synthetic_assets` builds a statistically fake but topologically real model
(template OBJ geometry, or a UV sphere with FLAME's vertex count when no
template is present, plus small random blendshapes), so the whole render
path runs without the licensed FLAME files. For the same seed it produces
the same arrays as the JAX package's `synthetic_assets`.
"""
from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional

import numpy as np

from .obj_io import load_obj
from .topology import NUM_VERTS, builtin_vertex_masks

NUM_JOINTS = 5  # global, neck, jaw, eye_l, eye_r
FLAME_PARENTS = np.array([-1, 0, 1, 1, 1], np.int32)


class FlameAssets(NamedTuple):
    """Static model data (numpy on the host)."""

    v_template: np.ndarray    # [V, 3]
    shapedirs: np.ndarray     # [V, 3, S+E]
    n_shape: int              # S (leading S columns of shapedirs)
    posedirs: np.ndarray      # [(J-1)*9, V*3]
    j_regressor: np.ndarray   # [J, V]
    parents: np.ndarray       # [J]
    lbs_weights: np.ndarray   # [V, J]
    faces: np.ndarray         # [F, 3]
    verts_uvs: np.ndarray     # [Vt, 2]
    faces_uv: np.ndarray      # [F, 3]
    lmk_faces_idx: np.ndarray   # [L]
    lmk_bary_coords: np.ndarray  # [L, 3]
    vertex_masks: Dict[str, np.ndarray]  # region name → vertex ids

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]


def default_template_path() -> str:
    """Search order: $GSAVATARS_FLAME_TEMPLATE → package assets dir → cwd
    assets dir (the first that exists, else the package path)."""
    candidates = [
        os.environ.get("GSAVATARS_FLAME_TEMPLATE", ""),
        os.path.join(os.path.dirname(__file__), "assets", "head_template_mesh.obj"),
        os.path.join("assets", "flame", "head_template_mesh.obj"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return candidates[1]


def load_assets(npz_path: str) -> FlameAssets:
    """Load assets from the npz format the JAX package's converter writes."""
    z = np.load(npz_path, allow_pickle=False)
    masks = {
        k[len("mask_"):]: z[k].astype(np.int32) for k in z.files if k.startswith("mask_")
    }
    parents = z["parents"].astype(np.int32)
    parents[0] = -1
    return FlameAssets(
        v_template=z["v_template"].astype(np.float32),
        shapedirs=z["shapedirs"].astype(np.float32),
        n_shape=int(z["n_shape"]),
        posedirs=z["posedirs"].astype(np.float32),
        j_regressor=z["j_regressor"].astype(np.float32),
        parents=parents,
        lbs_weights=z["lbs_weights"].astype(np.float32),
        faces=z["faces"].astype(np.int32),
        verts_uvs=z["verts_uvs"].astype(np.float32),
        faces_uv=z["faces_uv"].astype(np.int32),
        lmk_faces_idx=z["lmk_faces_idx"].astype(np.int32),
        lmk_bary_coords=z["lmk_bary_coords"].astype(np.float32),
        vertex_masks=masks,
    )


def synthetic_assets(
    n_shape: int = 300,
    n_expr: int = 100,
    seed: int = 0,
    template_obj: Optional[str] = None,
) -> FlameAssets:
    """Real topology (template OBJ), synthetic statistics.

    Blendshapes/posedirs are small random fields; the joint regressor places
    joints at plausible template locations; skinning weights blend smoothly
    between the global and neck joints from top to bottom.
    """
    rng = np.random.RandomState(seed)
    if template_obj is None:
        template_obj = default_template_path()
    if os.path.exists(template_obj):
        verts, uvs, faces, faces_uv = load_obj(template_obj)
    else:  # no template: a UV sphere with FLAME's vertex count
        verts, uvs, faces, faces_uv = _uv_sphere(NUM_VERTS)

    v = verts.shape[0]
    shapedirs = rng.randn(v, 3, n_shape + n_expr).astype(np.float32) * 1e-3
    posedirs = (rng.randn((NUM_JOINTS - 1) * 9, v * 3).astype(np.float32) * 1e-4)

    center = verts.mean(0)
    lo, hi = verts[:, 1].min(), verts[:, 1].max()
    joint_guess = np.array(
        [
            center,
            center + [0.0, -0.3 * (hi - lo), 0.0],        # neck below
            center + [0.0, -0.15 * (hi - lo), 0.02],      # jaw
            center + [-0.03, 0.05, 0.05],                 # eye_l
            center + [0.03, 0.05, 0.05],                  # eye_r
        ],
        np.float32,
    )
    # Soft regressor: weights ∝ exp(-d²) to nearby vertices, normalised.
    d2 = ((verts[None, :, :] - joint_guess[:, None, :]) ** 2).sum(-1)
    jreg = np.exp(-d2 / (0.02 + d2.min(axis=1, keepdims=True) * 4))
    jreg = (jreg / jreg.sum(axis=1, keepdims=True)).astype(np.float32)

    w = np.zeros((v, NUM_JOINTS), np.float32)
    t = np.clip((verts[:, 1] - lo) / (hi - lo + 1e-9), 0, 1)
    w[:, 0] = t
    w[:, 1] = (1 - t) * 0.7
    w[:, 2] = (1 - t) * 0.3
    w /= w.sum(1, keepdims=True)

    return FlameAssets(
        v_template=verts,
        shapedirs=shapedirs,
        n_shape=n_shape,
        posedirs=posedirs,
        j_regressor=jreg,
        parents=FLAME_PARENTS.copy(),
        lbs_weights=w,
        faces=faces,
        verts_uvs=uvs,
        faces_uv=faces_uv,
        lmk_faces_idx=np.arange(68, dtype=np.int32) % faces.shape[0],
        lmk_bary_coords=np.full((68, 3), 1.0 / 3.0, np.float32),
        vertex_masks=dict(builtin_vertex_masks()),
    )


def _uv_sphere(n_target: int):
    """Topology used when no template OBJ is available."""
    rows = int(np.sqrt(n_target / 2))
    cols = -(-n_target // rows)
    th = np.linspace(1e-3, np.pi - 1e-3, rows)
    ph = np.linspace(0, 2 * np.pi, cols, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack(
        [np.sin(tt) * np.cos(pp), np.cos(tt), np.sin(tt) * np.sin(pp)], -1
    ).reshape(-1, 3).astype(np.float32) * 0.1
    verts = verts[:n_target]
    faces = []
    for i in range(rows - 1):
        for j in range(cols):
            a = i * cols + j
            b = i * cols + (j + 1) % cols
            c = a + cols
            d = b + cols
            if d < n_target and c < n_target:
                faces.append([a, b, c])
                faces.append([b, d, c])
    faces = np.asarray(faces, np.int32)
    uvs = np.stack([pp.reshape(-1) / (2 * np.pi), tt.reshape(-1) / np.pi], -1)[
        :n_target
    ].astype(np.float32)
    return verts, uvs, faces, faces.copy()
