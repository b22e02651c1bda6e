"""The FLAME head model: teeth augmentation and forward pass (PyTorch).

`FlameModel` prepares the static augmented arrays once on the host (teeth
synthesis), moves them to the device as buffers, and runs the forward pass
over a `FlameParams` tuple of tensors. The teeth (120 vertices in 8 rows of
15, synthesised from the outer lip rings) are built exactly as in the JAX
package. It also holds the region lookups and the laplacian regulariser
of the train step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ...device import resolve_device
from .assets import FlameAssets
from .lbs import blend_shapes, lbs

TEETH_ROWS = 15


class FlameParams(NamedTuple):
    """Pose/shape inputs for a batch of B timesteps."""

    shape: torch.Tensor        # [S] (shared across timesteps)
    expr: torch.Tensor         # [B, E]
    rotation: torch.Tensor     # [B, 3] global axis-angle
    neck: torch.Tensor         # [B, 3]
    jaw: torch.Tensor          # [B, 3]
    eyes: torch.Tensor         # [B, 6]
    translation: torch.Tensor  # [B, 3]
    static_offset: Optional[torch.Tensor] = None   # [V, 3]
    dynamic_offset: Optional[torch.Tensor] = None  # [B, V, 3]


def zero_params(n_shape: int, n_expr: int, batch: int = 1, num_verts: int = 0,
                device="cuda") -> FlameParams:
    dev = resolve_device(device)

    def z(shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return FlameParams(
        shape=z((n_shape,)),
        expr=z((batch, n_expr)),
        rotation=z((batch, 3)),
        neck=z((batch, 3)),
        jaw=z((batch, 3)),
        eyes=z((batch, 6)),
        translation=z((batch, 3)),
        static_offset=z((num_verts, 3)) if num_verts else None,
        dynamic_offset=None,
    )


@dataclasses.dataclass(frozen=True)
class FlameConfig:
    n_shape: int = 300
    n_expr: int = 100
    add_teeth: bool = True


def _strip(a: np.ndarray, b: np.ndarray, flip: bool = False) -> np.ndarray:
    """Triangle strip between two equal-length vertex rows a, b."""
    tris = []
    for i in range(len(a) - 1):
        tris.extend([(a[i], b[i + 1], b[i]), (a[i], a[i + 1], b[i + 1])])
    tris = np.asarray(tris, np.int32)
    if flip:
        tris = tris[:, ::-1]
    return tris


def _build_teeth(assets: FlameAssets) -> tuple[FlameAssets, Dict[str, np.ndarray]]:
    """Synthesise teeth geometry and extend all per-vertex model arrays."""
    masks = assets.vertex_masks
    vid_up = masks["lip_outside_ring_upper"]
    vid_lo = masks["lip_outside_ring_lower"]
    vt = assets.v_template
    v_up, v_lo = vt[vid_up], vt[vid_lo]

    mean_dist = np.linalg.norm(v_up - v_lo, axis=-1, keepdims=True).mean()
    mid = (v_up + v_lo) / 2
    mid[:, 1] = mid[:, 1].mean()
    mid[:, 2] -= mean_dist * 1.5  # recess behind the lips

    dy = np.array([[0.0, mean_dist, 0.0]], np.float32)
    dz = np.array([[0.0, 0.0, mean_dist]], np.float32)
    up_edge = mid + dy * 0.1
    up_root = up_edge + dy * 2
    lo_edge = mid - dy * 0.1 - dz * 0.4
    lo_root = lo_edge - dy * 2
    thick = dz * 1.0
    rows = [
        up_root, lo_root, up_edge, lo_edge,              # front: rows 0..3
        up_root - thick, up_edge - thick,                # upper back: 4, 5
        lo_root - thick, lo_edge - thick,                # lower back: 6, 7
    ]
    v0 = vt.shape[0]
    v_teeth = np.concatenate(rows, axis=0).astype(np.float32)
    nvt = v_teeth.shape[0]  # 120

    def row_ids(r):
        return np.arange(r * TEETH_ROWS, (r + 1) * TEETH_ROWS, dtype=np.int32) + v0

    ids = {i: row_ids(i) for i in range(8)}
    vid_teeth_upper = np.concatenate([ids[0], ids[2], ids[4], ids[5]])
    vid_teeth_lower = np.concatenate([ids[1], ids[3], ids[6], ids[7]])

    # Faces: front slab, back slab and the biting-edge band, upper and lower.
    f_upper = np.concatenate([
        _strip(ids[0], ids[2]),
        _strip(ids[4], ids[5], flip=True),
        _strip(ids[5], ids[2]),
    ])
    f_lower = np.concatenate([
        _strip(ids[1], ids[3], flip=True),
        _strip(ids[6], ids[7]),
        _strip(ids[7], ids[3], flip=True),
    ])
    new_faces = np.concatenate([assets.faces, f_upper, f_lower])

    # Shape dirs: lip-ring average for the shape block, zero for expressions.
    sd = np.concatenate(
        [assets.shapedirs, np.zeros_like(assets.shapedirs[:nvt])], axis=0
    )
    s = assets.n_shape
    sd_mean = (sd[vid_up, :, :s] + sd[vid_lo, :, :s]) / 2
    for r in range(8):
        sd[ids[r], :, :s] = sd_mean

    # Pose dirs / joint regressor: zero for teeth.
    j1 = len(assets.parents) - 1
    pd = assets.posedirs.reshape(j1 * 9, v0, 3)
    pd = np.concatenate([pd, np.zeros((j1 * 9, nvt, 3), np.float32)], axis=1)
    pd = pd.reshape(j1 * 9, (v0 + nvt) * 3)
    jreg = np.concatenate(
        [assets.j_regressor, np.zeros((assets.j_regressor.shape[0], nvt), np.float32)],
        axis=1,
    )
    # Skinning: upper teeth ride the neck joint (1), lower ride the jaw (2).
    w = np.concatenate([assets.lbs_weights, np.zeros((nvt, assets.lbs_weights.shape[1]), np.float32)])
    w[vid_teeth_upper, 1] = 1.0
    w[vid_teeth_lower, 2] = 1.0

    # UVs: a rectangular grid in the reserved teeth patch of the FLAME atlas.
    u = np.linspace(0.62, 0.38, TEETH_ROWS, dtype=np.float32)
    vv = np.linspace(1 - 0.0083, 1 - 0.0425, 7, dtype=np.float32)[
        [3, 2, 0, 1, 3, 4, 6, 5]
    ]
    uv = np.stack(np.meshgrid(u, vv, indexing="ij"), -1).transpose(1, 0, 2).reshape(nvt, 2)
    uvs = np.concatenate([assets.verts_uvs, uv])
    uv0 = assets.verts_uvs.shape[0]
    faces_uv = np.concatenate(
        [assets.faces_uv, f_upper - v0 + uv0, f_lower - v0 + uv0]
    )

    new_masks = dict(masks)
    new_masks["teeth_upper"] = vid_teeth_upper
    new_masks["teeth_lower"] = vid_teeth_lower
    new_masks["teeth"] = np.concatenate([vid_teeth_upper, vid_teeth_lower])

    out = assets._replace(
        v_template=np.concatenate([vt, v_teeth]),
        shapedirs=sd,
        posedirs=pd,
        j_regressor=jreg,
        lbs_weights=w,
        faces=new_faces,
        verts_uvs=uvs,
        faces_uv=faces_uv,
        vertex_masks=new_masks,
    )
    return out, new_masks


def _uniform_laplacian(faces: np.ndarray, num_verts: int):
    """Edge list [E, 2] (both directions, unique) and vertex degrees [V] of
    the uniform graph laplacian L = I − D⁻¹A."""
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    edges = np.concatenate([edges, edges[:, ::-1]])
    edges = np.unique(edges, axis=0)
    deg = np.bincount(edges[:, 0], minlength=num_verts).astype(np.float32)
    return edges.astype(np.int64), deg


class FlameModel(nn.Module):
    """FLAME with its static arrays as device buffers.

    Usage:
        model = FlameModel(assets, FlameConfig(), device="cuda")
        verts = model(params)       # [B, V, 3]
    """

    def __init__(self, assets: FlameAssets, cfg: FlameConfig = FlameConfig(),
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if cfg.add_teeth:
            assets, _masks = _build_teeth(assets)
        self.assets = assets
        self.num_verts = assets.num_verts
        self.num_faces = assets.num_faces
        self.parents = np.asarray(assets.parents)
        for name in ("v_template", "shapedirs", "posedirs", "j_regressor",
                     "lbs_weights"):
            self.register_buffer(name, torch.as_tensor(getattr(assets, name), device=dev))
        self.register_buffer(
            "faces", torch.as_tensor(assets.faces.astype(np.int64), device=dev)
        )
        lap_edges, lap_deg = _uniform_laplacian(assets.faces, assets.num_verts)
        self.register_buffer("lap_edges", torch.as_tensor(lap_edges, device=dev))
        self.register_buffer("lap_deg", torch.as_tensor(np.maximum(lap_deg, 1.0), device=dev))

    # -- regions ------------------------------------------------------------
    def vid_by_region(self, regions: list[str]) -> np.ndarray:
        """Sorted unique vertex ids of the union of the named regions; ids
        beyond this topology's vertex count (region tables are FLAME-5023
        data) are dropped. No caller in the port yet: the region-adaptive
        loss that uses it raises in `make_train_step` until it is ported."""
        out = [self.assets.vertex_masks[r] for r in regions if r in self.assets.vertex_masks]
        if not out:
            return np.zeros((0,), np.int32)
        vids = np.unique(np.concatenate(out))
        return vids[vids < self.num_verts]

    def fid_by_region(self, regions: list[str], min_verts: int = 3) -> np.ndarray:
        """Faces with at least `min_verts` vertices inside the union of the
        regions (the reference's voting rule, `flame_model/flame.py:822-838`)."""
        inside = np.zeros((self.num_verts,), bool)
        inside[self.vid_by_region(regions)] = True
        votes = inside[np.asarray(self.assets.faces)].sum(axis=1)
        return np.nonzero(votes >= min_verts)[0].astype(np.int32)

    def fid_except_region(self, regions: list[str]) -> np.ndarray:
        """Faces with no vertex inside the union of the regions: the
        `disable_fid` list that keeps only those regions visible
        (`models/io.load_avatar`)."""
        sel = self.fid_by_region(regions, min_verts=1)
        mask = np.ones((self.num_faces,), bool)
        mask[sel] = False
        return np.nonzero(mask)[0].astype(np.int32)

    # -- forward ------------------------------------------------------------
    def forward(self, params: FlameParams, return_verts_cano: bool = False):
        """FLAME forward for B timesteps → verts [B, V, 3], or (verts,
        verts_cano) with the shaped canonical vertices [B, V, 3] (before
        posing) when `return_verts_cano`."""
        B = params.expr.shape[0]
        shape = params.shape[None, :].expand(B, params.shape.shape[0])
        betas = torch.cat([shape, params.expr], dim=1)
        v_shaped = self.v_template[None] + blend_shapes(betas, self.shapedirs)
        if params.static_offset is not None:
            v_shaped = v_shaped + params.static_offset[None]
        if params.dynamic_offset is not None:
            v_shaped = v_shaped + params.dynamic_offset

        full_pose = torch.cat(
            [params.rotation, params.neck, params.jaw, params.eyes], dim=1
        )
        verts, _joints = lbs(
            full_pose, v_shaped, self.posedirs, self.j_regressor,
            self.parents, self.lbs_weights,
        )
        verts = verts + params.translation[:, None, :]
        return (verts, v_shaped) if return_verts_cano else verts

    # -- regularisers -------------------------------------------------------
    def laplacian_loss(self, verts: torch.Tensor, verts_ref: torch.Tensor) -> torch.Tensor:
        """mean ‖L(verts) − L(verts_ref)‖² with the uniform graph laplacian
        (`compute_laplacian_loss`, `scene/flame_gaussian_model.py:160-171`)."""
        src, dst = self.lap_edges[:, 0], self.lap_edges[:, 1]

        def lap(v):
            nb = torch.zeros_like(v).index_add_(1, src, v[:, dst])
            return v - nb / self.lap_deg[None, :, None]

        return torch.mean((lap(verts) - lap(verts_ref)) ** 2)
