"""Triangle rasterizer for mesh previews (PyTorch).

The port of the JAX package's `ops/mesh_raster.py`, its replacement for
nvdiffrast as the reference uses it: flat-shaded FLAME mesh previews in the
viewers and `render --render_mesh` overlays
(`mesh_renderer/__init__.py:214-274`). Not on any training or splatting
path, so it is plain tensor code: a correct z-buffered face-id and
barycentric rasterization, not a fast one.

Algorithm (no atomics): chunks of triangles against all pixels; for each
(pixel, triangle) pair of a chunk the interpolated depth, then the
per-pixel min-depth and face id carried across chunks (a strictly smaller
depth replaces the carry, so on equal depths the earlier chunk wins and,
within a chunk, the lower face id), and the winning triangle's
barycentrics recomputed once per pixel at the end. The chunk is capped so
the [chunk, pixels] intermediates stay within `pair_budget` pairs at any
resolution. No backface culling (as `dr.rasterize` by default).

Outputs carry what `dr.rasterize`'s (u, v, z/w, face_id+1) carries
(`mesh_renderer/__init__.py:225-232`) in another convention: `face_id` is
0-based with **-1** for misses (plus a bool `mask`), and (u, v) are the
**screen-space** weights of vertices 1 and 2, not nvdiffrast's
perspective-correct ones. Depth is unaffected (z_ndc is affine in screen
space).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .transforms import _safe_normalize, compute_face_normals


class RastOut(NamedTuple):
    bary: torch.Tensor     # [H, W, 2] (u, v) of the winning triangle
    depth: torch.Tensor    # [H, W] clip-space z/w (inf = miss)
    face_id: torch.Tensor  # [H, W] int32, -1 = miss
    mask: torch.Tensor     # [H, W] bool hit mask


def _bary_weights(xy: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor):
    """Screen-space barycentrics of pixels (qx, qy) in triangles `xy`.

    xy: [..., 3, 2]; qx/qy broadcast against the leading dims. Returns
    (l1, l2, inside): the weights of vertices 1 and 2, and the
    inside-with-nondegenerate-area mask.
    """
    a, b, c = xy[..., 0, :], xy[..., 1, :], xy[..., 2, :]

    def edge(p0, p1):
        d = p1 - p0
        return d[..., 0:1] * (qy - p0[..., 1:2]) - d[..., 1:2] * (qx - p0[..., 0:1])

    w0 = edge(b, c)   # opposite a
    w1 = edge(c, a)   # opposite b
    w2 = edge(a, b)   # opposite c
    area = ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
            - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))[..., None]
    degenerate = torch.abs(area) < 1e-12
    area_safe = torch.where(degenerate, torch.ones_like(area), area)
    inside = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) | ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))) \
        & (torch.abs(area) > 1e-12)
    return w1 / area_safe, w2 / area_safe, inside


@torch.no_grad()
def rasterize_mesh(
    verts_clip: torch.Tensor,  # [V, 4] clip-space positions
    faces: torch.Tensor,       # [F, 3] integer
    height: int,
    width: int,
    chunk: int = 2048,
    pair_budget: int = 48 << 20,
) -> RastOut:
    """Z-buffer rasterization of a triangle mesh.

    `pair_budget` caps chunk × pixels so the per-chunk [C, P]
    intermediates stay at ~4·budget bytes each whatever the resolution (an
    802×550 preview at 2× supersampling has P ≈ 1.76M pixels: chunks of 27
    triangles).
    """
    dev = verts_clip.device
    faces = faces.long()
    v = verts_clip
    w = v[:, 3:4]
    w_safe = torch.where(torch.abs(w) < 1e-9, torch.full_like(w, 1e-9), w)
    ndc = v[:, :3] / w_safe
    # NDC → pixel centres (y down, as the splatting path).
    px = (ndc[:, 0] + 1.0) * 0.5 * width - 0.5
    py = (ndc[:, 1] + 1.0) * 0.5 * height - 0.5
    pz = ndc[:, 2]
    behind = v[:, 3] <= 1e-6

    tri_xy = torch.stack([px, py], -1)[faces]          # [F, 3, 2]
    tri_z = pz[faces]                                  # [F, 3]
    tri_dead = torch.any(behind[faces], dim=1)         # [F]

    f = faces.shape[0]
    n_pix = height * width
    chunk = max(8, min(chunk, pair_budget // max(n_pix, 1)))

    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)  # [P, 2]
    qx, qy = pix[None, :, 0], pix[None, :, 1]

    best_z = torch.full((n_pix,), float("inf"), device=dev)
    best_id = torch.full((n_pix,), -1, dtype=torch.int32, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for s in range(0, f, chunk):
        xy, z, dead = tri_xy[s:s + chunk], tri_z[s:s + chunk], tri_dead[s:s + chunk]
        l1, l2, inside = _bary_weights(xy, qx, qy)    # [C, P]
        inside = inside & ~dead[:, None]
        l0 = 1.0 - l1 - l2
        zpix = l0 * z[:, 0:1] + l1 * z[:, 1:2] + l2 * z[:, 2:3]
        zpix = torch.where(inside & (zpix > -1.0), zpix, inf)
        # The chunk's winner (first index on equal depths), then against
        # the carry (strictly smaller replaces it).
        ci = torch.argmin(zpix, dim=0)                # [P]
        pz_best = zpix.gather(0, ci[None])[0]
        sel = pz_best < best_z
        best_id = torch.where(sel, (ci + s).to(torch.int32), best_id)
        best_z = torch.where(sel, pz_best, best_z)
    # Barycentrics of the winning triangle, one triangle per pixel.
    win_xy = tri_xy[best_id.long().clamp_min(0)]      # [P, 3, 2]
    u, v_, _ = _bary_weights(win_xy, pix[:, 0:1], pix[:, 1:2])
    hit = (best_id >= 0)[:, None]
    best_uv = torch.where(hit, torch.cat([u, v_], -1), torch.zeros_like(u))
    return RastOut(
        bary=best_uv.reshape(height, width, 2),
        depth=best_z.reshape(height, width),
        face_id=best_id.reshape(height, width),
        mask=(best_id >= 0).reshape(height, width),
    )


def face_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Per-face unit normals (flat shading, `mesh_renderer/__init__.py:141-181`)."""
    return _safe_normalize(compute_face_normals(verts, faces.long()))


def _box_down(x: torch.Tensor, aa: int) -> torch.Tensor:
    """[H·aa, W·aa, C] → [H, W, C], the mean of each aa×aa cell."""
    h, w, c = x.shape
    return x.reshape(h // aa, aa, w // aa, aa, c).sum(dim=(1, 3)) * (1.0 / (aa * aa))


@torch.no_grad()
def render_mesh_preview(
    verts: torch.Tensor,       # [V, 3] world space
    faces: torch.Tensor,       # [F, 3]
    camera,                    # data.cameras.Camera
    color: tuple = (1.0, 1.0, 1.0),
    background: Optional[torch.Tensor] = None,
    lighting: str = "front",   # 'front' | 'constant'
    chunk: int = 2048,
    antialias: int = 2,        # supersampling factor (1 = off)
) -> dict:
    """Flat-shaded mesh preview through a 3DGS camera.

    Equivalent of `NVDiffRenderer.render_from_camera` (diffuse term only,
    `mesh_renderer/__init__.py:141-212`): RGBA, front-lit flat shading,
    miss pixels filled with `background`. `antialias` replaces
    `dr.antialias` (`:267`): the mesh is rasterized at `antialias`× the
    resolution and box-filtered down, which gives fractional coverage on
    both sides of every edge. `face_id` and `depth` stay hard (the top-left
    sample of each cell).
    """
    aa = max(int(antialias), 1)
    h, w = camera.height * aa, camera.width * aa
    vh = torch.cat([verts, torch.ones_like(verts[:, :1])], -1)
    verts_clip = vh @ camera.full_proj.T
    rast = rasterize_mesh(verts_clip, faces, h, w, chunk=chunk)

    normals = face_normals(verts, faces)
    n_pix = normals[rast.face_id.long().clamp_min(0)]   # [H, W, 3]
    if lighting == "front":
        view_dir = camera.camera_center - verts.mean(0)
        view_dir = view_dir / torch.linalg.norm(view_dir).clamp_min(1e-12)
        diffuse = torch.abs(n_pix @ view_dir)[..., None]
    else:
        diffuse = torch.ones_like(n_pix[..., :1])
    rgb = torch.as_tensor(color, dtype=torch.float32, device=verts.device) * diffuse
    alpha = rast.mask.to(torch.float32)[..., None]
    if background is None:
        background = torch.zeros(3, device=verts.device)
    rgb = rgb * alpha + background * (1.0 - alpha)
    n_shaded = n_pix * alpha
    face_id, depth = rast.face_id, rast.depth
    if aa > 1:
        rgb, alpha, n_shaded = _box_down(rgb, aa), _box_down(alpha, aa), _box_down(n_shaded, aa)
        face_id, depth = face_id[::aa, ::aa], depth[::aa, ::aa]
    return {
        "rgba": torch.cat([rgb, alpha], -1),
        "diffuse": rgb,
        "normal": n_shaded,
        "face_id": face_id,
        "depth": depth,
    }
