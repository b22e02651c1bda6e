"""Avatar rendering entry point: FLAME-driven Gaussians → image.

`AvatarRenderer.render(flame_params)` runs the whole forward path of one
frame: the FLAME forward, the per-face binding frames, the world-space
Gaussians, projection + SH colours, the sorted-data binning and the pair
compositor kernel. `build_scene` builds the synthetic trained-avatar scene
of the JAX package's benchmark (`bench.build_scene`): 9 Gaussians per FLAME
face with splats hugging their triangles, sub-triangle scales and high
opacity, seen at 802×550.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .data.cameras import Camera, look_at_camera
from .device import resolve_device
from .models.binding import face_frames
from .models.flame.assets import synthetic_assets
from .models.flame.flame_model import FlameConfig, FlameModel, FlameParams, zero_params
from .models.gaussians import GaussianAux, GaussianParams, init_bound, inverse_sigmoid, world_gaussians
from .ops.projection import project_from_params
from .ops.rasterize_dense import RenderOutput
from .ops.rasterize_tiled import TileConfig, render_tiled
from .ops.sort_binning import bbox_tiles, probe_tiers

WIDTH, HEIGHT = 802, 550
CAPACITY_ALIGN = 8192  # padded Gaussian capacity multiple of the bench scene


def _to_device(obj, dev):
    """A dataclass of tensors with every tensor field moved to `dev`."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dev)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
    })


def build_scene(per_face: int = 9, seed: int = 0, width: int = WIDTH,
                height: int = HEIGHT, n_shape: int = 100, n_expr: int = 50,
                device="cuda"):
    """The benchmark's synthetic trained-avatar scene.

    Returns (model, params, aux, flame_params, camera, n_gaussians). Random
    values come from a CPU `torch.Generator` seeded with `seed`, so the
    scene is the same on every device.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    assets = synthetic_assets(n_shape=n_shape, n_expr=n_expr, seed=seed)
    model = FlameModel(
        assets, FlameConfig(n_shape=n_shape, n_expr=n_expr, add_teeth=True), device=dev
    )
    n = model.num_faces * per_face
    cap = -(-n // CAPACITY_ALIGN) * CAPACITY_ALIGN
    params, aux = init_bound(model.num_faces, cap, gen, per_face=per_face, device=dev)
    shape3 = params.means.shape
    params = dataclasses.replace(
        params,
        # Trained-avatar statistics: splats near their triangle,
        # sub-triangle scales, high opacity.
        means=(torch.randn(shape3, generator=gen) * 0.1).to(dev),
        log_scales=torch.log(torch.empty(shape3).uniform_(0.25, 0.7, generator=gen)).to(dev),
        quats=torch.randn(params.quats.shape, generator=gen).to(dev),
        logit_opacity=torch.full_like(params.logit_opacity, inverse_sigmoid(0.92)),
    )
    fl = zero_params(n_shape, n_expr, batch=1, device=dev)
    center = assets.v_template.mean(0)
    extent = float(np.abs(assets.v_template - center).max())
    cam = look_at_camera(
        eye=center + np.array([0.0, 0.0, -4.5 * extent]), target=center,
        fovy=0.4, width=width, height=height, device=dev,
    )
    return model, params, aux, fl, cam, n


@torch.inference_mode()
def probe_tile_config(model: Optional[FlameModel], params: GaussianParams, aux: GaussianAux,
                      flame_params: Optional[FlameParams], camera: Camera,
                      tile_h: int = 32, tile_w: int = 32) -> TileConfig:
    """Tier budgets sized from one frame's footprints (`probe_tiers`), as
    the JAX package's benchmark and training loop size theirs. `model=None`
    probes an unbound avatar (no FLAME)."""
    frames = None
    if model is not None:
        frames = face_frames(model(flame_params)[0], model.faces)
    wg = world_gaussians(params, aux, frames)
    proj = project_from_params(wg.means, wg.scales, wg.quats, camera, alive=wg.alive)
    opac = torch.where(proj.mask, wg.opacity, torch.zeros_like(wg.opacity))
    _tx, _ty, _bw, ntiles, _nty, _ntx = bbox_tiles(
        proj, camera.height, camera.width, tile_h, tile_w, opacity=opac
    )
    spec = probe_tiers(torch.where(proj.mask, ntiles, torch.zeros_like(ntiles)))
    return TileConfig(tile_h=tile_h, tile_w=tile_w, base_budget=spec.base, tiers=spec.tiers)


class AvatarRenderer:
    """Renders a FLAME-bound Gaussian avatar from one camera.

    Every `render` call runs the FLAME update for the given parameters, so
    an animated sequence is one call per frame.
    """

    def __init__(self, model: FlameModel, params: GaussianParams, aux: GaussianAux,
                 camera: Camera, tile_cfg: TileConfig, sh_degree: int = 3,
                 bg_color: Optional[torch.Tensor] = None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.params = _to_device(params, self.device)
        self.aux = _to_device(aux, self.device)
        self.camera = _to_device(camera, self.device)
        self.tile_cfg = tile_cfg
        self.sh_degree = sh_degree
        if bg_color is None:
            bg_color = torch.zeros(3)
        self.bg_color = bg_color.to(self.device, torch.float32)

    @torch.inference_mode()
    def render(self, flame_params: FlameParams) -> RenderOutput:
        fp = FlameParams(*(None if x is None else x.to(self.device) for x in flame_params))
        verts = self.model(fp)
        wg = world_gaussians(self.params, self.aux, face_frames(verts[0], self.model.faces))
        return render_tiled(
            wg.means, wg.scales, wg.quats, wg.opacity, self.camera, self.bg_color,
            sh=wg.sh, sh_degree=self.sh_degree, alive=wg.alive, cfg=self.tile_cfg,
        )
