"""Tile-binned Gaussian rasterizer entry point (sorted-data path).

`render_tiled` is the drop-in tiled equivalent of `render_dense`: projection,
SH colours, then the sorted-data binning and the pair compositor kernel
(`ops/rasterize_sorted.py`). The JAX package's padded-table binning and
`lax.scan` compositor are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .projection import project_from_params
from .rasterize_dense import RenderOutput
from .rasterize_sorted import rasterize_sorted
from .sh import eval_sh_color_kc
from .sort_binning import TierSpec, default_tiers


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Rasterization geometry and tier budgets.

    `base_budget` slots for every Gaussian; each (count, budget) tier gives
    the `count` footprint-heaviest Gaussians slots up to `budget`. Empty
    tiers = `default_tiers` at the padded Gaussian count. (The JAX
    package's `capacity` and `max_tiles_per_gaussian` size its padded-table
    path, which is not ported.)
    """

    tile_h: int = 32
    tile_w: int = 32
    base_budget: int = 2
    tiers: tuple = ()

    def grid(self, height: int, width: int) -> tuple[int, int]:
        return (-(-height // self.tile_h), -(-width // self.tile_w))

    def tier_spec(self, n_gauss: int) -> TierSpec:
        if self.tiers:
            return TierSpec(base=self.base_budget, tiers=tuple(
                (int(c), int(b)) for c, b in self.tiers
            ))
        spec = default_tiers(n_gauss)
        if self.base_budget != 2:
            spec = dataclasses.replace(spec, base=self.base_budget)
        return spec


def view_colors(means3d, sh, camera, sh_degree: int) -> torch.Tensor:
    """View-dependent RGB [N, 3] from SH coefficients [N, K, 3]."""
    dirs = means3d - camera.camera_center
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
    return eval_sh_color_kc(sh, dirs, sh_degree)


def render_tiled(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacity: torch.Tensor,
    camera,
    bg_color: torch.Tensor,
    sh: Optional[torch.Tensor] = None,
    sh_degree: int = 0,
    colors: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    alive: Optional[torch.Tensor] = None,
    cfg: TileConfig = TileConfig(),
    amp: bool = False,
) -> RenderOutput:
    """Render one view through the sorted-data pipeline (same semantics as
    `render_dense`). Either `sh` [N,K,3] or `colors` [N,3]. `amp` selects
    the bf16 contraction of the compositor's backward (the `use_amp`
    policy)."""
    proj = project_from_params(means3d, scales, quats, camera, scale_modifier, alive=alive)
    if colors is None:
        if sh is None:
            raise ValueError("provide sh or colors")
        colors = view_colors(means3d, sh, camera, sh_degree)
    opac_eff = torch.where(proj.mask, opacity, torch.zeros_like(opacity))
    img, alpha, _plan = rasterize_sorted(
        proj, colors, opac_eff, camera.height, camera.width, bg_color,
        cfg.tile_h, cfg.tile_w, cfg.tier_spec(means3d.shape[0]), amp=amp,
    )
    return RenderOutput(
        color=img, alpha=alpha, radii=proj.radius, visibility=proj.radius > 0
    )
