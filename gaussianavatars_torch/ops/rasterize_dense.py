"""Dense reference rasterizer: O(N · pixels), plain PyTorch.

Exact alpha compositing of all Gaussians against all pixels, with the
semantics of the CUDA tile rasterizer the reference invokes:

  * alpha = min(0.99, opacity · exp(-½ dᵀ conic d)), skipped below 1/255,
  * front-to-back order by camera depth,
  * early termination: a Gaussian whose compositing would drop
    transmittance below 1e-4 is NOT composited and ends the pixel's ray,
  * background blended with the final transmittance.

This is the port's ground truth at small sizes for the tiled path and its
kernels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .projection import Projected, project_from_params
from .sh import eval_sh_color_kc

ALPHA_CUTOFF = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


class RenderOutput(NamedTuple):
    color: torch.Tensor        # [H, W, 3]
    alpha: torch.Tensor        # [H, W] accumulated opacity (1 - T_final)
    radii: torch.Tensor        # [N] int32
    visibility: torch.Tensor   # [N] bool (radius > 0)


def pixel_alphas(
    mean2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    radius: torch.Tensor | None = None,
    tile_shape: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Gaussian falloff alphas [P, N] for pixel centres px, py [P], with the
    1/255 cutoff and 0.99 clamp applied. With radius/tile_shape, a Gaussian
    only reaches pixels whose tile intersects its square radius bbox, like
    the tiled path."""
    dx = px[:, None] - mean2d[None, :, 0]
    dy = py[:, None] - mean2d[None, :, 1]
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    power = -0.5 * (a[None] * dx * dx + c[None] * dy * dy) - b[None] * dx * dy
    alpha = torch.clamp_max(opacity[None, :] * torch.exp(power), ALPHA_MAX)
    use = (power <= 0.0) & (alpha >= ALPHA_CUTOFF)
    if tile_shape is not None and radius is not None:
        th, tw = tile_shape
        r = radius.to(torch.float32)
        tminx = torch.floor((mean2d[:, 0] - r) / tw)
        tmaxx = torch.floor((mean2d[:, 0] + r) / tw)
        tminy = torch.floor((mean2d[:, 1] - r) / th)
        tmaxy = torch.floor((mean2d[:, 1] + r) / th)
        ptx = torch.floor(px / tw)[:, None]
        pty = torch.floor(py / th)[:, None]
        in_rect = (
            (ptx >= tminx[None]) & (ptx <= tmaxx[None])
            & (pty >= tminy[None]) & (pty <= tmaxy[None])
        )
        use = use & in_rect
    return torch.where(use, alpha, torch.zeros_like(alpha))


def composite_pixels(
    alphas: torch.Tensor,   # [P, N] in compositing (front-to-back) order
    colors: torch.Tensor,   # [N, 3] in the same order
) -> tuple[torch.Tensor, torch.Tensor]:
    """Front-to-back compositing with early termination.

    Returns (rgb [P,3], final transmittance [P]).
    """
    one_minus = 1.0 - alphas
    ones = torch.ones_like(one_minus[:, :1])
    t_before = torch.cat([ones, torch.cumprod(one_minus[:, :-1], dim=1)], dim=1)
    test_t = t_before * one_minus
    # A Gaussian that would take T below T_EPS ends the ray: it and everything
    # behind it are excluded.
    trigger = (alphas > 0.0) & (test_t < T_EPS)
    stopped = torch.cumsum(trigger.to(torch.int32), dim=1) > 0
    contrib = (alphas > 0.0) & ~stopped

    ealpha = torch.where(contrib, alphas, torch.zeros_like(alphas))
    t_eff = torch.cat([ones, torch.cumprod(1.0 - ealpha[:, :-1], dim=1)], dim=1)
    weights = ealpha * t_eff
    rgb = weights @ colors
    t_final = torch.prod(1.0 - ealpha, dim=1)
    return rgb, t_final


def render_dense(
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
    projected: Optional[Projected] = None,
    tile_cull: Optional[tuple[int, int]] = None,
) -> RenderOutput:
    """Render one view densely. Either `sh` [N,K,3] or `colors` [N,3].

    `tile_cull=(tile_h, tile_w)` emulates the tiled path's rect culling.
    """
    if projected is None:
        projected = project_from_params(
            means3d, scales, quats, camera, scale_modifier, alive=alive
        )
    if colors is None:
        if sh is None:
            raise ValueError("provide sh or colors")
        dirs = means3d - camera.camera_center
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
        colors = eval_sh_color_kc(sh, dirs, sh_degree)

    H, W = camera.height, camera.width
    key = torch.where(projected.mask, projected.depth,
                      torch.full_like(projected.depth, float("inf")))
    order = torch.argsort(key, stable=True)
    mean2d_s = projected.mean2d[order]
    conic_s = projected.conic[order]
    op_s = torch.where(projected.mask, opacity, torch.zeros_like(opacity))[order]
    colors_s = colors[order]

    dev = means3d.device
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev), indexing="ij",
    )
    radius_s = projected.radius[order] if tile_cull is not None else None
    alphas = pixel_alphas(
        mean2d_s, conic_s, op_s, xs.reshape(-1), ys.reshape(-1),
        radius=radius_s, tile_shape=tile_cull,
    )
    rgb, t_final = composite_pixels(alphas, colors_s)
    rgb = rgb + t_final[:, None] * bg_color[None, :]

    return RenderOutput(
        color=rgb.reshape(H, W, 3),
        alpha=(1.0 - t_final).reshape(H, W),
        radii=projected.radius,
        visibility=projected.radius > 0,
    )
