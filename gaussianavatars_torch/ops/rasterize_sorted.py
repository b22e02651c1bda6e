"""Sorted-data rasterization pipeline (forward), PyTorch.

  binning:    footprint sort → tiered expansion → (tile, depth) pair sort
              → param-major [16, M + PAIR_CHUNK] table, segment starts/counts
              (`sort_gather`);
  compositing: the pair compositor kernel over that table
              (`composite_sorted` → `ops/composite_pairs.fwd_call_pairs`).

Semantics are those of the JAX package's `ops/rasterize_sorted.py`: exact
(tile, depth)-keyed front-to-back order, 1/255 cutoff, 0.99 clamp,
T < 1e-4 early stop. Forward only: the backward of `sort_gather` and
`composite_sorted` is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .composite_pairs import fwd_call_pairs
from .sort_binning import (
    ALIGN,
    PAIR_CHUNK,
    SortPlan,
    TierSpec,
    bbox_tiles,
    segment_bounds,
    sort_bin_forward,
)


def sort_gather(geom, mean2d, conic, colors, opacity, ints):
    """geom = (nt, ntx, TierSpec); ints = (tminx, tminy, bw, ntiles_eff,
    depth_bits). Returns (dataT [16, M + PAIR_CHUNK] param-major sorted pair
    table, SortPlan)."""
    nt, ntx, spec = geom
    tminx, tminy, bw, ntiles_eff, depth_bits = ints
    # Dead rows get finite (zero) data before the sort, so NaNs of culled
    # Gaussians never reach the table.
    live = (ntiles_eff > 0)[:, None]
    zero = torch.zeros((), dtype=mean2d.dtype, device=mean2d.device)
    mean2d = torch.where(live, mean2d, zero)
    conic = torch.where(live, conic, zero)
    colors = torch.where(live, colors, zero)
    opacity = torch.where(live[:, 0], opacity, zero)
    # 128-align the Gaussian axis, as the JAX package does.
    pad = (-opacity.shape[0]) % ALIGN
    if pad:
        mean2d, conic, colors = (F.pad(x, (0, 0, 0, pad)) for x in (mean2d, conic, colors))
        opacity, tminx, tminy, bw, ntiles_eff, depth_bits = (
            F.pad(x, (0, pad)) for x in (opacity, tminx, tminy, bw, ntiles_eff, depth_bits)
        )
    cols = (
        mean2d[:, 0], mean2d[:, 1],
        conic[:, 0], conic[:, 1], conic[:, 2],
        colors[:, 0], colors[:, 1], colors[:, 2],
        opacity,
    )
    s_data, s_tile, s_pos, gidx_fp, budget_overflow = sort_bin_forward(
        cols, tminx, tminy, bw, ntiles_eff, depth_bits, ntx, nt, spec
    )
    starts, counts, total = segment_bounds(s_tile, nt)
    m = s_tile.shape[0]
    dataT = torch.zeros((16, m + PAIR_CHUNK), dtype=s_data.dtype, device=s_data.device)
    dataT[:9, :m] = s_data
    plan = SortPlan(
        tile_starts=starts, counts=counts, total=total,
        budget_overflow=budget_overflow,
        max_footprint=torch.max(ntiles_eff),
        pos=s_pos, gidx_fp=gidx_fp,
    )
    return dataT, plan


def composite_sorted(geom, dataT, starts, counts):
    """geom = (tile_h, tile_w, ntx). Returns (acc [NT, P, 3] premultiplied
    colour, t_final [NT, P])."""
    th, tw, ntx = geom[:3]
    acc, t_final, _stop = fwd_call_pairs(dataT, starts, counts, th, tw, ntx)
    return acc.transpose(1, 2), t_final


def depth_key(depth: torch.Tensor) -> torch.Tensor:
    """Monotone int32 depth key: the bits of the positive float32 depth
    (strictly increasing on positives; depths of live Gaussians are > 0)."""
    return torch.clamp_min(depth, 1e-20).float().view(torch.int32)


def rasterize_sorted(
    proj,                      # Projected
    colors: torch.Tensor,      # [N, 3]
    opacity: torch.Tensor,     # [N] (0 for masked)
    height: int,
    width: int,
    bg_color: torch.Tensor,
    tile_h: int,
    tile_w: int,
    spec: TierSpec,
):
    """Bin with the data-carrying sort and composite.

    Returns (color [H, W, 3], alpha [H, W], plan).
    """
    nty = -(-height // tile_h)
    ntx = -(-width // tile_w)
    nt = nty * ntx

    tminx, tminy, bw, ntiles, _nty, _ntx = bbox_tiles(
        proj, height, width, tile_h, tile_w, opacity=opacity
    )
    ntiles_eff = torch.where(proj.mask, ntiles, torch.zeros_like(ntiles))
    ints = (tminx, tminy, bw, ntiles_eff, depth_key(proj.depth))

    dataT, plan = sort_gather(
        (nt, ntx, spec), proj.mean2d, proj.conic, colors, opacity, ints
    )
    acc, t_final = composite_sorted(
        (tile_h, tile_w, ntx), dataT, plan.tile_starts, plan.counts
    )
    out = acc + t_final[..., None] * bg_color[None, None, :]

    img = out.reshape(nty, ntx, tile_h, tile_w, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(nty * tile_h, ntx * tile_w, 3)[:height, :width]
    alpha = (1.0 - t_final).reshape(nty, ntx, tile_h, tile_w).permute(0, 2, 1, 3)
    alpha = alpha.reshape(nty * tile_h, ntx * tile_w)[:height, :width]
    return img, alpha, plan
