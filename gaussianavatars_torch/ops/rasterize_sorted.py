"""Sorted-data rasterization pipeline, PyTorch, with its backward.

  binning:    footprint sort → tiered expansion → (tile, depth) pair sort
              → param-major [9, M + PAIR_CHUNK] table, segment starts/counts
              (`sort_gather`);
  compositing: the pair compositor kernel over that table
              (`composite_sorted` → `ops/composite_pairs.fwd_call_pairs`).

Both are `torch.autograd.Function`s, as the JAX package's are custom VJPs:

  `composite_sorted` backward: the backward compositor kernel
              (`bwd_call_pairs`) from the forward's saved acc/t_final/stop,
              in its bf16-contraction mode when `amp` is set;
  `sort_gather` backward: un-permute the pair sort by the saved `pos` →
              per-Gaussian sums (`reduce_expansion`) → un-permute the
              footprint sort by the saved `gidx_fp`. Both un-permutes are
              one scatter of a permutation (`index_copy`), deterministic on
              the card; autograd never runs back through the forward's
              gathers.

Semantics are those of the JAX package's `ops/rasterize_sorted.py`: exact
(tile, depth)-keyed front-to-back order, 1/255 cutoff, 0.99 clamp,
T < 1e-4 early stop. The binning's forward and backward are spans
(`utils/profiling.annotate`: `sort_gather/fwd`, `sort_gather/bwd`), and
so is the compositor's forward (`frame/composite`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import annotate
from .composite_pairs import bwd_call_pairs, fwd_call_pairs
from .sort_binning import (
    ALIGN,
    PAIR_CHUNK,
    SortPlan,
    TierSpec,
    bbox_tiles,
    reduce_expansion,
    segment_bounds,
    sort_bin_forward,
)


def _sort_gather_forward(geom, mean2d, conic, colors, opacity, ints):
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
    # Nine rows: the JAX package's rows 9..15 are the TPU's sublane padding,
    # which no kernel of the port reads.
    dataT = torch.empty((9, m + PAIR_CHUNK), dtype=s_data.dtype, device=s_data.device)
    dataT[:, :m] = s_data
    dataT[:, m:] = 0.0
    plan = SortPlan(
        tile_starts=starts, counts=counts, total=total,
        budget_overflow=budget_overflow,
        max_footprint=torch.max(ntiles_eff),
        pos=s_pos, gidx_fp=gidx_fp,
    )
    return dataT, plan


class _SortGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, geom, mean2d, conic, colors, opacity, *ints):
        with annotate("sort_gather/fwd"):
            dataT, plan = _sort_gather_forward(geom, mean2d, conic, colors, opacity, ints)
        ctx.spec = geom[2]
        ctx.n_out = mean2d.shape[0]
        ctx.save_for_backward(plan.pos, plan.gidx_fp)
        ctx.mark_non_differentiable(*plan)
        return (dataT, *plan)

    @staticmethod
    def backward(ctx, d_dataT, *_d_plan):
        pos, gidx_fp = ctx.saved_tensors
        m = pos.shape[0]
        with annotate("sort_gather/bwd"):
            d_cols = d_dataT[:9, :m]
            # 1. un-permute the pair sort to the column-major expansion layout.
            r = torch.empty_like(d_cols).index_copy_(1, pos.long(), d_cols)
            # 2. reduce the tier blocks: contiguous slice adds.
            acc = reduce_expansion(r, gidx_fp.shape[0], ctx.spec)
            # 3. un-permute the footprint order back to Gaussian order.
            g = torch.empty_like(acc).index_copy_(1, gidx_fp.long(), acc)[:, :ctx.n_out]
        d_mean2d = g[0:2].T
        d_conic = g[2:5].T
        d_colors = g[5:8].T
        d_opacity = g[8]
        return (None, d_mean2d, d_conic, d_colors, d_opacity) + (None,) * 5


def sort_gather(geom, mean2d, conic, colors, opacity, ints):
    """geom = (nt, ntx, TierSpec); ints = (tminx, tminy, bw, ntiles_eff,
    depth_bits), which take no gradient. Returns (dataT [9, M + PAIR_CHUNK]
    param-major sorted pair table: rows 0..8 of the JAX package's [16, ...]
    table, which pads them to 16; SortPlan). Differentiable with respect
    to mean2d, conic, colors and opacity."""
    dataT, *plan = _SortGather.apply(geom, mean2d, conic, colors, opacity, *ints)
    return dataT, SortPlan(*plan)


class _CompositeSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dataT, starts, counts, th, tw, ntx, amp):
        with annotate("frame/composite"):
            acc, t_final, stop = fwd_call_pairs(dataT, starts, counts, th, tw, ntx)
        ctx.geom = (th, tw, ntx)
        ctx.amp = amp
        ctx.save_for_backward(dataT, starts, counts, acc, t_final, stop)
        return acc.transpose(1, 2), t_final

    @staticmethod
    def backward(ctx, g_acc_t, g_t):
        dataT, starts, counts, acc, t_final, stop = ctx.saved_tensors
        if g_acc_t is None:
            g_acc_t = torch.zeros_like(acc).transpose(1, 2)
        if g_t is None:
            g_t = torch.zeros_like(t_final)
        d_dataT = bwd_call_pairs(dataT, starts, counts, acc, t_final, stop,
                                 g_acc_t.contiguous(), g_t.contiguous(), *ctx.geom,
                                 amp=ctx.amp)
        return d_dataT, None, None, None, None, None, None


def composite_sorted(geom, dataT, starts, counts):
    """geom = (tile_h, tile_w, ntx[, amp]), as the JAX package's; `amp` (default
    False) selects the backward's bf16 contraction. Returns (acc [NT, P, 3]
    premultiplied colour, t_final [NT, P]). Differentiable with respect to
    dataT."""
    th, tw, ntx = geom[:3]
    amp = bool(geom[3]) if len(geom) > 3 else False
    return _CompositeSorted.apply(dataT, starts, counts, th, tw, ntx, amp)


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
    amp: bool = False,
):
    """Bin with the data-carrying sort and composite.

    Differentiable with respect to proj.mean2d, proj.conic, colors and
    opacity; the bboxes and depth keys take no gradient. `amp` runs the
    compositor's backward with its bf16 contraction (the `use_amp` policy).
    Returns (color [H, W, 3], alpha [H, W], plan).
    """
    nty = -(-height // tile_h)
    ntx = -(-width // tile_w)
    nt = nty * ntx

    proj_sg = proj._replace(**{k: v.detach() for k, v in proj._asdict().items()})
    tminx, tminy, bw, ntiles, _nty, _ntx = bbox_tiles(
        proj_sg, height, width, tile_h, tile_w, opacity=opacity.detach()
    )
    ntiles_eff = torch.where(proj_sg.mask, ntiles, torch.zeros_like(ntiles))
    ints = (tminx, tminy, bw, ntiles_eff, depth_key(proj_sg.depth))

    dataT, plan = sort_gather(
        (nt, ntx, spec), proj.mean2d, proj.conic, colors, opacity, ints
    )
    acc, t_final = composite_sorted(
        (tile_h, tile_w, ntx, amp), dataT, plan.tile_starts, plan.counts
    )
    out = acc + t_final[..., None] * bg_color[None, None, :]

    img = out.reshape(nty, ntx, tile_h, tile_w, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(nty * tile_h, ntx * tile_w, 3)[:height, :width]
    alpha = (1.0 - t_final).reshape(nty, ntx, tile_h, tile_w).permute(0, 2, 1, 3)
    alpha = alpha.reshape(nty * tile_h, ntx * tile_w)[:height, :width]
    return img, alpha, plan
