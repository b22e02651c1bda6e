"""Data-carrying sort binning (PyTorch): the rasterizer's front end.

The same pipeline as the JAX package's `ops/sort_binning.py`:

  1. **Footprint sort** over the N Gaussians, descending clipped tile
     count, so every budget tier is a contiguous prefix.
  2. **Tiered expansion**, Gaussian-major blocks: slot j of Gaussian g
     covers bbox tile j; slots beyond the bbox get the sentinel tile NT.
  3. **Pair sort** by (tile, depth bits), the nine screen-space columns
     riding along as payload.
  4. Segment starts/counts per tile by `searchsorted`.

PyTorch has no multi-operand sort: each sort orders one key with
`torch.sort(stable=True)` and gathers the payload columns by the returned
permutation. JAX's `lax.sort` is not stable, so ties in the footprint
order (and therefore `pos` and `gidx_fp`) may differ from the JAX package;
the live pair table, `starts`, `counts` and `total` do not, as long as no
two pairs share a (tile, depth) key.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .projection import Projected
from .rasterize_dense import ALPHA_CUTOFF

# Tier counts and the Gaussian axis stay 128-aligned so the tables match the
# JAX package's layout slot for slot; PAIR_CHUNK is the zero slack at the
# end of the pair table.
ALIGN = 128
PAIR_CHUNK = 512


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """Tiered per-Gaussian budget spec.

    Every Gaussian gets ``base`` expansion slots. The ``tiers`` are
    (count, budget) pairs with strictly increasing budgets: the `count`
    footprint-heaviest Gaussians get slots up to `budget`. Counts are
    multiples of 128 and non-increasing.
    """

    base: int = 2
    tiers: tuple[tuple[int, int], ...] = ()

    def __post_init__(self):
        prev_b = self.base
        prev_c = None
        for c, b in self.tiers:
            if c % ALIGN:
                raise ValueError(f"tier count {c} must be 128-aligned")
            if b <= prev_b:
                raise ValueError("tier budgets must be strictly increasing")
            if prev_c is not None and c > prev_c:
                raise ValueError("tier counts must be non-increasing")
            prev_b, prev_c = b, c

    def blocks(self, n: int) -> list[tuple[int, int, int]]:
        """(n_rows, j0, j1) per expansion block, in layout order."""
        out = [(n, 0, self.base)]
        j0 = self.base
        for c, b in self.tiers:
            out.append((min(c, n), j0, b))
            j0 = b
        return out

    def expansion_size(self, n: int) -> int:
        return sum(nr * (j1 - j0) for nr, j0, j1 in self.blocks(n))

    def max_budget(self) -> int:
        return self.tiers[-1][1] if self.tiers else self.base

    def budget_for_rank(self, rank: torch.Tensor) -> torch.Tensor:
        """Per-Gaussian budget as a function of footprint-order position."""
        budget = torch.full_like(rank, self.base)
        for c, b in self.tiers:
            budget = torch.where(rank < c, torch.full_like(rank, b), budget)
        return budget


def default_tiers(capacity: int) -> TierSpec:
    """A generous default: ~5.1 slots/Gaussian, top tier budget 64."""
    def r(x):
        return max(ALIGN, (int(x) // ALIGN) * ALIGN)

    return TierSpec(
        base=2,
        tiers=((r(capacity / 4), 8), (r(capacity / 16), 24), (r(capacity / 64), 64)),
    )


def probe_tiers(
    footprints,
    base: int = 2,
    margin: float = 1.3,
    ladder: Sequence[int] = (8, 24, 64, 128, 256, 512),
) -> TierSpec:
    """Size a TierSpec from a measured footprint distribution (zero
    truncation on the probe frame, with `margin` headroom for motion).

    `footprints` = per-Gaussian clipped bbox tile counts of one frame
    (`bbox_tiles` → masked ntiles), as a tensor or array.
    """
    if isinstance(footprints, torch.Tensor):
        footprints = footprints.cpu().numpy()
    fp = np.asarray(footprints)
    n = fp.shape[0]
    n_aligned = -(-n // ALIGN) * ALIGN
    fmax = int(fp.max()) if n else 0
    top_needed = int(fmax * margin) + 1
    tiers: list[tuple[int, int]] = []
    prev_b = base
    for b in ladder:
        if fmax <= prev_b:
            break
        cnt = int((fp > prev_b).sum() * margin)
        cnt = min(-(-max(cnt, 1) // ALIGN) * ALIGN, n_aligned)
        b_eff = min(b, top_needed)
        if b_eff <= prev_b:
            break
        tiers.append((cnt, b_eff))
        prev_b = b_eff
        if b_eff >= top_needed:
            break
    else:
        if fmax > prev_b:  # ladder exhausted below the max footprint
            cnt = int((fp > prev_b).sum() * margin)
            cnt = min(-(-max(cnt, 1) // ALIGN) * ALIGN, n_aligned)
            tiers.append((cnt, top_needed))
    for i in range(len(tiers) - 2, -1, -1):
        tiers[i] = (max(tiers[i][0], tiers[i + 1][0]), tiers[i][1])
    return TierSpec(base=base, tiers=tuple(tiers))


def grow_tiers(
    spec: TierSpec, max_footprint: int, n_gauss: Optional[int] = None
) -> TierSpec:
    """Spec after a budget overflow: the top budget covers `max_footprint`
    and every tier's count doubles (clamped to the padded Gaussian count),
    so repeated growth reaches zero overflow."""
    new_top = max(spec.max_budget(), int(max_footprint))
    cap = None if n_gauss is None else -(-int(n_gauss) // ALIGN) * ALIGN
    tiers = []
    for c, b in spec.tiers:
        c2 = c * 2 if cap is None else min(c * 2, cap)
        tiers.append((c2, b))
    if tiers:
        tiers[-1] = (tiers[-1][0], new_top)
    else:
        c0 = ALIGN if cap is None else min(max(ALIGN, cap // 4), cap)
        tiers = [(c0, max(new_top, 2 * spec.base))]
    for i in range(len(tiers) - 2, -1, -1):
        tiers[i] = (max(tiers[i][0], tiers[i + 1][0]), tiers[i][1])
    return dataclasses.replace(spec, tiers=tuple(tiers))


class SortPlan(NamedTuple):
    """Integer bookkeeping of one binned frame."""

    tile_starts: torch.Tensor     # [NT] i32 segment start per tile
    counts: torch.Tensor          # [NT] i32 live pairs per tile
    total: torch.Tensor           # [] i32 live pairs
    budget_overflow: torch.Tensor  # [] bbox tiles dropped by tier budgets
    max_footprint: torch.Tensor   # [] largest clipped bbox tile count
    pos: torch.Tensor             # [M] i32 column-major destination per sorted row
    gidx_fp: torch.Tensor         # [N] original Gaussian index per fp row


def bbox_tiles(
    proj: Projected,
    height: int,
    width: int,
    tile_h: int,
    tile_w: int,
    opacity: Optional[torch.Tensor] = None,
):
    """Per-Gaussian tile-space bbox (tminx, tminy, bw, ntiles, nty, ntx).

    With ``opacity`` the bbox is the axis-aligned box of the alpha-cutoff
    ellipse intersected with the 3σ circle. The bounds divide by the tile
    size in float32 and then floor, as the JAX package does.
    """
    nty = -(-height // tile_h)
    ntx = -(-width // tile_w)
    mx = proj.mean2d[:, 0]
    my = proj.mean2d[:, 1]
    r = proj.radius.to(torch.float32)
    if opacity is not None:
        tau = 2.0 * torch.log(
            torch.clamp_min(opacity, ALPHA_CUTOFF) * (1.0 / ALPHA_CUTOFF)
        )
        hx = torch.minimum(r, torch.sqrt(tau * torch.clamp_min(proj.cov2d[:, 0], 0.0)))
        hy = torch.minimum(r, torch.sqrt(tau * torch.clamp_min(proj.cov2d[:, 2], 0.0)))
    else:
        hx = hy = r
    i32 = torch.int32
    tminx = torch.clamp(torch.floor((mx - hx) / tile_w).to(i32), 0, ntx)
    tmaxx = torch.clamp(torch.floor((mx + hx) / tile_w).to(i32) + 1, 0, ntx)
    tminy = torch.clamp(torch.floor((my - hy) / tile_h).to(i32), 0, nty)
    tmaxy = torch.clamp(torch.floor((my + hy) / tile_h).to(i32) + 1, 0, nty)
    bw = tmaxx - tminx
    ntiles = bw * (tmaxy - tminy)
    return tminx, tminy, bw, ntiles, nty, ntx


def sort_bin_forward(
    data_cols: Sequence[torch.Tensor],   # 9 × [N] f32 (mx my a b c r g b op)
    tminx: torch.Tensor,
    tminy: torch.Tensor,
    bw: torch.Tensor,
    ntiles_eff: torch.Tensor,            # [N] i32, 0 for masked Gaussians
    depth_bits: torch.Tensor,            # [N] i32 monotone depth key
    ntx: int,
    nt: int,
    spec: TierSpec,
):
    """The forward binning: fp-sort → tiered expand → (tile, depth) pair sort.

    Returns (sorted data [9, M], s_tile [M], pos [M], gidx_fp [N],
    budget_overflow []).
    """
    n = data_cols[0].shape[0]
    dev = data_cols[0].device
    i32 = torch.int32

    # 1. Footprint sort (descending tile count), all columns gathered along.
    _, perm = torch.sort(-ntiles_eff, stable=True)
    txs, tys, bws, nts, dbs = (
        x[perm] for x in (tminx, tminy, torch.clamp_min(bw, 1), ntiles_eff, depth_bits)
    )
    gidx_fp = perm.to(i32)
    ds = torch.stack(list(data_cols))[:, perm]                     # [9, N]

    rank = torch.arange(n, dtype=i32, device=dev)
    budget = spec.budget_for_rank(rank)
    budget_overflow = torch.sum(torch.clamp_min(nts - budget, 0))

    # 2. Tiered expansion, Gaussian-major blocks; `pos` is the column-major
    #    destination of each slot (j-major within each block).
    tk_parts, db_parts, pos_parts, g_parts = [], [], [], []
    off = 0
    for n_sel, j0, j1 in spec.blocks(n):
        nb = j1 - j0
        j = torch.arange(j0, j1, dtype=i32, device=dev)[None, :]      # [1, nb]
        # Exact integer floor division: a float reciprocal of bw puts
        # j = k·bw one row early for many widths (the smallest is 41).
        dy = torch.div(j, bws[:n_sel, None], rounding_mode="floor")
        dx = j - dy * bws[:n_sel, None]
        t_ = (tys[:n_sel, None] + dy) * ntx + (txs[:n_sel, None] + dx)
        valid = j < nts[:n_sel, None]
        tk_parts.append(torch.where(valid, t_, torch.full_like(t_, nt)).reshape(-1))
        db_parts.append(dbs[:n_sel, None].expand(n_sel, nb).reshape(-1))
        g_col = torch.arange(n_sel, dtype=i32, device=dev)[:, None]
        pos_parts.append((off + (j - j0) * n_sel + g_col).reshape(-1))
        g_parts.append(g_col.expand(n_sel, nb).reshape(-1))
        off += n_sel * nb

    tk = torch.cat(tk_parts)
    db = torch.cat(db_parts)
    pos = torch.cat(pos_parts)
    g = torch.cat(g_parts)

    # 3. Pair sort on one int64 key. The depth bits are shifted to unsigned
    #    so the key orders exactly like the lexicographic (tile, depth_bits)
    #    pair of signed int32s, whatever the depth bits of dead rows.
    key = tk.to(torch.int64) * (1 << 32) + (db.to(torch.int64) + (1 << 31))
    _, order = torch.sort(key, stable=True)
    s_tile = tk[order]
    s_pos = pos[order]
    s_data = ds[:, g[order]]
    return s_data, s_tile, s_pos, gidx_fp, budget_overflow


def segment_bounds(s_tile: torch.Tensor, nt: int):
    """Per-tile (starts [NT], counts [NT], total []) of a tile-sorted list."""
    tids = torch.arange(nt, dtype=s_tile.dtype, device=s_tile.device)
    starts = torch.searchsorted(s_tile, tids, side="left", out_int32=True)
    ends = torch.searchsorted(s_tile, tids, side="right", out_int32=True)
    counts = ends - starts
    total = ends[-1] if nt > 0 else torch.zeros((), dtype=torch.int32, device=s_tile.device)
    return starts, counts, total
