"""Tile-binned Gaussian rasterizer entry point: the sorted-data path and
the padded-table path.

`render_tiled` is the drop-in tiled equivalent of `render_dense`: projection,
SH colours, then one of two pipelines, selected as the JAX package selects
them (`sorted_data = use_pallas and compositor is None`):

  * the sorted-data binning and the pair compositor kernels
    (`ops/rasterize_sorted.py`), the default;
  * the padded-table pipeline (`use_pallas=False`, or an explicit
    `compositor`): `bin_gaussians` builds a [num_tiles, capacity] table of
    Gaussian indices front to back per tile from one sort of packed
    (tile, depth-rank) keys, and `composite_tiles` composites it front to
    back, `SLOT_CHUNK` slots a pass over the tiles that still have a live
    slot there. Its backward replays back to front from the saved final
    transmittance and stop index, so nothing of size capacity × pixels is
    kept. It is plain PyTorch: the JAX version is a `lax.scan` of one slot
    a step over every tile, not a Pallas kernel.

The table path has two forms that compute the same bits. Eager calls take
the planned walk: `rasterize_binned` gathers and composites the first
min(max(counts), capacity) slots only, and `composite_tiles` orders the
tiles by their live slots and skips, pass by pass, the tiles with nothing
left to composite (host reads of the counts and of which tiles remain).
Work captured in a CUDA graph, and work inside `fixed_walk()`, takes the
fixed walk, which reads nothing on the host: all `capacity` slots are
gathered, and every pass covers every tile, the masks of the planned walk
deciding on the device what a tile adds. A pass with nothing to add for
a tile multiplies its transmittance by exactly 1 and adds exactly 0, so
both forms give the same outputs and gradients.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import NamedTuple, Optional

import torch

from ..utils.profiling import annotate
from .projection import Projected, project_from_params
from .rasterize_dense import ALPHA_CUTOFF, ALPHA_MAX, T_EPS, RenderOutput
from .rasterize_sorted import rasterize_sorted
from .sh import eval_sh_color_kc
from .sort_binning import TierSpec, bbox_tiles, default_tiers


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Rasterization geometry and budgets.

    Sorted-data path: `base_budget` slots for every Gaussian; each (count,
    budget) tier gives the `count` footprint-heaviest Gaussians slots up to
    `budget`. Empty tiers = `default_tiers` at the padded Gaussian count.
    Table path: at most `capacity` Gaussians composited a tile, and at most
    `max_tiles_per_gaussian` (tile, Gaussian) pairs a Gaussian.
    """

    tile_h: int = 32
    tile_w: int = 32
    capacity: int = 1024
    max_tiles_per_gaussian: int = 32
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


class Binned(NamedTuple):
    idx: torch.Tensor          # [NT, C] int32 Gaussian index a slot (-1 = empty)
    tile_origin: torch.Tensor  # [NT, 2] float32 (x0, y0) pixel origin a tile
    counts: torch.Tensor       # [NT] int32 Gaussians binned a tile (before the cap)
    overflow: torch.Tensor     # [] int32 Gaussians dropped by the capacity cap
    budget_overflow: torch.Tensor  # [] int32 (tile, Gaussian) pairs dropped by
    #     `max_tiles_per_gaussian` (the trailing rows of a truncated bbox)


def view_colors(means3d, sh, camera, sh_degree: int) -> torch.Tensor:
    """View-dependent RGB [N, 3] from SH coefficients [N, K, 3]."""
    dirs = means3d - camera.camera_center
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
    return eval_sh_color_kc(sh, dirs, sh_degree)


# ---------------------------------------------------------------------------
# Table binning
# ---------------------------------------------------------------------------


def expand_sorted_pairs(proj: Projected, height: int, width: int, cfg: TileConfig,
                        opacity: Optional[torch.Tensor] = None):
    """Expand each Gaussian's tile bbox into (tile, depth-rank) pairs and
    sort them. Integer bookkeeping only; callers pass detached values.

    With `opacity` the bbox is the alpha-cutoff ellipse's box within the
    3σ circle (`sort_binning.bbox_tiles`). The depth rank comes from a
    stable argsort of the depth with masked Gaussians at +inf, so ties rank
    by index as in the JAX package. One int64 key (tile << rank_bits | rank)
    a pair is unique, so any sort gives the JAX package's order.

    Returns (s_tile [M] int32, s_gidx [M] int32, pair_drops [N] int32, nt,
    ntx), M = N × max_tiles_per_gaussian; invalid pairs carry tile == nt
    and sort to the end.
    """
    tminx, tminy, bw, ntiles, nty, ntx = bbox_tiles(
        proj, height, width, cfg.tile_h, cfg.tile_w, opacity=opacity)
    nt = nty * ntx
    n = proj.mean2d.shape[0]
    budget = cfg.max_tiles_per_gaussian
    dev = proj.mean2d.device
    i64 = torch.int64

    inf = torch.full((), float("inf"), dtype=proj.depth.dtype, device=dev)
    order = torch.argsort(torch.where(proj.mask, proj.depth, inf), stable=True)
    rank = torch.empty(n, dtype=i64, device=dev)
    rank[order] = torch.arange(n, dtype=i64, device=dev)

    # Slot j of Gaussian i covers tile (tminy + j // bw, tminx + j % bw).
    j = torch.arange(budget, dtype=i64, device=dev)[None, :]
    bw_safe = torch.clamp_min(bw, 1).to(i64)[:, None]
    dy = j // bw_safe
    dx = j - dy * bw_safe
    tile = (tminy.to(i64)[:, None] + dy) * ntx + (tminx.to(i64)[:, None] + dx)
    valid = (j < ntiles.to(i64)[:, None]) & proj.mask[:, None]
    tile_key = torch.where(valid, tile, torch.full_like(tile, nt))
    rank_bits = max(n - 1, 1).bit_length()
    key = ((tile_key << rank_bits) | rank[:, None]).reshape(-1)
    s_key, perm = torch.sort(key)
    s_gidx = torch.div(perm, budget, rounding_mode="floor").to(torch.int32)
    s_tile = (s_key >> rank_bits).to(torch.int32)
    pair_drops = torch.where(proj.mask, torch.clamp_min(ntiles - budget, 0),
                             torch.zeros_like(ntiles)).to(torch.int32)
    return s_tile, s_gidx, pair_drops, nt, ntx


def bin_gaussians(proj: Projected, height: int, width: int, cfg: TileConfig,
                  opacity: Optional[torch.Tensor] = None) -> Binned:
    """Assign Gaussians to image tiles, front to back within each tile: a
    [num_tiles, capacity] index table sliced from the sorted pair list."""
    s_tile, s_gidx, pair_drops, nt, ntx = expand_sorted_pairs(
        proj, height, width, cfg, opacity=opacity)
    dev = s_tile.device
    tiles = torch.arange(nt, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(s_tile, tiles, side="left")
    ends = torch.searchsorted(s_tile, tiles, side="right")
    counts = (ends - starts).to(torch.int32)
    m = s_tile.shape[0]
    slot = torch.arange(cfg.capacity, dtype=starts.dtype, device=dev)[None, :]
    take = torch.clamp_max(starts[:, None] + slot, m - 1)
    gidx = s_gidx[take]
    idx = torch.where(slot < counts[:, None], gidx, torch.full_like(gidx, -1))

    ty = tiles // ntx
    tx = tiles % ntx
    tile_origin = torch.stack([tx.float() * cfg.tile_w, ty.float() * cfg.tile_h], -1)
    overflow = torch.clamp_min(counts - cfg.capacity, 0).sum().to(torch.int32)
    budget_overflow = pair_drops.sum().to(torch.int32)
    return Binned(idx=idx, tile_origin=tile_origin, counts=counts, overflow=overflow,
                  budget_overflow=budget_overflow)


# ---------------------------------------------------------------------------
# The table compositor and its backward
# ---------------------------------------------------------------------------


def _tile_pixel_grid(cfg: TileConfig, device=None):
    py, px = torch.meshgrid(
        torch.arange(cfg.tile_h, dtype=torch.float32, device=device),
        torch.arange(cfg.tile_w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return px.reshape(-1), py.reshape(-1)  # [P]


def _slot_alpha(mean2d, conic, opac, px, py):
    """Alpha of slots against their tiles' pixels: mean2d [..., 2], conic
    [..., 3], opac [...]; px, py broadcast against [..., P] ([NT, P] for one
    slot a tile, [n, 1, P] for [n, S] slots). An empty slot (opacity 0)
    whose gathered geometry has power > 0 gives alpha = 0·inf = NaN:
    callers select with `torch.where`, never multiply by a mask."""
    dx = px - mean2d[..., 0:1]
    dy = py - mean2d[..., 1:2]
    a, b, c = conic[..., 0:1], conic[..., 1:2], conic[..., 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(opac[..., None] * torch.exp(power), ALPHA_MAX)
    use = (power <= 0.0) & (alpha >= ALPHA_CUTOFF)
    return alpha, use, power, dx, dy


def _pixels(tile_origin, cfg):
    px0, py0 = _tile_pixel_grid(cfg, tile_origin.device)
    return tile_origin[:, 0:1] + px0[None, :], tile_origin[:, 1:2] + py0[None, :]


# Slots composited a pass: each pass works on [tiles, SLOT_CHUNK,
# pixels] blocks, so a frame takes ~35 launches a pass forward and ~80
# backward where one slot a step took ~35 forward and ~45 backward a slot.
SLOT_CHUNK = 32

_FORM = threading.local()


@contextlib.contextmanager
def fixed_walk():
    """Within the block (in this thread), the table pipeline takes its
    fixed walk, which reads nothing on the host, the form a CUDA graph
    captures: for tests and measurements of that form outside a graph."""
    before = getattr(_FORM, "fixed", False)
    _FORM.fixed = True
    try:
        yield
    finally:
        _FORM.fixed = before


def host_read_free(x: torch.Tensor) -> bool:
    """Whether the table pipeline takes its fixed walk for `x`: inside
    `fixed_walk()`, or while `x`'s device captures a CUDA graph."""
    return getattr(_FORM, "fixed", False) or (
        x.is_cuda and torch.cuda.is_current_stream_capturing())


class _Plan(NamedTuple):
    order: Optional[torch.Tensor]   # [NT] tiles by live slots, most first; None: as given
    chunks: tuple          # (first slot, tiles of the walk's order it covers) a pass
    slots: int             # C, the slots given
    chunk: int             # slots a pass
    length: Optional[torch.Tensor]  # [NT] live slots a tile, in that order, on the host


def _plan(g_opac, chunk: int) -> _Plan:
    """Tiles ordered by their live slots (1 + the last slot of opacity > 0)
    and, for each pass of `chunk` slots, how many of them still have a live
    slot there. One host read."""
    nt, c = g_opac.shape
    live = g_opac > 0
    length = torch.where(live.any(1), c - torch.flip(live, [1]).to(torch.int32).argmax(1), 0)
    order = torch.argsort(length, descending=True, stable=True)
    sorted_len = length[order].cpu()
    chunks = []
    for s0 in range(0, c, chunk):
        n = int((sorted_len > s0).sum())
        if n == 0:
            break
        chunks.append((s0, n))
    return _Plan(order=order, chunks=tuple(chunks), slots=c, chunk=chunk, length=sorted_len)


def _fixed_plan(g_opac, chunk: int) -> _Plan:
    """The fixed walk: every pass over every tile, in the given order."""
    nt, c = g_opac.shape
    return _Plan(order=None, chunks=tuple((s0, nt) for s0 in range(0, c, chunk)), slots=c,
                 chunk=chunk, length=None)


def _by_plan(plan: _Plan, *xs):
    """Each [NT, C, ...] tensor in the plan's tile order, its slot axis
    padded with zeros (empty slots) to a multiple of the pass length."""
    c = plan.slots
    pad = (-c) % plan.chunk
    out = []
    for x in xs:
        if plan.order is not None:
            x = x[plan.order]
        if pad:
            x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)
        out.append(x)
    return out


def _rows(keep: torch.Tensor, n: int):
    """The tiles a pass works on, of the first `n` in plan order: a slice
    when all of them are kept, else their indices (None when none is)."""
    if bool(keep.all()):
        return slice(0, n)
    rows = keep.nonzero()[:, 0]
    return rows if rows.numel() else None


def _unorder(plan: _Plan, x):
    if plan.order is None:
        return x
    out = torch.empty_like(x)
    out[plan.order] = x
    return out


def _composite_fwd_scan(tile_origin, g_mean2d, g_conic, g_color, g_opac, cfg, plan: _Plan):
    """The front-to-back scan, `plan.chunk` slots a pass over the tiles still
    live there. Within a pass the transmittance before each slot is the
    running product of (1 − α) over the slots that composite (the carried T
    first, as the JAX scan multiplies); the first slot whose product falls
    below T_EPS stops the pixel, as the scan's trigger does. A tile whose
    pixels have all stopped leaves the later passes (one host read a pass),
    where the JAX scan walks on with nothing left to add; the fixed walk
    (`plan.order` None) covers every tile in every pass, as the JAX scan
    does. Returns (acc, t_final, stop) in the plan's tile order."""
    fixed = plan.order is None
    px, py = _pixels(tile_origin if fixed else tile_origin[plan.order], cfg)
    t = torch.ones_like(px)
    stop = torch.full(px.shape, plan.slots, dtype=torch.int32, device=px.device)
    acc = torch.zeros(px.shape + (3,), dtype=px.dtype, device=px.device)
    mean2d, conic, color, opac = _by_plan(plan, g_mean2d, g_conic, g_color, g_opac)
    chunk = plan.chunk
    slot = torch.arange(chunk, device=px.device)[None, :, None]
    done = torch.zeros(px.shape[0], dtype=torch.bool, device=px.device)
    for s0, n in plan.chunks:
        r = slice(0, n) if fixed else _rows(~done[:n], n)
        if r is None:       # the later passes' tiles are among these
            break
        sl = slice(s0, s0 + chunk)
        alpha, use, _pw, _dx, _dy = _slot_alpha(mean2d[r, sl], conic[r, sl], opac[r, sl],
                                                px[r][:, None], py[r][:, None])
        f = torch.where(use, 1.0 - alpha, 1.0)
        t_r, stop_r = t[r], stop[r]
        tt = torch.cumprod(torch.cat([t_r[:, None], f], 1), 1)      # [n, S + 1, P]
        trig = use & (tt[:, 1:] < T_EPS)
        hit = trig.any(1)
        first = torch.where(hit, trig.to(torch.int32).argmax(1), chunk)   # [n, P]
        running = stop_r == plan.slots
        contrib = use & (slot < first[:, None]) & running[:, None]
        w = torch.where(contrib, alpha * tt[:, :-1], 0.0)
        acc[r] = acc[r] + (w[..., None] * color[r, sl][:, :, None, :]).sum(1)
        t[r] = torch.where(running, tt.gather(1, first[:, None].long())[:, 0], t_r)
        stop_r = torch.where(running & hit, s0 + first, stop_r).to(stop.dtype)
        stop[r] = stop_r
        if not fixed:
            done[r] = (stop_r < plan.slots).all(1)
    return acc, t, stop


def _composite_bwd_scan(tile_origin, g_mean2d, g_conic, g_color, g_opac, t_final, stop,
                        g_acc, g_t, cfg, plan: _Plan):
    """The JAX package's custom VJP, back to front a pass at a time: the
    transmittance before each slot is the carried T after the pass divided
    by the product of (1 − α) over the pass's later compositing slots. The
    suffix Σ_{j>i} c_j α_j T_j enters d_alpha only as its dot product with
    the pixel's colour cotangent, so that scalar is carried (the later
    passes' part) and summed within the pass (an exclusive reverse sum of
    w_j · (g_acc · c_j)): [n, S, P] planes, no [n, S, P, 3] ones. A pass
    skips the tiles whose pixels all stopped before it (no slot there
    composites); the fixed walk covers every tile in every pass. t_final,
    stop, g_acc, g_t: in the plan's tile order. Returns the four slot
    gradients in the caller's order."""
    fixed = plan.order is None
    px, py = _pixels(tile_origin if fixed else tile_origin[plan.order], cfg)
    mean2d, conic, color, opac = _by_plan(plan, g_mean2d, g_conic, g_color, g_opac)
    chunk = plan.chunk
    nt, cp = opac.shape
    d_mean2d = torch.zeros((nt, cp, 2), dtype=px.dtype, device=px.device)
    d_conic = torch.zeros((nt, cp, 3), dtype=px.dtype, device=px.device)
    d_color = torch.zeros((nt, cp, 3), dtype=px.dtype, device=px.device)
    d_opac = torch.zeros((nt, cp), dtype=px.dtype, device=px.device)
    t_after = t_final.clone()               # T after the pass
    g_suffix = torch.zeros_like(t_final)    # g_acc · Σ over later passes of c_j α_j T_j
    ga = [g_acc[..., k][:, None] for k in range(3)]     # [NT, 1, P] a channel
    slot = torch.arange(chunk, device=px.device)[None, :, None]
    if not fixed:
        # Slots that can composite a tile: its live ones before its last stop.
        reach = torch.minimum(plan.length, stop.max(1).values.cpu())
    for s0, n in reversed(plan.chunks):
        r = slice(0, n) if fixed else _rows(reach[:n] > s0, n)
        if r is None:
            continue
        if isinstance(r, torch.Tensor):
            r = r.to(px.device)
        sl = slice(s0, s0 + chunk)
        cn, col = conic[r, sl], color[r, sl]
        alpha, use, power, dx, dy = _slot_alpha(mean2d[r, sl], cn, opac[r, sl],
                                                px[r][:, None], py[r][:, None])
        contrib = use & (s0 + slot < stop[r][:, None])
        one_minus = 1.0 - alpha
        f = torch.where(contrib, one_minus, 1.0)
        later = torch.flip(torch.cumprod(torch.flip(f, [1]), 1), [1])   # Π_{j≥s} (1 − α_j)
        t_i = t_after[r][:, None] / later
        w = torch.where(contrib, alpha * t_i, 0.0)
        # q = g_acc · c_s; Σ over pixels of elementwise products below (no
        # TF32 matmul on the card).
        gar = [x[r] for x in ga]
        q = gar[0] * col[..., 0:1] + gar[1] * col[..., 1:2] + gar[2] * col[..., 2:3]
        wq = w * q
        incl = torch.flip(torch.cumsum(torch.flip(wq, [1]), 1), [1])      # Σ_{j≥s}
        later_q = g_suffix[r][:, None] + torch.cat([incl[:, 1:], torch.zeros_like(incl[:, :1])], 1)
        d_color[r, sl] = torch.stack([(w * x).sum(-1) for x in gar], -1)
        d_alpha = q * t_i - later_q / one_minus
        d_alpha = d_alpha + g_t[r][:, None] * (-t_final[r][:, None] / one_minus)
        d_alpha = torch.where(contrib, d_alpha, 0.0)
        # Through alpha = min(0.99, o·e^p): the clamp kills the gradient.
        unclamped = alpha < ALPHA_MAX
        d_o_pix = torch.where(unclamped, d_alpha * torch.exp(power), 0.0)
        d_p = torch.where(unclamped, d_alpha * alpha, 0.0)
        d_opac[r, sl] = d_o_pix.sum(-1)
        # p = -½(a dx² + c dy²) - b dx dy
        d_conic[r, sl] = torch.stack([(d_p * (-0.5 * dx * dx)).sum(-1),
                                       (d_p * (-dx * dy)).sum(-1),
                                       (d_p * (-0.5 * dy * dy)).sum(-1)], -1)
        ca, cb, cc = cn[..., 0:1], cn[..., 1:2], cn[..., 2:3]
        d_mean2d[r, sl] = torch.stack([(d_p * (ca * dx + cb * dy)).sum(-1),
                                        (d_p * (cc * dy + cb * dx)).sum(-1)], -1)
        g_suffix[r] = g_suffix[r] + incl[:, 0]
        t_after[r] = t_i[:, 0]
    c = plan.slots
    return tuple(_unorder(plan, x[:, :c]) for x in (d_mean2d, d_conic, d_color, d_opac))


class _CompositeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tile_origin, g_mean2d, g_conic, g_color, g_opac, cfg):
        plan = (_fixed_plan if host_read_free(g_opac) else _plan)(g_opac, SLOT_CHUNK)
        acc, t_final, stop = _composite_fwd_scan(
            tile_origin, g_mean2d, g_conic, g_color, g_opac, cfg, plan)
        ctx.cfg, ctx.plan = cfg, plan
        ctx.save_for_backward(tile_origin, g_mean2d, g_conic, g_color, g_opac, t_final, stop)
        return _unorder(plan, acc), _unorder(plan, t_final)

    @staticmethod
    def backward(ctx, g_acc, g_t):
        tile_origin, g_mean2d, g_conic, g_color, g_opac, t_final, stop = ctx.saved_tensors
        order = ctx.plan.order
        if order is not None:
            g_acc, g_t = g_acc[order], g_t[order]
        grads = _composite_bwd_scan(tile_origin, g_mean2d, g_conic, g_color, g_opac,
                                    t_final, stop, g_acc, g_t, ctx.cfg, ctx.plan)
        return (None, *grads, None)


def composite_tiles(tile_origin, g_mean2d, g_conic, g_color, g_opac, cfg: TileConfig):
    """Front-to-back composite each tile's slot list.

    tile_origin [NT, 2] (no gradient); g_mean2d [NT, C, 2], g_conic
    [NT, C, 3], g_color [NT, C, 3], g_opac [NT, C] (0 for empty slots).
    Returns (acc [NT, P, 3] premultiplied colour, t_final [NT, P]),
    P = tile_h × tile_w. Differentiable in the four slot tensors (the JAX
    package's custom VJP, which keeps nothing of size C × P). The JAX
    version scans one slot at a time over every tile; this one passes
    SLOT_CHUNK slots at a time (the same function, summed in another
    order): over the tiles with a live slot there, or in the fixed walk
    (`host_read_free`) over every tile, with the same bits.
    """
    return _CompositeTiles.apply(tile_origin.detach(), g_mean2d, g_conic, g_color, g_opac, cfg)


def _gather_slots(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The slots' rows [NT, K, 9] of `packed` [N, 9], `idx` [NT, K] (-1:
    empty), by one gather from the table padded with K zero rows: an
    empty slot at position j reads row N + j. So empty slots hold zeros,
    and the gather's backward adds their (zero) gradients into the spare
    rows, spread over the slot position, which the table's slice then
    drops. Routing every empty slot to one row made the card serialise
    millions of additions into it (0.7 s of a 0.78 s step at the benchmark
    frame on an H100 80GB HBM3)."""
    n, k = packed.shape[0], idx.shape[1]
    spare = torch.arange(n, n + k, dtype=torch.int64, device=idx.device)
    route = torch.where(idx >= 0, idx.to(torch.int64), spare)
    return torch.cat([packed, packed.new_zeros((k, packed.shape[1]))])[route]


def rasterize_binned(proj_mean2d, proj_conic, colors, opacity, binned: Binned, height: int,
                     width: int, bg_color, cfg: TileConfig, compositor=composite_tiles):
    """Gather each tile's slot data with ONE packed [N, 9] row gather
    (`_gather_slots`) and composite. Differentiable in the screen-space
    inputs. The planned walk gathers and composites the first
    min(max(counts), capacity) slots (one host read); the fixed walk
    (`host_read_free`) all of them. Returns (color [H, W, 3], alpha
    [H, W]).

    An empty slot holds zeros (opacity 0), where the JAX package gathers
    Gaussian 0's row and multiplies its opacity by the slot's validity:
    the same image and gradients (an empty slot composites nothing), but
    no empty slot's gradient reaches a Gaussian.
    """
    idx = binned.idx.detach()
    if not host_read_free(idx):
        idx = idx[:, :min(int(binned.counts.max()), cfg.capacity) if binned.counts.numel() else 0]
    packed = torch.cat([proj_mean2d, proj_conic, colors, opacity[:, None]], dim=-1)  # [N, 9]
    g = _gather_slots(packed, idx)
    acc, t_final = compositor(binned.tile_origin.detach(), g[..., 0:2], g[..., 2:5],
                              g[..., 5:8], g[..., 8], cfg)
    out = acc + t_final[..., None] * bg_color[None, None, :]

    nty, ntx = cfg.grid(height, width)
    th, tw = cfg.tile_h, cfg.tile_w
    img = out.reshape(nty, ntx, th, tw, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(nty * th, ntx * tw, 3)[:height, :width]
    alpha = (1.0 - t_final).reshape(nty, ntx, th, tw).permute(0, 2, 1, 3)
    alpha = alpha.reshape(nty * th, ntx * tw)[:height, :width]
    return img, alpha


def detached(proj: Projected) -> Projected:
    return proj._replace(**{k: v.detach() for k, v in proj._asdict().items()})


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
    compositor=None,
    use_pallas: bool = True,
    sorted_data: Optional[bool] = None,
) -> RenderOutput:
    """Render one view (same semantics as `render_dense`). Either `sh`
    [N,K,3] or `colors` [N,3].

    The sorted-data pipeline and its compositor kernels run when
    `use_pallas` and no `compositor` is given (or `sorted_data=True`);
    otherwise the table pipeline, binned from the detached projection with
    the effective opacity, composited by `compositor` (default
    `composite_tiles`). `amp` selects the bf16 contraction of the sorted
    compositor's backward (the `use_amp` policy); the table path has none.
    Projection and the view's SH colours are the span `frame/project_sh`.
    """
    if colors is None and sh is None:
        raise ValueError("provide sh or colors")
    with annotate("frame/project_sh"):
        proj = project_from_params(means3d, scales, quats, camera, scale_modifier, alive=alive)
        if colors is None:
            colors = view_colors(means3d, sh, camera, sh_degree)
    opac_eff = torch.where(proj.mask, opacity, torch.zeros_like(opacity))
    if sorted_data is None:
        sorted_data = use_pallas and compositor is None
    if sorted_data:
        img, alpha, _plan = rasterize_sorted(
            proj, colors, opac_eff, camera.height, camera.width, bg_color,
            cfg.tile_h, cfg.tile_w, cfg.tier_spec(means3d.shape[0]), amp=amp,
        )
    else:
        binned = bin_gaussians(detached(proj), camera.height, camera.width, cfg,
                               opacity=opac_eff.detach())
        img, alpha = rasterize_binned(
            proj.mean2d, proj.conic, colors, opac_eff, binned, camera.height, camera.width,
            bg_color, cfg, compositor=compositor or composite_tiles)
    return RenderOutput(
        color=img, alpha=alpha, radii=proj.radius, visibility=proj.radius > 0
    )
