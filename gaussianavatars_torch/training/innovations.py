"""The five training innovations as plain functions on tensors.

The port of the JAX package's `training/innovations.py` (reference
`innovations/__init__.py`). Each is stateless or carries its state
explicitly in the `TrainState`:

  1. Region-adaptive loss  → a weight map (FLAME-projected boxes, or the
     heuristic face prior), consumed by `loss.weighted_l1_loss`.
  2. Smart densification   → percentile thresholds from the accumulated
     gradient statistics, fed to `densify_and_prune`.
  3. Progressive resolution → a host-side schedule of image scales.
  4. Colour calibration     → a per-pixel MLP (`ColorNetParams`, weights in
     the JAX package's `[in, out]` layout) with its own Adam, applied to
     the rendered image.
  5. Contrastive regulariser → a ring buffer of pooled renders in the
     state; loss = mean(1 − cosine) against its valid entries. Its `count`
     and `head` stay on the device, so neither the loss nor the update
     reads a device value on the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# 1. Region-adaptive loss weighting (`innovations/region_adaptive_loss.py`)
# ---------------------------------------------------------------------------

# The weighted regions in the order the map is built: (region names, the
# name of the weight argument of `flame_region_weight_map`).
WEIGHTED_REGIONS = ((("eyes_left", "eyes_right"), "eyes"), (("mouth",), "mouth"),
                    (("nose",), "nose"))


def heuristic_weight_map(height: int, width: int, weight_eyes: float = 2.0,
                         weight_mouth: float = 2.0, weight_nose: float = 1.5,
                         weight_face: float = 1.2, device=None) -> torch.Tensor:
    """Gaussian-blob face prior (`_heuristic_map`, reference :90-105). [H, W]."""
    y = torch.linspace(-1.0, 1.0, height, device=device)[:, None]
    x = torch.linspace(-1.0, 1.0, width, device=device)[None, :]
    face = torch.exp(-((x * 1.2) ** 2 + y**2))
    w = 1 + (weight_face - 1) * face
    eye = torch.exp(-((x / 0.3) ** 2 + ((y + 0.2) / 0.15) ** 2))
    mouth = torch.exp(-((x / 0.3) ** 2 + ((y - 0.4) / 0.2) ** 2))
    nose = torch.exp(-((x / 0.2) ** 2 + (y / 0.3) ** 2))
    w = torch.maximum(w, 1 + (weight_eyes - 1) * eye)
    w = torch.maximum(w, 1 + (weight_mouth - 1) * mouth)
    w = torch.maximum(w, 1 + (weight_nose - 1) * nose)
    return w


def region_index_tensors(region_vids: dict, device) -> list:
    """The weighted regions' vertex ids as int64 tensors on `device`, one
    per entry of WEIGHTED_REGIONS (None where the region is absent): built
    once per step function, so the map itself copies nothing from the
    host."""
    out = []
    for names, _ in WEIGHTED_REGIONS:
        parts = [np.asarray(region_vids[n], np.int64).reshape(-1)
                 for n in names if n in region_vids]
        vids = np.concatenate(parts) if parts else np.zeros((0,), np.int64)
        out.append(torch.as_tensor(vids, device=device) if vids.size else None)
    return out


def flame_region_weight_map(verts: torch.Tensor, region_vids, camera, height: int, width: int,
                            weight_eyes: float = 2.0, weight_mouth: float = 2.0,
                            weight_nose: float = 1.5) -> torch.Tensor:
    """Project the region vertices and splat a box of weights around each.

    `verts` [V, 3] posed vertices; `region_vids` a dict name → vertex ids,
    or `region_index_tensors`' list. Each vertex lands on pixel
    ((ndc·0.5 + 0.5)·(size − 1), clipped, truncated), the rasterizer's
    orientation (no y flip); a region's hits are dilated by a (2r + 1) box,
    r = max(H, W) // 60, as a separable max filter; weight = max over the
    regions covering a pixel, 1 elsewhere. The projection is written out
    element by element, so every device computes the same pixels. [H, W].
    """
    if isinstance(region_vids, dict):
        region_vids = region_index_tensors(region_vids, verts.device)
    full = camera.full_proj.to(torch.float32)
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]

    def row(i):
        return x * full[i, 0] + y * full[i, 1] + z * full[i, 2] + full[i, 3]

    w = row(3) + 1e-7
    ndc_x, ndc_y = row(0) / w, row(1) / w
    px = torch.clamp((ndc_x * 0.5 + 0.5) * (width - 1), 0, width - 1).to(torch.int64)
    py = torch.clamp((ndc_y * 0.5 + 0.5) * (height - 1), 0, height - 1).to(torch.int64)
    lin = py * width + px

    radius = max(height, width) // 60
    k = 2 * radius + 1
    weights = {"eyes": weight_eyes, "mouth": weight_mouth, "nose": weight_nose}
    wmap = torch.ones((height, width), dtype=torch.float32, device=verts.device)
    for (_names, wname), vids in zip(WEIGHTED_REGIONS, region_vids):
        if vids is None:  # region absent: no boxes
            continue
        hit = torch.zeros((height * width,), dtype=torch.float32, device=verts.device)
        hit = hit.index_fill_(0, lin[vids], 1.0).reshape(1, 1, height, width)
        # Dilate by `radius`: max_pool2d pads with -inf, as the JAX
        # package's reduce_window does.
        hit = F.max_pool2d(hit, (k, 1), stride=1, padding=(radius, 0))
        hit = F.max_pool2d(hit, (1, k), stride=1, padding=(0, radius))[0, 0]
        wmap = torch.maximum(wmap, torch.where(hit > 0, torch.full_like(hit, weights[wname]),
                                               torch.ones_like(hit)))
    return wmap


# ---------------------------------------------------------------------------
# 2. Smart densification (`innovations/smart_densification.py`)
# ---------------------------------------------------------------------------


def smart_thresholds(grad_accum: torch.Tensor, denom: torch.Tensor, max_grad: float,
                     percentile_clone: float = 75.0, percentile_split: float = 90.0):
    """Percentile thresholds over the nonzero mean gradients, floored at
    0.3 / 0.7 · max_grad (reference `smart_densification.py:18-52`).

    Not `torch.quantile`, which interpolates: the JAX package's masked
    quantile by truncated index, n − cnt + int((cnt − 1)·p/100) into the
    sort with the zeros pushed to −inf, in float32; `max_grad` when no
    gradient is nonzero. Returns 0-dim float32 tensors (clone, split).
    """
    zero = torch.zeros((), dtype=torch.float32, device=grad_accum.device)
    grads = torch.where(denom > 0, grad_accum / torch.clamp_min(denom, 1.0), zero)
    nz = grads > 0
    n = grads.shape[0]
    sorted_g = torch.sort(torch.where(nz, grads, torch.full_like(grads, -math.inf))).values
    cnt = nz.sum().to(torch.int32)
    fallback = torch.full((), max_grad, dtype=torch.float32, device=grads.device)

    def q(p):
        pos = torch.clamp((cnt - 1).to(torch.float32) * p / 100.0, 0, n - 1).to(torch.int32)
        idx = torch.clamp(n - cnt + pos, 0, n - 1).to(torch.int64).reshape(1)
        return torch.where(cnt > 0, sorted_g.index_select(0, idx)[0], fallback)

    clone_thr = torch.clamp_min(q(percentile_clone), 0.3 * max_grad)
    split_thr = torch.clamp_min(q(percentile_split), 0.7 * max_grad)
    return clone_thr, split_thr


# ---------------------------------------------------------------------------
# 3. Progressive resolution (`innovations/progressive_training.py`)
# ---------------------------------------------------------------------------


def resolution_scale_at(iteration: int, schedule: Sequence[float] = (0.5, 0.75, 1.0),
                        milestones: Sequence[int] = (100_000, 300_000)) -> float:
    """Piecewise-constant image-scale factor for an iteration (host-side)."""
    idx = sum(1 for m in milestones if iteration >= m)
    return schedule[min(idx, len(schedule) - 1)]


# ---------------------------------------------------------------------------
# 4. Colour calibration network (`innovations/color_calibration.py`)
# ---------------------------------------------------------------------------


class ColorNetParams(NamedTuple):
    weights: tuple            # tuple of [in, out] matrices
    biases: tuple             # tuple of [out]


def color_net_init(hidden: int = 16, layers: int = 3,
                   generator: Optional[torch.Generator] = None,
                   device="cpu") -> ColorNetParams:
    """3 → hidden → … → 3 per-pixel MLP with He-normal weights (drawn from
    `generator`, a CPU generator) and zero biases."""
    dims = [3] + [hidden] * (layers - 1) + [3]
    ws, bs = [], []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=generator, dtype=torch.float32) * math.sqrt(2.0 / a)
        ws.append(w.to(device))
        bs.append(torch.zeros((b,), dtype=torch.float32, device=device))
    return ColorNetParams(weights=tuple(ws), biases=tuple(bs))


def color_net_apply(p: ColorNetParams, image: torch.Tensor) -> torch.Tensor:
    """image [H, W, 3] → calibrated [H, W, 3] (no residual, sigmoid out)."""
    x = image
    last = len(p.weights) - 1
    for i, (w, b) in enumerate(zip(p.weights, p.biases)):
        x = x @ w + b
        x = torch.relu(x) if i < last else torch.sigmoid(x)
    return x


def color_net_reg(p: ColorNetParams) -> torch.Tensor:
    """L2 weight regulariser (`color_calibration.py:37-42`)."""
    return sum(torch.sum(w**2) for w in p.weights)


# ---------------------------------------------------------------------------
# 5. Contrastive regularisation (`innovations/contrastive_regularization.py`)
# ---------------------------------------------------------------------------


class ContrastiveCache(NamedTuple):
    images: torch.Tensor   # [cache, d, d, 3] pooled renders
    count: torch.Tensor    # [] int32 number of valid entries
    head: torch.Tensor     # [] int32 ring-buffer write position


def contrastive_init(cache_size: int, height: int, width: int, downsample: int = 8,
                     device="cpu") -> ContrastiveCache:
    """An empty cache. `downsample` is the pooled output size (the reference
    pools every render to a fixed thumbnail, `contrastive_regularization.py:18,26`),
    so the cache's shape does not depend on the resolution and survives the
    progressive milestones; height and width are taken for the JAX
    signature only."""
    del height, width
    return ContrastiveCache(
        images=torch.zeros((cache_size, downsample, downsample, 3), dtype=torch.float32,
                           device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        head=torch.zeros((), dtype=torch.int32, device=device),
    )


def _downsample(image: torch.Tensor, out: int) -> torch.Tensor:
    """[H, W, 3] → [out, out, 3] by `adaptive_avg_pool2d` (bin i covers rows
    [floor(i·H/out), ceil((i+1)·H/out)), so non-divisible sizes pool as
    the JAX package's integral image does)."""
    return F.adaptive_avg_pool2d(image.permute(2, 0, 1)[None], out)[0].permute(1, 2, 0)


def contrastive_loss(cache: ContrastiveCache, image: torch.Tensor,
                     downsample: int) -> torch.Tensor:
    """mean(1 − cosine) against the valid cache entries (reference :20-31)."""
    small = _downsample(image, downsample).reshape(-1)
    flat = cache.images.reshape(cache.images.shape[0], -1)
    dot = flat @ small
    cos = dot / (torch.linalg.vector_norm(flat, dim=1) * torch.linalg.vector_norm(small) + 1e-8)
    valid = torch.arange(cache.images.shape[0], device=image.device) < cache.count
    n = torch.clamp_min(cache.count, 1)
    return torch.sum(torch.where(valid, 1.0 - cos, torch.zeros_like(cos))) / n


def contrastive_update(cache: ContrastiveCache, image: torch.Tensor,
                       downsample: int) -> ContrastiveCache:
    """Write the pooled (detached) image at `head`; a new cache."""
    small = _downsample(image.detach(), downsample)
    size = cache.images.shape[0]
    images = cache.images.index_copy(0, cache.head.reshape(1).to(torch.int64), small[None])
    return ContrastiveCache(
        images=images,
        count=torch.clamp_max(cache.count + 1, size),
        head=torch.remainder(cache.head + 1, size),
    )
