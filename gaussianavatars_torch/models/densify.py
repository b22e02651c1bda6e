"""Adaptive density control on fixed-capacity buffers.

The port of the JAX package's `models/densify.py`. Parameters live in
padded tensors with an `alive` mask, so densification is slot surgery
(`scene/gaussian_model.py:340-541` reallocates instead):

  * clone: selected Gaussians are copied into free (dead) slots;
  * split: the parent slot is overwritten by child A and child B goes to a
    free slot;
  * prune: the alive mask is cleared; bound Gaussians whose face would lose
    its last Gaussian are kept (`prune_points`, `:377-404`);
  * the Adam moments ride along: new slots start with zero moments, as
    `cat_tensors_to_optimizer` gives them.

Free slots are taken in ascending order (`torch.nonzero` padded with −1,
as `jnp.nonzero(size=cap, fill_value=-1)`); requests past the free slots
are dropped and counted (`DensifyReport.dropped`), and the host can then
call `grow_capacity`. Every function returns new dataclasses; the inputs
are not modified.

The split's two normal draws come from a `torch.Generator` (not JAX's
bits); `noise=(a, b)` hands them in instead, so that the tests can give
both packages the same draws. As in the JAX package, bound children are
sampled with world stds and placed in triangle-local coordinates
(`densify_and_split`, `:467-471`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.quaternion import quat_normalize, quat_to_rotmat
from .gaussians import FaceFrames, GaussianAux, GaussianParams, inverse_sigmoid


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    grad_threshold: float = 0.0002
    percent_dense: float = 0.01
    min_opacity: float = 0.005
    max_screen_size: float = 20.0   # 0 disables the screen/world-size prunes
    split_factor: int = 2           # children per split (N in the reference)
    split_shrink: float = 0.8       # children scale = scale / (shrink · N)


class DensifyReport(NamedTuple):
    cloned: torch.Tensor   # [] int32
    split: torch.Tensor    # [] int32
    pruned: torch.Tensor   # [] int32
    dropped: torch.Tensor  # [] int32 requests lost to capacity exhaustion


def _padded_nonzero(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the True entries in ascending order, padded with −1 to
    the mask's length."""
    idx = torch.nonzero(mask).flatten()
    out = torch.full_like(mask, -1, dtype=torch.int64)
    out[:idx.shape[0]] = idx
    return out


def _copy_rows(obj, src, dst, valid, zero_new: bool = False):
    """obj.<field>[dst] = obj.<field>[src] (or zeros) for the valid pairs;
    the others are dropped."""
    src_v, dst_v = src[valid], dst[valid]
    out = {}
    for f in dataclasses.fields(obj):
        x = getattr(obj, f.name)
        x = x.clone()
        x[dst_v] = torch.zeros_like(x[src_v]) if zero_new else x[src_v]
        out[f.name] = x
    return dataclasses.replace(obj, **out)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum().to(torch.int32)


def world_scale_of(params: GaussianParams, aux: GaussianAux,
                   frames: Optional[FaceFrames]) -> torch.Tensor:
    s = torch.exp(params.log_scales)
    if frames is not None:
        s = s * frames.scaling[aux.binding]
    return s


@torch.no_grad()
def add_densification_stats(aux: GaussianAux, screen_grad: torch.Tensor, radii: torch.Tensor,
                            width: int, height: int) -> GaussianAux:
    """Accumulate screen-space gradient norms of the visible Gaussians.

    `screen_grad` [N, 2] is dL/dmean2d in pixels. The CUDA rasterizer the
    0.0002 densify threshold is calibrated for reports it scaled by half the
    screen size, and so is it here (`train.py:265-266`,
    `scene/gaussian_model.py:539-541`).
    """
    vis = radii > 0
    # Python-scalar multiplies: a tensor of the two factors would be a
    # host-to-device copy every step, which synchronises (and cannot be
    # captured in a CUDA graph).
    g = torch.stack((screen_grad[:, 0] * (width * 0.5), screen_grad[:, 1] * (height * 0.5)),
                    dim=-1)
    norm = torch.sqrt(torch.sum(g * g, dim=-1))
    zero = torch.zeros((), dtype=torch.float32, device=norm.device)
    return dataclasses.replace(
        aux,
        grad_accum=aux.grad_accum + torch.where(vis, norm, zero),
        denom=aux.denom + vis.to(aux.denom.dtype),
        max_radii2d=torch.maximum(aux.max_radii2d, torch.where(vis, radii.to(torch.float32),
                                                                zero)),
    )


@torch.no_grad()
def densify_and_prune(
    params: GaussianParams,
    aux: GaussianAux,
    adam_mu: GaussianParams,
    adam_nu: GaussianParams,
    extent: float,
    cfg: DensifyConfig,
    frames: Optional[FaceFrames] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    clone_threshold: Optional[torch.Tensor] = None,
    split_threshold: Optional[torch.Tensor] = None,
):
    """One densify+prune event. Returns (params, aux, mu, nu, report).

    The split's unit normals: `noise` ([cap, 3] each, on the parameters'
    device) when given, else two draws from `generator` (a CPU generator;
    None: the global one). `clone_threshold`/`split_threshold` (tensors,
    0-dim or per Gaussian: smart densification's, innovation 2) replace
    the scalar `cfg.grad_threshold` for the clone and the split.
    """
    cap = params.capacity
    dev = params.means.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    grads = torch.where(aux.denom > 0,
                        aux.grad_accum / torch.clamp_min(aux.denom, 1.0), zero)
    grads = torch.nan_to_num(grads)
    max_wscale = torch.amax(world_scale_of(params, aux, frames), dim=1)
    small = cfg.percent_dense * extent
    thr_c = cfg.grad_threshold if clone_threshold is None else clone_threshold
    thr_s = cfg.grad_threshold if split_threshold is None else split_threshold

    # ---------------- clone ----------------
    sel_clone = aux.alive & (grads >= thr_c) & (max_wscale <= small)
    src = _padded_nonzero(sel_clone)
    dst = _padded_nonzero(~aux.alive)
    valid = (src >= 0) & (dst >= 0)
    params = _copy_rows(params, src, dst, valid)
    adam_mu = _copy_rows(adam_mu, src, dst, valid, zero_new=True)
    adam_nu = _copy_rows(adam_nu, src, dst, valid, zero_new=True)
    alive, binding = aux.alive.clone(), aux.binding.clone()
    alive[dst[valid]] = True
    binding[dst[valid]] = aux.binding[src[valid]]
    aux = dataclasses.replace(aux, alive=alive, binding=binding)
    n_cloned = _count(valid)
    dropped = _count((src >= 0) & (dst < 0))

    # ---------------- split ----------------
    # Cloned slots have zero accumulated grads, so they are never re-split.
    sel_split = aux.alive & (grads >= thr_s) & (max_wscale > small)
    src_s = _padded_nonzero(sel_split)
    dst_s = _padded_nonzero(~aux.alive)
    valid_s = (src_s >= 0) & (dst_s >= 0)
    src_v, dst_v = src_s[valid_s], dst_s[valid_s]

    # Two children sampled from the parent (world stds in local
    # coordinates for bound Gaussians, the reference's quirk).
    if noise is None:
        noise = tuple(torch.randn((cap, 3), generator=generator).to(dev) for _ in range(2))
    elif any(tuple(z.shape) != (cap, 3) for z in noise):
        raise ValueError(f"noise must be two [{cap}, 3] tensors of unit normals")
    stds = world_scale_of(params, aux, frames)
    R = quat_to_rotmat(quat_normalize(params.quats))
    child_a_means = torch.einsum("nij,nj->ni", R, noise[0] * stds) + params.means
    child_b_means = torch.einsum("nij,nj->ni", R, noise[1] * stds) + params.means
    shrink = torch.log(torch.tensor(cfg.split_shrink * cfg.split_factor, dtype=torch.float32))
    child_log_scales = params.log_scales - shrink.to(dev)

    # Child B → free slot (every field from the parent, then means/scales).
    params = _copy_rows(params, src_s, dst_s, valid_s)
    adam_mu = _copy_rows(adam_mu, src_s, dst_s, valid_s, zero_new=True)
    adam_nu = _copy_rows(adam_nu, src_s, dst_s, valid_s, zero_new=True)
    params.means[dst_v] = child_b_means[src_v]
    params.log_scales[dst_v] = child_log_scales[src_v]
    alive, binding = aux.alive.clone(), aux.binding.clone()
    alive[dst_v] = True
    binding[dst_v] = aux.binding[src_v]
    aux = dataclasses.replace(aux, alive=alive, binding=binding)

    # Child A overwrites the parent slot (only where child B landed; a
    # parent whose child B was dropped keeps its parameters). The parent
    # slot's moments restart from zero: the children are fresh appends.
    took = torch.zeros((cap,), dtype=torch.bool, device=dev)
    took[src_v] = True
    params = dataclasses.replace(
        params,
        means=torch.where(took[:, None], child_a_means, params.means),
        log_scales=torch.where(took[:, None], child_log_scales, params.log_scales),
    )

    def zero_took(m):
        return dataclasses.replace(m, **{
            f.name: torch.where(took.reshape((cap,) + (1,) * (x.dim() - 1)),
                                torch.zeros_like(x), x)
            for f in dataclasses.fields(m) for x in [getattr(m, f.name)]})

    adam_mu, adam_nu = zero_took(adam_mu), zero_took(adam_nu)
    n_split = _count(valid_s)
    dropped = dropped + _count((src_s >= 0) & (dst_s < 0))

    # ---------------- prune ----------------
    opacity = torch.sigmoid(params.logit_opacity[:, 0])
    prune = opacity < cfg.min_opacity
    if cfg.max_screen_size > 0:
        prune = prune | (aux.max_radii2d > cfg.max_screen_size)
        prune = prune | (torch.amax(world_scale_of(params, aux, frames), dim=1) > 0.1 * extent)
    prune = prune & aux.alive
    if frames is not None:
        # Keep faces populated: if a face would lose all its Gaussians, keep
        # all of that face's requested prunes (reference `prune_points`).
        f = frames.center.shape[0]
        cnt_alive = torch.zeros((f,), dtype=torch.int32, device=dev).index_add_(
            0, aux.binding, aux.alive.to(torch.int32))
        cnt_prune = torch.zeros((f,), dtype=torch.int32, device=dev).index_add_(
            0, aux.binding, prune.to(torch.int32))
        emptied = (cnt_alive - cnt_prune) <= 0
        prune = prune & ~emptied[aux.binding]
    n_pruned = _count(prune)
    aux = dataclasses.replace(
        aux,
        alive=aux.alive & ~prune,
        grad_accum=torch.zeros_like(aux.grad_accum),
        denom=torch.zeros_like(aux.denom),
        max_radii2d=torch.zeros_like(aux.max_radii2d),
    )
    report = DensifyReport(cloned=n_cloned, split=n_split, pruned=n_pruned, dropped=dropped)
    return params, aux, adam_mu, adam_nu, report


@torch.no_grad()
def reset_opacity(params: GaussianParams, adam_mu: GaussianParams, adam_nu: GaussianParams,
                  ceiling: float = 0.01):
    """Clamp opacity to <= `ceiling` and zero its Adam moments
    (`reset_opacity` + `replace_tensor_to_optimizer`,
    `scene/gaussian_model.py:283-286,340-353`)."""
    op = torch.sigmoid(params.logit_opacity)
    params = dataclasses.replace(
        params, logit_opacity=inverse_sigmoid(torch.clamp_max(op, ceiling)))
    adam_mu = dataclasses.replace(adam_mu, logit_opacity=torch.zeros_like(adam_mu.logit_opacity))
    adam_nu = dataclasses.replace(adam_nu, logit_opacity=torch.zeros_like(adam_nu.logit_opacity))
    return params, adam_mu, adam_nu


@torch.no_grad()
def grow_capacity(params: GaussianParams, aux: GaussianAux, adam_mu: GaussianParams,
                  adam_nu: GaussianParams, new_cap: int):
    """Pad every buffer to a larger capacity: zeros, dead slots."""
    old = params.capacity
    if new_cap <= old:
        return params, aux, adam_mu, adam_nu
    extra = new_cap - old

    def pad(x, fill=0):
        return torch.cat([x, torch.full((extra,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                        device=x.device)])

    def pad_all(obj):
        return dataclasses.replace(obj, **{f.name: pad(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})

    aux = GaussianAux(alive=pad(aux.alive, False), binding=pad(aux.binding),
                      grad_accum=pad(aux.grad_accum), denom=pad(aux.denom),
                      max_radii2d=pad(aux.max_radii2d))
    return pad_all(params), aux, pad_all(adam_mu), pad_all(adam_nu)
