"""Adaptive density control: the densification statistics.

Only `add_densification_stats`, which the train step runs, is ported; the
densify/prune/opacity-reset events of the JAX package's `models/densify.py`
are not.
"""
from __future__ import annotations

import dataclasses

import torch

from .gaussians import GaussianAux


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
    g = screen_grad * torch.tensor([[width * 0.5, height * 0.5]], dtype=screen_grad.dtype,
                                   device=screen_grad.device)
    norm = torch.sqrt(torch.sum(g * g, dim=-1))
    zero = torch.zeros((), dtype=torch.float32, device=norm.device)
    return dataclasses.replace(
        aux,
        grad_accum=aux.grad_accum + torch.where(vis, norm, zero),
        denom=aux.denom + vis.to(aux.denom.dtype),
        max_radii2d=torch.maximum(aux.max_radii2d, torch.where(vis, radii.to(torch.float32),
                                                                zero)),
    )
