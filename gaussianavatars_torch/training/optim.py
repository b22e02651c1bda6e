"""Per-group Adam with its moments held beside the parameters.

The reference uses one torch.optim.Adam with named param groups and
eps 1e-15 (`scene/gaussian_model.py:214-232`). As in the JAX package, the
moments here have the same structure as the parameters (dataclasses of
tensors, or the colour net's NamedTuple of tuples), so densification can
edit them row by row, and each leaf has its own learning rate (a float or
a 0-dim tensor, for the xyz schedule). Fields that are None are not
parameters and stay None.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

ADAM_EPS = 1e-15  # reference: Adam(l, lr=0.0, eps=1e-15)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor  # [] int32


def tree_map(fn, tree, *rest):
    """fn over the tensor leaves of `tree` (a tensor, a dataclass, a
    NamedTuple or a tuple of them), with the leaves at the same places in
    `rest` (trees of the same structure) as further arguments. None leaves
    and None dataclass fields stay None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree) if getattr(tree, f.name) is not None})
    if isinstance(tree, tuple):
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_leaves(tree) -> list:
    """The tensor leaves of `tree` in `tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def adam_init(params) -> AdamState:
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return AdamState(mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params), step=step)


@torch.no_grad()
def adam_update(params, grads, state: AdamState, lr_tree, b1: float = 0.9,
                b2: float = 0.999, eps: float = ADAM_EPS):
    """One Adam step. `grads` and `lr_tree` have the structure of `params`
    (`lr_tree`'s leaves are floats or 0-dim tensors). The bias corrections
    1 − b**t are computed in float32, as in the JAX package. Returns (new
    params, new AdamState); nothing is updated in place."""
    step = state.step + 1
    t = step.to(torch.float32)
    # The bases are filled on t's device: a tensor built from a Python
    # number would be a host-to-device copy, which synchronises.
    c1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
    c2 = 1.0 - torch.pow(torch.full_like(t, b2), t)
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * (g * g), state.nu, grads)
    new_params = tree_map(lambda p, m, v, lr: p - lr * (m / c1) / (torch.sqrt(v / c2) + eps),
                          params, mu, nu, lr_tree)
    return new_params, AdamState(mu=mu, nu=nu, step=step)


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000) -> torch.Tensor:
    """Log-linear LR decay with an optional sine delay: the 3DGS xyz schedule
    (`utils/general_utils.py:29-62`). `step` is a Python number or a tensor;
    returns a float32 0-dim tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    return delay * log_lerp
