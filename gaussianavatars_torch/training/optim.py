"""Per-group Adam with its moments held beside the parameters.

The reference uses one torch.optim.Adam with named param groups and
eps 1e-15 (`scene/gaussian_model.py:214-232`). As in the JAX package, the
moments here have the same structure as the parameters (dataclasses of
tensors), so densification can edit them row by row, and each field has
its own learning rate (a float or a 0-dim tensor, for the xyz schedule).
Fields that are None are not parameters and stay None.
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


def _tensor_fields(obj) -> dict:
    """A dataclass's fields that hold tensors (None fields are left out)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def adam_init(params) -> AdamState:
    fields = _tensor_fields(params)
    step = torch.zeros((), dtype=torch.int32, device=next(iter(fields.values())).device)
    return AdamState(
        mu=dataclasses.replace(params, **{k: torch.zeros_like(v) for k, v in fields.items()}),
        nu=dataclasses.replace(params, **{k: torch.zeros_like(v) for k, v in fields.items()}),
        step=step,
    )


@torch.no_grad()
def adam_update(params, grads, state: AdamState, lr_tree, b1: float = 0.9,
                b2: float = 0.999, eps: float = ADAM_EPS):
    """One Adam step. `grads` and `lr_tree` have the fields of `params`.
    The bias corrections 1 − b**t are computed in float32, as in the JAX
    package. Returns (new params, new AdamState); nothing is updated in
    place."""
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in _tensor_fields(params).items():
        g = getattr(grads, k)
        m = b1 * getattr(state.mu, k) + (1 - b1) * g
        v = b2 * getattr(state.nu, k) + (1 - b2) * (g * g)
        mhat = m / c1
        vhat = v / c2
        new_p[k] = p - getattr(lr_tree, k) * mhat / (torch.sqrt(vhat) + eps)
        new_m[k] = m
        new_v[k] = v
    return dataclasses.replace(params, **new_p), AdamState(
        mu=dataclasses.replace(state.mu, **new_m),
        nu=dataclasses.replace(state.nu, **new_v), step=step)


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
