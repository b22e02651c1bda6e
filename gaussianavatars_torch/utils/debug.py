"""Debug hooks: the reference's `--detect_anomaly` and finite checks.

The port of the JAX package's `utils/debug.py`:

  * `enable_nan_debugging()` — `torch.autograd.set_detect_anomaly`, which
    is what the reference's `--detect_anomaly` turns on
    (`train.py:423-424`): a backward that produces NaN raises and names
    the forward operation that made it;
  * `checked(fn)` — wraps a function so that a call returns (err, out),
    err the message of a non-finite output or None (the JAX version
    returns `checkify`'s error);
  * `assert_finite(tree)` — host-side finite check over a tree of tensors
    (the analogue of the reference's finite assertions under anomaly mode,
    `utils/graphics_utils.py:154-155`).
"""
from __future__ import annotations

import functools
from typing import Any

import torch

from ..training.checkpoint import flatten_state


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def non_finite_leaves(tree: Any) -> list:
    """Key paths (as `training.checkpoint.flatten_state` names them:
    `params/means`, …) of the floating-point leaves of `tree` that hold a
    NaN or an infinity. One host read for the whole tree."""
    leaves = [(k, v) for k, v in flatten_state(tree).items() if v.is_floating_point()]
    if not leaves:
        return []
    ok = torch.stack([torch.isfinite(v.detach()).all().to(leaves[0][1].device)
                      for _k, v in leaves]).cpu()
    return [k for (k, _v), good in zip(leaves, ok.tolist()) if not good]


def assert_finite(tree: Any, name: str = "tree") -> None:
    bad = non_finite_leaves(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def checked(fn):
    """`fn` wrapped so that a call returns (err, out): err is None, or the
    message naming `fn`'s non-finite outputs."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = non_finite_leaves(out)
        err = f"non-finite values in {getattr(fn, '__name__', 'output')}: {bad}" if bad else None
        return err, out

    return wrapped
