"""Full training-state checkpoints (resume-capable), in the JAX package's
format.

The port of the JAX package's `training/checkpoint.py` (the reference's
`torch.save((gaussians.capture(), iteration))` → `chkpnt{iter}.pth`,
`train.py:287-289`): the whole `TrainState` — Gaussian parameters, alive
and binding masks, densification statistics, the Adam moments of the
Gaussians and of FLAME, and with the innovations the colour net, its Adam
moments and the contrastive cache — flattened by key path into one
`.npz`, with the JAX package's key-path names (`params/means`,
`adam/mu/means`, `adam/step`, `flame/expr`, `flame_static/shape`,
`color_net/weights/0`, `color_adam/mu/biases/2`, `color_adam/step`,
`contrastive/images`, `contrastive/count`, …), so that a checkpoint
written by either package loads into the other.

The JAX state's PRNG `key` is skipped on load. The port's random
generator is saved under `__torch_generator__`; for the JAX loader, which
expects every leaf of its template, the port also writes `key`: the raw
bits of JAX's default PRNG key for the generator's seed, `[0, seed]`.
Shapes are checked against the template; values take the template's
dtypes (the JAX package's int32 `binding` becomes the port's int64).
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

GENERATOR_KEY = "__torch_generator__"
ITERATION_KEY = "__iteration__"


def _children(obj):
    """(name, child) of a dataclass, a NamedTuple, a dict or a tuple (named
    by index, as JAX names a sequence's leaves), None children left out."""
    if dataclasses.is_dataclass(obj):
        items = [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        items = [(str(k), v) for k, v in obj.items()]
    elif hasattr(obj, "_asdict"):
        items = list(obj._asdict().items())
    else:
        items = [(str(i), x) for i, x in enumerate(obj)]
    return [(k, v) for k, v in items if v is not None and not isinstance(v, torch.Generator)]


def flatten_state(state) -> dict:
    """{key path: tensor} of every tensor leaf, in field order."""
    out = {}

    def walk(obj, prefix):
        if isinstance(obj, torch.Tensor):
            out[prefix] = obj
            return
        for name, child in _children(obj):
            walk(child, f"{prefix}/{name}" if prefix else name)

    walk(state, "")
    return out


def _rebuild(obj, prefix, leaves):
    if isinstance(obj, torch.Tensor):
        return leaves[prefix]
    new = {name: _rebuild(child, f"{prefix}/{name}" if prefix else name, leaves)
           for name, child in _children(obj)}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **new)
    if hasattr(obj, "_replace"):
        return obj._replace(**new)
    return tuple(new[str(i)] for i in range(len(obj)))


def save_train_state(path: str, state, iteration: int) -> None:
    out = {ITERATION_KEY: np.asarray(iteration)}
    for key, leaf in flatten_state(state).items():
        out[key] = leaf.detach().cpu().numpy()
    gen = getattr(state, "generator", None)
    if gen is not None:
        out[GENERATOR_KEY] = gen.get_state().numpy()
        out["key"] = np.asarray([0, gen.initial_seed() & 0xFFFFFFFF], np.uint32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **out)


def load_train_state(path: str, template) -> Tuple[object, int]:
    """Restore into the structure of `template` (a TrainState with the same
    capacity and options, on the device to restore to). Returns (state,
    iteration)."""
    data = np.load(path, allow_pickle=False)
    iteration = int(data[ITERATION_KEY])
    leaves = {}
    for key, tleaf in flatten_state(template).items():
        if key not in data.files:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = data[key]
        if arr.shape != tuple(tleaf.shape):
            raise ValueError(
                f"checkpoint leaf {key} has shape {arr.shape}, template "
                f"{tuple(tleaf.shape)} — was the capacity or config changed?")
        leaves[key] = torch.as_tensor(arr).to(device=tleaf.device, dtype=tleaf.dtype)
    state = _rebuild(template, "", leaves)
    gen = getattr(template, "generator", None)
    if gen is not None and GENERATOR_KEY in data.files:
        restored = torch.Generator()
        restored.set_state(torch.as_tensor(data[GENERATOR_KEY]))
        state = dataclasses.replace(state, generator=restored)
    return state, iteration


def latest_checkpoint(model_path: str) -> Optional[str]:
    """The `chkpnt{iter}.npz` with the highest iteration."""
    best, best_it = None, -1
    if not os.path.isdir(model_path):
        return None
    for name in os.listdir(model_path):
        m = re.fullmatch(r"chkpnt(\d+)\.npz", name)
        if m and int(m.group(1)) > best_it:
            best_it = int(m.group(1))
            best = os.path.join(model_path, name)
    return best
