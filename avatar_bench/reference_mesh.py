"""The plain reference of one step of the ('data' × 'tile') mesh.

It composes `reference.py`'s functions, unedited: each data row's view runs
the reference's single-view step (`reference.train_step`, through
`train._step`) from the same state, and the rows are reduced as
`gaussianavatars_torch/parallel/sharded.py` reduces them: the gradients of
every leaf summed over the rows and divided by their number (the mean over
the cameras), the densification statistics' increments summed, the loss
the mean; then one Adam update of the mean gradient
(`reference_scene.adam_step`). The tile bands are a layout of the image
and leave the step's mathematics as it is. It imports nothing of the
program.
"""
from __future__ import annotations

import dataclasses

import torch

from . import reference, reference_scene, train


def row_steps(r, flame, st, views, gt_used, cams, prec, fault=""):
    """Each view's single-view step from `st`: [(loss, gradients,
    (accum, denom) increments)] in row order."""
    zero = dataclasses.replace(st, grad_accum=torch.zeros_like(st.grad_accum),
                               denom=torch.zeros_like(st.denom))
    out = []
    for v in views:
        new, loss, grads, _w = train._step(r, flame, zero, gt_used, cams, v, prec, fault)
        out.append((loss, grads, (new.grad_accum, new.denom)))
    return out


def reduce_rows(rows: list) -> tuple:
    """The mesh's reduction of the rows' steps: (mean loss, mean gradients,
    summed accum increment, summed denom increment)."""
    n = len(rows)
    loss = sum(x[0] for x in rows) / n
    grads = {k: sum(x[1][k] for x in rows) / n for k in rows[0][1]}
    accum = sum(x[2][0] for x in rows)
    denom = sum(x[2][1] for x in rows)
    return loss, grads, accum, denom


def step(r, flame, st, views, gt_used, cams, prec, fault=""):
    """One mesh step on `views` (one a data row): (new state, loss,
    gradients by leaf)."""
    if st.cache is not None or any(k.startswith("color_") for k in st.leaves):
        raise ValueError("the mesh reference does not implement the colour net or the "
                         "contrastive term")
    loss, grads, accum, denom = reduce_rows(row_steps(r, flame, st, views, gt_used, cams, prec,
                                                      fault))
    st = dataclasses.replace(st, grad_accum=st.grad_accum + accum, denom=st.denom + denom)
    opt = train._opt(r)
    lrs = reference.learning_rates(opt, st.step + 1, opt["spatial_lr_scale"])
    return reference_scene.adam_step(st, grads, lrs), loss, grads
