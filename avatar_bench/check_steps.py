"""The training check of `train.check`, for modes whose reference step is a
function of a state and a unit of the run (a view, or the views of one
mesh step): the reference follows the first three units from the seed's
state, then the replayed unit from the program's state before it, and the
numbers of `check.py` compare the two. `control` runs the reference in the
program's place through the same units.
"""
from __future__ import annotations

import torch

from .check import leaf_gap, moving_leaves, rel


def _cpu(tree: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def check(r, st0, start: dict, replay: dict, step, rebuild) -> dict:
    """`start`: the program's `units` (three), `loss` of each, `grad1` (the
    first step's gradient), `leaves3` and `stats3` after the third;
    `replay`: its `unit`, the program's `state` before it (`rebuild` makes
    the reference's state of it), its `loss`, `leaves` and `grad`. `step(st,
    unit)` → (state, loss, gradients by leaf), the reference's."""
    st, losses = st0, []
    for i, unit in enumerate(start["units"]):
        st, loss, grads = step(st, unit)
        losses.append(loss)
        if i == 0:
            g1 = grads
    keep = moving_leaves(g1)
    grad_gap, grad_leaf = leaf_gap(start["grad1"], g1)
    change_gap, change_leaf = leaf_gap(
        {k: start["leaves3"][k] - st0.leaves[k].cpu() for k in st.leaves},
        {k: st.leaves[k] - st0.leaves[k] for k in st.leaves}, keep)
    stats_gap = rel(float(torch.linalg.norm(start["stats3"].double())),
                    float(torch.linalg.norm(st.grad_accum.double())))
    sta = rebuild(replay["state"])
    stb, loss_b, grads_b = step(sta, replay["unit"])
    keep_b = moving_leaves(grads_b)
    g_b, gl_b = leaf_gap(replay["grad"], grads_b)
    c_b, cl_b = leaf_gap({k: replay["leaves"][k] - replay["state"]["leaves"][k]
                          for k in stb.leaves},
                         {k: stb.leaves[k] - sta.leaves[k] for k in stb.leaves}, keep_b)
    loss_gaps = [rel(p, q) for p, q in zip(start["loss"] + [replay["loss"]], losses + [loss_b])]
    r.note(f"losses program {start['loss'] + [replay['loss']]} reference {losses + [loss_b]}; "
           f"worst leaves: gradient {grad_leaf} / {gl_b}, change {change_leaf} / {cl_b}; "
           f"leaves left out of the change: {sorted(set(g1) - keep)} / "
           f"{sorted(set(grads_b) - keep_b)}")
    numbers = dict(loss_gap=max(loss_gaps), grad_gap=max(grad_gap, g_b),
                   change_gap=max(change_gap, c_b), stats_gap=stats_gap)
    failed = sum(numbers[k] > r.limits[k] for k in numbers)
    return dict(numbers=numbers, failed=int(failed), compared=len(loss_gaps))


def control(r, st0, units: list, unit, stand_in, step, rebuild) -> dict:
    """`stand_in(st, unit)`, a control or a faulty reference, in the
    program's place: three `units`, then `unit` from the state after them;
    then `check` against the sound reference `step` as a run makes it."""
    st, start = st0, dict(units=units, loss=[])
    for i, u in enumerate(units):
        st, loss, grads = stand_in(st, u)
        start["loss"].append(loss)
        if i == 0:
            start["grad1"] = _cpu(grads)
    start["leaves3"] = _cpu(st.leaves)
    start["stats3"] = st.grad_accum.cpu()
    before = dict(leaves=_cpu(st.leaves), mu=_cpu(st.mu), nu=_cpu(st.nu), step=st.step,
                  grad_accum=st.grad_accum.cpu(), denom=st.denom.cpu())
    stb, loss_b, grads_b = stand_in(st, unit)
    replay = dict(unit=unit, state=before, loss=loss_b, leaves=_cpu(stb.leaves),
                  grad=_cpu(grads_b))
    return check(r, st0, start, replay, step, rebuild)
