"""The numbers that decide `correct`, each held to its limit
(`limits/<workload>.json`, set from the readings that `PERF.md` lists).

Frames: each compared frame's mean and largest absolute difference from
the reference's frame, over its pixels and channels; the worst frame's
are the cell's numbers. Training: the largest relative gap of a step's
loss; the worst leaf's gap between the program's and the reference's norm
of the first gradient (as Adam received it) and of the parameters' change,
each against the larger of that leaf's reference norm and the median
leaf's; the relative gap of the densification statistics' norm.
"""
from __future__ import annotations

import statistics

import torch


def compare_frames(r, answers: dict, refs: dict) -> dict:
    worst = {"frame_mae": 0.0, "frame_max": 0.0}
    failed = 0
    for i, img in answers.items():
        d = (img.to(refs[i].device).float() - refs[i]).abs()
        got = {"frame_mae": float(d.mean()), "frame_max": float(d.max())}
        if not all(got[k] <= r.limits[k] for k in got):
            failed += 1
        worst = {k: max(worst[k], got[k]) for k in worst}
    return dict(numbers=worst, failed=failed, compared=len(answers))


def norms(tree: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double())) for k, v in tree.items()}


def leaf_gap(got: dict, want: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's |‖got‖ − ‖want‖| against the larger of ‖want‖ and
    the median leaf's ‖want‖: (gap, leaf)."""
    g, w = norms(got), norms(want)
    names = [k for k in w if keep is None or k in keep]
    med = statistics.median(w[k] for k in names)
    gaps = {k: abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in names}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def moving_leaves(ref_grad: dict) -> set:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's; the others move under Adam by round-off alone."""
    w = norms(ref_grad)
    med = statistics.median(w.values())
    return {k for k, v in w.items() if v > 1e-3 * med}


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)
