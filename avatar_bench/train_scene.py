"""Training an unbound scene: the recipe's steps after densification ends,
chunks of steps through the program's training chunk with no FLAME model
(`make_train_chunk(None, …)`), each step one view of a seeded shuffle over
the training views.

As `train.py` does for the avatar: set-up builds one state and one chunk,
runs the check's three eager steps, captures, takes one replayed step for
the check, runs chunks for the traffic's `settle_s` seconds, and hands the
same chunk and state to the window. The tier budgets are the program's
own, sized to cover every training view (`render.probe_tile_config_views`;
a program without it cannot run this cell, and the run stops before it
makes its inputs). Every step of the window whose binning dropped a tile
(`budget_overflow` above 0) counts as failed. A traced run also reads the
program's binning counts over the traced chunk (`ops/sort_binning`:
expansion slots, live pairs) into `run.binning`. The reference
(`reference_scene.py`) follows the first three steps from the seed's
inputs and the replayed step from the program's state before it.
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import torch

from . import check_steps, reference, reference_scene, scene, scene_3dgs
from .reference import GAUSS_LEAVES
from .train import Schedule, _cpu
from .work import mean as mean_work


def _inputs(r):
    gen = scene.generator(r.seed, r.device)
    leaves, binding, alive = scene_3dgs.gaussians(r.cfg, gen)
    cams = scene_3dgs.rig(r.cfg, r.device)
    gt = scene_3dgs.ground_truth(r.cfg, gen)
    return leaves, binding, alive, cams, gt


def _opt(r) -> dict:
    return dict(r.cfg["opt"], spatial_lr_scale=r.cfg["spatial_lr_scale"])


def _leaves(tree) -> dict:
    return {k: getattr(tree, k) for k in GAUSS_LEAVES}


def _program():
    """The program's modules this mode drives; a RuntimeError when the
    program cannot size tier budgets over many views."""
    from gaussianavatars_torch import render
    from gaussianavatars_torch.ops import sort_binning

    if not hasattr(render, "probe_tile_config_views"):
        raise RuntimeError("the program has no render.probe_tile_config_views: it cannot size "
                           "tier budgets that cover every training view")
    return render, sort_binning


def _binning(sort_binning) -> dict | None:
    """The program's binning counts now (slots, live pairs, dropped tiles);
    None from a program that keeps none."""
    counts = getattr(sort_binning, "COUNTS", None)
    pairs = getattr(sort_binning, "PAIRS", None)
    got = None if pairs is None else pairs.read()
    if counts is None or got is None:
        return None
    return dict(slots=counts["expansion_slots"], plans=counts["plans"], **got)


def run(r) -> None:
    render, sort_binning = _program()
    from . import program, trace
    from gaussianavatars_torch.training.trainer import init_train_state

    cfg, traffic = r.cfg, r.traffic
    leaves, binding, alive, cams, gt = _inputs(r)
    pcfg = program.program_config(cfg)
    params, aux = program.gaussian_state(leaves, binding, alive)
    pcams = [program.camera(c) for c in cams]
    stacked = program.rig_cameras(cams)
    sched = Schedule(r.seed, len(cams))
    tile_cfg = render.probe_tile_config_views(None, params, aux, [(None, c) for c in pcams],
                                              cfg["tile"], cfg["tile"])
    state = init_train_state(params, aux, pcfg)
    start_step = cfg["start_iteration"]
    state = dataclasses.replace(state, adam=state.adam._replace(
        step=torch.full((), start_step, dtype=torch.int32, device=r.device)))
    chunk = program.make_train_chunk(None, pcfg, tile_cfg, cfg["spatial_lr_scale"])
    bg = torch.zeros(3, device=r.device)
    sh = cfg["sh_degree"]

    def call(st, views):
        idx = torch.tensor(views, device=r.device)
        return chunk(st, gt, views, program.camera_rows(stacked, idx), [0] * len(views), bg, sh)

    views = sched.take(3)
    s1, m1 = call(state, views[:1])
    start = dict(units=views, loss=[float(m1["loss"][0])],
                 grad1={k: v.detach().cpu() / 0.1 for k, v in _leaves(s1.adam.mu).items()})
    s3, m3 = call(s1, views[1:])
    start["loss"] += m3["loss"].tolist()
    start["leaves3"] = _cpu(_leaves(s3.params))
    start["stats3"] = s3.aux.grad_accum.detach().cpu()
    st, _ = call(s3, sched.take(traffic["steps_per_call"]))
    before = dict(leaves=_cpu(_leaves(st.params)), mu=_cpu(_leaves(st.adam.mu)),
                  nu=_cpu(_leaves(st.adam.nu)), step=int(st.adam.step),
                  grad_accum=st.aux.grad_accum.detach().cpu(), denom=st.aux.denom.detach().cpu())
    view = sched.take(1)
    st, mr = call(st, view)
    replay = dict(unit=view[0], state=before, loss=float(mr["loss"][0]),
                  leaves=_cpu(_leaves(st.params)),
                  grad={k: (v.detach().cpu() - 0.9 * before["mu"][k]) / 0.1
                        for k, v in _leaves(st.adam.mu).items()})
    r.sync()

    k = traffic["steps_per_call"]
    settle = time.perf_counter() + traffic["settle_s"]
    while time.perf_counter() < settle:
        st, m = call(st, sched.take(k))
        float(m["loss"][-1])
    overflowed = torch.zeros((), dtype=torch.int64, device=r.device)
    host = []
    r.start_window()
    t_start = time.perf_counter()
    steps = 0
    while True:
        t0 = time.perf_counter()
        st, m = call(st, sched.take(k))
        host.append(time.perf_counter() - t0)
        overflowed += (m["budget_overflow"] > 0).sum()
        last = float(m["loss"][-1])
        t1 = time.perf_counter()
        steps += k
        if t1 - t_start >= r.seconds:
            break
    r.window_s = t1 - t_start
    r.attempted = steps
    r.memory_peak = r.peak_memory()
    r.e2e["train_images_per_s"] = steps / r.window_s
    r.host_ms = [h * 1e3 for h in host]
    r.captures = chunk.captures
    dropped = int(overflowed)
    spec = tile_cfg.tier_spec(cfg["capacity"])
    r.note(f"steps {steps} in {r.window_s:.6f} s, chunk call ms median "
           f"{statistics.median(host) * 1e3:.6f}, last loss {last:.6f}, steps that dropped "
           f"tiles {dropped}; tiers {spec.tiers}, expansion {spec.expansion_size(cfg['capacity'])}"
           f" slots; chunk call ms " + " ".join(f"{h * 1e3:.1f}" for h in host))
    traced = [sched.take(k) for _ in range(traffic["trace_calls"])] if r.traced else []
    if traced:
        at_trace = _cpu(_leaves(st.params))
        counts0 = _binning(sort_binning)

        def stretch():
            nonlocal st
            for vs in traced:
                st, _m = call(st, vs)
            return len(traced) * k
        r.trace = trace.profile(stretch, r.device)
        counts1 = _binning(sort_binning)
        r.binning = None if counts0 is None else {key: counts1[key] - counts0[key]
                                                  for key in counts0}
        r.note(f"binning over the traced chunk: {r.binning}")
    used = sorted({*start["units"], replay["unit"]})
    gt_used = {v: gt[v].clone() for v in used}
    del st, s1, s3, m, m1, m3, mr, chunk, params, aux, state, gt
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    r.finish_check(check(r, leaves, alive, cams, gt_used, start, replay))
    r.failed += dropped
    if traced:
        every = traffic["trace_work_every"]
        r.work = traced_work(r, at_trace, alive, cams,
                             [v for vs in traced for v in vs][::every])


def traced_work(r, at: dict, alive, cams, views: list) -> dict:
    """A step's mean compositor work over `views` (the traced steps' views,
    every `trace_work_every`-th), counted by the reference's forward at the
    program's state when the stretch began."""
    g = {k: at[k].to(r.device) for k in GAUSS_LEAVES}
    bg = torch.zeros(3, device=r.device)
    return mean_work([reference_scene.render(g, alive, cams[v], bg, r.cfg["tile"]).work
                      for v in views])


def _reference(r, leaves, alive, cams, gt_used, prec, fault=""):
    """The reference's (initial state, step(state, view), rebuild(saved
    program state)) for `check_steps`."""
    binding = torch.zeros(alive.shape, dtype=torch.int64, device=alive.device)
    lv = {k: leaves[k] for k in GAUSS_LEAVES}
    zeros = torch.zeros(binding.shape, device=binding.device)
    st0 = reference.TrainState(
        leaves=lv, mu={k: torch.zeros_like(v) for k, v in lv.items()},
        nu={k: torch.zeros_like(v) for k, v in lv.items()}, step=r.cfg["start_iteration"],
        binding=binding, alive=alive, shape=None, grad_accum=zeros, denom=zeros.clone())
    bg = torch.zeros(3, device=r.device)

    def step(st, v):
        gt = gt_used[v].to(r.device).float() / 255.0
        st, loss, grads, _w = reference_scene.train_step(st, gt, cams[v], bg, _opt(r),
                                                         r.cfg["tile"], prec, fault)
        return st, loss, grads

    def rebuild(a):
        dev = lambda t: {k: x.to(r.device) for k, x in t.items()}  # noqa: E731
        return reference.TrainState(
            leaves=dev(a["leaves"]), mu=dev(a["mu"]), nu=dev(a["nu"]), step=int(a["step"]),
            binding=binding, alive=alive, shape=None, grad_accum=a["grad_accum"].to(r.device),
            denom=a["denom"].to(r.device))
    return st0, step, rebuild


def check(r, leaves, alive, cams, gt_used, start, replay) -> dict:
    """`check_steps.check` against `reference_scene`."""
    st0, step, rebuild = _reference(r, leaves, alive, cams, gt_used, reference.Precision())
    return check_steps.check(r, st0, start, replay, step, rebuild)


def control(r, kind: str) -> dict:
    """A stand-in for the program: the reference in TF32 ("tf32"), or in
    float32 with the loss over the top half of the image only
    ("half_image"), through the same steps; then the check as a run makes
    it."""
    if kind not in ("tf32", "half_image"):
        raise ValueError(f"training has no control {kind!r}")
    leaves, _binding, alive, cams, gt = _inputs(r)
    prec = reference.precision("tf32" if kind == "tf32" else "float32")
    sched = Schedule(r.seed, len(cams))
    views = sched.take(3)
    sched.take(r.traffic["steps_per_call"])
    view = sched.take(1)[0]
    gt_used = {v: gt[v].clone() for v in {*views, view}}
    del gt
    st0, stand_in, _ = _reference(r, leaves, alive, cams, gt_used, prec,
                                  "half_image" if kind == "half_image" else "")
    _, step, rebuild = _reference(r, leaves, alive, cams, gt_used, reference.Precision())
    return check_steps.control(r, st0, views, view, stand_in, step, rebuild)
