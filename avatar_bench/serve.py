"""Serving: a viewer's closed loop of frames, each a fresh FLAME pose
through the renderer's captured frame, each waited for.

The traffic file gives the pose ranges, the trajectory's frequencies, how
many poses the tier budgets are probed on, the warm-up (frames to capture,
then seconds of frames before the window), how many answered frames the
check compares and within which first frames they are drawn, and how many
frames a traced stretch holds.
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from . import reference, scene
from .check import compare_frames
from .work import mean as mean_work


def _inputs(r):
    cfg, traffic = r.cfg, r.traffic
    gen = scene.generator(r.seed, r.device)
    arrays = scene.flame_arrays(cfg, gen)
    leaves, binding, alive = scene.gaussians(cfg, gen)
    shape = scene.shape_coeffs(cfg, gen)
    pose = scene.trajectory(cfg, traffic, traffic["poses"], gen)
    cam = scene.rig(dict(cfg, cameras=1), cfg["width"], cfg["height"], r.device)[0]
    return arrays, leaves, binding, alive, shape, pose, cam


def compared_frames(r, frames: int) -> list[int]:
    """The answered frames the check compares: drawn from the seed within
    the first `compare_within`, and the last."""
    gen = torch.Generator().manual_seed(r.seed)
    within = min(r.traffic["compare_within"], frames)
    picks = torch.randperm(within, generator=gen)[:r.traffic["compare"]].tolist()
    return sorted(set(picks) | {frames - 1})


def run(r) -> None:
    from . import program, trace

    traffic = r.traffic
    arrays, leaves, binding, alive, shape, pose, cam = _inputs(r)
    model = program.flame_model(arrays, r.cfg, r.device)
    params, aux = program.gaussian_state(leaves, binding, alive)
    pcam = program.camera(cam)
    n = traffic["poses"]
    inputs = [program.flame_params(shape, pose, i) for i in range(n)]
    probe = torch.linspace(0, n - 1, traffic["probe"]).round().long().tolist()
    tile_cfg = program.probe_tile_config(model, params, aux, [(inputs[i], pcam) for i in probe],
                                         r.cfg["tile"])
    rend = program.AvatarRenderer(model, params, aux, pcam, tile_cfg,
                                  sh_degree=r.cfg["sh_degree"], device=r.device)
    for i in range(traffic["warmup"]):          # eager, capture, replays
        rend.render(inputs[i % n])
    r.sync()
    # A fresh process replays slower until it switches, for good and at a
    # time of its own, to a faster pace (PERF.md §5): the window's own
    # frames run for `settle_s` first.
    settle, i = time.perf_counter() + traffic["settle_s"], 0
    while time.perf_counter() < settle:
        rend.render(inputs[i % n])
        r.sync()
        i += 1

    keep = set(compared_frames(r, traffic["compare_within"]))
    kept, lat, host = {}, [], []
    r.start_window()
    t_start = time.perf_counter()
    i = 0
    while True:
        fp = inputs[i % n]
        t0 = time.perf_counter()
        out = rend.render(fp)
        t1 = time.perf_counter()
        r.sync()
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        host.append(t1 - t0)
        if i in keep:
            kept[i] = out.color
        i += 1
        if t2 - t_start >= r.seconds:
            break
    r.window_s = t2 - t_start
    r.attempted = i
    kept[i - 1] = out.color
    r.memory_peak = r.peak_memory()
    r.e2e["frames_per_s"] = i / r.window_s
    r.e2e["frame_ms_p95"] = statistics.quantiles(lat, n=100)[94] * 1e3
    q = statistics.quantiles(lat, n=20)
    r.note(f"frames {i} in {r.window_s:.6f} s; frame ms p5/p25/median/p75/p95 "
           + "/".join(f"{x * 1e3:.4f}" for x in (q[0], q[4], q[9], q[14], q[18]))
           + f"; frames a second of the window {_per_second(lat)}")
    r.host_ms = [h * 1e3 for h in host]
    r.captures = rend.captures
    traced = [(i + j) % n for j in range(traffic["trace_frames"])] if r.traced else []
    if traced:
        def stretch():
            for j in traced:
                rend.render(inputs[j])
                r.sync()
            return len(traced)
        r.trace = trace.profile(stretch, r.device)
    # The program's state goes before the reference runs.
    compared = {k: kept[k] for k in sorted(kept) if k in keep or k == i - 1}
    del rend, model, params, aux, out, kept
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    r.finish_check(check(r, arrays, leaves, binding, alive, shape, pose, cam, compared))
    if traced:
        r.work = traced_work(r, arrays, leaves, binding, alive, shape, pose, cam, traced)


def _per_second(lat: list) -> list:
    """Frames completed in each whole second of the window."""
    out, t, n = [], 0.0, 0
    for x in lat:
        t += x
        n += 1
        if t >= len(out) + 1:
            out.append(n)
            n = 0
    return out


def reference_frame(arrays, leaves, binding, alive, shape, pose, cam, i, r, prec, flame=None):
    flame = flame or reference.Flame(arrays, r.device, prec)
    fp = dict(shape=shape, **{k: v[i % v.shape[0]][None] for k, v in pose.items()})
    bg = torch.zeros(3, device=r.device)
    return reference.render(flame, fp, leaves, binding, alive, cam, bg, r.cfg["tile"], prec)


def check(r, arrays, leaves, binding, alive, shape, pose, cam, answers: dict) -> dict:
    """Each compared frame against the reference's frame of the same pose."""
    prec = reference.Precision()
    flame = reference.Flame(arrays, r.device, prec)
    refs, work = {}, []
    for i in answers:
        f = reference_frame(arrays, leaves, binding, alive, shape, pose, cam, i, r, prec, flame)
        refs[i] = f.image
        work.append(f.work)
    r.window_work = mean_work(work)
    return compare_frames(r, answers, refs)


def traced_work(r, arrays, leaves, binding, alive, shape, pose, cam, frames: list) -> dict:
    """A frame's mean work over the traced frames, counted by the reference
    on their own poses."""
    prec = reference.Precision()
    flame = reference.Flame(arrays, r.device, prec)
    return mean_work([reference_frame(arrays, leaves, binding, alive, shape, pose, cam, i, r,
                                      prec, flame).work for i in frames])


def control(r, kind: str) -> dict:
    """The reference in TF32 put in the program's place, on the frames a
    run compares."""
    if kind != "tf32":
        raise ValueError(f"serving has no control {kind!r}")
    arrays, leaves, binding, alive, shape, pose, cam = _inputs(r)
    low = reference.precision(kind)
    flame = reference.Flame(arrays, r.device, low)
    answers = {i: reference_frame(arrays, leaves, binding, alive, shape, pose, cam, i, r, low,
                                  flame).image
               for i in compared_frames(r, r.traffic["compare_within"])}
    return check(r, arrays, leaves, binding, alive, shape, pose, cam, answers)
