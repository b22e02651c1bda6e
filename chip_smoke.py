#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints a line; a failing phase raises and the exit code is
non-zero):

  1. device   — card name and count, `nvidia-smi` name and power limit,
                torch/CUDA versions and both TF32 flags (forced off);
  2. build    — every kernel under gaussianavatars_torch/csrc, one nvcc
                each, all started together;
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at a small scene (128×256, 4096 splats: multi-chunk walks
                and early stops) and at the full-size frame's table (also
                the first training frame's table); the backward kernel with
                fixed-seed cotangents, each row within 1e-4 of its largest
                plain value and the plain version's zero slots exact;
  4. slice    — the benchmark scene at full width (802×550, 90,090 FLAME-
                bound Gaussians, SH degree 3, 32×32 tiles, probed tier
                budgets), rendered frame after frame through
                `AvatarRenderer.render` with the jaw moving every frame; the
                compositor must launch once per frame; one full frame is
                checked against the plain compositor and a small frame
                against the dense ground truth;
  5. numbers  — frames/s, per-stage milliseconds, peak memory;
  6. train    — the FLAME-bound training step at the same full width
                (`training.trainer.make_train_step`, SH degree 3, `Config`
                defaults with 100 shape and 50 expression parameters, two
                timesteps) towards a target rendered with the jaw moved
                and the SH DC perturbed: 5 warm-up and 50 timed steps; each
                compositor launches once per step, no budget overflow, the
                loss finite and falling, every gradient and parameter
                finite, dead slots unchanged bit for bit, and one step's
                gradients equal to those with the plain backward compositor;
  7. train numbers — steps/s, device ms per stage (torch.profiler ranges),
                device busy share and ops per step, the backward kernel
                against its plain version and its bound, peak memory.

The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without a CUDA device it prints no result
and exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 300          # frames of the timed main-path run
N_STAGE_FRAMES = 100    # frames of the per-stage breakdown
N_KERNEL_REPS = 50      # kernel launches per timing
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
# Float operations per (pair, pixel) evaluation of composite_pairs_fwd.cu:
# dx, dy (2); power (9); expf (1); op·e (1); the 0.99 clamp (1); 1 - alpha
# (1); T·(1 - alpha) (1); alpha·T (1); three colour multiply-adds (6).
FLOPS_PER_EVAL = 24
BYTES_PER_PAIR = 36     # nine float32 rows of the pair table
N_PROFILE_FRAMES = 20  # frames under torch.profiler
STAGES = ("flame_binding", "projection_sh", "binning", "compositor")
KERNEL_SOURCE = "gaussianavatars_torch/csrc/composite_pairs_fwd.cu"
REPLACES = "gaussianavatars_tpu/ops/pallas/composite_pairs.py:236"
BWD_KERNEL_SOURCE = "gaussianavatars_torch/csrc/composite_pairs_bwd.cu"
BWD_REPLACES = "gaussianavatars_tpu/ops/pallas/composite_pairs.py:620"
# Float operations per (pair, pixel) evaluation of composite_pairs_bwd.cu:
# dx, dy (2); power (9); expf (1); op·e (1); the 0.99 clamp (1); gc (5);
# 1 - alpha and T·(1 - alpha) (2); w (1); w·gc and the prefix q (2);
# G - q (1); 1/(1 - alpha) (1); d_alpha (3); d_p (1); the products
# d_p·{x, y, x², xy, y²} and w·g_c (8); one add of each of the nine sums
# over the tile's pixels (9).
BWD_FLOPS_PER_EVAL = 48
BWD_REL_TOL = 1e-4       # per row: max |kernel - plain| <= 1e-4 · max |plain|
N_TRAIN_WARMUP = 5
N_TRAIN_STEPS = 50       # timed steps, as the JAX package's bench.py times
N_PROFILE_STEPS = 10     # steps under torch.profiler
TRAIN_TIMESTEPS = 2
TRAIN_RANGES = ("train/geometry_fwd", "sort_gather/fwd", "train/image_fwd",
                "train/image_bwd", "sort_gather/bwd", "train/densify_stats",
                "train/geometry_bwd", "train/adam")


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn` over `reps` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()
    print(smi, flush=True)
    info = {
        "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }
    log("device", **info)
    return info


def phase_build() -> None:
    from gaussianavatars_torch import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build()
    log("build", seconds=time.perf_counter() - t0,
        kernels={k: v["seconds"] for k, v in built.items()})
    for name, v in built.items():
        for line in v["ptxas"].splitlines():
            print(f"[build] {name}: {line.strip()}", flush=True)


def parity_table(dev):
    """The parity scene of the JAX package's benchmark (128×256, 4096 splats,
    32×32 tiles), binned by the port. Returns the scene and its table."""
    from gaussianavatars_torch.data.cameras import look_at_camera
    from gaussianavatars_torch.ops.projection import project_from_params
    from gaussianavatars_torch.ops.rasterize_sorted import depth_key, sort_gather
    from gaussianavatars_torch.ops.sort_binning import TierSpec, bbox_tiles

    h, w, th, tw, n = 128, 256, 32, 32, 4096
    g = torch.Generator().manual_seed(3)
    means = torch.randn((n, 3), generator=g) * torch.tensor([0.4, 0.3, 0.3]) \
        + torch.tensor([0.0, 0.0, 2.5])
    scales = torch.empty((n, 3)).uniform_(0.005, 0.06, generator=g)
    quats = torch.randn((n, 4), generator=g)
    opacity = torch.empty((n,)).uniform_(0.3, 0.98, generator=g)
    colors = torch.rand((n, 3), generator=g)
    means, scales, quats, opacity, colors = (
        x.to(dev) for x in (means, scales, quats, opacity, colors))
    cam = look_at_camera(eye=np.zeros(3), target=np.array([0.0, 0.0, 2.5]), fovy=0.9,
                         width=w, height=h, device=dev)
    proj = project_from_params(means, scales, quats, cam)
    opac = torch.where(proj.mask, opacity, torch.zeros_like(opacity))
    spec = TierSpec(base=2, tiers=((4096, 64),))
    tminx, tminy, bw, ntiles, nty, ntx = bbox_tiles(proj, h, w, th, tw, opacity=opac)
    ntiles_eff = torch.where(proj.mask, ntiles, torch.zeros_like(ntiles))
    dataT, plan = sort_gather((nty * ntx, ntx, spec), proj.mean2d, proj.conic, colors, opac,
                              (tminx, tminy, bw, ntiles_eff, depth_key(proj.depth)))
    if int(plan.budget_overflow) != 0:
        raise AssertionError("parity scene: tier budget overflow")
    scene = dict(means=means, scales=scales, quats=quats, colors=colors, opac=opac,
                 proj=proj, cam=cam, spec=spec, h=h, w=w, th=th, tw=tw)
    return scene, (dataT, plan.tile_starts, plan.counts, th, tw, ntx)


def compare_kernel(label: str, table) -> dict:
    """Kernel vs plain version on the same card tensors."""
    from gaussianavatars_torch.ops.composite_pairs import (
        STOP_NEVER, fwd_call_pairs, fwd_call_pairs_reference,
    )

    dataT, starts, counts, th, tw, ntx = table
    acc, tfin, stop = fwd_call_pairs(*table)
    torch.cuda.synchronize()
    r_acc, r_tfin, r_stop = fwd_call_pairs_reference(*table)
    err_acc = float((acc - r_acc).abs().max())
    err_t = float((tfin - r_tfin).abs().max())
    tile_max_equal = bool(torch.equal(stop.max(dim=1).values, r_stop.max(dim=1).values))
    stop_mismatch = int((stop != r_stop).sum())
    walked = torch.where(stop == STOP_NEVER, counts[:, None], stop - (starts % 128)[:, None])
    past_first_chunk = bool((walked > th * tw).any())  # the kernel stages P pairs a chunk
    res = dict(max_abs_err_acc=err_acc, max_abs_err_t_final=err_t,
               stop_tile_max_equal=tile_max_equal, stop_elements_differing=stop_mismatch,
               stopped_pixel_share=float((stop != STOP_NEVER).float().mean()),
               max_tile_count=int(counts.max()), walk_past_first_chunk=past_first_chunk,
               total_pairs=int(counts.sum()))
    log(f"kernels/{label}", **res)
    if not (err_acc <= 1e-5 and err_t <= 1e-5 and tile_max_equal):
        raise AssertionError(f"composite_pairs_fwd disagrees with its plain version: {res}")
    return dict(res, outputs=(acc, tfin, stop))


COMPOSITOR_KERNELS = ("composite_pairs_fwd_kernel", "composite_pairs_bwd_kernel")


def range_device_us(e) -> float:
    """Device microseconds of the kernels a host range owns (its own and
    its child operators'), the compositor kernels left out. They are
    launched through ctypes, so whether a range owns them depends on the
    operator around the launch (an autograd Function's does, a bare range
    does not); the callers count them by name instead, once."""
    own = sum(k.duration for k in e.kernels if not any(n in k.name for n in COMPOSITOR_KERNELS))
    return own + sum(range_device_us(c) for c in e.cpu_children)


def profile_device(stages, renderer, poses, frames_per_s: float) -> dict:
    """Device time per frame from torch.profiler: per stage (the `stage/*`
    ranges of `stages`), and the kernels of `renderer.render`, whose sum
    against the unprofiled frame time gives the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    with profile(activities=acts) as prof:
        for i in range(N_PROFILE_FRAMES):
            stages(poses[i])
        torch.cuda.synchronize()
    # The host-side range of each stage sums the device time of the kernels
    # launched inside it. Its device-side twin (same name) spans the stage on
    # the device timeline, idle gaps included, and is left out.
    # The compositor kernel is counted by its name (see range_device_us).
    stage_dev = dict.fromkeys(STAGES, 0.0)
    for e in prof.events():
        if e.device_type == cpu and e.name.startswith("stage/"):
            stage_dev[e.name[len("stage/"):]] += range_device_us(e) / 1e3 / N_PROFILE_FRAMES
        elif e.device_type == cuda and "composite_pairs_fwd_kernel" in e.name:
            stage_dev["compositor"] += e.time_range.elapsed_us() / 1e3 / N_PROFILE_FRAMES
    with profile(activities=acts) as prof:
        for i in range(N_PROFILE_FRAMES):
            renderer.render(poses[i])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == cuda and not e.is_user_annotation]
    if not kernels:
        return {"device_time": "not measured: the profiler recorded no device events"}
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / N_PROFILE_FRAMES
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        stage_device_ms=stage_dev,
        device_busy_ms_per_frame=busy_ms,
        device_busy_share=busy_ms * frames_per_s / 1e3,
        device_ops_per_frame=len(kernels) / N_PROFILE_FRAMES,
        top_device_ms_per_frame={k[:80]: v / 1e3 / N_PROFILE_FRAMES for k, v in top},
    )


def compositor_bound(starts, counts, stop, p: int) -> dict:
    """Least time for this frame's compositing on an H100 SXM: walked pairs
    per tile (up to the last pixel's stop, or the whole segment) × P pixel
    evaluations, against the bytes those pairs and the outputs take."""
    from gaussianavatars_torch.ops.composite_pairs import STOP_NEVER

    local = stop.long() - (starts.long() % 128)[:, None]
    all_stopped = (stop != STOP_NEVER).all(dim=1)
    walked = torch.where(all_stopped, torch.minimum(local.max(dim=1).values + 1, counts.long()),
                         counts.long())
    pairs = int(walked.sum())
    nt = starts.shape[0]
    ops = pairs * p * FLOPS_PER_EVAL
    nbytes = pairs * BYTES_PER_PAIR + nt * 8 + nt * p * 5 * 4
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return dict(walked_pairs=pairs, ops=ops, bytes=nbytes,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def cotangents(nt: int, p: int, dev, seed: int):
    """Fixed-seed cotangents (g_acc [NT, P, 3], g_t [NT, P]): the gradient
    of Σ acc·w1 + Σ t_final·w2 with normal weights."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((nt, p, 3), generator=g).to(dev),
            torch.randn((nt, p), generator=g).to(dev))


def walked_pairs(starts, counts, stop) -> torch.Tensor:
    """Pairs the backward walks per tile: min(count, max(stop) - head + 1)."""
    head = starts.long() % 128
    return torch.minimum(counts.long(), stop.long().max(dim=1).values - head + 1).clamp_min(0)


def compare_bwd_kernel(label: str, table, fwd_outputs, seed: int) -> dict:
    """Backward kernel vs its plain version on the same card tensors."""
    from gaussianavatars_torch.ops.composite_pairs import (
        bwd_call_pairs, bwd_call_pairs_reference,
    )

    dataT, starts, counts, th, tw, ntx = table
    acc, tfin, stop = fwd_outputs
    g_acc_t, g_t = cotangents(starts.shape[0], th * tw, dataT.device, seed)
    args = (dataT, starts, counts, acc, tfin, stop, g_acc_t, g_t, th, tw, ntx)
    d = bwd_call_pairs(*args)
    torch.cuda.synchronize()
    r = bwd_call_pairs_reference(*args)
    row_err = (d[:9] - r[:9]).abs().amax(dim=1)
    row_max = r[:9].abs().amax(dim=1)
    rel = (row_err / row_max).tolist()
    plain_zero = (r == 0).all(dim=0)
    zeros_exact = not bool(d[:, plain_zero].any()) and not bool(d[9:].any())
    walked = walked_pairs(starts, counts, stop)
    res = dict(max_abs_err=float(row_err.max()), rel_err_per_row=rel,
               zeros_exact=zeros_exact, zero_slots=int(plain_zero.sum()),
               walked_pairs=int(walked.sum()), longest_walk=int(walked.max()),
               walks_cut_by_stops=int((walked < counts.long()).sum()))
    log(f"kernels/bwd_{label}", **res)
    if not (max(rel) <= BWD_REL_TOL and zeros_exact):
        raise AssertionError(f"composite_pairs_bwd disagrees with its plain version: {res}")
    return dict(res, args=args)


def bwd_bound(starts, counts, stop, p: int, n_cols=None) -> dict:
    """Least time for this frame's backward compositing on an H100 SXM:
    walked pairs × P pixel evaluations of BWD_FLOPS_PER_EVAL, against the
    walked pairs' nine rows read, the per-pixel inputs (acc, t_final, stop
    and the two cotangents: 9 words) and the output. With `n_cols`, the
    wrapper's output: the whole [16, n_cols] table written once (its zero
    fill); without, the kernel's own: nine rows of the walked pairs."""
    pairs = int(walked_pairs(starts, counts, stop).sum())
    nt = starts.shape[0]
    ops = pairs * p * BWD_FLOPS_PER_EVAL
    out_bytes = pairs * BYTES_PER_PAIR if n_cols is None else 16 * n_cols * 4
    nbytes = pairs * BYTES_PER_PAIR + nt * 8 + nt * p * 9 * 4 + out_bytes
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return dict(walked_pairs=pairs, ops=ops, bytes=nbytes,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def profile_train(step, state, gt, cam, bg, steps_per_s: float) -> dict:
    """Device time per training step from torch.profiler, by stage.

    The backward runs on the calling thread (autograd multithreading off
    inside the window) so that the `train/*` and `sort_gather/*` ranges
    hold the kernels of their stage; the two compositor kernels are
    counted by name (see range_device_us)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    with torch.autograd.set_multithreading_enabled(False), profile(activities=acts) as prof:
        for i in range(N_PROFILE_STEPS):
            state = step(state, gt, cam, i % TRAIN_TIMESTEPS, bg, 3).state
        torch.cuda.synchronize()
    rng = dict.fromkeys(TRAIN_RANGES, 0.0)
    fwd_k = bwd_k = 0.0
    kernels = []
    for e in prof.events():
        if e.device_type == cpu and e.name in rng:
            rng[e.name] += range_device_us(e) / 1e3 / N_PROFILE_STEPS
        elif e.device_type == cuda and not e.is_user_annotation:
            kernels.append(e)
            if "composite_pairs_fwd_kernel" in e.name:
                fwd_k += e.time_range.elapsed_us() / 1e3 / N_PROFILE_STEPS
            elif "composite_pairs_bwd_kernel" in e.name:
                bwd_k += e.time_range.elapsed_us() / 1e3 / N_PROFILE_STEPS
    if not kernels:
        return {"device_time": "not measured: the profiler recorded no device events"}
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / N_PROFILE_STEPS
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    stages = {
        "geometry_fwd": rng["train/geometry_fwd"],
        "binning": rng["sort_gather/fwd"],
        "compositor_fwd": fwd_k,
        # The image stage less the binning and the compositor kernels: the
        # L1 + D-SSIM loss forward and backward and the raster's glue (the
        # zero fills of the compositors' outputs included).
        "loss": (rng["train/image_fwd"] - rng["sort_gather/fwd"]
                 + rng["train/image_bwd"] - rng["sort_gather/bwd"]),
        "compositor_bwd": bwd_k,
        "sort_gather_bwd": rng["sort_gather/bwd"],
        "densify_stats": rng["train/densify_stats"],
        "geometry_bwd": rng["train/geometry_bwd"],
        "adam": rng["train/adam"],
    }
    return dict(
        stage_device_ms=stages,
        device_busy_ms_per_step=busy_ms,
        device_busy_share=busy_ms * steps_per_s / 1e3,
        device_ops_per_step=len(kernels) / N_PROFILE_STEPS,
        top_device_ms_per_step={k[:80]: v / 1e3 / N_PROFILE_STEPS for k, v in top},
    )


def leaf_errors(a, b) -> dict:
    """Per field of two dataclasses of tensors: max |a - b| / max |b|."""
    out = {}
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if y is not None:
            out[f.name] = float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
    return out


def all_finite(obj) -> bool:
    return all(bool(torch.isfinite(getattr(obj, f.name)).all())
               for f in dataclasses.fields(obj) if getattr(obj, f.name) is not None)


def phase_train(dev, model, params, aux, fl, cam, tile_cfg, card) -> dict:
    """The FLAME-bound training step at full width (phases 6 and 7)."""
    from gaussianavatars_torch.config import Config
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.ops import rasterize_sorted as rs
    from gaussianavatars_torch.render import AvatarRenderer
    from gaussianavatars_torch.training.trainer import init_train_state, make_train_step

    n_shape, n_expr = fl.shape.shape[0], fl.expr.shape[1]
    cfg = Config()
    g = torch.Generator().manual_seed(11)
    p_gt = dataclasses.replace(
        params, sh_dc=params.sh_dc + 0.3 * torch.randn(params.sh_dc.shape, generator=g).to(dev))
    jaw = fl._replace(jaw=torch.tensor([[0.15, 0.0, 0.0]], device=dev))
    gt = AvatarRenderer(model, p_gt, aux, cam, tile_cfg, device=dev).render(jaw).color.clone()
    bg = torch.zeros(3, device=dev)
    state0 = init_train_state(params, aux, cfg, num_timesteps=TRAIN_TIMESTEPS, n_expr=n_expr,
                              n_shape=n_shape, num_verts=model.num_verts)
    step = make_train_step(model, cfg, tile_cfg)

    # One step's gradients (Adam's first moment from zero moments is 0.1·g)
    # with the kernel and with the plain backward compositor.
    out_k = step(state0, gt, cam, 0, bg, 3)
    rs.bwd_call_pairs = cp.bwd_call_pairs_reference
    try:
        out_r = step(state0, gt, cam, 0, bg, 3)
    finally:
        rs.bwd_call_pairs = cp.bwd_call_pairs
    grad_err = {**leaf_errors(out_k.state.adam.mu, out_r.state.adam.mu),
                **{f"flame.{k}": v for k, v in
                   leaf_errors(out_k.state.flame_adam.mu, out_r.state.flame_adam.mu).items()}}
    log("train/kernel_vs_plain_gradients", rel_err_per_leaf=grad_err)
    if not max(grad_err.values()) <= 1e-4:
        raise AssertionError(f"train-step gradients differ with the plain backward: {grad_err}")

    state = state0
    for i in range(N_TRAIN_WARMUP):
        state = step(state, gt, cam, i % TRAIN_TIMESTEPS, bg, 3).state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cp.fwd_call_pairs.launches = 0
    cp.bwd_call_pairs.launches = 0
    losses, overflow = [], torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for i in range(N_TRAIN_STEPS):
        out = step(state, gt, cam, i % TRAIN_TIMESTEPS, bg, 3)
        state = out.state
        losses.append(out.metrics["loss"])
        overflow = torch.maximum(overflow, out.metrics["budget_overflow"].to(torch.int64))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"fwd": cp.fwd_call_pairs.launches, "bwd": cp.bwd_call_pairs.launches}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    loss = torch.stack(losses).tolist()
    dead = ~aux.alive
    dead_same = all(torch.equal(getattr(state.params, f.name)[dead],
                                getattr(params, f.name)[dead])
                    for f in dataclasses.fields(params))
    finite = dict(params=all_finite(state.params), flame=all_finite(state.flame),
                  grads=all_finite(state.adam.mu) and all_finite(state.adam.nu)
                  and all_finite(state.flame_adam.mu) and all_finite(state.flame_adam.nu))
    res = dict(steps=N_TRAIN_STEPS, launches=launches, budget_overflow=int(overflow),
               loss_first=loss[0], loss_last=loss[-1], loss_finite=all(map(math.isfinite, loss)),
               finite=finite, dead_slots=int(dead.sum()), dead_slots_unchanged=dead_same,
               psnr_last=float(out.metrics["psnr"]))
    log("train", **res)
    if launches != {"fwd": N_TRAIN_STEPS, "bwd": N_TRAIN_STEPS}:
        raise AssertionError(f"compositor launches {launches} for {N_TRAIN_STEPS} steps")
    if not (res["loss_finite"] and loss[-1] < loss[0] and int(overflow) == 0
            and all(finite.values()) and dead_same):
        raise AssertionError(f"training checks failed: {res}")

    # --- 7. train numbers ----------------------------------------------------
    steps_per_s = N_TRAIN_STEPS / wall_s
    prof_res = profile_train(step, state, gt, cam, bg, steps_per_s)
    log("train/numbers", card=card["nvidia_smi"], steps_per_s=steps_per_s,
        ms_per_step=1e3 * wall_s / N_TRAIN_STEPS, resolution=f"{cam.width}x{cam.height}",
        gaussians=int(aux.alive.sum()), peak_mem_mib=peak_mib,
        bwd_launches_per_step=launches["bwd"] / N_TRAIN_STEPS, **prof_res)
    return dict(res, steps_per_s=steps_per_s)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gaussianavatars_torch.models.binding import face_frames
    from gaussianavatars_torch.models.gaussians import world_gaussians
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.ops.projection import project_from_params
    from gaussianavatars_torch.ops.rasterize_dense import render_dense
    from gaussianavatars_torch.ops.rasterize_sorted import (
        composite_sorted, depth_key, rasterize_sorted, sort_gather,
    )
    from gaussianavatars_torch.ops.rasterize_tiled import view_colors
    from gaussianavatars_torch.ops.sort_binning import bbox_tiles
    from gaussianavatars_torch.render import (
        HEIGHT, WIDTH, AvatarRenderer, build_scene, probe_tile_config,
    )

    dev = torch.device("cuda")
    card = phase_device()
    phase_build()
    torch.set_grad_enabled(False)

    # --- 3. kernels against their plain versions ---------------------------
    small, small_table = parity_table(dev)
    k_small = compare_kernel("parity_128x256", small_table)
    if not (k_small["stopped_pixel_share"] > 0 and k_small["walk_past_first_chunk"]):
        raise AssertionError("parity scene must exercise early stops and multi-chunk walks")
    kb_small = compare_bwd_kernel("parity_128x256", small_table, k_small["outputs"], seed=21)
    if not kb_small["longest_walk"] > 256:   # the kernel stages 256 pairs a chunk
        raise AssertionError("parity scene must exercise multi-chunk backward walks")

    model, params, aux, fl, cam, n_g = build_scene(device=dev)
    cfg = probe_tile_config(model, params, aux, fl, cam)
    th, tw = cfg.tile_h, cfg.tile_w
    nty, ntx = cfg.grid(HEIGHT, WIDTH)
    spec = cfg.tier_spec(params.capacity)

    def stages(flp, ev=None):
        """One frame of the main path, stage by stage (the body of
        AvatarRenderer.render), each stage a profiler range, with optional
        CUDA events between stages."""
        def mark(i):
            if ev is not None:
                ev[i].record()
        rf = torch.profiler.record_function
        mark(0)
        with rf("stage/flame_binding"):
            verts = model(flp)
            wg = world_gaussians(params, aux, face_frames(verts[0], model.faces))
        mark(1)
        with rf("stage/projection_sh"):
            proj = project_from_params(wg.means, wg.scales, wg.quats, cam, alive=wg.alive)
            colors = view_colors(wg.means, wg.sh, cam, 3)
            opac = torch.where(proj.mask, wg.opacity, torch.zeros_like(wg.opacity))
        mark(2)
        with rf("stage/binning"):
            tminx, tminy, bw, ntiles, _nty, _ntx = bbox_tiles(proj, HEIGHT, WIDTH, th, tw,
                                                              opacity=opac)
            ntiles_eff = torch.where(proj.mask, ntiles, torch.zeros_like(ntiles))
            dataT, plan = sort_gather(
                (nty * ntx, ntx, spec), proj.mean2d, proj.conic, colors, opac,
                (tminx, tminy, bw, ntiles_eff, depth_key(proj.depth)))
        mark(3)
        with rf("stage/compositor"):
            composite_sorted((th, tw, ntx), dataT, plan.tile_starts, plan.counts)
        mark(4)
        return dataT, plan

    dataT0, plan0 = stages(fl)
    full_table = (dataT0, plan0.tile_starts, plan0.counts, th, tw, ntx)
    k_full = compare_kernel("full_802x550", full_table)
    # The first training frame's table: the same avatar, camera and FLAME
    # parameters as the training phase's step 0.
    kb_full = compare_bwd_kernel("full_802x550", full_table, k_full["outputs"], seed=22)
    log("scene", gaussians=n_g, capacity=params.capacity, faces=model.num_faces,
        verts=model.num_verts, tiers=[cfg.base_budget, list(cfg.tiers)],
        expansion_slots=spec.expansion_size(params.capacity),
        total_pairs=int(plan0.total), budget_overflow=int(plan0.budget_overflow),
        max_footprint=int(plan0.max_footprint))
    if int(plan0.budget_overflow) != 0:
        raise AssertionError("tier budget overflow on the probe frame")

    kernel_ms = cuda_ms(lambda: cp.fwd_call_pairs(*full_table), N_KERNEL_REPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cp.fwd_call_pairs_reference(*full_table)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    bound = compositor_bound(plan0.tile_starts, plan0.counts, k_full["outputs"][2], th * tw)
    log("kernels/timing_full_802x550", ms=kernel_ms, plain_ms=plain_ms, **bound,
        card=card["nvidia_smi"])
    bwd_args = kb_full.pop("args")
    bwd_ms = cuda_ms(lambda: cp.bwd_call_pairs(*bwd_args), N_KERNEL_REPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cp.bwd_call_pairs_reference(*bwd_args)
    torch.cuda.synchronize()
    bwd_plain_ms = 1e3 * (time.perf_counter() - t0)
    b_bound = bwd_bound(plan0.tile_starts, plan0.counts, k_full["outputs"][2], th * tw,
                        dataT0.shape[1])
    # The kernel alone, into one zero-filled output (each launch stores the
    # same values), against the bound of its own walked work.
    dgrad = torch.zeros_like(dataT0)
    bwd_kernel_ms = cuda_ms(lambda: cp._launch_bwd_cuda(dgrad, *bwd_args), N_KERNEL_REPS)
    if not torch.equal(dgrad, cp.bwd_call_pairs(*bwd_args)):
        raise AssertionError("composite_pairs_bwd: repeated launches changed the output")
    del dgrad
    k_bound = bwd_bound(plan0.tile_starts, plan0.counts, k_full["outputs"][2], th * tw)
    log("kernels/bwd_timing_full_802x550", ms=bwd_ms, plain_ms=bwd_plain_ms, **b_bound,
        note="ms: the wrapper, zero fill of the [16, M] output included",
        kernel_ms=bwd_kernel_ms, kernel_bound_ms=k_bound["bound_ms"],
        kernel_bound_by=k_bound["bound_by"], kernel_bytes=k_bound["bytes"],
        kernel_note="kernel_ms: the launch alone, no zero fill; its bound: the walked "
                    "pairs' nine rows written, not the [16, M] table",
        card=card["nvidia_smi"])

    # --- 4. the slice at full width ----------------------------------------
    renderer = AvatarRenderer(model, params, aux, cam, cfg, device=dev)

    def jaw_params(i):
        return fl._replace(jaw=torch.tensor([[0.002 * (i % 150), 0.0, 0.0]], device=dev))

    poses = [jaw_params(i) for i in range(N_FRAMES)]
    for i in range(5):  # warm-up: allocator, library load, first launches
        renderer.render(poses[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    coverage = torch.zeros((), device=dev)
    first = last = None
    cp.fwd_call_pairs.launches = 0
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    for i in range(N_FRAMES):
        out = renderer.render(poses[i])
        finite &= torch.isfinite(out.color).all()
        coverage += out.alpha.mean()
        if i == 0:
            first = out.color
        if i == 149:
            last = out.color
    ev1.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = cp.fwd_call_pairs.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    img_diff = float((first - last).abs().max())
    slice_res = dict(frames=N_FRAMES, launches=launches, finite=bool(finite),
                     mean_coverage=float(coverage) / N_FRAMES, jaw_image_max_diff=img_diff)
    log("slice", **slice_res)
    if launches != N_FRAMES:
        raise AssertionError(f"compositor launched {launches} times for {N_FRAMES} frames")
    if not bool(finite) or not float(coverage) > 0 or not img_diff > 0:
        raise AssertionError(f"bad frames: {slice_res}")

    # One full frame against the same binning with the plain compositor.
    ref_pose = poses[149]
    img_k = renderer.render(ref_pose).color
    d1, p1 = stages(ref_pose)
    r_acc, r_t, _ = cp.fwd_call_pairs_reference(d1, p1.tile_starts, p1.counts, th, tw, ntx)
    img_p = r_acc.transpose(1, 2).reshape(nty, ntx, th, tw, 3).permute(0, 2, 1, 3, 4)
    img_p = img_p.reshape(nty * th, ntx * tw, 3)[:HEIGHT, :WIDTH]
    full_err = float((img_k - img_p).abs().max())
    overflow = int(p1.budget_overflow)
    # A small frame against the dense ground truth (parity scene).
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    s = small
    img_s, _a, _p = rasterize_sorted(s["proj"], s["colors"], s["opac"], s["h"], s["w"], bg,
                                     s["th"], s["tw"], s["spec"])
    dense = render_dense(s["means"], s["scales"], s["quats"], s["opac"], s["cam"], bg,
                         colors=s["colors"], projected=s["proj"], tile_cull=(s["th"], s["tw"]))
    dense_err = float((img_s - dense.color).abs().max())
    log("slice/checks", full_frame_vs_plain_max_err=full_err, moved_jaw_budget_overflow=overflow,
        small_frame_vs_dense_max_err=dense_err)
    if not (full_err <= 1e-5 and overflow == 0 and dense_err <= 1e-4):
        raise AssertionError("full-width checks failed")

    # --- 5. numbers ----------------------------------------------------------
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    sums = [0.0] * 4
    for i in range(N_STAGE_FRAMES):
        stages(poses[i], evs)
        torch.cuda.synchronize()
        for k in range(4):
            sums[k] += evs[k].elapsed_time(evs[k + 1])
    stage_ms = dict(zip(STAGES, (x / N_STAGE_FRAMES for x in sums)))
    prof_res = profile_device(stages, renderer, poses, N_FRAMES / wall_s)
    log("numbers", card=card["nvidia_smi"], frames_per_s=N_FRAMES / wall_s,
        stream_ms_per_frame=ev0.elapsed_time(ev1) / N_FRAMES, resolution=f"{WIDTH}x{HEIGHT}",
        gaussians=n_g, peak_mem_mib=peak_mib, stage_ms=stage_ms,
        stage_note="CUDA events between stages, synchronised per frame: host and device",
        library_ms_note="no PyTorch call computes either pair compositor: library_ms is null")
    log("numbers/profile", card=card["nvidia_smi"], **prof_res)

    # --- 6./7. the training step at full width -----------------------------
    torch.set_grad_enabled(True)
    train = phase_train(dev, model, params, aux, fl, cam, cfg, card)

    print(json.dumps({"kernels": [{
        "name": "composite_pairs_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches + train["launches"]["fwd"],
        "max_abs_err": max(k_small["max_abs_err_acc"], k_small["max_abs_err_t_final"],
                           k_full["max_abs_err_acc"], k_full["max_abs_err_t_final"]),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None,
    }, {
        "name": "composite_pairs_bwd", "route": "cuda", "source": BWD_KERNEL_SOURCE,
        "replaces": BWD_REPLACES, "launches": train["launches"]["bwd"],
        "max_abs_err": max(kb_small["max_abs_err"], kb_full["max_abs_err"]),
        "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": b_bound["bound_ms"],
        "bound_by": b_bound["bound_by"], "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
