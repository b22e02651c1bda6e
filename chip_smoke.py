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
                and early stops) and at the full-size frame's table;
  4. slice    — the benchmark scene at full width (802×550, 90,090 FLAME-
                bound Gaussians, SH degree 3, 32×32 tiles, probed tier
                budgets), rendered frame after frame through
                `AvatarRenderer.render` with the jaw moving every frame; the
                compositor must launch once per frame; one full frame is
                checked against the plain compositor and a small frame
                against the dense ground truth;
  5. numbers  — frames/s, per-stage milliseconds, peak memory.

The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without a CUDA device it prints no result
and exits non-zero.
"""
from __future__ import annotations

import json
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
    # The compositor kernel is launched through ctypes, not by a PyTorch
    # operator, so no host range owns it: it is found by its name.
    stage_dev = dict.fromkeys(STAGES, 0.0)
    for e in prof.events():
        if e.device_type == cpu and e.name.startswith("stage/"):
            stage_dev[e.name[len("stage/"):]] += e.device_time_total / 1e3 / N_PROFILE_FRAMES
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
        library_ms_note="no PyTorch call computes the pair compositor: library_ms is null")
    log("numbers/profile", card=card["nvidia_smi"], **prof_res)

    print(json.dumps({"kernels": [{
        "name": "composite_pairs_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(k_small["max_abs_err_acc"], k_small["max_abs_err_t_final"],
                           k_full["max_abs_err_acc"], k_full["max_abs_err_t_final"]),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
