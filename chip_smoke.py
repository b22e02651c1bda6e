#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

`--against ROOT` (repeatable) also builds another checkout's compositor
and micro-reduce kernels (for example the parent commit, unpacked with
`git archive` into an ignored directory) and times rows 1, 2, 3 and 4 and
the four micro-reduce kernels of both in the same call (`[against/*]`,
phases 3, 11 and 13).

Phases (each prints a line; a failing phase raises and the exit code is
non-zero):

  1. device   — card name and count, `nvidia-smi` name and power limit,
                torch/CUDA versions and both TF32 flags (forced off);
  2. build    — every kernel under gaussianavatars_torch/csrc, one nvcc
                each, all started together;
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at a small scene (128×256, 4096 splats: multi-chunk walks
                and early stops) and at the full-size frame's table (also
                the first training frame's table): the forward bit for bit;
                the backward kernel with fixed-seed cotangents, each row
                within 1e-4 of its largest plain value and the plain
                version's zero slots exact; the port's 9-row table against
                the JAX package's 16-row layout (bit for bit, rows 9..15
                zero); both forward kernels and the backward's six
                instantiations without spills in their ptxas report, with
                registers and blocks per SM; the forward timed through its
                wrapper and alone;
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
                against its plain version and its bound, peak memory;
  8. variants — in phase 3, on both tables: the other implementations'
                kernels (v2 forward, v2 and v4 backward) and the three
                backward kernels' `amp` entry points against their plain
                versions (the v2 forward bit for bit, stop ids included; each backward row
                within 1e-4 of its largest plain value, zero slots exact,
                every column written by the kernel), and each entry point's
                time, plain time and bound;
  9. ab       — the kernel A/B entry point (`tools/kernel_ab.main`) over v2,
                v3 and v4 at the benchmark frame, float32 and `--amp`: each
                implementation's own entry points must launch;
 10. train amp — the training step with `use_amp` at the same full width:
                one step from one state in both modes held to
                `tests/test_amp.py`'s criteria (on a textured target,
                uniform noise in [0, 1]; two more targets measured), then
                5 warm-up and 30 timed
                steps (loss finite and falling, every parameter finite, the
                `amp` backward launched once a step), steps/s of both modes
                in alternating blocks, device ms per stage, peak memory;
 11. micro-reduce — `tools/micro_reduce_bench.main` at NT = 468, then each
                of its four kernels against its plain version (relative 1e-5
                a slot), with its time, the plain version's, the
                `torch.matmul` yardstick, its bound and share of it (C and
                D: also of their route's tensor-core floor), its ptxas
                report and a count of opcodes in its SASS; the no-fold
                gate: A and B not above 1.05 of their bound, C and D not
                above 1.05 of their route's floor, and each one's SASS
                holding its route's instruction (FFMA in A, SHFL in B,
                HMMA in C, HGMMA in D);
 12. loop     — `tools/train_synthetic` at 802×550, 800 iterations, with
                its events, then a resume from its checkpoint;
 13. fitted   — on one 802×550 view of phase 12's fitted avatar: both
                forward kernels (v3, v2) bit for bit against their plain
                version, timed through the wrapper, alone and as a CUDA
                graph; the backward's six entries (v3, v4,
                v2, float32 and `amp`) against their plain versions, every
                column written, timed, with the walked pairs;
 14. replay   — phase 12's model directory read back and replayed through
                the user's entry points: `models/io.load_avatar` (every
                leaf the fitted state's live slots, bit for bit), a round
                trip against the in-memory state (max abs diff <= 1e-6),
                `tools/render` over val and test (row 1 once a view),
                `tools/metrics` with synthetic VGG LPIPS weights (val PSNR
                within 0.1 dB of the loop's; one pair's LPIPS on the card
                within rtol 1e-4 of the CPU's; `evaluate_split` with
                `$GSAVATARS_LPIPS_WEIGHTS`), `viewers.local.AvatarViewerCore`
                at 802×550 (a splat frame, the mesh overlay, a jaw
                override, `motion_path` and `disable_fid` each change it),
                and the FPS benchmarks: `tools/fps_benchmark_demo` on the
                fitted avatar and on the benchmark avatar written as a
                model directory, `tools/fps_benchmark_dataset` on the fit;
 15. innovations — `tools/train_synthetic --all_innovations` on phase 12's
                dataset (802×550, 900 iterations: scales 0.5 / 0.75 / 1.0
                from 1 / 300 / 600, a smart densify event at 750, evals and
                checkpoints at 450 and 900): every iteration at its scale's
                size, the past scales' caches evicted, row 2 once a step and
                row 1 once a step and an eval view, the thresholds at or
                above their floors, the colour net stepped every iteration,
                the contrastive cache full, loss and PSNR finite; a resume
                from 450 (every leaf bit for bit, on at 0.75); then the bare
                step at full width with the region-adaptive loss, the colour
                net and the contrastive term: gradients with the kernel and
                the plain backward (phase 6's tolerance), the region map
                (exactly), the colour net, the pooled thumbnail and the
                contrastive term's mean cosine (rtol 1e-5) on the card
                against the CPU, steps/s with the
                innovations on and off in alternating blocks, device ms per
                stage, kernels a step, peak memory, and the synchronising
                calls of a step, equal in both modes;
 16. cli      — the training CLI, `tools.train.main` in-process: FLAME-bound
                on phase 12's dataset (802×550, 300 iterations: an opacity
                reset at 200, a densify event at 250, evals and checkpoints
                at 150 and 300) with `--flame_assets` the npz that the
                port's `convert_flame_pickle` made from FLAME-2023-shaped
                files written from the synthetic assets the CLI would fall
                back to (phase 21's files: no fallback warning, the part
                masks loaded) and the viewer server on a free port and a
                `RemoteClient` thread that holds the loop (its splat frame
                equal byte for byte to `make_render_fn` on the held state,
                its mesh frame different, `num_points` the live count, the
                round trip timed), finite checks on every step from 160,
                then 5 steps under `--detect_anomaly`, then `tools.render`
                and `tools.metrics` on the model directory; unbound on a
                NeRF-synthetic scene of the fitted avatar (32 orbit views at
                800×800 on white, no `points3d.ply`: the reader's 100,000
                random points; 300 iterations, a densify event at 250), the
                knn of those points on the card against the CPU on 4,096
                sampled rows (rtol 1e-4); unbound on the same views as a
                COLMAP scene (`sparse/0/*.bin` from the port's writers, 20,000
                points of the avatar; 100 iterations; the `llffhold` 8
                split). Every run: rows 1 and 2 once a step (and row 1 once
                an eval view, a served frame, a rendered view), its events
                at its flags' cadences, the loss falling.
 17. table    — the table pipeline and the tools: (a) `render_tiled(
                use_pallas=False)` at the benchmark frame with the default
                `TileConfig` (capacity 1,024, 32 tiles a Gaussian: its
                overflow reported) and with the table sized to the frame
                (`probe_tile_config(table=True)`: no overflow; image and
                alpha equal to the sorted kernel path's within 1e-5), and on
                phase 12's fitted avatar through `AvatarViewerCore(
                use_pallas=False)` at 802×550 (no overflow, the sorted core's
                image within 1e-5, the CPU's table core within one alpha-
                cutoff step, 1/255, on at most 1e-3 of the values); frames/s
                of both paths in turns, the table compositor's device ms
                and launches; (b) one table step against the sorted step
                on the same state (the benchmark state and the fitted one,
                each with its sized table; loss and Adam's first moments
                within 1e-4), steps/s of both, kernels a step, peak memory;
                (c) `tools.train_synthetic --no_pallas` (802×550, 4 × 4
                views, 80 iterations, single steps: phase 20 runs its
                chunks) at 3/4 of the initial fullest tile:
                the capacity doubled once, the loss falling, rows 1 and 2
                never launched; (d) `tools.stage_timings --iters 20`, and
                `--iters 5 --no_pallas`; (e) the H100's primitive rates
                (`utils.roofline.measure_primitive_rates`) and both
                rooflines at the benchmark frame against the measured
                frames/s and steps/s, every share of speed of light at most
                1.05; (f) `utils.profiling.trace` around 3 steps (every
                `train/*` range and both kernels' names in the trace); (g) `tools.local_viewer --headless` on phase
                12's model directory (equal byte for byte to
                `AvatarViewerCore`, the `--no_pallas` frame within 1/255)
                and `tools.remote_viewer --headless` taking 2 frames from a
                `TrainingGuiServer`.
 18. sharded  — multi-device training over a rank mesh at the benchmark
                width (the 90,090-Gaussian avatar, 802×550, `Config`
                defaults, the sorted pipeline): (a) an NCCL world of one
                rank in this process: the eager sharded step against
                `make_train_step` from one state for 2 steps (every leaf and
                the loss within 1e-5 of its largest value; the largest
                difference printed), rows 1 and 2 once a step; the step's
                captured form (`sharded.ShardedStep`: one CUDA graph, its
                NCCL collectives inside, replayed once a step) against the
                eager sharded step over 50 steps with a densify event and an
                opacity reset among them, every leaf and metric bit for bit,
                one capture, rows 1 and 2 once a step, the collectives'
                counts equal; no synchronising call while 10 steps replay;
                steps/s of the unsharded, the eager and the captured step in
                alternating blocks, each one's peak memory, device-busy
                share and kernels a step from the profiler, and the
                collectives' ms and bytes; (b) four ranks through the
                launcher, over gloo on one card (eager), NCCL on four
                (captured; the steps rerun eagerly beside them) with
                `tools/sharded_steps`: 1×4, 1×4 with `gauss_shard`, 2×2,
                each held to the single-device step on the card at the CPU
                tests' bounds (2×2: the mean loss and the summed statistics
                of its two cameras), every rank's state digest equal after
                every step, rows 1 and 2 once a step in every rank, each
                rank's form, captures, step ms and collectives, and where
                the backend puts the operands; (c) `tools.train --mesh 2x2`
                on phase 12's dataset (60 iterations, a densify event, an
                eval, a save): only rank 0 printed, the step's form as the
                rule picks it, one state digest on all ranks; (d)
                `tools.multiproc_check --device cuda`; (e)
                `tools.scaling_bench` unsharded (chunks of 50 against eager
                steps), 1×1 under NCCL (captured against eager), and 2×2
                (gloo, time-shared and so labelled) or 2×2 and 1×4 (NCCL):
                cameras/s against the eager mesh and the chunked single
                card. `sharded/seconds` holds each part's seconds.
                `--sharded_only` runs phases 1, 2 and 18 alone (phase 12's
                dataset written, not fitted): the multi-card proof on a
                machine with four cards, where every rank has its own card
                and phase 18 runs over NCCL.
 19. chunks   — K training steps a dispatch (`trainer.make_train_chunk`: one
                captured CUDA graph of the step, replayed once a step) on the
                benchmark scene (802×550, `Config` defaults, SH 3): (a) a
                chunk of 50 against 50 `make_train_step` calls from one state
                on the same views (the camera and the camera turned 0.03 rad
                in turns, timesteps 0 and 1), float32 and `use_amp`: every
                state leaf and metric within 1e-5 of its largest magnitude
                (the largest difference printed), one capture, rows 1 and 2
                once a step; (b) a profiler trace of 4 replays: rows 1 and 2
                once a replayed step; (c) no synchronising call while a chunk
                replays (one to read its result); (d) steps/s of chunks
                against eager steps in alternating blocks of 50, float32,
                `use_amp` and the step-level innovations, with each one's
                device-busy share and peak memory; (e) `train_synthetic` on
                phase 12's dataset and recipe cut to 100 iterations (evals
                and checkpoints at 50 and 100, an opacity reset at 75)
                with `--steps_per_call 50` (its default, which phases 12, 15
                and 16 run too) and `1`: the same events at the same
                iterations, the logged losses at rtol 1e-4, `alive` and
                `binding` equal, every parameter within 1e-2 of its largest
                move; steps/s of both. `--chunks_only` runs phases 1, 2, 12
                and 19 alone.
 20. frames   — frames as CUDA graphs (`utils/graphs.py`: one captured graph
                of a frame, replayed once a call) and the table pipeline's
                graphs: (a) `AvatarRenderer.render` at the benchmark frame,
                300 frames with the jaw moving every frame, each returned
                frame bit for bit its eager frame (`render_eager`), one
                capture, row 1 once a frame, no synchronising call while 50
                frames replay; (b) frames/s captured against eager in
                alternating blocks of 150, each one's device-busy share and
                peak memory; (c) both FPS tools' chains on phase 12's model
                directory (`fps_benchmark_demo.run_chain`, the captured chain
                the tools run) against the chain issued frame by frame: the
                same final s and last image, frames/s a round; (d)
                `evaluate_split` over val on phase 12's fit through one
                `make_render_fn`, captured, eager and captured again: the
                same metrics, one capture; (e) the table pipeline at the
                benchmark frame with the table sized to it: a captured frame
                (the fixed walk) against the eager planned walk, and a chunk
                of 50 table steps against 50 eager table steps, every leaf,
                metric and image within 1e-5 of its largest magnitude (the
                largest difference printed), with each form's time, rate and
                peak memory (the planned walk, the fixed walk eagerly, the
                graph), then `train_synthetic --no_pallas` (phase 17's
                recipe, 30 iterations) at `--steps_per_call` 50 against 1:
                the same events, one capacity doubling, the losses at rtol
                1e-4, steps/s of both. `--frames_only` runs phases 1, 2, 12
                and 20 alone.
 21. flame_import — the real-FLAME import (written before phase 16, which
                trains on it): a FLAME-2023-shaped model pickle (float64,
                shapedirs [5023, 3, 400], posedirs [5023, 3, 36], a
                scipy-sparse J_regressor, a kintree_table) made from
                `synthetic_assets(300, 100, seed=0)`, its template OBJ, a
                masks pickle with FLAME_masks.pkl's part names and a 68-point
                landmark embedding, converted by `convert_flame_pickle`;
                every array loaded back equal to the one written. Then on
                that npz: the FLAME forward with teeth, landmarks, the
                shaped canonical vertices and root centring over 8
                timesteps, on the card against the CPU (1e-5 of each
                output's largest magnitude), timed with and without the
                flags; `project_gaussians` on the benchmark avatar (90,090
                Gaussians, 802×550) against the sorted path's
                `project_from_params` (the same bits) and against the CPU
                (1e-5 relative), both timed. `--flame_only` runs phases 1,
                2, 16's FLAME-bound run (on phase 12's dataset, written and
                not fitted) and 21 alone.
 22. binding_gather — the binding gathers' backward (`ops/binding_gather`,
                `csrc/binding_segment_sum.cu`) at three layouts, every
                padding slot on face 0: the benchmark's base-train and
                innov-train avatars (98,304 and 114,688 slots) and a fit's
                initial state (131,072 slots, 10,010 live). With random
                gradients on every slot: the kernel bit for bit its plain
                version; against `index_put_` with accumulate on the three
                tables (the backward it replaces), the faces of runs of at
                most 32 entries bit for bit; every face within the kernel's
                own rounding of its sum in float64, (32 + S) · 2^-24 · Σ|g|
                for a run of S slices; its ptxas report (no spills) and no
                atomic in its SASS. Timed (device ms, a CUDA graph of 50 calls): the kernel
                against its bound (bytes at 3.35 TB/s), the index build, the
                two together, the parent's path as `library_ms` and the plain
                version. `--binding_only` runs phases 1, 2 and 22 alone.
                The training paths of phases 6, 10, 12, 15 and 19 hold the
                kernel to one launch and one index build a step, serving
                (phase 4) to none; the kernels line counts its launches over
                the main paths, not phase 22's own calls.

The last two lines are the kernels' JSON record (every C entry point of the
compositor, the `amp` ones marked, and the segment sum) and
{"ok": true, "device": {...}}. Without a CUDA device it prints no result
and exits non-zero.
"""
from __future__ import annotations

import copy
import dataclasses
import io
import json
import math
import os
import shutil
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
# The line of each TPU kernel that a C entry point replaces, by (direction,
# implementation), in gaussianavatars_tpu/ops/pallas/composite_pairs.py.
TPU_KERNEL_LINE = {("fwd", "v2"): 90, ("fwd", "v3"): 236, ("bwd", "v2"): 407,
                   ("bwd", "v3"): 620, ("bwd", "v4"): 880}


def compositor_entries() -> dict:
    """Every C entry point of the compositor, named as the wrapper module
    names them: name → (direction, implementation, amp, source, the TPU
    kernel it replaces). v4's forward is v3's, so it is listed once."""
    from gaussianavatars_torch.ops import composite_pairs as cp

    out = {}
    for kind, impl, amp in [("fwd", i, False) for i in ("v3", "v2")] + [
            ("bwd", i, a) for i in ("v3", "v2", "v4") for a in (False, True)]:
        lib, name = cp.fwd_entry(impl) if kind == "fwd" else cp.bwd_entry(impl, amp)
        out[name] = (kind, impl, amp, f"gaussianavatars_torch/csrc/{lib}.cu",
                     f"gaussianavatars_tpu/ops/pallas/composite_pairs.py:"
                     f"{TPU_KERNEL_LINE[kind, impl]}")
    return out


N_AB_ITERS = 20          # calls per A/B timing (best of three)
N_AMP_STEPS = 30         # timed `use_amp` steps
N_AMP_BLOCK = 10         # steps per block of the float32/amp alternation
UPDATE_KEYS = ("means", "log_scales", "logit_opacity", "sh_dc")   # tests/test_amp.py
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
                "train/geometry_bwd", "train/adam",
                # The innovations' (phase 15): the region map and the colour
                # net's forward inside train/image_fwd, the contrastive loss
                # there and the cache update after the step.
                "train/region_map", "train/color_net", "train/contrastive",
                "train/contrastive_update")


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


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds of `fn` per call with no host issue between the
    launches: `reps` calls captured in one CUDA graph, the replay timed by
    CUDA events. For a kernel shorter than its wrapper's host time, where
    `cuda_ms` times the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def phase_build() -> dict:
    """Every kernel library, built in parallel; returns each one's build
    seconds and compiler output."""
    from gaussianavatars_torch import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build()
    log("build", seconds=time.perf_counter() - t0,
        kernels={k: v["seconds"] for k, v in built.items()})
    for name, v in built.items():
        for line in v["log"].splitlines():
            print(f"[build] {name}: {line.strip()}", flush=True)
    return built


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


FWD_CHUNK = 256   # pairs composite_pairs_fwd.cu stages at a time


def compare_kernel(label: str, table) -> dict:
    """Kernel vs plain version on the same card tensors: acc, t_final and
    the stop ids bit for bit."""
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
    bit_equal = dict(acc=bool(torch.equal(acc, r_acc)), t_final=bool(torch.equal(tfin, r_tfin)),
                     stop=stop_mismatch == 0)
    walked = torch.where(stop == STOP_NEVER, counts[:, None], stop - (starts % 128)[:, None])
    past_first_chunk = bool((walked > FWD_CHUNK).any())
    res = dict(max_abs_err_acc=err_acc, max_abs_err_t_final=err_t, bit_equal=bit_equal,
               stop_tile_max_equal=tile_max_equal, stop_elements_differing=stop_mismatch,
               stopped_pixel_share=float((stop != STOP_NEVER).float().mean()),
               max_tile_count=int(counts.max()), walk_past_first_chunk=past_first_chunk,
               total_pairs=int(counts.sum()))
    log(f"kernels/{label}", **res)
    if not (err_acc <= 1e-5 and err_t <= 1e-5 and tile_max_equal and all(bit_equal.values())):
        raise AssertionError(f"composite_pairs_fwd disagrees with its plain version: {res}")
    return dict(res, outputs=(acc, tfin, stop), plain=(r_acc, r_tfin, r_stop))


COMPOSITOR_KERNELS = ("composite_pairs_fwd_kernel", "composite_pairs_bwd_kernel",
                      "composite_pairs_fwd_v2_kernel", "composite_pairs_bwd_v2_kernel")


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
               writes_every_column=writes_every_column(d, args, False),
               walked_pairs=int(walked.sum()), longest_walk=int(walked.max()),
               walks_cut_by_stops=int((walked < counts.long()).sum()))
    log(f"kernels/bwd_{label}", **res)
    if not (max(rel) <= BWD_REL_TOL and zeros_exact and res["writes_every_column"]):
        raise AssertionError(f"composite_pairs_bwd disagrees with its plain version: {res}")
    return dict(res, args=args, plain=r, out=d)


def reset_launches() -> None:
    """Every engagement count (`utils/profiling.counter`: the compositor's
    and the binding segment sum's launches, the binding index's builds)
    to 0."""
    from gaussianavatars_torch.utils import profiling

    for counts in profiling.counters().values():
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict:
    """The launches since `reset_launches` by entry point: the compositor's
    and the binding segment sum's."""
    from gaussianavatars_torch.ops import binding_gather as bg
    from gaussianavatars_torch.ops import composite_pairs as cp

    return {**cp.LAUNCHES, **bg.LAUNCHES}


def binding_launches(steps: int, what: str) -> int:
    """The binding segment sum's launches since `reset_launches`, which a
    FLAME-bound training path makes once a step (the backward of its
    binding gathers), building the index as often; nothing built or
    launched where no step ran."""
    from gaussianavatars_torch.ops import binding_gather as bg

    n, builds = bg.LAUNCHES["binding_segment_sum"], bg.INDEX["builds"]
    log(f"{what}/binding_segment_sum", launches=n, index_builds=builds, steps=steps)
    if n != steps or builds != steps:
        raise AssertionError(f"{what}: the binding segment sum launched {n} times and its "
                             f"index was built {builds} times in {steps} steps")
    return n


def with_impl(impl: str, fn):
    """fn() with the compositor's implementation switch on `impl`."""
    from gaussianavatars_torch.ops import composite_pairs as cp

    cp._FWD_IMPL = cp._BWD_IMPL = impl
    try:
        return fn()
    finally:
        cp._FWD_IMPL = cp._BWD_IMPL = "v3"


def writes_every_column(d, bwd_args, amp: bool) -> bool:
    """Whether a launch into a NaN-filled output gives rows 0..8 of the
    wrapper's result `d`: every backward kernel writes every column itself."""
    from gaussianavatars_torch.ops import composite_pairs as cp

    out = torch.full_like(d, float("nan"))
    cp._launch_bwd_cuda(out, *bwd_args, amp=amp)
    return bool(torch.equal(out[:9], d[:9]))


def bwd_errors(d, r) -> dict:
    """Kernel output d against plain output r: per-row relative error, and
    whether rows 9..15 and the plain version's zero slots are exact zeros."""
    row_err = (d[:9] - r[:9]).abs().amax(dim=1)
    rel = (row_err / r[:9].abs().amax(dim=1)).tolist()
    plain_zero = (r == 0).all(dim=0)
    zeros_exact = not bool(d[:, plain_zero].any()) and not bool(d[9:].any())
    return dict(max_abs_err=float(row_err.max()), rel_err_per_row=rel, zeros_exact=zeros_exact)


def compare_variants(label: str, table, k_res: dict, kb_res: dict) -> dict:
    """The v2 forward, the v2 and v4 backward and the three `amp` backward
    entry points against their plain versions on the same card tensors.

    The v2 forward must equal the plain forward bit for bit (acc, t_final,
    stop ids), as the v3 kernel does. Each backward kernel is
    held to the v3 kernel's bound, per row max |kernel − plain| <= 1e-4 ·
    max |plain|, with exact zeros. For `amp` that bound holds for the same
    reason: each pixel's float32 values are operation for operation the
    plain version's, so the bf16 roundings of d_p, w, the basis and g_c are
    the same and their products exact; only the order of the sums over a
    tile's pixels differs, as in float32."""
    from gaussianavatars_torch.ops import composite_pairs as cp

    out = {}
    acc, tfin, stop = with_impl("v2", lambda: cp.fwd_call_pairs(*table))
    torch.cuda.synchronize()
    r_acc, r_tfin, r_stop = k_res["plain"]
    res = dict(bit_equal_acc=bool(torch.equal(acc, r_acc)),
               bit_equal_t_final=bool(torch.equal(tfin, r_tfin)),
               stop_tile_max_equal=bool(torch.equal(stop.max(dim=1).values,
                                                    r_stop.max(dim=1).values)),
               stop_elements_differing=int((stop != r_stop).sum()),
               max_abs_err=max(float((acc - r_acc).abs().max()),
                               float((tfin - r_tfin).abs().max())))
    log(f"kernels/fwd_v2_{label}", **res)
    if not (res["bit_equal_acc"] and res["bit_equal_t_final"] and res["stop_tile_max_equal"]
            and res["stop_elements_differing"] == 0):
        raise AssertionError(f"composite_pairs_fwd_v2 disagrees with its plain version: {res}")
    out["composite_pairs_fwd_v2"] = res

    args, r32 = kb_res["args"], kb_res["plain"]
    r16 = cp.bwd_call_pairs_reference(*args, amp=True)
    amp_moves = ((r16[:9] - r32[:9]).abs().amax(dim=1) / r32[:9].abs().amax(dim=1)).tolist()
    for name, (kind, impl, amp, _src, _rep) in compositor_entries().items():
        if kind != "bwd" or name == "composite_pairs_bwd":
            continue
        d = with_impl(impl, lambda: cp.bwd_call_pairs(*args, amp=amp))
        torch.cuda.synchronize()
        res = bwd_errors(d, r16 if amp else r32)
        res["writes_every_column"] = with_impl(impl, lambda: writes_every_column(d, args, amp))
        if impl == "v4":   # v4 against the v3 kernel of the same mode
            v3 = kb_res["out"] if not amp else cp.bwd_call_pairs(*args, amp=True)
            res["bit_equal_to_v3"] = bool(torch.equal(d, v3))
        log(f"kernels/{name.replace('composite_pairs_', '')}_{label}", **res)
        if not (max(res["rel_err_per_row"]) <= BWD_REL_TOL and res["zeros_exact"]
                and res["writes_every_column"]):
            raise AssertionError(f"{name} disagrees with its plain version: {res}")
        out[name] = res
    log(f"kernels/amp_vs_f32_plain_{label}", rel_diff_per_row=amp_moves,
        note="how far the bf16 contraction moves the plain gradient, per row")
    return out


# The compositor kernels whose ptxas report phase 3 gates: (library,
# kernel name with its template arguments (amp, gc_vpu) as they appear in
# the mangled name) → the C entry point of the instantiation.
KERNEL_INSTANCES = {
    ("composite_pairs_fwd", "composite_pairs_fwd_kernelE"): "composite_pairs_fwd",
    ("composite_pairs_fwd_v2", "composite_pairs_fwd_v2_kernelE"): "composite_pairs_fwd_v2",
    ("composite_pairs_bwd", "composite_pairs_bwd_kernelILb0ELb0E"): "composite_pairs_bwd",
    ("composite_pairs_bwd", "composite_pairs_bwd_kernelILb1ELb0E"): "composite_pairs_bwd_amp",
    ("composite_pairs_bwd", "composite_pairs_bwd_kernelILb0ELb1E"): "composite_pairs_bwd_v4",
    ("composite_pairs_bwd", "composite_pairs_bwd_kernelILb1ELb1E"): "composite_pairs_bwd_v4_amp",
    ("composite_pairs_bwd_v2", "composite_pairs_bwd_v2_kernelILb0EE"): "composite_pairs_bwd_v2",
    ("composite_pairs_bwd_v2", "composite_pairs_bwd_v2_kernelILb1EE"): "composite_pairs_bwd_v2_amp",
}
# Threads a block of each library's kernels at a 32×32 tile: 2 warps
# (the forward walk's kFwdBlockWarps), ceil(P / 128) warps (backward).
BLOCK_THREADS_32X32 = {"composite_pairs_fwd": 64, "composite_pairs_fwd_v2": 64,
                       "composite_pairs_bwd": 256, "composite_pairs_bwd_v2": 256}
FWD_NAMES = ("composite_pairs_fwd", "composite_pairs_fwd_v2")
# The backward's entry points: rows 2, 5 and 4, each float32 and `amp`.
BWD_ENTRIES = (("v3", False), ("v3", True), ("v4", False), ("v4", True), ("v2", False),
               ("v2", True))


def kernel_resources(built) -> dict:
    """The ptxas report (phase 2's compiler output) of the forward kernels
    (rows 1 and 3) and of the backward's six instantiations (rows 2, 4 and
    5): registers,
    shared memory, stack and spill bytes, and blocks per SM at a 32×32
    tile's block. Fails when one is missing or spills."""
    from gaussianavatars_torch import cuda_build

    out = {}
    for lib in {k[0] for k in KERNEL_INSTANCES}:
        for mangled, rep in cuda_build.ptxas_report(built[lib]["log"]).items():
            for (lib_k, key), name in KERNEL_INSTANCES.items():
                if lib_k == lib and key in mangled:
                    threads = BLOCK_THREADS_32X32[lib]
                    out[name] = dict(rep, threads=threads,
                                     blocks_per_sm=cuda_build.blocks_per_sm(rep, threads))
    log("kernels/fwd_ptxas", **{k: out.get(k) for k in FWD_NAMES})
    log("kernels/bwd_ptxas", **{k: v for k, v in out.items() if k not in FWD_NAMES})
    if len(out) != len(KERNEL_INSTANCES) or any(
            r.get("spill_stores", 1) or r.get("spill_loads", 1) for r in out.values()):
        raise AssertionError(f"a compositor kernel is missing or spills: {out}")
    return out


def compare_16_rows(label: str, table, fwd_outputs, seed: int) -> dict:
    """The JAX package's 16-row table on the card: the forward's outputs,
    and rows 0..8 of each backward entry's gradient (v3, v4, v2, float32 and
    `amp`), equal the port's 9-row table's bit for bit, and the gradient's
    rows 9..15 are exact zeros."""
    from gaussianavatars_torch.ops import composite_pairs as cp

    dataT, starts, counts, th, tw, ntx = table
    pad = torch.zeros((16, dataT.shape[1]), dtype=dataT.dtype, device=dataT.device)
    pad[:9] = dataT
    fwd16 = cp.fwd_call_pairs(pad, starts, counts, th, tw, ntx)
    res = {"composite_pairs_fwd": all(map(torch.equal, fwd16, fwd_outputs))}
    g_acc_t, g_t = cotangents(starts.shape[0], th * tw, dataT.device, seed)
    rest = (starts, counts, *fwd_outputs, g_acc_t, g_t, th, tw, ntx)
    for impl, amp in BWD_ENTRIES:
        d9 = with_impl(impl, lambda: cp.bwd_call_pairs(dataT, *rest, amp=amp))
        d16 = with_impl(impl, lambda: cp.bwd_call_pairs(pad, *rest, amp=amp))
        res[cp.bwd_entry(impl, amp)[1]] = bool(torch.equal(d16[:9], d9) and not d16[9:].any())
    log(f"kernels/16_rows_{label}", **res)
    if not all(res.values()):
        raise AssertionError(f"16-row table differs from the 9-row one: {res}")
    return res


def time_bwd(impl: str, amp: bool, stop, bwd_args) -> dict:
    """One backward entry point at one table: the wrapper's ms (its
    allocation and zero fill included) and the kernel's alone (into one
    output), CUDA events; the plain version's ms (once); the wrapper's bound
    (the table it returns written once) and the kernel's (rows 0..8 of
    every column, which every implementation's kernel writes)."""
    from gaussianavatars_torch.ops import composite_pairs as cp

    dataT, starts, counts = bwd_args[:3]
    p = bwd_args[-3] * bwd_args[-2]
    ms = with_impl(impl, lambda: cuda_ms(lambda: cp.bwd_call_pairs(*bwd_args, amp=amp),
                                         N_KERNEL_REPS))
    dgrad = torch.zeros_like(dataT)
    kernel_ms = with_impl(impl, lambda: cuda_ms(
        lambda: cp._launch_bwd_cuda(dgrad, *bwd_args, amp=amp), N_KERNEL_REPS))
    del dgrad
    k_bound = bwd_bound(starts, counts, stop, p, (9, dataT.shape[1]))
    return dict(ms=ms, kernel_ms=kernel_ms,
                plain_ms=plain_ms(lambda: cp.bwd_call_pairs_reference(*bwd_args, amp=amp)),
                kernel_bound_ms=k_bound["bound_ms"], kernel_bound_by=k_bound["bound_by"],
                **bwd_bound(starts, counts, stop, p, tuple(dataT.shape)))


def time_entries(table, fwd_outputs, bwd_args) -> dict:
    """Per other entry point at the full frame: ms (CUDA events; the
    wrapper, its allocation included), the kernel alone, the plain
    version's time (once), and the bound of the same work
    (`compositor_bound`/`bwd_bound`: every implementation does row 1's or
    row 2's work)."""
    from gaussianavatars_torch.ops import composite_pairs as cp

    stop = fwd_outputs[2]
    out = {}
    for name, (kind, impl, amp, _src, _rep) in compositor_entries().items():
        if name in ("composite_pairs_fwd", "composite_pairs_bwd"):
            continue
        if kind == "fwd":
            res = with_impl(impl, lambda: time_fwd(table, stop))
        else:
            res = time_bwd(impl, amp, stop, bwd_args)
        out[name] = res
    return out


def time_fwd(table, stop) -> dict:
    """The `_FWD_IMPL` forward at one table: the wrapper's ms (its three
    allocations included) and the kernel's alone (into one set of outputs),
    CUDA events, and the kernel's device time (`graph_ms`); the plain
    version's ms (once) and the bound."""
    from gaussianavatars_torch.ops import composite_pairs as cp

    dataT, starts, counts, th, tw, _ntx = table
    ms = cuda_ms(lambda: cp.fwd_call_pairs(*table), N_KERNEL_REPS)
    out = cp._fwd_output(dataT, starts, th, tw)
    kernel_ms = cuda_ms(lambda: cp._launch_fwd_cuda(out, *table), N_KERNEL_REPS)
    device_ms = graph_ms(lambda: cp._launch_fwd_cuda(out, *table), N_KERNEL_REPS)
    return dict(ms=ms, kernel_ms=kernel_ms, kernel_device_ms=device_ms,
                plain_ms=plain_ms(lambda: cp.fwd_call_pairs_reference(*table)),
                **compositor_bound(starts, counts, stop, th * tw))


def plain_ms(fn) -> float:
    """Milliseconds of one call on the host clock, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def bwd_bound(starts, counts, stop, p: int, out_shape=None) -> dict:
    """Least time for this frame's backward compositing on an H100 SXM:
    walked pairs × P pixel evaluations of BWD_FLOPS_PER_EVAL, against the
    walked pairs' nine rows read, the per-pixel inputs (acc, t_final, stop
    and the two cotangents: 9 words) and the output. With `out_shape`, the
    wrapper's output: the whole (rows, n_cols) table it returns written
    once (its zero fill; 9 rows on the main path); without, the kernel's
    own: nine rows of the walked pairs."""
    pairs = int(walked_pairs(starts, counts, stop).sum())
    nt = starts.shape[0]
    ops = pairs * p * BWD_FLOPS_PER_EVAL
    out_bytes = pairs * BYTES_PER_PAIR if out_shape is None else math.prod(out_shape) * 4
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
        "region_map": rng["train/region_map"],
        "color_net_fwd": rng["train/color_net"],
        "contrastive": rng["train/contrastive"] + rng["train/contrastive_update"],
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


def train_setup(dev, model, params, aux, fl, cam, tile_cfg):
    """The training phases' target, background and first state: a target
    rendered with the jaw at 0.15 and the SH DC perturbed (σ 0.3), `Config`
    defaults, two timesteps."""
    from gaussianavatars_torch.config import Config
    from gaussianavatars_torch.render import AvatarRenderer
    from gaussianavatars_torch.training.trainer import init_train_state

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
    return cfg, gt, bg, state0


def phase_train(model, params, aux, cam, tile_cfg, card, setup) -> dict:
    """The FLAME-bound training step at full width (phases 6 and 7)."""
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.ops import rasterize_sorted as rs
    from gaussianavatars_torch.training.trainer import make_train_step

    cfg, gt, bg, state0 = setup
    dev = gt.device
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
    reset_launches()
    losses, overflow = [], torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for i in range(N_TRAIN_STEPS):
        out = step(state, gt, cam, i % TRAIN_TIMESTEPS, bg, 3)
        state = out.state
        losses.append(out.metrics["loss"])
        overflow = torch.maximum(overflow, out.metrics["budget_overflow"].to(torch.int64))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    entry_launches = dict(cp.LAUNCHES, binding_segment_sum=binding_launches(N_TRAIN_STEPS,
                                                                            "train"))
    launches = {"fwd": entry_launches["composite_pairs_fwd"],
                "bwd": entry_launches["composite_pairs_bwd"]}
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
    return dict(res, steps_per_s=steps_per_s, entry_launches=entry_launches)


def phase_ab(card) -> tuple[dict, dict]:
    """Phase 9: the kernel A/B entry point over v2, v3 and v4, float32 and
    `--amp`, at the benchmark frame. Each run's launches are counted from 0;
    every entry point of the run's implementations must have launched."""
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.tools import kernel_ab

    impls = ("v2", "v3", "v4")
    results, launches = {}, dict.fromkeys(cp.LAUNCHES, 0)
    for amp in (False, True):
        reset_launches()
        args = ["--impls", ",".join(impls), "--iters", str(N_AB_ITERS)] + (["--amp"] * amp)
        results[amp] = kernel_ab.main(args)
        own = {cp.fwd_entry(i)[1] for i in impls} | {cp.bwd_entry(i, amp)[1] for i in impls}
        missing = [e for e in own if cp.LAUNCHES[e] == 0]
        stray = [e for e, k in cp.LAUNCHES.items() if k and e not in own]
        if missing or stray or (cp._FWD_IMPL, cp._BWD_IMPL) != ("v3", "v3"):
            raise AssertionError(f"A/B (amp={amp}): entry points not launched {missing}, "
                                 f"launched but not asked for {stray}, switch left on "
                                 f"{cp._FWD_IMPL}/{cp._BWD_IMPL}")
        for e, k in cp.LAUNCHES.items():
            launches[e] += k
    for impl in impls:
        log(f"ab/{impl}", **results[False][impl], amp=results[True][impl], iters=N_AB_ITERS,
            card=card["nvidia_smi"])
    return results, launches


def update_stats(before, after_32, after_16) -> dict:
    """Per UPDATE_KEYS leaf: the cosine of the two steps' parameter updates
    and the ratio of their norms (amp over float32)."""
    out = {}
    for name in UPDATE_KEYS:
        u32 = getattr(after_32.params, name) - getattr(before.params, name)
        u16 = getattr(after_16.params, name) - getattr(before.params, name)
        n32, n16 = float(u32.norm()), float(u16.norm())
        out[name] = dict(cosine=float((u32 * u16).sum()) / (n32 * max(n16, 1e-12)),
                         norm_ratio=n16 / n32)
    return out


def one_step_vs_f32(step32, step16, state0, gt, cam, bg) -> dict:
    """One float32 and one `amp` step from one state: the loss and SSIM of
    each, and `update_stats` of their parameter updates."""
    o32 = step32(state0, gt, cam, 0, bg, 3)
    o16 = step16(state0, gt, cam, 0, bg, 3)
    l32, l16 = float(o32.metrics["loss"]), float(o16.metrics["loss"])
    # The metric holds (1 - SSIM) · lambda_dssim.
    return dict(loss_f32=l32, loss_amp=l16, loss_rel_diff=abs(l32 - l16) / max(abs(l32), 1e-9),
                dssim_term_f32=float(o32.metrics["ssim"]),
                dssim_term_amp=float(o16.metrics["ssim"]),
                updates=update_stats(state0, o32.state, o16.state))


def phase_train_amp(model, aux, cam, tile_cfg, card, setup) -> dict:
    """Phase 10: the training step with `use_amp` at full width.

    `tests/test_amp.py`'s criteria hold where the bf16 blur policy (the
    JAX package's, ported as it is) is well conditioned: SSIM's variance
    terms are differences of bf16-rounded moments, so they are only as good
    as bf16 resolves them against the window's variances. The phase's
    target is textured, as `tests/test_amp.py`'s is: uniform noise in
    [0, 1] (seeded). Two more targets are measured and logged, not held:
    `tests/test_amp.py`'s own noise range [0.25, 0.75], where the
    benchmark avatar's smooth render leaves the loss criterion at its edge,
    and the smooth rendered target of phase 6, where the policy cannot
    track float32 at all."""
    from gaussianavatars_torch.config import Config
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.training.trainer import make_train_step

    cfg32, gt_rendered, bg, state0 = setup
    dev = gt_rendered.device
    noise = torch.rand(gt_rendered.shape, generator=torch.Generator().manual_seed(12)).to(dev)
    gt = noise
    step32 = make_train_step(model, cfg32, tile_cfg)
    step16 = make_train_step(model, Config(opt=dataclasses.replace(cfg32.opt, use_amp=True)),
                             tile_cfg)

    for label, target in (("rendered_target", gt_rendered),
                          ("noise_0.25_0.75", noise * 0.5 + 0.25)):
        log(f"train_amp/one_step_vs_f32_{label}",
            **one_step_vs_f32(step32, step16, state0, target, cam, bg),
            note="measured, not held to tests/test_amp.py's criteria")
    # tests/test_amp.py's criteria.
    one = one_step_vs_f32(step32, step16, state0, gt, cam, bg)
    log("train_amp/one_step_vs_f32", **one, target="uniform noise in [0, 1], seed 12")
    if not (one["loss_rel_diff"] < 1e-2 and all(
            u["cosine"] > 0.98 and abs(u["norm_ratio"] - 1.0) < 0.1
            for u in one["updates"].values())):
        raise AssertionError(f"the amp step does not track the float32 step: {one}")

    state = state0
    for i in range(N_TRAIN_WARMUP):
        state = step16(state, gt, cam, i % TRAIN_TIMESTEPS, bg, 3).state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, overflow = [], torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for i in range(N_AMP_STEPS):
        out = step16(state, gt, cam, i % TRAIN_TIMESTEPS, bg, 3)
        state = out.state
        losses.append(out.metrics["loss"])
        overflow = torch.maximum(overflow, out.metrics["budget_overflow"].to(torch.int64))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(cp.LAUNCHES)
    binding = binding_launches(N_AMP_STEPS, "train_amp")
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    loss = torch.stack(losses).tolist()
    finite = dict(params=all_finite(state.params), flame=all_finite(state.flame),
                  grads=all_finite(state.adam.mu) and all_finite(state.flame_adam.mu))
    res = dict(steps=N_AMP_STEPS, launches={k: v for k, v in launches.items() if v},
               budget_overflow=int(overflow), loss_first=loss[0], loss_last=loss[-1],
               loss_finite=all(map(math.isfinite, loss)), finite=finite,
               psnr_last=float(out.metrics["psnr"]))
    log("train_amp", **res)
    if res["launches"] != {"composite_pairs_fwd": N_AMP_STEPS,
                           "composite_pairs_bwd_amp": N_AMP_STEPS}:
        raise AssertionError(f"amp training launches {res['launches']} for {N_AMP_STEPS} steps")
    if not (res["loss_finite"] and loss[-1] < loss[0] and int(overflow) == 0
            and all(finite.values())):
        raise AssertionError(f"amp training checks failed: {res}")

    # Steps/s of both modes in alternating blocks (float32, amp, amp,
    # float32), each continuing its own state.
    # Each block's peak memory is read over the same live set.
    states = {False: state0, True: state}
    block_s = {False: [], True: []}
    block_peak = {False: 0.0, True: 0.0}
    for amp in (False, True, True, False):
        st, step = states[amp], (step16 if amp else step32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(N_AMP_BLOCK):
            st = step(st, gt, cam, i % TRAIN_TIMESTEPS, bg, 3).state
        torch.cuda.synchronize()
        block_s[amp].append(time.perf_counter() - t0)
        block_peak[amp] = max(block_peak[amp], torch.cuda.max_memory_allocated() / 2**20)
        states[amp] = st
    rate = {amp: N_AMP_BLOCK * len(b) / sum(b) for amp, b in block_s.items()}
    prof_res = profile_train(step16, state, gt, cam, bg, N_AMP_STEPS / wall_s)
    log("train_amp/numbers", card=card["nvidia_smi"], steps_per_s=N_AMP_STEPS / wall_s,
        ms_per_step=1e3 * wall_s / N_AMP_STEPS, peak_mem_mib=peak_mib,
        alternating_steps_per_s={"f32": rate[False], "amp": rate[True]},
        alternating_peak_mem_mib={"f32": block_peak[False], "amp": block_peak[True]},
        alternating_block_ms_per_step={
            "f32": [1e3 * b / N_AMP_BLOCK for b in block_s[False]],
            "amp": [1e3 * b / N_AMP_BLOCK for b in block_s[True]]},
        **prof_res)
    return dict(res, one_step=one, entry_launches=dict(launches, binding_segment_sum=binding),
                steps_per_s=N_AMP_STEPS / wall_s)


PEAK_TF32_FLOPS = 495e12   # H100 SXM, dense TF32 on the tensor cores
MICRO_REL_TOL = 1e-5       # every slot, each micro-reduce kernel against its plain version
# The instruction each micro-reduce kernel's route must show in its SASS:
# A on the CUDA cores, B by warp shuffles, C on the tensor cores by
# mma.sync, D by wgmma.
MICRO_ROUTE_OPCODE = {"a": "FFMA", "b": "SHFL", "c": "HMMA", "d": "HGMMA"}
N_LIBRARY_REPS = 20


def micro_reduce_entries() -> dict:
    """The four C entry points of csrc/micro_reduce.cu: name → (formulation,
    the TPU kernel it replaces)."""
    lines = {"a": 46, "b": 62, "c": 76, "d": 99}
    return {f"micro_reduce_{k}": (k, f"scripts/micro_reduce_bench.py:{line}")
            for k, line in lines.items()}


def route_floor(k: str, nt: int) -> dict:
    """Least time of a tensor-core formulation's own products: their count
    in m16n8k8 TF32 products (2·16·8·8 FLOP each) at the dense TF32 peak.
    Per 16 slots and chunk, 1024 / 8 k-steps × 3 (3xTF32) × the n-tiles: 9
    for C (one a field, 1 of 8 columns live), 2 for D (the 9 columns in
    16; its wgmma.m64n16k8 is 4 × 2 of them over 64 slots)."""
    from gaussianavatars_torch.tools import micro_reduce_bench as mr

    n_tiles = {"c": mr.NRED, "d": 2}[k]
    mma = (nt * mr.C // 16) * (mr.ROWS * mr.LANES // 8) * 3 * n_tiles
    return dict(route_mma=mma, route_floor_ms=1e3 * mma * 2 * 16 * 8 * 8 / PEAK_TF32_FLOPS)


def micro_reduce_bound(nt: int) -> dict:
    """Least time for the micro-benchmark's work on an H100 SXM: NT·C·9·1024
    multiply-adds (every formulation does the same work) and the table read
    and written once."""
    from gaussianavatars_torch.tools import micro_reduce_bench as mr

    flops = 2 * nt * mr.C * mr.NRED * mr.ROWS * mr.LANES
    nbytes = 2 * nt * mr.C * 4
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return dict(flops=flops, bytes=nbytes, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_ms_tf32=1e3 * flops / PEAK_TF32_FLOPS,
                bound_ms_3xtf32=3e3 * flops / PEAK_TF32_FLOPS)


def phase_micro_reduce(card, built, against=()) -> dict:
    """Phase 11: `tools/micro_reduce_bench.main` at NT = 468 (the main path:
    each kernel's warm-up and 50 chained launches), then each kernel against
    its plain version on the same input, the plain versions' times, the
    `torch.matmul` yardstick and the bounds, each kernel's share of its
    bound (and for C and D of their route's tensor-core floor), its ptxas
    report (`built`: phase 2's compiler output) and the count of some
    opcodes in its SASS. The no-fold gate: the phase fails if A or B runs
    above 1.05 of its bound, C or D above 1.05 of its route's floor (a
    tensor-core route may beat the CUDA-core bound), or a kernel's SASS
    (which must be readable) lacks its route's instruction
    (`MICRO_ROUTE_OPCODE`). With `--against`, each other checkout's four
    kernels beside this one's (`time_micro_against`)."""
    from gaussianavatars_torch import cuda_build
    from gaussianavatars_torch.tools import micro_reduce_bench as mr

    ptxas = cuda_build.ptxas_report(built["micro_reduce"]["log"])
    sass = cuda_build.sass_opcodes(cuda_build.library_sass("micro_reduce"))

    for k in mr.LAUNCHES:
        mr.LAUNCHES[k] = 0
    res = mr.main(["--nt", str(mr.NT), "--iters", "50"])
    launches = dict(mr.LAUNCHES)
    x = torch.rand((mr.NT, mr.C, 1), generator=torch.Generator().manual_seed(0)).to("cuda")
    # The yardstick: the materialised [NT·C, 1024] plane (built outside the
    # timed window) times the [1024, 9] basis, TF32 off (phase 1). It
    # computes the 9 per-slot sums; their 9-column sum is left out.
    plane = x.reshape(-1, 1).expand(-1, mr.ROWS * mr.LANES).contiguous()
    basis = torch.arange(1, mr.NRED + 1, dtype=torch.float32, device="cuda").expand(
        mr.ROWS * mr.LANES, mr.NRED).contiguous()
    library_ms = cuda_ms(lambda: torch.matmul(plane, basis), N_LIBRARY_REPS)
    del plane
    bound = micro_reduce_bound(mr.NT)
    out = {}
    for name, (k, rep) in micro_reduce_entries().items():
        got = mr.reduce_slots(k, x)
        torch.cuda.synchronize()
        want = mr.PLAIN[k](x)
        rel = mr.relative_error(got, want)
        r = dict(ms=res[k]["ms"], plain_ms=plain_ms(lambda: mr.PLAIN[k](x)),
                 library_ms=library_ms, max_abs_err=float((got - want).abs().max()),
                 max_rel_err=rel, max_rel_err_vs_46080x=mr.relative_error(got, 46080.0 * x),
                 launches=launches[name], replaces=rep, **bound)
        if k in ("a", "b"):
            r.pop("bound_ms_tf32"), r.pop("bound_ms_3xtf32")
        else:
            r.update(route_floor(k, mr.NT))
            r["route_floor_share"] = r["route_floor_ms"] / r["ms"]
        r["bound_share"] = r["bound_ms"] / r["ms"]
        kern = f"kern_{k}E"   # the kernel's mangled name holds this
        r["ptxas"] = next((v for n, v in ptxas.items() if kern in n), None)
        r["sass"] = next((v for n, v in sass.items() if kern in n), None)
        r["fold_failures"] = cuda_build.fold_failures(name, r["bound_share"], r["sass"],
                                                      MICRO_ROUTE_OPCODE[k],
                                                      r.get("route_floor_share"))
        log(f"micro_reduce/{k}", **r, card=card["nvidia_smi"])
        if not rel <= MICRO_REL_TOL:
            raise AssertionError(f"{name} disagrees with its plain version: {r}")
        out[name] = r
    missing = [e for e, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"micro_reduce entry points not launched: {missing}")
    folded = [f for r in out.values() for f in r["fold_failures"]]
    if folded:
        raise AssertionError(f"micro_reduce times that are not their route's: {folded}")
    log("micro_reduce/yardstick", library_ms=library_ms, card=card["nvidia_smi"],
        note="torch.matmul of the [NT*C, 1024] plane by the [1024, 9] basis, TF32 off; "
             "the sum over the 9 columns is left out")
    for k in "abcd" if against else "":   # D the redesign, A-C controls
        time_micro_against(k, against, x, card)
    return out


def time_micro_against(k: str, against, x, card) -> dict:
    """micro_reduce_<k> of this checkout beside each `--against` checkout's
    on the same input, on one card in one call: N_KERNEL_REPS launches into
    one output (CUDA events) and as a CUDA graph (`graph_ms`), in the order
    others, this, this, others reversed; each other's output against this
    one's (max relative error a slot). The C entry points are called
    directly, so these comparison launches add to no count."""
    from gaussianavatars_torch.tools import micro_reduce_bench as mr

    sym = f"micro_reduce_{k}"
    own = mr._kernel_fn(sym)
    fns = {"this": own}
    for root, libs in against:
        fn = getattr(libs["micro_reduce"], sym)
        fn.restype, fn.argtypes = own.restype, own.argtypes
        fns[root] = fn
    outs = {name: torch.empty_like(x) for name in fns}

    def launcher(name):
        def launch():   # on the current stream, which a graph capture replaces
            err = fns[name](x.data_ptr(), outs[name].data_ptr(), x.shape[0],
                            torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{sym} of {name}: CUDA error {err}")
        return launch

    times = {name: {"kernel_ms": [], "device_ms": []} for name in fns}
    others = [name for name in fns if name != "this"]
    for name in others + ["this", "this"] + others[::-1]:
        times[name]["kernel_ms"].append(cuda_ms(launcher(name), N_KERNEL_REPS))
        times[name]["device_ms"].append(graph_ms(launcher(name), N_KERNEL_REPS))
    torch.cuda.synchronize()
    res = dict(times=times, nt=x.shape[0])
    for name in others:
        res[f"max_rel_err/{name}"] = mr.relative_error(outs[name], outs["this"])
    log(f"against/micro_reduce/{sym}", **res, card=card["nvidia_smi"])
    return res


LOOP_FLAGS = ("--width", "802", "--height", "550", "--capacity", "131072", "--per_face", "2",
              "--timesteps", "12", "--cameras", "8", "--iterations", "800",
              "--log_every", "100", "--eval_every", "400", "--checkpoint_every", "400",
              "--opacity_reset_interval", "600")
LOOP_WORKDIR = os.path.join("build", "chip_smoke", "train_synthetic")
N_LOOP_AB = 30          # steps per block of the loop/bare-step alternation


def sync_sites(fn) -> dict:
    """{"file:line": count} of the synchronising CUDA calls fn() makes, by
    the Python line that made each (torch's sync debug mode)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites: dict = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def sync_count(fn) -> int:
    """Synchronising CUDA calls that fn() makes."""
    return sum(sync_sites(fn).values())


def train_view_overflow(harness) -> int:
    """Budget overflow of the final state on every training view with the
    loop's last tile budgets (the overflow the loop leaves unhandled)."""
    from gaussianavatars_torch.models.binding import face_frames
    from gaussianavatars_torch.models.gaussians import world_gaussians
    from gaussianavatars_torch.ops.projection import project_from_params
    from gaussianavatars_torch.ops.rasterize_sorted import rasterize_sorted
    from gaussianavatars_torch.ops.rasterize_tiled import view_colors
    from gaussianavatars_torch.training.loop import _flame_params

    st, model, tcfg = harness.state, harness.model, harness.live_tile_config
    worst = 0
    with torch.no_grad():
        for cam in harness.scene.cameras("train"):
            verts = model(_flame_params(st, cam.timestep))
            wg = world_gaussians(st.params, st.aux, face_frames(verts[0], model.faces))
            proj = project_from_params(wg.means, wg.scales, wg.quats, cam, alive=wg.alive)
            colors = view_colors(wg.means, wg.sh, cam, 0)
            opac = torch.where(proj.mask, wg.opacity, torch.zeros_like(wg.opacity))
            _img, _a, plan = rasterize_sorted(proj, colors, opac, cam.height, cam.width,
                                              torch.zeros(3, device=opac.device), tcfg.tile_h,
                                              tcfg.tile_w, tcfg.tier_spec(st.params.capacity))
            worst = max(worst, int(plan.budget_overflow))
    return worst


def phase_loop(card) -> dict:
    """Phase 12: the host loop at full width through `tools/train_synthetic`
    (dataset, untrained eval, 800 iterations with a densify event at 750,
    an opacity reset at 600, evals and checkpoints at 400 and 800, a PLY
    save at 800, final eval), then a resume from the 400 checkpoint."""
    from gaussianavatars_torch.config import from_json
    from gaussianavatars_torch.data import pipeline as pipe
    from gaussianavatars_torch.models.flame.assets import load_assets
    from gaussianavatars_torch.models.flame.flame_model import FlameConfig, FlameModel
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.tools import train_synthetic as ts
    from gaussianavatars_torch.training import loop
    from gaussianavatars_torch.training.checkpoint import (
        GENERATOR_KEY, flatten_state, load_train_state,
    )
    from gaussianavatars_torch.training.trainer import make_train_step

    shutil.rmtree(LOOP_WORKDIR, ignore_errors=True)
    args = ts.parse_args([*LOOP_FLAGS, "--workdir", LOOP_WORKDIR])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # Earlier phases' tensors still held: the loop's own peak is above this.
    start_mib = torch.cuda.memory_allocated() / 2**20
    reset_launches()
    harness, result = ts.run(args)
    torch.cuda.synchronize()
    launches = dict(cp.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    logs, events = result["logs"], harness.events
    iters = args.iterations
    binding = binding_launches(iters, "loop")

    # Launches: the backward once per training step; the forward once per
    # step, per dataset view rendered and per eval view.
    eval_views = sum(e["n"] for e in events if e["kind"] == "eval")
    eval_views += sum(result[k]["n"] for k in result if k.startswith("eval_"))
    n_views = args.timesteps * args.cameras
    expect = {"composite_pairs_fwd": iters + n_views + eval_views, "composite_pairs_bwd": iters}
    got = {k: launches[k] for k in expect}
    stray = {k: v for k, v in launches.items() if v and k not in expect}
    densify = [e for e in events if e["kind"] == "densify"]
    points = {r["iteration"]: r["num_points"] for r in logs}
    model_dir = os.path.join(LOOP_WORKDIR, "model")
    ckpts = ts.checkpoint_iterations(args)
    artifacts = ["cfg_args.json", "cameras.json", "flame_assets.npz",
                 f"point_cloud/iteration_{iters}/point_cloud.ply",
                 f"point_cloud/iteration_{iters}/flame_param.npz",
                 *(f"chkpnt{i}.npz" for i in ckpts)]
    missing = [a for a in artifacts if not os.path.exists(os.path.join(model_dir, a))]
    overflow_left = train_view_overflow(harness)
    psnr = {s: (result[f"eval_untrained_{s}"]["psnr"], result[f"eval_{s}"]["psnr"])
            for s in ("val", "test")}
    res = dict(launches=got, expected_launches=expect, stray_launches=stray,
               densify=densify, points_by_log=points,
               loss_by_log=[r["loss"] for r in logs], psnr_untrained_vs_trained=psnr,
               missing_artifacts=missing, tier_growths=[e for e in events
                                                        if e["kind"] == "grow_tiers"],
               train_view_budget_overflow=overflow_left)
    log("loop", **res)
    # Live Gaussians at the logs around the densify event.
    d_it = densify[0]["iteration"] if densify else None
    around = [points[max(i for i in points if i < d_it)],
              points[min(i for i in points if i > d_it)]] if densify else []
    res["points_around_densify"] = around
    checks = {
        "launches": got == expect and not stray,
        "densify": (len(densify) == 1 and densify[0]["cloned"] + densify[0]["split"] > 0
                    and around[0] != around[1]),
        "loss": all(map(math.isfinite, res["loss_by_log"])) and logs[-1]["loss"] < logs[0]["loss"],
        "psnr": all(math.isfinite(b) and b > a for a, b in psnr.values()),
        "artifacts": not missing,
        "overflow": overflow_left == 0,
    }
    if not all(checks.values()):
        raise AssertionError(f"loop checks failed: {checks}")

    # --- numbers ---------------------------------------------------------
    elapsed = {r["iteration"]: r["elapsed_s"] for r in logs}
    first_event = min(e["iteration"] for e in events if e["kind"] not in ("gt_cache",))
    before = max(i for i in elapsed if i <= first_event)
    by_kind: dict[str, list] = {}
    for e in events:
        by_kind.setdefault(e["kind"], []).append(e["ms"])
    gt = next(e for e in events if e["kind"] == "gt_cache")
    log("loop/numbers", card=card["nvidia_smi"], resolution=f"{args.width}x{args.height}",
        steps_per_s_whole_loop=iters / result["train_s"],
        steps_per_s_100_before_first_event=100.0 / (elapsed[before] - elapsed[before - 100]),
        window=[before - 100, before],
        event_host_ms=by_kind, dataset_write_s=result["dataset_write_s"],
        gt_cache_views=gt["views"], images_decoded_per_s=gt["views"] / (gt["ms"] / 1e3),
        gt_cache_mib=gt["views"] * args.width * args.height * 3 / 2**20,
        peak_mem_mib=peak_mib,
        peak_mem_above_start_mib=peak_mib - start_mib,
        live_gaussians_final=logs[-1]["num_points"], capacity=args.capacity,
        steps_per_call=args.steps_per_call, chunk_captures=harness.chunk_captures,
        eval={k: v for k, v in result.items() if k.startswith("eval_")})

    # --- resume from the first checkpoint -----------------------------------
    cfg = from_json(open(os.path.join(model_dir, "cfg_args.json")).read())
    model = FlameModel(load_assets(os.path.join(model_dir, "flame_assets.npz")),
                       FlameConfig(n_shape=args.n_shape, n_expr=args.n_expr, add_teeth=False),
                       device="cuda")
    start = ckpts[0]
    ckpt = os.path.join(model_dir, f"chkpnt{start}.npz")
    h2 = loop.build_harness(cfg, model=model, start_checkpoint=ckpt, device="cuda")
    saved = np.load(ckpt)
    leaves = flatten_state(h2.state)
    unequal = [k for k, v in leaves.items()
               if not torch.equal(v.cpu(), torch.as_tensor(saved[k]).to(v.dtype))]
    gen_equal = torch.equal(h2.state.generator.get_state(),
                            torch.as_tensor(saved[GENERATOR_KEY]))
    if h2.start_iteration != start or unequal or not gen_equal or set(leaves) != (
            set(saved.files) - {"__iteration__", "key", GENERATOR_KEY}):
        raise AssertionError(f"resume: state differs from the checkpoint: {unequal}")
    # 10 then 20 steps: the loop's own synchronising calls per step must be
    # the bare step's (it reads device values only at the log cadence).
    reset_launches()
    s10 = sync_count(lambda: loop.train(h2, iterations=start + 10, log_every=1000,
                                        eval_every=0))
    s30 = sync_count(lambda: loop.train(dataclasses.replace(h2, start_iteration=start + 10),
                                        iterations=start + 30, log_every=1000, eval_every=0))
    st = h2.state
    step = make_train_step(model, cfg, h2.live_tile_config,
                           spatial_lr_scale=h2.spatial_lr_scale)
    cam = h2.scene.cameras("train")[0]
    gt0 = torch.from_numpy(pipe.load_view(h2.scene.records("train")[0], cam)).cuda()
    bg = torch.zeros(3, device="cuda")
    step(st, gt0, cam, cam.timestep, bg, 0)
    s_step = sync_count(lambda: [step(st, gt0, cam, cam.timestep, bg, 0) for _ in range(5)])
    resumed = dict(start_iteration=h2.start_iteration, leaves=len(leaves),
                   generator_restored=gen_equal, launches=dict(cp.LAUNCHES),
                   syncs_10_steps=s10, syncs_20_steps=s30, syncs_per_bare_step=s_step / 5,
                   loop_syncs_per_step=(s30 - s10) / 10)
    log("loop/resume", **resumed)
    if cp.LAUNCHES["composite_pairs_bwd"] != 30 + 6:
        raise AssertionError(f"resume: backward launches {cp.LAUNCHES}")
    if (s30 - s10) / 10 != s_step / 5:
        raise AssertionError(f"the loop adds host synchronisations per step: {resumed}")

    # The loop against the bare step on the same state, in turns (loop, bare,
    # bare, loop; N_LOOP_AB steps each): what the loop itself costs a step.
    rates = {"loop": [], "bare": []}
    it0 = start + 30
    for kind in ("loop", "bare", "bare", "loop"):
        if kind == "loop":
            h3 = dataclasses.replace(h2, start_iteration=it0)
            lg = loop.train(h3, iterations=it0 + 2 * N_LOOP_AB, log_every=N_LOOP_AB,
                            eval_every=0)
            h2.state, it0 = h3.state, it0 + 2 * N_LOOP_AB
            # The logs fall on multiples of log_every, not on it0 + N_LOOP_AB.
            rates["loop"].append((lg[-1]["iteration"] - lg[0]["iteration"])
                                 / (lg[-1]["elapsed_s"] - lg[0]["elapsed_s"]))
        else:
            st = h2.state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(N_LOOP_AB):
                st = step(st, gt0, cam, cam.timestep, bg, 0).state
            torch.cuda.synchronize()
            rates["bare"].append(N_LOOP_AB / (time.perf_counter() - t0))
    log("loop/vs_bare_step", card=card["nvidia_smi"], steps=N_LOOP_AB, steps_per_s=rates,
        note="loop: the steps between its first and last log; bare: make_train_step on "
             "the same state, one view")
    # Where the fit's step spends its device time (the chunked loop runs at it).
    log("loop/profile", card=card["nvidia_smi"], **profile_train(
        step, h2.state, gt0, cam, bg, sum(rates["bare"]) / len(rates["bare"])))
    return dict(res, launches=dict(launches, binding_segment_sum=binding), harness=harness)


def fitted_view(harness):
    """The fitted avatar's first 802×550 training view (SH degree 0): its
    table, row 1 against the plain forward (`compare_kernel`'s result, the
    plain outputs included), and the backward's arguments with fixed-seed
    cotangents."""
    from gaussianavatars_torch.models.binding import face_frames
    from gaussianavatars_torch.models.gaussians import world_gaussians
    from gaussianavatars_torch.ops.projection import project_from_params
    from gaussianavatars_torch.ops.rasterize_sorted import depth_key, sort_gather
    from gaussianavatars_torch.ops.rasterize_tiled import view_colors
    from gaussianavatars_torch.ops.sort_binning import bbox_tiles
    from gaussianavatars_torch.training.loop import _flame_params

    st, model, tcfg = harness.state, harness.model, harness.live_tile_config
    cam = harness.scene.cameras("train")[0]
    th, tw = tcfg.tile_h, tcfg.tile_w
    nty, ntx = tcfg.grid(cam.height, cam.width)
    with torch.no_grad():
        verts = model(_flame_params(st, cam.timestep))
        wg = world_gaussians(st.params, st.aux, face_frames(verts[0], model.faces))
        proj = project_from_params(wg.means, wg.scales, wg.quats, cam, alive=wg.alive)
        colors = view_colors(wg.means, wg.sh, cam, 0)
        opac = torch.where(proj.mask, wg.opacity, torch.zeros_like(wg.opacity))
        tminx, tminy, bw, ntiles, _nty, _ntx = bbox_tiles(proj, cam.height, cam.width, th, tw,
                                                          opacity=opac)
        ntiles_eff = torch.where(proj.mask, ntiles, torch.zeros_like(ntiles))
        dataT, plan = sort_gather((nty * ntx, ntx, tcfg.tier_spec(st.params.capacity)),
                                  proj.mean2d, proj.conic, colors, opac,
                                  (tminx, tminy, bw, ntiles_eff, depth_key(proj.depth)))
    if int(plan.budget_overflow) != 0:
        raise AssertionError("fitted view: tier budget overflow")
    table = (dataT, plan.tile_starts, plan.counts, th, tw, ntx)
    fwd = compare_kernel(f"fitted_{cam.width}x{cam.height}", table)
    g_acc_t, g_t = cotangents(nty * ntx, th * tw, dataT.device, seed=23)
    args = (*table[:3], *fwd["outputs"], g_acc_t, g_t, th, tw, ntx)
    info = dict(live_gaussians=int(st.aux.alive.sum()), table_rows=dataT.shape[0],
                resolution=f"{cam.width}x{cam.height}")
    return table, fwd, args, info


def phase_fitted_bwd(card, harness, against=()) -> dict:
    """Phase 13: the compositor kernels on the fitted avatar (phase 12's
    state after its 800 iterations, `fitted_view`): rows 1 and 3 bit for
    bit against their plain version (acc, t_final, stop ids) and timed
    (`time_fwd`); each backward entry
    (rows 2, 5 and 4: v3, v4 and v2, float32 and `amp`) against its plain
    version (`bwd_errors`, every column written) and timed (`time_bwd`),
    with the walked pairs; the `--against` checkouts' kernels beside them.
    These launches are comparisons and timings, outside every counted
    main-path run."""
    from gaussianavatars_torch.ops import composite_pairs as cp

    table, fwd, args, info = fitted_view(harness)
    outputs, plain = fwd["outputs"], fwd.pop("plain")
    walked = walked_pairs(table[1], table[2], outputs[2])
    walks = dict(longest_walk=int(walked.max()), mean_walk=float(walked.float().mean()))
    out = {}
    for impl in ("v3", "v2"):
        name = cp.fwd_entry(impl)[1]
        got = with_impl(impl, lambda: cp.fwd_call_pairs(*table))
        torch.cuda.synchronize()
        bit_equal = dict(zip(("acc", "t_final", "stop"), map(torch.equal, got, plain)))
        del got
        out[name] = dict(with_impl(impl, lambda: time_fwd(table, outputs[2])),
                         bit_equal=bit_equal)
        log(f"fitted/fwd/{name}", **out[name], **info, **walks, card=card["nvidia_smi"])
        if not all(bit_equal.values()):
            raise AssertionError(f"{name} disagrees with its plain version on the fitted "
                                 f"view: {bit_equal}")
    del plain
    with torch.no_grad():
        for impl, amp in BWD_ENTRIES:
            name = cp.bwd_entry(impl, amp)[1]
            d = with_impl(impl, lambda: cp.bwd_call_pairs(*args, amp=amp))
            torch.cuda.synchronize()
            res = bwd_errors(d, cp.bwd_call_pairs_reference(*args, amp=amp))
            res["writes_every_column"] = with_impl(impl, lambda: writes_every_column(d, args, amp))
            del d
            res.update(time_bwd(impl, amp, outputs[2], args))
            log(f"fitted/bwd/{name}", **res, **info, **walks, card=card["nvidia_smi"])
            if not (max(res["rel_err_per_row"]) <= BWD_REL_TOL and res["zeros_exact"]
                    and res["writes_every_column"]):
                raise AssertionError(f"{name} disagrees with its plain version on the fitted "
                                     f"view: {res}")
            out[name] = res
        if against:
            time_against("fitted", against, table, outputs, args)
    return out


N_REPLAY_FPS_FRAMES = 300   # frames a round of the FPS benchmarks
N_REPLAY_FPS_ROUNDS = 3
REPLAY_DIR = os.path.join("build", "chip_smoke", "replay")
REPLAY_PARAM_KEYS = ("means", "log_scales", "quats", "sh_dc", "sh_rest", "logit_opacity")
# Regions the synthetic topology has masks for (it has no "face" mask, as
# FLAME's own masks are not in the repository): the viewer keeps the
# Gaussians of the left half visible.
REPLAY_VISIBLE_REGIONS = ["left_half"]


def sync_ms(fn, reps: int) -> float:
    """Host milliseconds per call of `fn`, synchronised before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def fwd_launches_only(expected: int, what: str) -> int:
    """Row 1's launches since the last reset; fails on any other entry."""
    from gaussianavatars_torch.ops import composite_pairs as cp

    got = dict(cp.LAUNCHES)
    other = {k: v for k, v in got.items() if v and k != "composite_pairs_fwd"}
    if got["composite_pairs_fwd"] != expected or other:
        raise AssertionError(f"{what}: launches {got}, expected {expected} of row 1 only")
    return got["composite_pairs_fwd"]


def view_overflow(core, cam) -> int:
    """Tier-budget overflow of the viewer core's avatar on `cam` at
    timestep 0 with the core's tile configuration."""
    from gaussianavatars_torch.models.binding import face_frames
    from gaussianavatars_torch.models.gaussians import world_gaussians
    from gaussianavatars_torch.ops.projection import project_from_params
    from gaussianavatars_torch.ops.rasterize_sorted import rasterize_sorted
    from gaussianavatars_torch.ops.rasterize_tiled import view_colors

    t = core.tile
    with torch.no_grad():
        verts = core.model(core.flame_params_at(0))
        wg = world_gaussians(core.params, core.aux, face_frames(verts[0], core.model.faces))
        proj = project_from_params(wg.means, wg.scales, wg.quats, cam, alive=wg.alive)
        opac = torch.where(proj.mask, wg.opacity, torch.zeros_like(wg.opacity))
        _img, _a, plan = rasterize_sorted(proj, view_colors(wg.means, wg.sh, cam, 0), opac,
                                          cam.height, cam.width,
                                          torch.zeros(3, device=opac.device), t.tile_h,
                                          t.tile_w, t.tier_spec(core.params.capacity))
    return int(plan.budget_overflow)


def write_bench_avatar(model_dir: str) -> tuple:
    """`render.build_scene()`'s avatar (90,090 Gaussians) as a model
    directory: its PLY with the binding, a one-timestep flame_param.npz of
    its FLAME parameters, and its assets. Returns (PLY path, camera, probed
    tile configuration)."""
    from gaussianavatars_torch.data.ply import save_gaussian_ply
    from gaussianavatars_torch.models.flame.assets import save_assets
    from gaussianavatars_torch.render import build_scene, probe_tile_config

    model, params, aux, fl, cam, n = build_scene(device="cuda")
    live = aux.alive.cpu().numpy()
    assert int(live.sum()) == n
    out = os.path.join(model_dir, "point_cloud", "iteration_0")
    os.makedirs(out, exist_ok=True)
    ply = os.path.join(out, "point_cloud.ply")
    host = {k: getattr(params, k).cpu().numpy()[live] for k in REPLAY_PARAM_KEYS}
    save_gaussian_ply(ply, binding=aux.binding.cpu().numpy()[live], **host)
    np.savez(os.path.join(out, "flame_param.npz"),
             shape=fl.shape.cpu().numpy(), expr=fl.expr.cpu().numpy(),
             rotation=fl.rotation.cpu().numpy(), neck_pose=fl.neck.cpu().numpy(),
             jaw_pose=fl.jaw.cpu().numpy(), eyes_pose=fl.eyes.cpu().numpy(),
             translation=fl.translation.cpu().numpy(),
             static_offset=np.zeros((model.num_verts, 3), np.float32))
    save_assets(model.assets, os.path.join(model_dir, "flame_assets.npz"))
    return ply, cam, probe_tile_config(model, params, aux, fl, cam)


def run_fps(label: str, card, fn) -> dict:
    """An FPS benchmark run: its rounds, row 1's launches, peak memory."""
    from gaussianavatars_torch.tools.fps_benchmark_demo import N_WARMUP

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_mib = torch.cuda.memory_allocated() / 2**20
    reset_launches()
    fps = fn()
    torch.cuda.synchronize()
    frames = N_REPLAY_FPS_FRAMES * N_REPLAY_FPS_ROUNDS + min(N_WARMUP, N_REPLAY_FPS_FRAMES)
    launches = fwd_launches_only(frames, f"replay/fps/{label}")
    res = dict(fps_per_round=fps, frames_per_round=N_REPLAY_FPS_FRAMES, launches=launches,
               peak_mem_mib=torch.cuda.max_memory_allocated() / 2**20,
               mem_at_start_mib=start_mib, card=card["nvidia_smi"])
    log(f"replay/fps/{label}", **res)
    if not all(math.isfinite(f) and f > 0 for f in fps):
        raise AssertionError(f"replay/fps/{label}: {fps}")
    return res


N_ALTERNATE_FRAMES = 100   # frames a block of the serving/demo alternation


def alternate_vs_serving(renderer, poses, core, cam) -> dict:
    """Frames/s of phase 4's `AvatarRenderer.render` and of the demo
    benchmark's frame (`fps_benchmark_demo.run_benchmark`) on the same
    avatar, camera and tier budgets, in turns (serving, demo, demo at the
    renderer's capacity, the same again in reverse), N_ALTERNATE_FRAMES
    frames a block: what the demo's frame costs beside the serving path's."""
    from gaussianavatars_torch.tools.fps_benchmark_demo import run_benchmark

    cap = renderer.params.capacity
    trimmed = copy.copy(core)
    trimmed.params = dataclasses.replace(core.params, **{
        f.name: getattr(core.params, f.name)[:cap] for f in dataclasses.fields(core.params)})
    trimmed.aux = dataclasses.replace(core.aux, **{
        f.name: getattr(core.aux, f.name)[:cap] for f in dataclasses.fields(core.aux)})
    if int(trimmed.aux.alive.sum()) != core.num_points:
        raise AssertionError("the renderer's capacity drops live Gaussians")
    rates = {"serving": [], "demo": [], "demo_trimmed": []}
    for kind in ("serving", "demo", "demo_trimmed", "demo_trimmed", "demo", "serving"):
        if kind == "serving":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(N_ALTERNATE_FRAMES):
                renderer.render(poses[i])
            torch.cuda.synchronize()
            rates["serving"].append(N_ALTERNATE_FRAMES / (time.perf_counter() - t0))
        else:
            rates[kind] += run_benchmark(core if kind == "demo" else trimmed,
                                         N_ALTERNATE_FRAMES, 1, camera=cam)
    return dict(frames_per_s=rates, capacity={"serving": cap, "demo": core.params.capacity,
                                              "demo_trimmed": cap})


def phase_replay(card, harness, loop_res, serving) -> dict:
    """Phase 14: replay the fitted avatar that phase 12 left in its model
    directory, through the entry points a user calls: load it, render it
    (round trip against the in-memory state, then `tools/render` over val
    and test), score it (`tools/metrics` with synthetic LPIPS weights),
    re-pose it in `AvatarViewerCore` at 802×550, and time it
    (`tools/fps_benchmark_demo` on the fitted and the benchmark avatars,
    `tools/fps_benchmark_dataset`). Returns row 1's launches on these
    paths (each counted from 0 just before it). `serving`: phase 4's
    renderer, its poses and its frames/s."""
    from gaussianavatars_torch.metrics import lpips as lpips_fn
    from gaussianavatars_torch.metrics.lpips import (
        load_lpips_weights, save_lpips_weights, synthetic_lpips_params,
    )
    from gaussianavatars_torch.models import io
    from gaussianavatars_torch.tools import fps_benchmark_dataset, fps_benchmark_demo
    from gaussianavatars_torch.tools import metrics as tmetrics
    from gaussianavatars_torch.tools import render as trender
    from gaussianavatars_torch.training import loop
    from gaussianavatars_torch.training.trainer import active_sh_degree
    from gaussianavatars_torch.viewers.local import AvatarViewerCore
    from PIL import Image

    model_dir = os.path.join(LOOP_WORKDIR, "model")
    iters = int(LOOP_FLAGS[LOOP_FLAGS.index("--iterations") + 1])
    st, cfg = harness.state, harness.cfg
    shutil.rmtree(REPLAY_DIR, ignore_errors=True)
    os.makedirs(REPLAY_DIR)
    launches = 0

    # --- 1. load ------------------------------------------------------------
    it = io.find_latest_iteration(model_dir)
    ply = io.checkpoint_ply_path(model_dir, it)
    params, aux, table = io.load_avatar(ply, capacity=cfg.model.capacity, device="cuda")
    live = st.aux.alive
    n = int(live.sum())
    unequal = [k for k in REPLAY_PARAM_KEYS
               if not torch.equal(getattr(params, k)[:n], getattr(st.params, k)[live])]
    if not torch.equal(aux.binding[:n], st.aux.binding[live]):
        unequal.append("binding")
    ref_table = loop.flame_table_from_state(st, harness.scene.flame_table)
    table_equal = sorted(table) == sorted(ref_table) and all(
        np.array_equal(table[k], np.asarray(ref_table[k])) for k in ref_table)
    res = dict(iteration=it, live=int(aux.alive.sum()), harness_live=n,
               unequal_leaves=unequal, flame_table_equal=table_equal)
    log("replay/load", **res)
    if it != iters or res["live"] != n or bool(aux.alive[n:].any()) or unequal \
            or not table_equal:
        raise AssertionError(f"replay/load: {res}")

    # --- 2. round trip --------------------------------------------------------
    model = trender.replay_model(model_dir, cfg, device="cuda")
    state = trender.replay_state(params, aux, table, model)
    tcfg = harness.live_tile_config
    cam = harness.scene.cameras("val")[0]
    bg = torch.zeros(3, device="cuda")
    sh = cfg.model.sh_degree
    reset_launches()
    img_loaded = loop.make_render_fn(model, cfg, tcfg)(state, cam, cam.timestep, bg, sh)
    img_harness = loop.make_render_fn(harness.model, cfg, tcfg)(st, cam, cam.timestep, bg, sh)
    launches += fwd_launches_only(2, "replay/round_trip")
    rt = dict(max_abs_diff=float((img_loaded - img_harness).abs().max()),
              view=cam.image_name, resolution=f"{cam.width}x{cam.height}")
    log("replay/round_trip", **rt)
    if not rt["max_abs_diff"] <= 1e-6:
        raise AssertionError(f"replay/round_trip: {rt}")
    del img_loaded, img_harness, state, params, aux

    # --- 3. tools/render over val and test ----------------------------------------
    n_views = {s: len(harness.scene.cameras(s)) for s in ("val", "test")}
    reset_launches()
    t0 = time.perf_counter()
    stats = trender.main(["-m", model_dir, "--skip_train", "--quiet"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches += fwd_launches_only(sum(n_views.values()), "replay/render")
    pngs = {s: {k: len([f for f in os.listdir(os.path.join(model_dir, s, f"ours_{it}", k))
                        if f.endswith(".png")]) for k in ("renders", "gt")} for s in n_views}
    log("replay/render", per_split=stats, pngs=pngs, views=n_views, wall_s=wall,
        launches=sum(n_views.values()), card=card["nvidia_smi"])
    if any(pngs[s] != {"renders": n_views[s], "gt": n_views[s]} or stats[s]["views"] != n_views[s]
           for s in n_views):
        raise AssertionError(f"replay/render: PNGs {pngs}, views {n_views}")

    # --- 4. tools/metrics with synthetic LPIPS weights --------------------------------
    weights = os.path.join(REPLAY_DIR, "lpips_synthetic_vgg.npz")
    save_lpips_weights(synthetic_lpips_params(torch.Generator().manual_seed(0), "vgg",
                                              device="cpu"), weights)
    t0 = time.perf_counter()
    out = tmetrics.main(["-m", model_dir, "--splits", "val", "test", "--lpips_weights",
                         weights])[model_dir]["results"]
    metrics_s = time.perf_counter() - t0
    loop_val_psnr = loop_res["psnr_untrained_vs_trained"]["val"][1]
    val = out[f"val/ours_{it}"]
    # One view pair on the card and on the CPU (TF32 off, phase 1).
    pair = [np.asarray(Image.open(os.path.join(model_dir, "val", f"ours_{it}", k, "00000.png"))
                       .convert("RGB"), np.float32) / 255.0 for k in ("renders", "gt")]
    lp_card = load_lpips_weights(weights, device="cuda")
    x, y = (torch.from_numpy(a).cuda() for a in pair)
    with torch.no_grad():
        on_card = float(lpips_fn(lp_card, x, y))
        on_cpu = float(lpips_fn(load_lpips_weights(weights, device="cpu"),
                                *(torch.from_numpy(a) for a in pair)))
        lpips_ms = sync_ms(lambda: lpips_fn(lp_card, x, y), 5)
    os.environ["GSAVATARS_LPIPS_WEIGHTS"] = weights
    loop._eval_lpips_params.cache_clear()
    try:
        ev = loop.evaluate_split(harness, "val", loop.make_render_fn(harness.model, cfg, tcfg),
                                 active_sh_degree(iters, cfg.model.sh_degree), max_views=2)
    finally:
        del os.environ["GSAVATARS_LPIPS_WEIGHTS"]
        loop._eval_lpips_params.cache_clear()
    mres = dict(results=out, loop_val_psnr=loop_val_psnr,
                val_psnr_minus_loop=val["psnr"] - loop_val_psnr,
                lpips_card_vs_cpu=[on_card, on_cpu],
                lpips_rel_diff=abs(on_card - on_cpu) / abs(on_cpu),
                lpips_ms_802x550=lpips_ms, metrics_wall_s=metrics_s,
                evaluate_split_with_lpips=ev, card=card["nvidia_smi"],
                note="LPIPS from synthetic VGG weights: the value says nothing of quality")
    log("replay/metrics", **mres)
    if not (abs(mres["val_psnr_minus_loop"]) <= 0.1 and math.isfinite(val["lpips"])
            and mres["lpips_rel_diff"] <= 1e-4 and "lpips" in ev):
        raise AssertionError(f"replay/metrics: {mres}")

    # --- 5. the viewer core at 802×550 ----------------------------------------------
    core = AvatarViewerCore(ply, width=802, height=550, device="cuda")   # probes its tiers
    vcam = core.cam.to_camera(device="cuda")
    tile = dict(tile_h=core.tile.tile_h, tile_w=core.tile.tile_w,
                base_budget=core.tile.base_budget, tiers=core.tile.tiers)
    overflow = view_overflow(core, vcam)
    reset_launches()
    base = core.render(timestep=0)
    mesh = core.render(timestep=0, show_mesh=True, mesh_opacity=0.5)
    core.overrides["jaw"] = np.array([0.3, 0.0, 0.0], np.float32)
    jaw = core.render(timestep=0)
    core.overrides.clear()
    side = dict(np.load(os.path.join(os.path.dirname(ply), "flame_param.npz")))
    side["jaw_pose"] = side["jaw_pose"] + np.array([0.3, 0.0, 0.0], np.float32)
    motion_path = os.path.join(REPLAY_DIR, "motion_flame_param.npz")
    np.savez(motion_path, **side)
    motion = AvatarViewerCore(ply, motion_path=motion_path, width=802, height=550, tile=tile,
                              device="cuda").render(timestep=0)
    fids = core.model.fid_except_region(REPLAY_VISIBLE_REGIONS)
    hidden = int(torch.isin(core.aux.binding[core.aux.alive],
                            torch.as_tensor(fids, device="cuda").long()).sum())
    core_d = AvatarViewerCore(ply, disable_fid=fids, width=802, height=550, tile=tile,
                              device="cuda")
    part = core_d.render(timestep=0)
    launches += fwd_launches_only(5, "replay/viewer")
    diffs = {k: float(np.abs(v - base).mean()) for k, v in
             (("mesh", mesh), ("jaw", jaw), ("motion", motion), ("disable_fid", part))}
    vres = dict(resolution="802x550", live=core.num_points, tiers=[tile["base_budget"],
                                                                    list(tile["tiers"])],
                budget_overflow=overflow, coverage=float((base.sum(-1) > 0).mean()),
                mean_abs_change=diffs, disable_fid_faces=len(fids),
                disable_fid_hidden=hidden, live_after_disable_fid=core_d.num_points,
                visible_regions=REPLAY_VISIBLE_REGIONS)
    log("replay/viewer", **vres)
    if not (overflow == 0 and vres["coverage"] > 0.01 and min(diffs.values()) > 1e-4
            and np.isfinite(base).all()
            and core_d.num_points == core.num_points - hidden and 0 < hidden < core.num_points):
        raise AssertionError(f"replay/viewer: {vres}")
    del core_d

    # --- 6. FPS ---------------------------------------------------------------
    fitted = run_fps("demo_fitted", card, lambda: fps_benchmark_demo.run_benchmark(
        core, N_REPLAY_FPS_FRAMES, N_REPLAY_FPS_ROUNDS))
    launches += fitted["launches"]
    del core
    bench_ply, bench_cam, bench_tile = write_bench_avatar(os.path.join(REPLAY_DIR, "bench"))
    core_b = AvatarViewerCore(bench_ply, width=802, height=550, device="cuda",
                              tile=dict(tile_h=bench_tile.tile_h, tile_w=bench_tile.tile_w,
                                        base_budget=bench_tile.base_budget,
                                        tiers=bench_tile.tiers))
    bench = run_fps("demo_benchmark_avatar", card, lambda: fps_benchmark_demo.run_benchmark(
        core_b, N_REPLAY_FPS_FRAMES, N_REPLAY_FPS_ROUNDS, camera=bench_cam))
    launches += bench["launches"]
    renderer, poses, serving_fps = serving
    log("replay/fps/vs_serving", live=core_b.num_points, demo_capacity=core_b.params.capacity,
        demo_fps_per_round=bench["fps_per_round"], phase5_frames_per_s=serving_fps,
        alternating_frames_per_s=alternate_vs_serving(renderer, poses, core_b, bench_cam),
        alternating_block_frames=N_ALTERNATE_FRAMES, card=card["nvidia_smi"],
        note="same avatar, camera and tier budgets; the demo pads to the next power of two, "
             "phase 5 to a multiple of 8192; alternating: in turns in this phase")
    del core_b
    dataset = run_fps("dataset_fitted", card, lambda: fps_benchmark_dataset.main(
        ["-m", model_dir, "--n_iter", str(N_REPLAY_FPS_FRAMES),
         "--n_rounds", str(N_REPLAY_FPS_ROUNDS)]))
    launches += dataset["launches"]
    log("replay", launches=launches, card=card["nvidia_smi"])
    return {"composite_pairs_fwd": launches}


# The compositor entry points `--against` times in each other checkout and
# in this one: rows 1 and 3, row 4 in float32 and `amp`, and row 2.
AGAINST_ENTRIES = (("fwd", "v3", False), ("fwd", "v2", False), ("bwd", "v2", False),
                   ("bwd", "v2", True), ("bwd", "v3", False))


def build_against(roots) -> list:
    """Each other checkout's kernels (`--against ROOT`): the sources of
    AGAINST_ENTRIES and micro_reduce.cu under ROOT/gaussianavatars_torch/csrc,
    built with this checkout's nvcc flags (one nvcc each, all started
    together) under build/chip_smoke/against/, their ptxas reports logged,
    and loaded. Returns [(root, {library: CDLL})]."""
    import ctypes

    from gaussianavatars_torch import cuda_build
    from gaussianavatars_torch.ops import composite_pairs as cp

    libs = sorted({(cp.fwd_entry(i) if k == "fwd" else cp.bwd_entry(i, a))[0]
                   for k, i, a in AGAINST_ENTRIES} | {"micro_reduce"})
    procs = []
    for n, root in enumerate(roots):
        out_dir = os.path.abspath(os.path.join("build", "chip_smoke", "against", str(n)))
        os.makedirs(out_dir, exist_ok=True)
        for lib in libs:
            so = os.path.join(out_dir, f"lib{lib}.so")
            src = os.path.join(root, "gaussianavatars_torch", "csrc", f"{lib}.cu")
            procs.append((n, lib, so, subprocess.Popen(
                [cuda_build.cuda_tool(), *cuda_build.NVCC_FLAGS, "-o", so, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    loaded = [{} for _ in roots]
    ptxas = [{} for _ in roots]
    for n, lib, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"--against {roots[n]}: {lib} did not build:\n{out}")
        loaded[n][lib] = ctypes.CDLL(so)
        ptxas[n].update(cuda_build.ptxas_report(out))
    log("against/build", roots=list(roots), libraries=libs)
    for root, rep in zip(roots, ptxas):
        log("against/ptxas", root=root, kernels=rep)
    return list(zip(roots, loaded))


def with_kernel(fn, call):
    """call() with the compositor wrappers' kernel lookup giving `fn` (None:
    this checkout's own kernels)."""
    from gaussianavatars_torch.ops import composite_pairs as cp

    if fn is None:
        return call()
    saved = cp._fwd_kernel_fn, cp._bwd_kernel_fn
    cp._fwd_kernel_fn = cp._bwd_kernel_fn = lambda _lib, _sym: fn
    try:
        return call()
    finally:
        cp._fwd_kernel_fn, cp._bwd_kernel_fn = saved


def time_against(label: str, against, table, fwd_outputs, bwd_args) -> dict:
    """AGAINST_ENTRIES of this checkout beside those of each `--against`
    checkout at one table, on one card in one call: each kernel alone
    (N_KERNEL_REPS launches into one output, CUDA events, and as a CUDA
    graph, `graph_ms`) and through the
    wrapper, in the order others, this, this, others reversed. An other
    checkout's kernel runs through this checkout's wrapper code, its
    backward output zero-filled (`torch.zeros_like`, right for every
    version of the kernel). Its forward must equal this checkout's bit for
    bit; its backward is compared per row (max |other - this| / max |this|)."""
    from gaussianavatars_torch.ops import composite_pairs as cp

    dataT, starts, _counts, th, tw, _ntx = table
    out = {}
    for kind, impl, amp in AGAINST_ENTRIES:
        lib, sym = cp.fwd_entry(impl) if kind == "fwd" else cp.bwd_entry(impl, amp)
        own = (cp._fwd_kernel_fn if kind == "fwd" else cp._bwd_kernel_fn)(lib, sym)
        fns = {"this": None}
        for root, libs in against:
            fn = getattr(libs[lib], sym)
            fn.restype, fn.argtypes = own.restype, own.argtypes
            fns[root] = fn
        if kind == "fwd":
            res_out = cp._fwd_output(dataT, starts, th, tw)
            alone = lambda: cp._launch_fwd_cuda(res_out, *table)
            wrappers = dict.fromkeys(fns, lambda: cp.fwd_call_pairs(*table))
        else:
            res_out = torch.zeros_like(dataT)
            alone = lambda: cp._launch_bwd_cuda(res_out, *bwd_args, amp=amp)
            wrappers = dict.fromkeys(fns, lambda: cp._launch_bwd_cuda(
                torch.zeros_like(dataT), *bwd_args, amp=amp))
            wrappers["this"] = lambda: cp.bwd_call_pairs(*bwd_args, amp=amp)
        times = {name: {"kernel_ms": [], "device_ms": [], "ms": []} for name in fns}
        others = [name for name in fns if name != "this"]
        for name in others + ["this", "this"] + others[::-1]:
            run = lambda f: with_impl(impl, lambda: with_kernel(
                fns[name], lambda: cuda_ms(f, N_KERNEL_REPS)))
            times[name]["kernel_ms"].append(run(alone))
            times[name]["device_ms"].append(with_impl(impl, lambda: with_kernel(
                fns[name], lambda: graph_ms(alone, N_KERNEL_REPS))))
            times[name]["ms"].append(run(wrappers[name]))
        res = dict(times=times)
        with_impl(impl, alone)
        this_out = [x.clone() for x in res_out] if kind == "fwd" else res_out.clone()
        for name in others:
            with_impl(impl, lambda: with_kernel(fns[name], alone))
            if kind == "fwd":
                res[f"bit_equal/{name}"] = all(map(torch.equal, res_out, this_out))
            else:
                rel = ((res_out[:9] - this_out[:9]).abs().amax(dim=1)
                       / this_out[:9].abs().amax(dim=1).clamp_min(1e-30))
                res[f"max_rel_err/{name}"] = float(rel.max())
        log(f"against/{label}/{sym}", **res)
        out[sym] = res
    return out


INNOV_FLAGS = (*LOOP_FLAGS[:LOOP_FLAGS.index("--iterations")], "--iterations", "900",
               "--log_every", "50", "--eval_every", "450", "--checkpoint_every", "450",
               "--opacity_reset_interval", "600", "--all_innovations")
INNOV_WORKDIR = os.path.join("build", "chip_smoke", "innovations")
N_INNOV_BLOCK = 10       # steps per block of the innovations on/off alternation


def copy_dataset(src: str, dst: str) -> None:
    """Phase 12's rendered dataset (images, FLAME files, transforms, its
    meta) into `dst`, without the model directory."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("model"))


def cpu_camera(cam):
    return dataclasses.replace(cam, **{f.name: getattr(cam, f.name).cpu()
                                       for f in dataclasses.fields(cam)
                                       if isinstance(getattr(cam, f.name), torch.Tensor)})


def innovations_run(card) -> dict:
    """Phase 15, part 1: `tools/train_synthetic --all_innovations` at
    802×550 on phase 12's dataset (900 iterations: scales 0.5 / 0.75 / 1.0
    from 1 / 300 / 600, a smart densify event at 750, an opacity reset at
    600, evals and checkpoints at 450 and 900), then a resume from 450."""
    from gaussianavatars_torch.config import from_json
    from gaussianavatars_torch.models.flame.assets import load_assets
    from gaussianavatars_torch.models.flame.flame_model import FlameConfig, FlameModel
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.tools import train_synthetic as ts
    from gaussianavatars_torch.training import loop
    from gaussianavatars_torch.training.checkpoint import GENERATOR_KEY, flatten_state
    from gaussianavatars_torch.training.innovations import resolution_scale_at

    copy_dataset(LOOP_WORKDIR, INNOV_WORKDIR)
    args = ts.parse_args([*INNOV_FLAGS, "--workdir", INNOV_WORKDIR])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_mib = torch.cuda.memory_allocated() / 2**20
    reset_launches()
    harness, result = ts.run(args)
    torch.cuda.synchronize()
    launches = dict(cp.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    logs, events, o = result["logs"], harness.events, harness.cfg.opt
    iters = args.iterations
    binding = binding_launches(iters, "innovations")
    st = harness.state

    # Each iteration at its scale's image size; the past scales evicted.
    scene = harness.scene
    size_of = {s: (scene.cameras("train", 1.0 / s)[0].height,
                   scene.cameras("train", 1.0 / s)[0].width) for s in o.resolution_schedule}
    want_sizes: dict = {}
    for it in range(1, iters + 1):
        k = size_of[resolution_scale_at(it, o.resolution_schedule, o.resolution_milestones)]
        want_sizes[k] = want_sizes.get(k, 0) + 1
    built = [(e["iteration"], e["scale"]) for e in events if e["kind"] == "gt_cache"]
    evicted = [(e["iteration"], e["scale"]) for e in events if e["kind"] == "evict_scale"]
    m1, m2 = o.resolution_milestones
    held = all(r["cached_scales"] == [r["resolution_scale"]] for r in logs)
    # Row 2 once a step; row 1 once a step, a rendered dataset view (none
    # when phase 12's dataset is reused) and an eval view.
    eval_views = sum(e["n"] for e in events if e["kind"] == "eval")
    eval_views += sum(result[k]["n"] for k in result if k.startswith("eval_"))
    written = result["dataset_write_s"] > 0
    n_views = args.timesteps * args.cameras if written else 0
    expect = {"composite_pairs_fwd": iters + n_views + eval_views, "composite_pairs_bwd": iters}
    got = {k: launches[k] for k in expect}
    stray = {k: v for k, v in launches.items() if v and k not in expect}
    densify = [e for e in events if e["kind"] == "densify"]
    # The floors as the thresholds hold them: in float32.
    floors = tuple(float(np.float32(f * o.densify_grad_threshold)) for f in (0.3, 0.7))
    thr = [(e["clone_threshold"], e["split_threshold"]) for e in densify]
    psnr = {s: (result[f"eval_untrained_{s}"]["psnr"], result[f"eval_{s}"]["psnr"])
            for s in ("val", "test")}
    res = dict(steps_by_size={f"{h}x{w}": n for (h, w), n in harness.steps_by_size.items()},
               expected_steps_by_size={f"{h}x{w}": n for (h, w), n in want_sizes.items()},
               gt_caches_built=built, evicted=evicted, only_current_scale_cached=held,
               launches=got, expected_launches=expect, stray_launches=stray,
               dataset_reused=not written, densify=densify, threshold_floors=floors,
               color_adam_step=int(st.color_adam.step),
               contrastive_count=int(st.contrastive.count),
               contrastive_head=int(st.contrastive.head),
               loss_by_log=[r["loss"] for r in logs], psnr_untrained_vs_trained=psnr)
    log("innovations/loop", **res)
    checks = {
        "sizes": harness.steps_by_size == want_sizes and len(want_sizes) == 3,
        "eviction": built == [(1, 0.5), (m1, 0.75), (m2, 1.0)]
        and evicted == [(m1, 0.5), (m2, 0.75)] and held,
        "launches": got == expect and not stray,
        "smart_densify": len(densify) == 1 and all(c >= floors[0] and s >= floors[1]
                                                   for c, s in thr),
        "color_net": int(st.color_adam.step) == iters,
        "contrastive": int(st.contrastive.count) == min(iters, o.contrastive_cache_size),
        "finite": all(map(math.isfinite, res["loss_by_log"]))
        and all(math.isfinite(b) for _a, b in psnr.values()),
    }
    if not all(checks.values()):
        raise AssertionError(f"innovations loop checks failed: {checks}")
    # Steps/s of each scale over the intervals between consecutive logs of
    # that scale that hold no host event.
    event_its = {e["iteration"] for e in events}
    spans: dict = {}
    for r0, r1 in zip(logs, logs[1:]):
        if (r0["resolution_scale"] == r1["resolution_scale"]
                and not any(r0["iteration"] <= e <= r1["iteration"] for e in event_its)):
            n, sec = spans.get(r1["resolution_scale"], (0, 0.0))
            spans[r1["resolution_scale"]] = (n + r1["iteration"] - r0["iteration"],
                                             sec + r1["elapsed_s"] - r0["elapsed_s"])
    seg_rate = {s: {"steps": n, "steps_per_s": n / sec} for s, (n, sec) in spans.items()}
    by_kind: dict[str, list] = {}
    for e in events:
        by_kind.setdefault(e["kind"], []).append(e["ms"])
    log("innovations/loop_numbers", card=card["nvidia_smi"],
        steps_per_s_whole_loop=iters / result["train_s"],
        steps_per_s_by_scale=seg_rate, event_host_ms=by_kind, peak_mem_mib=peak_mib,
        peak_mem_above_start_mib=peak_mib - start_mib,
        live_gaussians_final=logs[-1]["num_points"],
        eval={k: v for k, v in result.items() if k.startswith("eval_")})

    # --- resume from 450: every leaf bit for bit, and on at scale 0.75 ------
    model_dir = os.path.join(INNOV_WORKDIR, "model")
    cfg = from_json(open(os.path.join(model_dir, "cfg_args.json")).read())
    model = FlameModel(load_assets(os.path.join(model_dir, "flame_assets.npz")),
                       FlameConfig(n_shape=args.n_shape, n_expr=args.n_expr, add_teeth=False),
                       device="cuda")
    start = ts.checkpoint_iterations(args)[0]
    ckpt = os.path.join(model_dir, f"chkpnt{start}.npz")
    h2 = loop.build_harness(cfg, model=model, start_checkpoint=ckpt, device="cuda")
    saved = np.load(ckpt)
    leaves = flatten_state(h2.state)
    unequal = [k for k, v in leaves.items()
               if not torch.equal(v.cpu(), torch.as_tensor(saved[k]).to(v.dtype))
               or saved[k].dtype != v.cpu().numpy().dtype]
    innov_leaves = sorted(k for k in leaves if k.split("/")[0] in
                          ("color_net", "color_adam", "contrastive"))
    moved = any(not torch.equal(a, b) for a, b in zip(h2.state.color_net.weights,
                                                      st.color_net.weights))
    lg = loop.train(h2, iterations=start + 5, log_every=1, eval_every=0)
    want_scales = [resolution_scale_at(start + i, o.resolution_schedule,
                                       o.resolution_milestones) for i in range(1, 6)]
    want_resumed: dict = {}
    for s in want_scales:
        want_resumed[size_of[s]] = want_resumed.get(size_of[s], 0) + 1
    resumed = dict(start_iteration=h2.start_iteration, leaves=len(leaves),
                   innovation_leaves=innov_leaves, unequal=unequal,
                   color_net_moved_450_to_900=moved,
                   scales=[r["resolution_scale"] for r in lg],
                   steps_by_size={f"{h}x{w}": n for (h, w), n in h2.steps_by_size.items()})
    log("innovations/resume", **resumed)
    # 22 innovation leaves: the net's 6, their 12 moments, its Adam step,
    # the cache's 3.
    if (h2.start_iteration != start or unequal or len(innov_leaves) != 22 or not moved
            or set(leaves) != set(saved.files) - {"__iteration__", "key", GENERATOR_KEY}
            or resumed["scales"] != want_scales or want_scales[0] != 0.75
            or h2.steps_by_size != want_resumed):
        raise AssertionError(f"innovations resume: {resumed}")
    return dict(launches=dict(launches, binding_segment_sum=binding))


def rel_err(a, b) -> float:
    """max |a - b| / max |b| of two tensors (b on any device)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def innovations_step(card, model, params, aux, cam, tile_cfg, setup) -> dict:
    """Phase 15, part 2: the bare step at full width (phase 6's scene and
    target) with the region-adaptive loss, the colour net and the
    contrastive term: one step's gradients with the kernel and with the
    plain backward compositor; the innovations' functions on the card
    against the CPU on the same inputs; steps/s with the innovations on
    and off in alternating blocks, device ms per stage, kernels a step and
    peak memory; the synchronising calls of a step in each mode."""
    from gaussianavatars_torch.config import Config
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.ops import rasterize_sorted as rs
    from gaussianavatars_torch.training import innovations as inn
    from gaussianavatars_torch.training.loop import _flame_params
    from gaussianavatars_torch.training.optim import tree_leaves, tree_map
    from gaussianavatars_torch.training.trainer import init_train_state, make_train_step

    cfg_off, gt, bg, state_off = setup
    o = dataclasses.replace(cfg_off.opt, use_region_adaptive_loss=True,
                            use_color_calibration=True, use_contrastive_reg=True)
    cfg_on = Config(model=cfg_off.model, pipeline=cfg_off.pipeline, opt=o)
    state_on = init_train_state(
        params, aux, cfg_on, num_timesteps=TRAIN_TIMESTEPS,
        n_expr=state_off.flame.expr.shape[1], n_shape=state_off.flame_static.shape.shape[0],
        num_verts=model.num_verts, generator=torch.Generator().manual_seed(13),
        image_hw=(cam.height, cam.width))
    step_on = make_train_step(model, cfg_on, tile_cfg)
    step_off = make_train_step(model, cfg_off, tile_cfg)
    # One step fills the cache, so the compared step has a contrastive term.
    state1 = step_on(state_on, gt, cam, 0, bg, 3).state
    out_k = step_on(state1, gt, cam, 1, bg, 3)
    rs.bwd_call_pairs = cp.bwd_call_pairs_reference
    try:
        out_r = step_on(state1, gt, cam, 1, bg, 3)
    finally:
        rs.bwd_call_pairs = cp.bwd_call_pairs
    grad_err = {**leaf_errors(out_k.state.adam.mu, out_r.state.adam.mu),
                **{f"flame.{k}": v for k, v in
                   leaf_errors(out_k.state.flame_adam.mu, out_r.state.flame_adam.mu).items()},
                **{f"color_net.{i}": rel_err(a, b) for i, (a, b) in enumerate(zip(
                    tree_leaves(out_k.state.color_adam.mu),
                    tree_leaves(out_r.state.color_adam.mu)))}}
    terms = {k: float(out_k.metrics[k]) for k in ("l1", "ssim", "color_reg", "contrastive")}
    log("innovations/kernel_vs_plain_gradients", rel_err_per_leaf=grad_err, loss_terms=terms)
    if not (max(grad_err.values()) <= 1e-4 and terms["contrastive"] > 0):
        raise AssertionError(f"innovation step: gradients differ with the plain backward: "
                             f"{grad_err}, {terms}")

    # The innovations' functions on the card against the CPU, same inputs.
    vids = {k: model.vid_by_region([k]) for k in ("eyes_left", "eyes_right", "mouth", "nose")}
    with torch.no_grad():
        verts = model(_flame_params(state1, 1))[0]
        wmap = inn.flame_region_weight_map(verts, vids, cam, cam.height, cam.width,
                                           o.region_weight_eyes, o.region_weight_mouth,
                                           o.region_weight_nose)
        wmap_cpu = inn.flame_region_weight_map(verts.cpu(), vids, cpu_camera(cam), cam.height,
                                               cam.width, o.region_weight_eyes,
                                               o.region_weight_mouth, o.region_weight_nose)
        net_cpu = tree_map(lambda x: x.cpu(), state1.color_net)
        cal = inn.color_net_apply(state1.color_net, gt)
        cal_cpu = inn.color_net_apply(net_cpu, gt.cpu())
        cache_cpu = tree_map(lambda x: x.cpu(), state1.contrastive)
        d = o.contrastive_downsample
        thumb = inn._downsample(out_k.image, d)
        thumb_cpu = inn._downsample(out_k.image.cpu(), d)
        closs = inn.contrastive_loss(state1.contrastive, out_k.image, d)
        closs_cpu = inn.contrastive_loss(cache_cpu, out_k.image.cpu(), d)
    # The loss is mean(1 − cos) with cos near 1: the difference scales the
    # cosines' rounding by 1 / loss. The cosines' mean (1 − loss) is held to
    # rtol 1e-5; the loss's own relative difference is logged.
    on_card = dict(region_map_equal=bool(torch.equal(wmap.cpu(), wmap_cpu)),
                   weighted_pixels={str(w): int((wmap_cpu == w).sum())
                                    for w in torch.unique(wmap_cpu).tolist()},
                   region_vertices={k: len(v) for k, v in vids.items()},
                   color_net_rel_err=rel_err(cal, cal_cpu),
                   thumbnail_rel_err=rel_err(thumb, thumb_cpu),
                   contrastive_loss=float(closs_cpu),
                   contrastive_cosine_rel_err=rel_err(1.0 - closs, 1.0 - closs_cpu),
                   contrastive_loss_rel_diff=rel_err(closs, closs_cpu))
    log("innovations/card_vs_cpu", **on_card)
    if not (on_card["region_map_equal"] and float(wmap_cpu.max()) > 1.0
            and on_card["color_net_rel_err"] <= 1e-5 and on_card["thumbnail_rel_err"] <= 1e-5
            and on_card["contrastive_cosine_rel_err"] <= 1e-5):
        raise AssertionError(f"innovations on the card differ from the CPU: {on_card}")

    # Host synchronisations of one step in each mode.
    syncs = {"off": sync_count(lambda: step_off(state_off, gt, cam, 1, bg, 3)),
             "on": sync_count(lambda: step_on(state1, gt, cam, 1, bg, 3))}

    # Steps/s in alternating blocks (off, on, on, off), each mode continuing
    # its own state; each block's peak memory over the same live set.
    states = {False: state_off, True: state1}
    block_s = {False: [], True: []}
    block_peak = {False: 0.0, True: 0.0}
    reset_launches()
    for on in (False, True, True, False):
        st, step = states[on], (step_on if on else step_off)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(N_INNOV_BLOCK):
            st = step(st, gt, cam, i % TRAIN_TIMESTEPS, bg, 3).state
        torch.cuda.synchronize()
        block_s[on].append(time.perf_counter() - t0)
        block_peak[on] = max(block_peak[on], torch.cuda.max_memory_allocated() / 2**20)
        states[on] = st
    launches = dict(cp.LAUNCHES)
    n = 4 * N_INNOV_BLOCK
    if {k: v for k, v in launches.items() if v} != {"composite_pairs_fwd": n,
                                                    "composite_pairs_bwd": n}:
        raise AssertionError(f"innovation blocks: launches {launches} for {n} steps")
    launches["binding_segment_sum"] = binding_launches(n, "innovations/blocks")
    if not (all(bool(torch.isfinite(x).all()) for x in tree_leaves(states[True].color_net))
            and all_finite(states[True].params)):
        raise AssertionError("innovation blocks: non-finite state")
    rate = {on: N_INNOV_BLOCK * len(b) / sum(b) for on, b in block_s.items()}
    prof = {"off": profile_train(step_off, states[False], gt, cam, bg, rate[False]),
            "on": profile_train(step_on, states[True], gt, cam, bg, rate[True])}
    res = dict(card=card["nvidia_smi"], resolution=f"{cam.width}x{cam.height}",
               alternating_steps_per_s={"off": rate[False], "on": rate[True]},
               alternating_block_ms_per_step={
                   "off": [1e3 * b / N_INNOV_BLOCK for b in block_s[False]],
                   "on": [1e3 * b / N_INNOV_BLOCK for b in block_s[True]]},
               peak_mem_mib={"off": block_peak[False], "on": block_peak[True]},
               syncs_per_step=syncs, profile=prof)
    log("innovations/step_numbers", **res)
    if syncs["on"] != syncs["off"]:
        raise AssertionError(f"the innovations add host synchronisations: {syncs}")
    return dict(launches=launches)


# --- 16. the training CLI ----------------------------------------------------

CLI_DIR = os.path.join("build", "chip_smoke", "cli")
CLI_DEVICE = "cuda"
CLI_ITERS = 300
# FLAME-bound on phase 12's dataset: an opacity reset at 200, a densify
# event at 250, evals and checkpoints at 150 and 300, finite checks from
# 160 on.
CLI_FLAME_FLAGS = ("--bind_to_mesh", "--eval", "--iterations", str(CLI_ITERS),
                   "--interval", "150", "--checkpoint_iterations", "150", "300",
                   "--densify_from_iter", "100", "--densification_interval", "250",
                   "--densify_until_iter", str(CLI_ITERS), "--opacity_reset_interval", "200",
                   "--log_every", "10", "--debug_from", "160")
CLI_ANOMALY_FLAGS = ("--bind_to_mesh", "--iterations", "5", "--test_iterations",
                     "--save_iterations", "--checkpoint_iterations", "--port", "0",
                     "--detect_anomaly", "--log_every", "1")
# Unbound, Blender layout, white background: an opacity reset at 100
# (densify_from_iter, white background), a densify event at 250, eval,
# save and checkpoint at 300.
CLI_BLENDER_FLAGS = ("-w", "--eval", "--iterations", str(CLI_ITERS), "--interval", "300",
                     "--densify_from_iter", "100", "--densification_interval", "250",
                     "--densify_until_iter", str(CLI_ITERS), "--opacity_reset_interval", "3000",
                     "--log_every", "10", "--port", "0")
CLI_COLMAP_FLAGS = ("-w", "--eval", "--iterations", "100", "--interval", "100",
                    "--densify_from_iter", "1000", "--opacity_reset_interval", "3000",
                    "--log_every", "10", "--port", "0")
ORBIT_VIEWS = 32          # every 4th a Blender test view; COLMAP holds out every 8th by name
ORBIT_SIZE = 800          # NeRF-synthetic's 800×800
ORBIT_FOV = 0.6911112070083618   # NeRF-synthetic lego's camera_angle_x
# World units per avatar unit: the fitted avatar (radius 0.1 at the origin)
# becomes a head 2 units wide inside the reader's random-point cube
# [-1.3, 1.3]³, the cameras orbit at radius 4: NeRF-synthetic's scale.
ORBIT_SCALE = 10.0
COLMAP_POINTS = 20_000
NERF_RANDOM_POINTS = 100_000   # the reader's draw when a Blender scene has no points3d.ply
KNN_SAMPLE_ROWS = 4096
N_GUI_TIMED = 5           # held splat requests timed for the round trip


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def loss_falls(logs) -> bool:
    """Finite losses whose mean over the last three logs is below that of
    the first three (one view a step: a single log is noisy)."""
    loss = [r["loss"] for r in logs]
    return (all(map(math.isfinite, loss)) and len(loss) >= 6
            and sum(loss[-3:]) < sum(loss[:3]))


def rate_between_events(logs, events, exclude=()) -> dict:
    """Steps/s over the intervals between consecutive logs that hold no
    host event and no iteration of `exclude`."""
    busy = {e["iteration"] for e in events} | set(exclude)
    n, sec = 0, 0.0
    for r0, r1 in zip(logs, logs[1:]):
        if not any(r0["iteration"] <= i <= r1["iteration"] for i in busy):
            n += r1["iteration"] - r0["iteration"]
            sec += r1["elapsed_s"] - r0["elapsed_s"]
    return {"steps": n, "steps_per_s": n / sec if sec else None}


def gui_client(port: int, captured: dict, box: dict) -> None:
    """Phase 16's viewer: connects to the trainer's GUI server, holds the
    loop (`do_training=False`) for a splat frame, which must equal byte for
    byte the uint8 of `make_render_fn` on the held state at the camera the
    server decodes, a mesh frame, which must differ, and N_GUI_TIMED timed
    splat frames; then lets the loop go on."""
    import traceback

    from gaussianavatars_torch.models.gaussians import num_alive
    from gaussianavatars_torch.training import loop
    from gaussianavatars_torch.viewers import network_gui as gui

    try:
        deadline = time.monotonic() + 300
        while True:
            try:
                client = gui.RemoteClient("127.0.0.1", port, timeout=120)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        try:
            h = captured["harness"]          # built before the server listens
            cam = h.scene.cameras("train")[0]
            frame, stats = client.request(cam, do_training=False)
            # Held: the loop waits in `service` for our next request.
            wire_cam = gui._camera_from_msg(gui.camera_message(cam), CLI_DEVICE)
            t = min(wire_cam.timestep, max(h.scene.num_timesteps - 1, 0))
            want = loop.make_render_fn(h.model, h.cfg, h.live_tile_config)(
                h.state, wire_cam, t, torch.zeros(3, device=CLI_DEVICE), h.cfg.model.sh_degree)
            want_u8 = (np.clip(want.cpu().numpy(), 0.0, 1.0) * 255).astype(np.uint8)
            got_u8 = np.rint(frame * 255).astype(np.uint8)
            mesh, _stats = client.request(cam, do_training=False, show_mesh=True)
            t0 = time.perf_counter()
            for _ in range(N_GUI_TIMED):
                client.request(cam, do_training=False)
            rt_ms = 1e3 * (time.perf_counter() - t0) / N_GUI_TIMED
            box.update(
                frame_equal=bool(np.array_equal(got_u8, want_u8)),
                frame_max_diff=int(np.abs(got_u8.astype(int) - want_u8).max()),
                frame_nonzero=bool(got_u8.any()),
                mesh_differs=bool(not np.array_equal(np.rint(mesh * 255).astype(np.uint8),
                                                     got_u8)),
                num_points=stats["num_points"], live=int(num_alive(h.state.aux)),
                num_timesteps=stats["num_timesteps"], round_trip_ms=rt_ms,
                resolution=f"{cam.width}x{cam.height}",
                # Row 1: the served splat frames (the mesh request renders
                # the splats under its overlay) and our own check.
                fwd_launches=2 + N_GUI_TIMED + 1)
            client.request(None, do_training=True)
        finally:
            client.close()
    except Exception:
        box["error"] = traceback.format_exc()


def expected_events(argv) -> set:
    """(kind, iteration) of the host events `tools.train.main(argv)` must
    record: densify, opacity reset, eval, save and checkpoint, from its
    flags and `training.loop`'s cadences."""
    from gaussianavatars_torch.tools import train as ttrain

    a = ttrain.parse_args(argv)
    tests, saves, ckpts = ttrain.event_iterations(a)
    out = set()
    for it in range(1, a.iterations + 1):
        if a.densify_from_iter < it < a.densify_until_iter and it % a.densification_interval == 0:
            out.add(("densify", it))
        if it < a.densify_until_iter and (it % a.opacity_reset_interval == 0 or (
                a.white_background and it == a.densify_from_iter)):
            out.add(("opacity_reset", it))
    return (out | {("eval", i) for i in tests} | {("save", i) for i in saves}
            | {("checkpoint", i) for i in ckpts})


def recorded_events(events) -> set:
    return {(e["kind"], e["iteration"]) for e in events
            if e["kind"] in ("densify", "opacity_reset", "eval", "save", "checkpoint")}


class Tee(io.TextIOBase):
    """Standard output that also keeps what was written."""

    def __init__(self, out):
        self.out, self.seen = out, []

    def write(self, text: str) -> int:
        self.seen.append(text)
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()


def cli_flame(card, flame_npz: str, parts: dict) -> dict:
    """Phase 16, FLAME-bound: `tools.train.main` on phase 12's dataset at
    802×550 with `--flame_assets flame_npz` (phase 21's converted pickle),
    the GUI on a free port and a viewer holding the loop, finite checks
    from `--debug_from` on, then a short `--detect_anomaly` run, then
    `tools.render` and `tools.metrics` on the model directory."""
    import contextlib
    import threading

    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.tools import metrics as tmetrics
    from gaussianavatars_torch.tools import render as trender
    from gaussianavatars_torch.tools import train as ttrain
    from gaussianavatars_torch.training import loop
    from gaussianavatars_torch.viewers import network_gui as gui

    model_dir = os.path.join(CLI_DIR, "flame")
    argv = ["-s", LOOP_WORKDIR, "-m", model_dir, *CLI_FLAME_FLAGS, "--port", str(free_port()),
            "--device", CLI_DEVICE, "--flame_assets", flame_npz]
    a = ttrain.parse_args(argv)
    out = Tee(sys.stdout)
    captured, box, served, checks_run = {}, {}, [], []
    build, service, check = ttrain.build_harness, gui.TrainingGuiServer.service, loop.assert_finite

    def capture(*args, **kw):
        captured["harness"] = build(*args, **kw)
        return captured["harness"]

    def traced(self, harness, it):
        on = service(self, harness, it)
        if on:
            served.append(it)
        return on

    def counted(tree, name="tree"):
        checks_run.append(name)
        return check(tree, name)

    client = threading.Thread(target=gui_client, args=(a.port, captured, box), daemon=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ttrain.build_harness, gui.TrainingGuiServer.service, loop.assert_finite = (
        capture, traced, counted)
    client.start()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            h, logs = ttrain.main(argv)
    finally:
        ttrain.build_harness, gui.TrainingGuiServer.service, loop.assert_finite = (
            build, service, check)
        client.join(timeout=120)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cp_launches()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if client.is_alive() or "error" in box:
        raise AssertionError(f"cli/flame: the viewer failed: {box.get('error', 'hung')}")
    # The fit read the converted npz: no fallback warning, and the model
    # holds the regions that only the masks pickle gives.
    fallback = any("no FLAME assets npz" in line for line in "".join(out.seen).splitlines())
    masks = h.model.assets.vertex_masks
    read = dict(flame_assets=flame_npz, fallback_warning=fallback,
                parts_loaded=all(np.array_equal(masks[k], v) for k, v in parts.items()),
                regions_from_parts=sorted(set(masks) & {"ears", "eyeballs", "hair", "skin"}),
                verts=h.model.num_verts, faces=h.model.num_faces)
    log("cli/flame_assets", **read)
    if fallback or not read["parts_loaded"] or len(read["regions_from_parts"]) != 4:
        raise AssertionError(f"cli/flame did not train on the converted assets: {read}")
    events = h.events
    eval_views = sum(e.get("n", 0) for e in events if e["kind"] == "eval")
    expect = {"composite_pairs_fwd": a.iterations + eval_views + box["fwd_launches"],
              "composite_pairs_bwd": a.iterations}
    got = {k: launches[k] for k in expect}
    stray = {k: v for k, v in launches.items() if v and k not in expect}
    want_events = expected_events(argv)
    _tests, saves, ckpts = ttrain.event_iterations(a)
    artifacts = ["cfg_args.json", "cameras.json", "flame_assets.npz",
                 *(f"chkpnt{i}.npz" for i in ckpts),
                 *(f"point_cloud/iteration_{i}/{f}" for i in saves
                   for f in ("point_cloud.ply", "flame_param.npz"))]
    missing = [f for f in artifacts if not os.path.exists(os.path.join(model_dir, f))]
    tb_events = [f for f in os.listdir(model_dir) if f.startswith("events.out.tfevents")]
    n_checks = 2 * (a.iterations - a.debug_from + 1)
    res = dict(launches=got, expected_launches=expect, stray_launches=stray,
               events=sorted(recorded_events(events)), expected_events=sorted(want_events),
               gui={k: v for k, v in box.items() if k != "fwd_launches"}, gui_held_at=served,
               finite_checks=len(checks_run), expected_finite_checks=n_checks,
               missing_artifacts=missing, summary_writer_events=tb_events,
               loss_by_log=[r["loss"] for r in logs],
               points_by_log=[r["num_points"] for r in logs])
    log("cli/flame", **res)
    checks = {
        "launches": got == expect and not stray,
        "events": recorded_events(events) == want_events
        and any(k == "densify" for k, _i in want_events)
        and any(k == "opacity_reset" for k, _i in want_events),
        "gui": (box["frame_equal"] and box["frame_nonzero"] and box["mesh_differs"]
                and box["num_points"] == box["live"] and len(served) == 1),
        "debug_from": len(checks_run) == n_checks,
        "loss": loss_falls(logs),
        "artifacts": not missing,
    }
    if not all(checks.values()):
        raise AssertionError(f"cli/flame checks failed: {checks}")
    log("cli/flame_numbers", card=card["nvidia_smi"], resolution="802x550",
        steps_per_call=a.steps_per_call, steps_per_s_whole_run=a.iterations / wall,
        steps_per_s_between_events=rate_between_events(logs, events, served),
        gui_round_trip_ms=box["round_trip_ms"], gui_resolution=box["resolution"],
        fwd_launches_per_step=(got["composite_pairs_fwd"] - eval_views - box["fwd_launches"])
        / a.iterations, bwd_launches_per_step=got["composite_pairs_bwd"] / a.iterations,
        peak_mem_mib=peak_mib, live_gaussians_final=logs[-1]["num_points"],
        summary_writer="importable, events written" if tb_events else
        "not importable: no TensorBoard records",
        event_host_ms={f"{e['kind']}@{e['iteration']}": e["ms"] for e in events})

    # --- --detect_anomaly: a few steps under autograd's anomaly mode ----------
    reset_launches()
    t0 = time.perf_counter()
    argv2 = ["-s", LOOP_WORKDIR, "-m", os.path.join(CLI_DIR, "anomaly"), *CLI_ANOMALY_FLAGS,
             "--device", CLI_DEVICE]
    n2 = ttrain.parse_args(argv2).iterations
    _h2, logs2 = ttrain.main(argv2)
    torch.cuda.synchronize()
    an = dict(logs=len(logs2), finite=all(math.isfinite(r["loss"]) for r in logs2),
              launches=cp_launches(), anomaly_mode_after=torch.is_anomaly_enabled(),
              seconds=time.perf_counter() - t0)
    log("cli/detect_anomaly", **an)
    if not (an["logs"] == n2 and an["finite"] and not an["anomaly_mode_after"]
            and an["launches"]["composite_pairs_fwd"] == n2
            and an["launches"]["composite_pairs_bwd"] == n2):
        raise AssertionError(f"cli/detect_anomaly: {an}")
    for k in got:
        got[k] += an["launches"][k]

    # --- tools/render and tools/metrics, as run_ablation.sh runs them ------------
    n_views = sum(len(h.scene.cameras(s)) for s in ("val", "test"))
    reset_launches()
    t0 = time.perf_counter()
    stats = trender.main(["-m", model_dir, "--skip_train", "--quiet", "--device", CLI_DEVICE])
    render_s = time.perf_counter() - t0
    got["composite_pairs_fwd"] += fwd_launches_only(n_views, "cli/render")
    scores = tmetrics.main(["-m", model_dir, "--device", CLI_DEVICE])[model_dir]["results"]
    log("cli/render_metrics", render=stats, render_s=render_s, views=n_views, metrics=scores,
        card=card["nvidia_smi"])
    # The metrics tool scores the test split by default (`scripts/metrics.py`).
    if list(scores) != [f"test/ours_{a.iterations}"] or not all(
            math.isfinite(v["psnr"]) for v in scores.values()):
        raise AssertionError(f"cli/render_metrics: {scores}")
    return got


def orbit_cameras(dev):
    """ORBIT_VIEWS look-at cameras around the fitted avatar (in its units:
    radius 4 / ORBIT_SCALE), ORBIT_SIZE square, elevations ±0.3 rad."""
    from gaussianavatars_torch.data.cameras import look_at_camera

    r = 4.0 / ORBIT_SCALE
    cams = []
    for i in range(ORBIT_VIEWS):
        az = 2 * math.pi * i / ORBIT_VIEWS
        el = 0.3 if i % 2 else -0.15
        eye = r * np.array([math.cos(el) * math.sin(az), math.sin(el),
                            -math.cos(el) * math.cos(az)])
        cams.append(look_at_camera(eye=eye, target=np.zeros(3), fovy=ORBIT_FOV,
                                   width=ORBIT_SIZE, height=ORBIT_SIZE, device=dev))
    return cams


def write_orbit_scenes(fitted, root: str) -> dict:
    """The fitted avatar (timestep 0, white background) from the orbit
    cameras, written twice with the world scaled by ORBIT_SCALE: a
    NeRF-synthetic layout (`blender/`: `transforms_{train,test}.json`,
    every 4th view a test view, no `points3d.ply`) and a COLMAP layout
    (`colmap/`: `images/`, `sparse/0/{cameras,images,points3D}.bin`,
    PINHOLE, COLMAP_POINTS points sampled from the avatar's live means
    with their DC colours)."""
    from PIL import Image

    from gaussianavatars_torch.data import colmap
    from gaussianavatars_torch.data.readers import fov_to_focal
    from gaussianavatars_torch.models.binding import face_frames
    from gaussianavatars_torch.models.gaussians import world_gaussians
    from gaussianavatars_torch.ops.sh import C0
    from gaussianavatars_torch.training import loop

    model, st, cfg = fitted.model, fitted.state, fitted.cfg
    blender, cm = os.path.join(root, "blender"), os.path.join(root, "colmap")
    for d in ("train", "test"):
        os.makedirs(os.path.join(blender, d))
    os.makedirs(os.path.join(cm, "images"))
    os.makedirs(os.path.join(cm, "sparse", "0"))
    white = torch.ones(3, device=CLI_DEVICE)
    frames = {"train": [], "test": []}
    images = {}
    reset_launches()
    for i, cam in enumerate(orbit_cameras(CLI_DEVICE)):
        tcfg = loop.probe_tier_budgets(loop.tile_config(cfg), cfg, model, st, cam, verbose=False)
        img = loop.make_render_fn(model, cfg, tcfg)(st, cam, 0, white, 0)
        u8 = (torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        split = "test" if i % 4 == 3 else "train"
        Image.fromarray(u8).save(os.path.join(blender, split, f"r_{i}.png"))
        Image.fromarray(u8).save(os.path.join(cm, "images", f"view_{i:03d}.png"))
        w2c = cam.world_view.double().cpu().numpy()
        w2c[:3, 3] *= ORBIT_SCALE
        c2w = np.linalg.inv(w2c)
        c2w[:3, 1:3] *= -1                      # COLMAP → OpenGL axes
        frames[split].append({"file_path": f"{split}/r_{i}", "transform_matrix": c2w.tolist()})
        images[i + 1] = colmap.ColmapImage(i + 1, colmap.rotmat_to_qvec(w2c[:3, :3]),
                                           w2c[:3, 3], 1, f"view_{i:03d}.png",
                                           np.zeros((0, 2)), np.zeros((0,), np.int64))
    render_launches = dict(cp_launches())
    for split, fr in frames.items():
        with open(os.path.join(blender, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": ORBIT_FOV, "frames": fr}, f)
    focal = fov_to_focal(ORBIT_FOV, ORBIT_SIZE)
    colmap.write_cameras_binary({1: colmap.ColmapCamera(
        1, "PINHOLE", ORBIT_SIZE, ORBIT_SIZE,
        np.array([focal, focal, ORBIT_SIZE / 2, ORBIT_SIZE / 2]))},
        os.path.join(cm, "sparse", "0", "cameras.bin"))
    colmap.write_images_binary(images, os.path.join(cm, "sparse", "0", "images.bin"))
    with torch.no_grad():
        wg = world_gaussians(st.params, st.aux, face_frames(
            model(loop._flame_params(st, 0))[0], model.faces))
    live = torch.nonzero(st.aux.alive)[:, 0]
    pick = live[torch.randperm(len(live), generator=torch.Generator().manual_seed(16))
                [:COLMAP_POINTS].to(live.device)]
    rgb = torch.clamp(st.params.sh_dc[pick, 0] * C0 + 0.5, 0, 1)
    colmap.write_points3d_binary(colmap.ColmapPoints(
        wg.means[pick].double().cpu().numpy() * ORBIT_SCALE,
        (rgb * 255).round().to(torch.uint8).cpu().numpy(), np.zeros(len(pick))),
        os.path.join(cm, "sparse", "0", "points3D.bin"))
    return dict(blender=blender, colmap=cm, views=ORBIT_VIEWS, colmap_points=len(pick),
                render_launches=render_launches)


def cp_launches() -> dict:
    from gaussianavatars_torch.ops import composite_pairs as cp

    return dict(cp.LAUNCHES)


def cli_unbound(card, source: str, name: str, flags) -> tuple:
    """`tools.train.main` unbound on `source`: its launches (rows 1 and 2
    once a step and an eval view), the loss falling, no FLAME leaves."""
    from gaussianavatars_torch.data import ply

    from gaussianavatars_torch.tools import train as ttrain

    model_dir = os.path.join(CLI_DIR, name)
    argv = ["-s", source, "-m", model_dir, *flags, "--device", CLI_DEVICE]
    iters = ttrain.parse_args(argv).iterations
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    h, logs = ttrain.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cp_launches()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    events = h.events
    eval_views = sum(e.get("n", 0) for e in events if e["kind"] == "eval")
    expect = {"composite_pairs_fwd": iters + eval_views, "composite_pairs_bwd": iters}
    got = {k: launches[k] for k in expect}
    stray = {k: v for k, v in launches.items() if v and k not in expect}
    saved = ply.load_gaussian_ply(os.path.join(model_dir, "point_cloud", f"iteration_{iters}",
                                               "point_cloud.ply"))
    res = dict(launches=got, expected_launches=expect, stray_launches=stray,
               events=sorted(recorded_events(events)),
               expected_events=sorted(expected_events(argv)),
               initial_points=logs[0]["num_points"], final_points=logs[-1]["num_points"],
               ply_binding=saved["binding"] is not None, ply_points=len(saved["means"]),
               flame_leaves=h.state.flame is not None,
               loss_by_log=[r["loss"] for r in logs])
    log(f"cli/{name}", **res)
    checks = {"launches": got == expect and not stray, "loss": loss_falls(logs),
              "events": recorded_events(events) == expected_events(argv),
              "unbound": h.model is None and not res["flame_leaves"]
              and not res["ply_binding"] and res["ply_points"] == res["final_points"]}
    if not all(checks.values()):
        raise AssertionError(f"cli/{name} checks failed: {checks}")
    numbers = dict(card=card["nvidia_smi"], steps_per_s_whole_run=iters / wall,
                   steps_per_s_between_events=rate_between_events(logs, events),
                   peak_mem_mib=peak_mib,
                   event_host_ms={f"{e['kind']}@{e['iteration']}": e["ms"] for e in events})
    return h, got, res, numbers


def phase_cli(card, fitted) -> dict:
    """Phase 16: the training CLI through `tools.train.main`, FLAME-bound
    (with the viewer, the debug hooks, render and metrics) and unbound on
    a Blender and a COLMAP scene of the fitted avatar. Returns rows 1 and
    2's launches on these paths."""
    from gaussianavatars_torch.ops.knn import mean_sq_dist_3nn, rows_mean_sq_dist_3nn

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(CLI_DIR)
    got = cli_flame(card, *flame_files(card))

    # --- unbound, Blender layout --------------------------------------------------
    t0 = time.perf_counter()
    scenes = write_orbit_scenes(fitted, os.path.join(CLI_DIR, "scenes"))
    log("cli/scenes", **scenes, seconds=time.perf_counter() - t0)
    h, b_got, b_res, b_num = cli_unbound(card, scenes["blender"], "blender", CLI_BLENDER_FLAGS)
    # The reader's 100,000 random points: the knn on the card against the
    # CPU's on a sample of rows (each against all the points).
    pts = torch.as_tensor(h.scene.info.point_cloud.points, dtype=torch.float32)
    pts_dev = pts.to(CLI_DEVICE)
    knn_card = mean_sq_dist_3nn(pts_dev)
    knn_ms = cuda_ms(lambda: mean_sq_dist_3nn(pts_dev), 3)
    rows = torch.randperm(len(pts), generator=torch.Generator().manual_seed(7))[:KNN_SAMPLE_ROWS]
    t0 = time.perf_counter()
    knn_cpu = rows_mean_sq_dist_3nn(pts, rows)
    cpu_s = time.perf_counter() - t0
    rel = float(((knn_card.cpu()[rows] - knn_cpu).abs() / knn_cpu.abs()).max())
    knn = dict(points=len(pts), sample_rows=KNN_SAMPLE_ROWS, max_rel_err=rel,
               card_ms=knn_ms, cpu_s_sample=cpu_s)
    log("cli/knn", **knn, card=card["nvidia_smi"])
    if not (len(pts) == NERF_RANDOM_POINTS == b_res["initial_points"] and rel <= 1e-4):
        raise AssertionError(f"cli/knn: {knn}, initial points {b_res['initial_points']}")
    log("cli/blender_numbers", **b_num, resolution=f"{ORBIT_SIZE}x{ORBIT_SIZE}",
        knn_ms_100k=knn_ms)
    del h

    # --- unbound, COLMAP layout ------------------------------------------------------
    h, c_got, c_res, c_num = cli_unbound(card, scenes["colmap"], "colmap", CLI_COLMAP_FLAGS)
    names = sorted(f"view_{i:03d}" for i in range(ORBIT_VIEWS))
    split = dict(train=[c.image_name for c in h.scene.cameras("train")],
                 test=[c.image_name for c in h.scene.cameras("test")])
    log("cli/colmap_numbers", **c_num, split=split, resolution=f"{ORBIT_SIZE}x{ORBIT_SIZE}")
    if split["test"] != names[::8] or split["train"] != [n for n in names if n not in names[::8]]:
        raise AssertionError(f"cli/colmap: the split is not llffhold 8: {split}")
    for k in got:
        got[k] += b_got[k] + c_got[k]
    return got


# --- 21. the real-FLAME import -------------------------------------------------

FLAME_DIR = os.path.join("build", "chip_smoke", "flame_import")
FLAME_NPZ = os.path.join(FLAME_DIR, "flame2023.npz")
# The part names of the licensed FLAME_masks.pkl.
FLAME_PARTS = ("eye_region", "neck", "left_eyeball", "right_eyeball", "right_ear",
               "left_ear", "forehead", "lips", "nose", "scalp", "boundary", "face",
               "left_eye_region", "right_eye_region")
N_LANDMARK_STEPS = 8      # timesteps of the landmark forward
N_FLAME_REPS = 20         # forwards a timing


def write_obj(path: str, verts, uvs, faces, faces_uv) -> None:
    """An OBJ with positions, UVs and `f v/vt` triangles (float32 exact)."""
    with open(path, "w") as f:
        f.writelines(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in verts)
        f.writelines(f"vt {u:.9g} {v:.9g}\n" for u, v in uvs)
        f.writelines(f"f {a + 1}/{ta + 1} {b + 1}/{tb + 1} {c + 1}/{tc + 1}\n"
                     for (a, b, c), (ta, tb, tc) in zip(faces, faces_uv))


def flame_files(card) -> tuple:
    """FLAME-2023-shaped files made from `synthetic_assets(300, 100, seed=0)`
    (what `tools.train` falls back to without `--flame_assets`), as the
    licensed ones are laid out: the model pickle (float64, shapedirs
    [V, 3, 400], posedirs [V, 3, 36], a scipy-sparse J_regressor, a
    kintree_table), the template OBJ, a masks pickle (FLAME_PARTS' names,
    vertex sets drawn from a seed) and a 68-point landmark embedding.
    Converted by the port's `convert_flame_pickle`; every array loaded back
    must equal the one written. Returns (npz path, the part masks)."""
    import pickle

    import scipy.sparse

    from gaussianavatars_torch.models.flame.assets import (
        convert_flame_pickle, load_assets, synthetic_assets,
    )

    shutil.rmtree(FLAME_DIR, ignore_errors=True)
    os.makedirs(FLAME_DIR)
    t0 = time.perf_counter()
    a = synthetic_assets(n_shape=300, n_expr=100, seed=0)
    v, f64 = a.num_verts, np.float64
    obj = os.path.join(FLAME_DIR, "head_template_mesh.obj")
    write_obj(obj, a.v_template, a.verts_uvs, a.faces, a.faces_uv)
    model = {
        "v_template": a.v_template.astype(f64),
        "shapedirs": a.shapedirs.astype(f64),
        "posedirs": a.posedirs.T.reshape(v, 3, -1).astype(f64),
        "J_regressor": scipy.sparse.csc_matrix(a.j_regressor.astype(f64)),
        "kintree_table": np.stack([np.where(a.parents < 0, 2**32 - 1, a.parents),
                                   np.arange(len(a.parents))]).astype(np.int64),
        "weights": a.lbs_weights.astype(f64),
        "f": a.faces.astype(np.uint32),
    }
    pkl = os.path.join(FLAME_DIR, "flame2023.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(model, f, protocol=2)
    rng = np.random.RandomState(21)
    parts = {k: np.sort(rng.choice(v, 300, replace=False)) for k in FLAME_PARTS}
    masks_pkl = os.path.join(FLAME_DIR, "FLAME_masks.pkl")
    with open(masks_pkl, "wb") as f:
        pickle.dump(parts, f, protocol=2)
    lmk = os.path.join(FLAME_DIR, "landmark_embedding.npy")
    np.save(lmk, {"full_lmk_faces_idx": a.lmk_faces_idx[None].astype(np.int64),
                  "full_lmk_bary_coords": a.lmk_bary_coords[None].astype(f64)},
            allow_pickle=True)
    written_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    npz = convert_flame_pickle(pkl, obj, FLAME_NPZ, masks_pkl=masks_pkl, lmk_embedding_npy=lmk)
    convert_s = time.perf_counter() - t0
    b = load_assets(npz)
    differ = [k for k in a._fields if k not in ("vertex_masks", "n_shape")
              and not np.array_equal(getattr(a, k), getattr(b, k))]
    differ += [] if a.n_shape == b.n_shape else ["n_shape"]
    want = {**a.vertex_masks, **{k: p.astype(np.int32) for k, p in parts.items()}}
    differ += [f"mask_{k}" for k, m in want.items()
               if k not in b.vertex_masks or not np.array_equal(b.vertex_masks[k], m)]
    res = dict(npz=npz, npz_mib=os.path.getsize(npz) / 2**20, pickle_mib=os.path.getsize(pkl)
               / 2**20, verts=b.num_verts, faces=b.num_faces, shapedirs=list(b.shapedirs.shape),
               posedirs=list(b.posedirs.shape), landmarks=len(b.lmk_faces_idx),
               masks=len(b.vertex_masks), keys_compared=len(a._fields) - 1 + len(want),
               keys_differ=differ, write_s=written_s, convert_s=convert_s,
               card=card["nvidia_smi"])
    log("flame_import/files", **res)
    if differ or b.num_verts != 5023 or b.shapedirs.shape[-1] != 400 or len(b.lmk_faces_idx) != 68:
        raise AssertionError(f"flame_import/files: {res}")
    return npz, parts


def phase_flame_import(card, npz: str, scene) -> dict:
    """Phase 21 on the converted npz: the FLAME forward with landmarks and
    root centring over N_LANDMARK_STEPS timesteps, teeth added, on the card
    against the CPU (1e-5 of each output's largest magnitude); then
    `project_gaussians` on the benchmark avatar (`scene`: `render.build_scene`)
    against the sorted path's `project_from_params` (the same bits), and on
    the card against the CPU (1e-5 relative)."""
    from gaussianavatars_torch.models.binding import face_frames
    from gaussianavatars_torch.models.flame.assets import load_assets
    from gaussianavatars_torch.models.flame.flame_model import (
        FlameConfig, FlameModel, FlameParams,
    )
    from gaussianavatars_torch.models.gaussians import world_gaussians
    from gaussianavatars_torch.ops.projection import project_from_params, project_gaussians
    from gaussianavatars_torch.ops.quaternion import covariance_from_scaling_rotation

    t0 = time.perf_counter()
    assets = load_assets(npz)
    cfg = FlameConfig(n_shape=300, n_expr=100, add_teeth=True)
    card_model = FlameModel(assets, cfg, device="cuda")
    cpu_model = FlameModel(assets, cfg, device="cpu")
    rng = np.random.RandomState(31)
    b = N_LANDMARK_STEPS

    def r(*shape, scale=0.2):
        return torch.as_tensor((rng.randn(*shape) * scale).astype(np.float32))

    host = FlameParams(shape=r(300, scale=1.0), expr=r(b, 100, scale=1.0), rotation=r(b, 3),
                       neck=r(b, 3), jaw=r(b, 3), eyes=r(b, 6),
                       translation=r(b, 3, scale=0.05))
    dev = FlameParams(*(x.cuda() if x is not None else None for x in host))
    flags = dict(return_verts_cano=True, return_landmarks=True, zero_centered_at_root_node=True)
    with torch.no_grad():
        got = card_model(dev, **flags)
        want = cpu_model(host, **flags)
        plain = card_model(dev)
        landmark_ms = cuda_ms(lambda: card_model(dev, **flags), N_FLAME_REPS)
        plain_ms = cuda_ms(lambda: card_model(dev), N_FLAME_REPS)
    errs = {k: rel_err(g, w) for k, g, w in zip(("verts", "verts_cano", "landmarks"), got, want)}
    # Root centring moves every vertex of a timestep by the same vector.
    shift = plain - got[0]
    spread = float((shift - shift[:, :1]).abs().max())
    flame = dict(timesteps=b, verts=card_model.num_verts, landmarks=list(got[2].shape),
                 max_rel_err=errs, root_shift_spread=spread, finite=all(
                     bool(torch.isfinite(x).all()) for x in got),
                 ms_with_landmarks=landmark_ms, ms_plain=plain_ms, card=card["nvidia_smi"])
    log("flame_import/forward", **flame)
    if not (max(errs.values()) <= 1e-5 and flame["finite"] and spread <= 1e-6
            and flame["landmarks"] == [b, 68, 3]):
        raise AssertionError(f"flame_import/forward: {flame}")

    model, params, aux, fl, cam, n_g = scene
    with torch.no_grad():
        wg = world_gaussians(params, aux, face_frames(model(fl)[0], model.faces))
        cov = covariance_from_scaling_rotation(wg.scales, wg.quats)
        pg = project_gaussians(wg.means, cov, cam, alive=wg.alive)
        pf = project_from_params(wg.means, wg.scales, wg.quats, cam, alive=wg.alive)
        pg_ms = cuda_ms(lambda: project_gaussians(
            wg.means, covariance_from_scaling_rotation(wg.scales, wg.quats), cam,
            alive=wg.alive), N_FLAME_REPS)
        pf_ms = cuda_ms(lambda: project_from_params(wg.means, wg.scales, wg.quats, cam,
                                                    alive=wg.alive), N_FLAME_REPS)
        cpu_cam = cpu_camera(cam)
        pc = project_gaussians(wg.means.cpu(), cov.cpu(), cpu_cam, alive=wg.alive.cpu())
    same = {k: bool(torch.equal(getattr(pg, k), getattr(pf, k))) for k in pg._fields}
    m = pg.mask.cpu() & pc.mask
    cpu_err = {k: rel_err(getattr(pg, k)[m.cuda()], getattr(pc, k)[m])
               for k in ("mean2d", "depth", "conic", "cov2d")}
    proj = dict(gaussians=n_g, resolution=f"{cam.width}x{cam.height}",
                visible=int(pg.mask.sum()), equal_to_sorted_path=same,
                card_vs_cpu_max_rel_err=cpu_err,
                card_vs_cpu_mask_mismatches=int((pg.mask.cpu() != pc.mask).sum()),
                card_vs_cpu_radius_mismatches=int((pg.radius.cpu() != pc.radius).sum()),
                ms=pg_ms, sorted_path_ms=pf_ms, card=card["nvidia_smi"])
    log("flame_import/project_gaussians", **proj)
    if not (all(same.values()) and max(cpu_err.values()) <= 1e-5 and proj["visible"] > 0):
        raise AssertionError(f"flame_import/project_gaussians: {proj}")
    log("flame_import/seconds", seconds=time.perf_counter() - t0)
    return dict(forward=flame, projection=proj)


# --- phase 17: the table pipeline, the stage timings, the roofline, the
# profiler and the two viewer tools ------------------------------------------

TABLE_DIR = os.path.join("build", "chip_smoke", "table")
N_TABLE_FRAMES = 30      # frames of each path in the table/sorted serving timing
N_TABLE_STEPS = 5        # steps of each path in the fitted table/sorted step timing
N_TABLE_STEPS_BENCH = 2  # the same at the benchmark frame (~1.5 s a table step)
# The table fit: `train_synthetic --no_pallas` at 802×550 on 4 timesteps ×
# 4 cameras, 80 iterations, the tiles a Gaussian probed on the initial
# state's train views and a capacity of 3/4 of its fullest tile: the first
# window overflows and the loop doubles the capacity once, to 1.5× it.
TABLE_FIT_FLAGS = ("--no_pallas", "--width", "802", "--height", "550", "--capacity", "65536",
                   "--per_face", "2", "--timesteps", "4", "--cameras", "4",
                   "--log_every", "15", "--eval_every", "0")
TABLE_FIT_ITERS = 80
TABLE_IMG_ATOL = 1e-5    # tests/test_torch_rasterize_tiled.py: table = sorted = JAX at 1e-5
# The card against the CPU on a whole frame: the two round exp and the
# FLAME forward differently by an ulp, which can move a Gaussian's alpha
# across the 1/255 cutoff at a pixel; that pixel then moves by up to
# 1/255 · T · colour. So at most 1/255 anywhere, and above TABLE_IMG_ATOL
# on at most 1e-3 of the values (3.83e-3 at one pixel of phase 12's fitted view on an
# NVIDIA H100 80GB HBM3).
CARD_CPU_MAX = 1.0 / 255.0 + 1e-6
CARD_CPU_SHARE = 1e-3
TABLE_DEVICE = "cuda"
TABLE_GRAD_REL = 1e-4    # the same file: the gradients within 1e-4 of their largest
STAGE_ITERS = 20
# The table run's chunk row replays the fixed walk (~1.5 s a step at the
# benchmark table on an H100 80GB HBM3, phase 20 (e)): 5 iterations a row.
STAGE_ITERS_TABLE = 5
ROOFLINE_SHARE_MAX = 1.05
TRACE_RANGES = ("train/geometry_fwd", "train/image_fwd", "train/image_bwd",
                "train/densify_stats", "train/geometry_bwd", "train/adam")


def kernels_per_call(fn, calls: int = 3) -> float:
    """CUDA kernels a call of `fn` launches (torch.profiler's device events,
    the compositor kernels' ctypes launches included)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.events()
               if e.device_type == cuda and not e.is_user_annotation) / calls


def host_rate(fn, n: int) -> float:
    """Calls a second of `fn` over `n` calls, host clock, synchronised at
    both ends."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def table_render(scene, flp, use_pallas: bool, tile=None):
    from gaussianavatars_torch.models.binding import face_frames
    from gaussianavatars_torch.models.gaussians import world_gaussians
    from gaussianavatars_torch.ops.rasterize_tiled import render_tiled

    model, params, aux, cam = scene["model"], scene["params"], scene["aux"], scene["cam"]
    wg = world_gaussians(params, aux, face_frames(model(flp)[0], model.faces))
    return render_tiled(wg.means, wg.scales, wg.quats, wg.opacity, cam,
                        torch.zeros(3, device=cam.world_view.device), sh=wg.sh, sh_degree=3,
                        alive=wg.alive, cfg=tile or scene["tile"], use_pallas=use_pallas)


def table_binning(scene, tile):
    """The benchmark frame's table binning with `tile`, and the largest
    bbox footprint (tiles) of a live Gaussian."""
    from gaussianavatars_torch.models.binding import face_frames
    from gaussianavatars_torch.models.gaussians import world_gaussians
    from gaussianavatars_torch.ops.projection import project_from_params
    from gaussianavatars_torch.ops.rasterize_tiled import bin_gaussians
    from gaussianavatars_torch.ops.sort_binning import bbox_tiles

    model, params, aux, cam = scene["model"], scene["params"], scene["aux"], scene["cam"]
    wg = world_gaussians(params, aux, face_frames(model(scene["fl"])[0], model.faces))
    proj = project_from_params(wg.means, wg.scales, wg.quats, cam, alive=wg.alive)
    opac = torch.where(proj.mask, wg.opacity, torch.zeros_like(wg.opacity))
    _x, _y, _bw, ntiles, _ny, _nx = bbox_tiles(proj, cam.height, cam.width, tile.tile_h,
                                               tile.tile_w, opacity=opac)
    footprint = int(torch.where(proj.mask, ntiles, torch.zeros_like(ntiles)).max())
    return bin_gaussians(proj, cam.height, cam.width, tile, opacity=opac), footprint


def table_frame_numbers(scene, tile, label: str) -> dict:
    """The table render at the benchmark frame with `tile`: its overflow,
    frames/s against the sorted path's in turns, and the compositor's
    device ms and launches (CUDA events and the profiler, a forward on the
    frame's fixed slots)."""
    from gaussianavatars_torch.ops import rasterize_tiled as rt

    binned, footprint = table_binning(scene, tile)
    poses = scene["poses"]
    rates = {}
    n = N_TABLE_FRAMES if min(int(binned.counts.max()), tile.capacity) <= 1024 else 3
    for name, use_pallas in (("table", False), ("sorted", True), ("table_again", False)):
        rates[name] = host_rate(lambda i, u=use_pallas: table_render(
            scene, poses[i % len(poses)], u, tile), n)
    calls = []
    real = rt.composite_tiles

    def spy(*a):
        calls.append(a)
        return real(*a)

    rt.composite_tiles = spy
    try:
        table_render(scene, scene["fl"], False, tile)
    finally:
        rt.composite_tiles = real
    slots = calls[0]
    fixed = lambda: real(*slots)   # noqa: E731
    return dict(label=label, capacity=tile.capacity,
                max_tiles_per_gaussian=tile.max_tiles_per_gaussian,
                overflow=int(binned.overflow), budget_overflow=int(binned.budget_overflow),
                fullest_tile=int(binned.counts.max()), largest_footprint=footprint,
                pairs_binned=int(binned.counts.sum()), slots_composited=slots[4].shape[1],
                frames_per_s=rates, frames_timed=n, compositor_device_ms=cuda_ms(fixed, 3),
                compositor_launches_per_frame=kernels_per_call(fixed, 2),
                frame_launches=kernels_per_call(
                    lambda: table_render(scene, scene["fl"], False, tile), 2))


def table_phase_render(card, scene, fitted_ply: str) -> dict:
    """17a: `render_tiled(use_pallas=False)`. At the benchmark frame with
    the default `TileConfig` (its overflow reported) and with a table
    sized to the frame (no overflow; image and alpha against the sorted
    kernel path); on the fitted avatar (phase 12) through
    `AvatarViewerCore(use_pallas=False)` with the default table, against
    the sorted core and the CPU's table core."""
    from gaussianavatars_torch.ops.rasterize_tiled import TileConfig
    from gaussianavatars_torch.render import probe_tile_config
    from gaussianavatars_torch.viewers.local import AvatarViewerCore

    default = scene["tile"]
    assert (default.capacity, default.max_tiles_per_gaussian) == (
        TileConfig().capacity, TileConfig().max_tiles_per_gaussian)
    res = {"default": table_frame_numbers(scene, default, "default TileConfig")}
    # The table that holds the frame (`probe_tile_config(table=True)`).
    sized = probe_tile_config(scene["model"], scene["params"], scene["aux"], scene["fl"],
                              scene["cam"], default.tile_h, default.tile_w, table=True)
    res["sized"] = table_frame_numbers(scene, sized, "sized to the frame")
    res["sized_counts"] = table_binning(scene, sized)[0].counts
    table = table_render(scene, scene["fl"], False, sized)
    sorted_ = table_render(scene, scene["fl"], True)
    res["benchmark_errors"] = dict(
        table_vs_sorted_color=float((table.color - sorted_.color).abs().max()),
        table_vs_sorted_alpha=float((table.alpha - sorted_.alpha).abs().max()))

    # The fitted avatar through the viewer core, at the orbit camera (the
    # table cores size their table to that view).
    cores = {name: AvatarViewerCore(fitted_ply, use_pallas=use_pallas, device=dev)
             for name, use_pallas, dev in (("table", False, TABLE_DEVICE),
                                           ("sorted", None, TABLE_DEVICE),
                                           ("table_cpu", False, "cpu"))}
    imgs = {}
    for name, core in cores.items():
        cam = core.cam.to_camera(device=core.device)
        imgs[name] = core.render_tensor(core.flame_params_at(0), cam).cpu()
    tcore = cores["table"]
    fit_scene = dict(model=tcore.model, params=tcore.params, aux=tcore.aux,
                     cam=tcore.cam.to_camera(device=TABLE_DEVICE), fl=tcore.flame_params_at(0))
    fit_binned, fit_fp = table_binning(fit_scene, tcore.tile)
    fcam = fit_scene["cam"]
    rates = {}
    for name in ("table", "sorted", "table_again"):
        core = cores[name.replace("_again", "")]
        rates[name] = host_rate(lambda i, c=core: c.render_tensor(
            c.flame_params_at(0), fcam), N_TABLE_FRAMES)
    res["fitted"] = dict(
        gaussians=tcore.num_points, overflow=int(fit_binned.overflow),
        budget_overflow=int(fit_binned.budget_overflow),
        fullest_tile=int(fit_binned.counts.max()), largest_footprint=fit_fp,
        table_vs_sorted_color=float((imgs["table"] - imgs["sorted"]).abs().max()),
        card_vs_cpu_color=float((imgs["table"] - imgs["table_cpu"]).abs().max()),
        card_vs_cpu_share_above_atol=float(
            ((imgs["table"] - imgs["table_cpu"]).abs() > TABLE_IMG_ATOL).float().mean()),
        frames_per_s=rates,
        frame_launches=kernels_per_call(lambda: tcore.render_tensor(tcore.flame_params_at(0),
                                                                    fcam), 2))
    log("table/render", **{k: v for k, v in res.items() if k != "sized_counts"},
        card=card["nvidia_smi"])
    errs = [res["benchmark_errors"]["table_vs_sorted_color"],
            res["benchmark_errors"]["table_vs_sorted_alpha"],
            res["fitted"]["table_vs_sorted_color"]]
    f = res["fitted"]
    if not (res["sized"]["overflow"] == res["sized"]["budget_overflow"] == 0
            and f["overflow"] == f["budget_overflow"] == 0
            and max(errs) <= TABLE_IMG_ATOL and f["card_vs_cpu_color"] <= CARD_CPU_MAX
            and f["card_vs_cpu_share_above_atol"] <= CARD_CPU_SHARE):
        raise AssertionError(f"table/render: {res}")
    res["sized_tile"] = sized
    return res


def table_step_pair(model, cfg0, tile_t, tile_s, state0, gt, cam, bg, ts: int, n_steps: int):
    """One table-path step against the sorted step on `state0` (loss and
    Adam's first moments), then steps/s of both in turns, kernels a step
    and the peak memory above the start."""
    from gaussianavatars_torch.training.trainer import make_train_step

    cfg_t = dataclasses.replace(cfg0, pipeline=dataclasses.replace(cfg0.pipeline,
                                                                   use_pallas=False))
    step_t = make_train_step(model, cfg_t, tile_t)
    step_s = make_train_step(model, cfg0, tile_s)
    out_t = step_t(state0, gt, cam, ts, bg, 3)
    out_s = step_s(state0, gt, cam, ts, bg, 3)
    loss_rel = abs(float(out_t.metrics["loss"]) / float(out_s.metrics["loss"]) - 1.0)
    mu_err = leaf_errors(out_t.state.adam.mu, out_s.state.adam.mu)
    if state0.flame_adam is not None:
        mu_err.update({f"flame.{k}": v for k, v in
                       leaf_errors(out_t.state.flame_adam.mu, out_s.state.flame_adam.mu).items()})
    rates, peak = {}, {}
    for name, step in (("table", step_t), ("sorted", step_s), ("table_again", step_t)):
        st = {"s": state0}

        def run(i, step=step, st=st):
            st["s"] = step(st["s"], gt, cam, ts, bg, 3).state

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rates[name] = host_rate(run, n_steps)
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**20
    return dict(loss_rel_err=loss_rel, adam_mu_rel_err=mu_err,
                overflow=int(out_t.metrics["overflow"]),
                budget_overflow=int(out_t.metrics["budget_overflow"]),
                steps_per_s=rates, steps_timed=n_steps, peak_mem_above_start_mib=peak,
                table_kernels_per_step=kernels_per_call(
                    lambda: step_t(state0, gt, cam, ts, bg, 3), 1),
                sorted_kernels_per_step=kernels_per_call(
                    lambda: step_s(state0, gt, cam, ts, bg, 3), 1))


def table_phase_step(card, scene, setup, harness, sized_tile) -> dict:
    """17b: the table step against the sorted step on the same state: the
    benchmark state and phase 12's fitted state on its first train view,
    each with the table sized to its frame."""
    from gaussianavatars_torch.data.pipeline import load_view
    from gaussianavatars_torch.render import probe_tile_config
    from gaussianavatars_torch.training import loop

    cfg0, gt, bg, state0 = setup
    res = {"benchmark": table_step_pair(scene["model"], cfg0, sized_tile, scene["tile"],
                                        state0, gt, scene["cam"], bg, 0, N_TABLE_STEPS_BENCH)}
    cam = harness.scene.cameras("train")[0]
    rec = harness.scene.records("train")[0]
    gt_f = torch.from_numpy(load_view(rec, cam)).to(TABLE_DEVICE)
    live = harness.live_tile_config
    ts = int(cam.timestep or 0)
    probed = probe_tile_config(harness.model, harness.state.params, harness.state.aux,
                               loop._flame_params(harness.state, ts), cam, live.tile_h,
                               live.tile_w, table=True)
    tile_t = dataclasses.replace(live, capacity=probed.capacity,
                                 max_tiles_per_gaussian=probed.max_tiles_per_gaussian)
    res["fitted"] = table_step_pair(harness.model, harness.cfg, tile_t, live, harness.state,
                                    gt_f, cam, torch.zeros(3, device=TABLE_DEVICE), ts,
                                    N_TABLE_STEPS)
    res["fitted"]["table"] = [tile_t.capacity, tile_t.max_tiles_per_gaussian]
    res["benchmark"]["table"] = [sized_tile.capacity, sized_tile.max_tiles_per_gaussian]
    log("table/step", **res, card=card["nvidia_smi"])
    for r in res.values():
        if not (r["loss_rel_err"] <= TABLE_GRAD_REL
                and max(r["adam_mu_rel_err"].values()) <= TABLE_GRAD_REL
                and r["overflow"] == 0 and r["budget_overflow"] == 0):
            raise AssertionError(f"table/step: the table step differs from the sorted one: {res}")
    return res


def fullest_train_tile(harness) -> tuple:
    """(the most Gaussians binned to one tile, the probed tiles a Gaussian)
    over the train views of the harness's state, no bbox cut."""
    from gaussianavatars_torch.render import probe_tile_config
    from gaussianavatars_torch.training import loop

    st, model = harness.state, harness.model
    fullest = tiles = 0
    for cam in harness.scene.cameras("train"):
        fp = loop._flame_params(st, int(cam.timestep or 0))
        t = probe_tile_config(model, st.params, st.aux, fp, cam, table=True)
        scene = dict(model=model, params=st.params, aux=st.aux, cam=cam, fl=fp)
        counts = table_binning(scene, dataclasses.replace(t, capacity=1))[0].counts
        fullest = max(fullest, int(counts.max()))
        tiles = max(tiles, t.max_tiles_per_gaussian)
    return fullest, tiles


def table_phase_fit(card) -> dict:
    """17c: `tools.train_synthetic --no_pallas`; the capacity doubles once,
    the loss falls, rows 1 and 2 never launch. A run of 0 iterations writes
    the dataset (which the fit then reuses) and gives the initial state."""
    from gaussianavatars_torch.tools import train_synthetic as ts

    workdir = os.path.join(TABLE_DIR, "fit")
    shutil.rmtree(workdir, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    h0, _r0 = ts.run(ts.parse_args([*TABLE_FIT_FLAGS, "--iterations", "0",
                                    "--workdir", workdir]))
    # The tiles a Gaussian of the probed table (a power of two at or above
    # every bbox: no budget overflow) and 3/4 of the initial fullest tile.
    fullest, tiles = fullest_train_tile(h0)
    capacity = 3 * fullest // 4
    del h0
    # Single steps: phase 20 (e) runs this recipe's chunks against them.
    args = ts.parse_args([*TABLE_FIT_FLAGS, "--iterations", str(TABLE_FIT_ITERS),
                          "--capacity_per_tile", str(capacity),
                          "--max_tiles_per_gaussian", str(tiles), "--workdir", workdir,
                          "--steps_per_call", "1"])
    harness, result = ts.run(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cp_launches()
    logs = result["logs"]
    grows = [e for e in harness.events if e["kind"] in ("grow_table", "grow_tiers")]
    capacity_grows = [e for e in grows if e["overflow"] > 0]
    live = harness.live_tile_config
    res = dict(launches=launches, fullest_initial_tile=fullest, tiles_per_gaussian=tiles,
               capacity=capacity, grows=grows,
               loss_by_log=[r["loss"] for r in logs],
               overflow_by_log=[r["overflow"] for r in logs],
               capacity_final=live.capacity, steps_per_s=args.iterations / result["train_s"],
               between_events=rate_between_events(logs, harness.events),
               eval_val=result.get("eval_val"), eval_untrained_val=result.get("eval_untrained_val"),
               seconds=seconds)
    log("table/fit", **res, card=card["nvidia_smi"])
    ok = (not any(launches.values()) and len(capacity_grows) == 1
          and all(e["kind"] == "grow_table" for e in grows)
          and capacity_grows[0]["capacity"] == 2 * capacity
          and live.capacity == 2 * capacity and loss_falls(logs))
    if not ok:
        raise AssertionError(f"table/fit: {res}")
    return res


def table_phase_stages(card) -> tuple:
    """17d: `tools.stage_timings` on both pipelines; rows 1 and 2's
    launches of the sorted run."""
    from gaussianavatars_torch.tools import stage_timings

    out = {}
    reset_launches()
    out["sorted"] = stage_timings.main(["--iters", str(STAGE_ITERS)])
    launches = cp_launches()
    reset_launches()
    out["table"] = stage_timings.main(["--iters", str(STAGE_ITERS_TABLE), "--no_pallas"])
    table_launches = cp_launches()
    log("table/stage_timings", ms=out, iters={"sorted": STAGE_ITERS, "table": STAGE_ITERS_TABLE},
        card=card["nvidia_smi"])
    bad = {p: k for p, rows in out.items() for k, v in rows.items()
           if not (math.isfinite(v) and v > 0)}
    if bad or len(out["sorted"]) != 9 or len(out["table"]) != 9 or any(table_launches.values()):
        raise AssertionError(f"table/stage_timings: {bad}, table launches {table_launches}")
    return out, launches


def table_phase_roofline(card, scene, serving_fps, train_steps_s, render_res, step_res):
    """17e: the H100's primitive rates, and both rooflines at the benchmark
    frame against the measured frames/s and steps/s (the table path's with
    the table sized to the frame)."""
    from gaussianavatars_torch.utils.roofline import (
        ChipSpec, compositor_roofline, measure_primitive_rates, sorted_roofline,
    )

    rates = measure_primitive_rates(TABLE_DEVICE)
    log("table/primitive_rates", **rates, n=1 << 20, card=card["nvidia_smi"])
    params, cam, tile = scene["params"], scene["cam"], scene["tile"]
    sized = render_res["sized_tile"]
    cap = params.capacity
    p_px = tile.tile_h * tile.tile_w
    counts_sorted = scene["plan_counts"].cpu().numpy()
    counts_table = render_res["sized_counts"].cpu().numpy()
    n_expand = tile.tier_spec(cap).expansion_size(cap)
    measured = dict(serving_frames_per_s=serving_fps, train_steps_per_s=train_steps_s,
                    table_frames_per_s=render_res["sized"]["frames_per_s"]["table"],
                    table_steps_per_s=step_res["benchmark"]["steps_per_s"]["table"])
    out = {}
    for name, spec in (("default_spec", ChipSpec()),
                       ("this_run", dataclasses.replace(ChipSpec(), **rates))):
        srt = sorted_roofline(counts_sorted, p_px, cap, n_expand, cam.height, cam.width,
                              chip=spec)
        tab = compositor_roofline(counts_table, sized.capacity, p_px, cap,
                                  sized.max_tiles_per_gaussian, cam.height, cam.width,
                                  chip=spec)
        shares = {
            "sorted_render": serving_fps / srt["sol_render_fps"],
            "sorted_train": train_steps_s / srt["sol_train_iters_s"],
            "table_render": measured["table_frames_per_s"] / tab["sol_render_fps"],
            "table_train": measured["table_steps_per_s"] / tab["sol_train_iters_s"],
        }
        out[name] = dict(sorted=srt, table=tab, share_of_speed_of_light=shares)
    log("table/roofline", **out, measured=measured, table_capacity=sized.capacity,
        table_tiles_per_gaussian=sized.max_tiles_per_gaussian, card=card["nvidia_smi"])
    worst = max(v for r in out.values() for v in r["share_of_speed_of_light"].values())
    if not worst <= ROOFLINE_SHARE_MAX:
        raise AssertionError(f"table/roofline: a share of speed of light is {worst}")
    return out


def table_phase_profiler(card, scene, setup) -> dict:
    """17f: `utils.profiling.trace` around 3 sorted steps."""
    from gaussianavatars_torch.training.trainer import make_train_step
    from gaussianavatars_torch.utils.profiling import annotate, trace

    cfg0, gt, bg, state0 = setup
    cam = scene["cam"]
    step = make_train_step(scene["model"], cfg0, scene["tile"])
    log_dir = os.path.join(TABLE_DIR, "trace")
    shutil.rmtree(log_dir, ignore_errors=True)
    st = state0
    reset_launches()
    with trace(log_dir):
        for i in range(3):
            with annotate("smoke/step"):
                st = step(st, gt, cam, i % TRAIN_TIMESTEPS, bg, 3).state
        torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    launches = cp_launches()
    res = dict(trace_mib=os.path.getsize(path) / 2**20, events=len(names),
               ranges={r: r in names for r in TRACE_RANGES + ("smoke/step",)},
               kernels={k: any(k in n for n in names)
                        for k in ("composite_pairs_fwd_kernel", "composite_pairs_bwd_kernel")},
               launches=launches)
    log("table/profiler", **res, card=card["nvidia_smi"])
    if not (all(res["ranges"].values()) and all(res["kernels"].values())):
        raise AssertionError(f"table/profiler: {res}")
    return res


def table_phase_viewers(card, harness) -> dict:
    """17g: `tools.local_viewer --headless` on phase 12's model directory
    (its frame equal byte for byte to `AvatarViewerCore`'s, the table
    frame within 1/255), and `tools.remote_viewer --headless` taking 2
    frames from a `TrainingGuiServer`."""
    import threading

    from PIL import Image

    from gaussianavatars_torch.models import io
    from gaussianavatars_torch.tools import local_viewer, remote_viewer
    from gaussianavatars_torch.viewers.local import AvatarViewerCore
    from gaussianavatars_torch.viewers.network_gui import TrainingGuiServer

    model_dir = os.path.join(LOOP_WORKDIR, "model")
    ply = io.checkpoint_ply_path(model_dir, io.find_latest_iteration(model_dir))
    out_dir = os.path.join(TABLE_DIR, "viewers")
    shutil.rmtree(out_dir, ignore_errors=True)
    reset_launches()
    frame = local_viewer.main([ply, "--headless", "--n_frames", "1", "--out_dir",
                               os.path.join(out_dir, "kernel")])[0]
    core = AvatarViewerCore(ply)
    want = (np.clip(core.render(timestep=0), 0, 1) * 255).astype(np.uint8)
    got = np.asarray(Image.open(frame).convert("RGB"))
    table = local_viewer.main([ply, "--headless", "--n_frames", "1", "--no_pallas",
                               "--out_dir", os.path.join(out_dir, "table")])[0]
    got_t = np.asarray(Image.open(table).convert("RGB")).astype(int)
    local = cp_launches()

    reset_launches()
    server = TrainingGuiServer("127.0.0.1", 0)
    box = {}

    def client():
        try:
            box["out"] = remote_viewer.main([
                "--port", str(server.port), "--headless", "--n_frames", "2",
                "--out_dir", os.path.join(out_dir, "remote")])
        except Exception as e:   # noqa: BLE001 — re-raised below on the main thread
            box["error"] = e

    th = threading.Thread(target=client)
    t0 = time.perf_counter()
    th.start()
    try:
        while th.is_alive() and time.perf_counter() - t0 < 120:
            server.service(harness, 0)
            time.sleep(0.002)
        th.join(timeout=30)
    finally:
        server.close()
    if "error" in box:
        raise box["error"]
    remote = cp_launches()
    frames = [np.asarray(Image.open(p).convert("RGB")) for p, _ in box.get("out", [])]
    live = int(harness.state.aux.alive.sum())
    res = dict(local_equal=bool(np.array_equal(got, want)) and got.shape == (550, 802, 3),
               local_nonzero=int((got > 0).any(-1).sum()),
               table_max_diff=int(np.abs(got_t - got.astype(int)).max()),
               local_launches=local, remote_frames=len(frames),
               remote_stats=[s for _p, s in box.get("out", [])], remote_launches=remote,
               seconds_remote=time.perf_counter() - t0)
    log("table/viewers", **res)
    if not (res["local_equal"] and res["local_nonzero"] > 0 and res["table_max_diff"] <= 1
            and local["composite_pairs_fwd"] == 2 and res["remote_frames"] == 2
            and remote["composite_pairs_fwd"] == 2
            and all(s["num_points"] == live for s in res["remote_stats"])):
        raise AssertionError(f"table/viewers: {res}")
    return res, {k: local[k] + remote[k] for k in local}


def phase_table(card, scene, setup, harness, serving_fps: float, train_steps_s: float) -> dict:
    """Phase 17. Returns rows 1 and 2's launches on its paths."""
    from gaussianavatars_torch.models import io

    t0 = time.perf_counter()
    seconds = {}
    launches = dict.fromkeys(cp_launches(), 0)

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t
        return out

    def add(got):
        for k, v in got.items():
            launches[k] += v

    model_dir = os.path.join(LOOP_WORKDIR, "model")
    fitted_ply = io.checkpoint_ply_path(model_dir, io.find_latest_iteration(model_dir))
    reset_launches()
    with torch.no_grad():
        render_res = part("render", lambda: table_phase_render(card, scene, fitted_ply))
    add(cp_launches())
    reset_launches()
    step_res = part("step", lambda: table_phase_step(card, scene, setup, harness,
                                                     render_res["sized_tile"]))
    add(cp_launches())
    part("fit", lambda: table_phase_fit(card))
    add(part("stage_timings", lambda: table_phase_stages(card))[1])
    part("roofline", lambda: table_phase_roofline(card, scene, serving_fps, train_steps_s,
                                                  render_res, step_res))
    add(part("profiler", lambda: table_phase_profiler(card, scene, setup))["launches"])
    add(part("viewers", lambda: table_phase_viewers(card, harness))[1])
    log("table/seconds", seconds=time.perf_counter() - t0, parts=seconds)
    return launches


# --- 18. multi-device training over a rank mesh --------------------------------

SHARDED_DIR = os.path.join("build", "chip_smoke", "sharded")
SHARDED_DEVICE = "cuda"   # "cpu" only in a CPU rehearsal (gloo for the one-rank world)
N_SHARDED_STEPS = 2       # steps of each eager comparison run ((a) against the single step, (b))
N_SHARDED_NCCL_STEPS = 6  # (b) over NCCL: 3 eager warm-up steps, the capture, 2 more replays
N_SHARDED_CAPTURED = 50   # (a): captured 1x1 steps against as many eager sharded steps
SHARDED_EVENTS = {20: "densify", 35: "opacity_reset"}   # (a): before these steps
N_SHARDED_SYNC = 10       # (a): replays under the sync check
N_SHARDED_PROFILED = 5    # (a): steps of each form under the profiler
N_SHARDED_BLOCK = 20      # (a): steps a block of the unsharded / eager / captured alternation
SHARDED_BLOCKS = ("unsharded", "eager", "captured", "captured", "eager", "unsharded")
SHARDED_REL = 1e-5        # the 1x1 step against the single-device step, every leaf
SHARDED_TIMEOUT_S = 420   # a launch's wall-clock limit
SHARDED_RUNS = ("1x4", "1x4:gauss_shard", "2x2")
SHARDED_YAW = 0.03        # radians: 2x2's second view, ~40 px off the first at 802x550
SHARDED_SCALING_SIZE = ()   # scaling_bench's defaults: the benchmark avatar at 802x550
# (e): scaling_bench's multi-rank meshes; on one card (gloo) they time-share it, so
# one mesh shows the path runs.
SHARDED_SCALING_MESHES = {"gloo": ("2x2", "5"), "nccl": ("2x2,1x4", "20")}   # meshes, iters
SHARDED_CLI_ITERS = 60
SHARDED_CLI_FLAGS = ("--bind_to_mesh", "--eval", "--iterations", str(SHARDED_CLI_ITERS),
                     "--test_iterations", "40", "--save_iterations", str(SHARDED_CLI_ITERS),
                     "--checkpoint_iterations", str(SHARDED_CLI_ITERS),
                     "--densify_from_iter", "10", "--densification_interval", "40",
                     "--densify_until_iter", str(SHARDED_CLI_ITERS),
                     "--opacity_reset_interval", "1000", "--log_every", "20", "--port", "0",
                     "--mesh", "2x2")


def ranks_backend() -> str:
    """The backend of phase 18's multi-rank runs: NCCL when every rank has a
    card of its own (four cards), else gloo, which lets ranks share one
    (NCCL refuses two ranks on a device)."""
    return "nccl" if torch.cuda.device_count() >= 4 else "gloo"


def max_rel(a: dict, b: dict) -> tuple:
    """(largest max|a - b| / max|b| over the leaves, its leaf)."""
    worst = (0.0, "")
    for k in b:
        x, y = a[k].double(), b[k].double()
        scale = float(y.abs().max()) if y.numel() else 0.0
        err = float((x - y).abs().max()) if y.numel() else 0.0
        rel = err / scale if scale else err
        worst = max(worst, (rel, k))
    return worst


def sharded_event(kind: str, state, model, cfg, it: int):
    """The loop's densify or opacity-reset event (`loop.densify_event`,
    `loop.opacity_reset_event`) on `state`: (new state, report)."""
    import types

    from gaussianavatars_torch.training import loop

    h = types.SimpleNamespace(cfg=cfg, model=model, state=state, spatial_lr_scale=1.0)
    report = loop.densify_event(h, it) if kind == "densify" else loop.opacity_reset_event(h)
    return h.state, report


def run_steps(fn, state, rows, bg, n: int, events=None, model=None, cfg=None):
    """n steps of fn (a sharded step's form) on the rows in turns, the
    SHARDED_EVENTS-like `events` applied before their steps: (state, each
    step's metrics, the events' reports)."""
    metrics, reports = [], {}
    for i in range(n):
        if events and i in events:
            state, reports[i] = sharded_event(events[i], state, model, cfg, i)
        state, m = fn(state, *rows[i % TRAIN_TIMESTEPS], bg, 3)
        metrics.append(m)
    return state, metrics, reports


def sharded_captured_1x1(card, step, rows, bg, model, cfg, state0) -> dict:
    """Phase 18 (a2): the step in its form (captured on the card over NCCL)
    against its eager form over N_SHARDED_CAPTURED steps from one state,
    with SHARDED_EVENTS among them: every leaf and every step's metrics bit
    for bit, the same event reports, one capture, rows 1 and 2 once a step,
    the collectives' counts equal; then no synchronising call while
    N_SHARDED_SYNC steps replay. Returns the runs' final states and
    launches."""
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.parallel.sharded import CAPTURED
    from gaussianavatars_torch.training.checkpoint import flatten_state

    runs, launches = {}, dict.fromkeys(cp.LAUNCHES, 0)
    for kind, fn in (("eager", step.eager), ("captured", step)):
        st0 = dataclasses.replace(state0, generator=torch.Generator().set_state(
            state0.generator.get_state()))
        reset_launches()
        step.collectives.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st, metrics, reports = run_steps(fn, st0, rows, bg, N_SHARDED_CAPTURED, SHARDED_EVENTS,
                                         model, cfg)
        torch.cuda.synchronize()
        runs[kind] = dict(state=st, metrics={k: torch.stack([m[k] for m in metrics])
                                             for k in metrics[0]},
                          reports=reports, launches={k: v for k, v in cp.LAUNCHES.items() if v},
                          collectives={k: (v["calls"], v["bytes"])
                                       for k, v in step.collectives.stats.items()},
                          seconds=time.perf_counter() - t0,
                          peak_mib=torch.cuda.max_memory_allocated() / 2**20)
        for k, v in cp.LAUNCHES.items():
            launches[k] += v
    e, c = runs["eager"], runs["captured"]
    fe, fc = flatten_state(e["state"]), flatten_state(c["state"])
    leaves_equal = list(fe) == list(fc) and all(torch.equal(fc[k], fe[k]) for k in fe)
    metrics_equal = set(e["metrics"]) == set(c["metrics"]) and all(
        torch.equal(c["metrics"][k], e["metrics"][k]) for k in e["metrics"])
    want = {"composite_pairs_fwd": N_SHARDED_CAPTURED, "composite_pairs_bwd": N_SHARDED_CAPTURED}
    res = dict(form=step.form, steps=N_SHARDED_CAPTURED, events=SHARDED_EVENTS,
               reports=c["reports"], reports_equal=c["reports"] == e["reports"],
               leaves_bit_equal=leaves_equal, metrics_bit_equal=metrics_equal,
               largest_leaf_rel=max_rel(fc, fe), largest_metric_rel=max_rel(c["metrics"],
                                                                             e["metrics"]),
               captures=step.captures, launches={k: runs[k]["launches"] for k in runs},
               collectives={k: runs[k]["collectives"] for k in runs},
               seconds={k: runs[k]["seconds"] for k in runs},
               peak_mem_mib={k: runs[k]["peak_mib"] for k in runs},
               loss_first_last=[float(c["metrics"]["loss"][0]), float(c["metrics"]["loss"][-1])])
    log("sharded/nccl_1x1/captured", card=card["nvidia_smi"], **res)
    if not (step.form == CAPTURED and leaves_equal and metrics_equal and res["reports_equal"]
            and step.captures == 1 and e["launches"] == want and c["launches"] == want
            and c["collectives"] == e["collectives"]):
        raise AssertionError(f"sharded/nccl_1x1/captured: {res}")

    # (a3) no host synchronisation while the step replays.
    reset_launches()
    out = {}
    syncs = sync_count(lambda: out.update(r=run_steps(step, c["state"], rows, bg,
                                                      N_SHARDED_SYNC)))
    for k, v in cp.LAUNCHES.items():
        launches[k] += v
    log("sharded/nccl_1x1/syncs", syncs_while_replaying=syncs, steps=N_SHARDED_SYNC,
        captures=step.captures)
    if syncs != 0 or step.captures != 1:
        raise AssertionError(f"sharded/nccl_1x1/syncs: {syncs} synchronising calls in "
                             f"{N_SHARDED_SYNC} replays, {step.captures} captures")
    return dict(states={"eager": e["state"], "captured": out["r"][0]}, launches=launches)


def sharded_rates_1x1(card, single, step, rows, gt, cam, bg, states) -> dict:
    """Phase 18 (a4)-(a6): steps/s of the unsharded, the eager sharded and
    the captured sharded step in SHARDED_BLOCKS of N_SHARDED_BLOCK steps,
    each continuing its own state, with each one's peak memory; a profiler
    trace of N_SHARDED_PROFILED steps of each (the unsharded step from the
    eager one's state; kernels a step, rows 1 and 2 once a replayed step,
    device-busy share);
    the collectives' ms and bytes a step, timed in eager steps. Returns
    rows 1 and 2's launches."""
    from gaussianavatars_torch.ops import composite_pairs as cp

    coll = step.collectives
    forms = {"unsharded": lambda st, ts: single(st, gt, cam, ts, bg, 3).state,
             "eager": lambda st, ts: step.eager(st, *rows[ts], bg, 3)[0],
             "captured": lambda st, ts: step(st, *rows[ts], bg, 3)[0]}

    def run(kind, n):
        st = states[kind]
        for i in range(n):
            st = forms[kind](st, i % TRAIN_TIMESTEPS)
        states[kind] = st

    secs = {k: [] for k in forms}
    peak = dict.fromkeys(forms, 0.0)
    reset_launches()
    for kind in SHARDED_BLOCKS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run(kind, N_SHARDED_BLOCK)
        torch.cuda.synchronize()
        secs[kind].append(time.perf_counter() - t0)
        peak[kind] = max(peak[kind], torch.cuda.max_memory_allocated() / 2**20)
    rates = {k: N_SHARDED_BLOCK * len(v) / sum(v) for k, v in secs.items()}
    device = {}
    states["unsharded"] = states["eager"]   # the unsharded and the eager profile: one state
    for kind in ("unsharded", "eager", "captured"):
        ms, counts, ops = kernel_busy_ms(lambda: run(kind, N_SHARDED_PROFILED),
                                         N_SHARDED_PROFILED)
        device[kind] = dict(device_busy_ms_per_step=ms, device_busy_share=ms * rates[kind] / 1e3,
                            kernels_per_step=ops, compositor_kernels_per_step=counts)
    coll.timed = True
    coll.reset()
    run("eager", N_SHARDED_BLOCK)
    per = {k: v / N_SHARDED_BLOCK for k, v in coll.summary().items()}
    coll.timed = False
    launches = dict(cp.LAUNCHES)
    res = dict(steps_per_s=rates, block_ms_per_step={k: [1e3 * x / N_SHARDED_BLOCK for x in v]
                                                     for k, v in secs.items()},
               captured_over_eager=rates["captured"] / rates["eager"],
               eager_over_unsharded=rates["eager"] / rates["unsharded"],
               peak_mem_mib=peak, device=device, captures=step.captures,
               collective_ms_per_step=per["ms"], collective_bytes_per_step=per["bytes"],
               collective_calls_per_step=per["calls"])
    log("sharded/nccl_1x1/numbers", card=card["nvidia_smi"], **res,
        note="blocks alternate; collectives timed synchronised in a separate eager block")
    if any(v != 1 for v in device["captured"]["compositor_kernels_per_step"].values()):
        raise AssertionError(f"rows 1 and 2 not once a replayed step: {device}")
    return launches


def sharded_nccl_1x1(card, model, cam, tile_cfg, setup) -> dict:
    """Phase 18 (a): an NCCL world of one rank in this process. (a1) the
    eager sharded step against `make_train_step` from the same state for
    N_SHARDED_STEPS steps (every leaf of the state and the loss within
    SHARDED_REL of its largest value), rows 1 and 2 once a sharded step;
    (a2)-(a3) the captured step (`sharded_captured_1x1`); (a4)-(a6) the
    rates (`sharded_rates_1x1`). Returns rows 1 and 2's launches."""
    import tempfile

    import torch.distributed as dist

    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.parallel import distributed as pdist
    from gaussianavatars_torch.parallel.mesh import make_rank_mesh
    from gaussianavatars_torch.parallel.sharded import (
        camera_batch, make_sharded_train_step, pad_gt_for_mesh, padded_height, state_digest,
    )
    from gaussianavatars_torch.training.checkpoint import flatten_state
    from gaussianavatars_torch.training.trainer import make_train_step

    cfg, gt, bg, state0 = setup
    store = tempfile.mkdtemp(prefix="gsav_nccl_")
    backend = pdist.default_backend(SHARDED_DEVICE)
    dist.init_process_group(backend, init_method=f"file://{store}/rendezvous", world_size=1,
                            rank=0, **({"device_id": torch.device("cuda", 0)}
                                       if backend == "nccl" else {}))
    try:
        mesh = make_rank_mesh(1, 1)
        coll = pdist.Collectives(backend)
        single = make_train_step(model, cfg, tile_cfg)
        step = make_sharded_train_step(model, cfg, tile_cfg, mesh, cam, collectives=coll)
        hp = padded_height(cam.height, tile_cfg.tile_h, 1)
        rows = [pdist.make_local_batch(
            mesh, camera_batch([dataclasses.replace(cam, timestep=ts)]),
            pad_gt_for_mesh(gt[None], hp)) for ts in range(TRAIN_TIMESTEPS)]
        a = b = state0
        worst, loss_rel, launches = (0.0, ""), 0.0, []
        for i in range(N_SHARDED_STEPS):
            ts = i % TRAIN_TIMESTEPS
            out = single(a, gt, cam, ts, bg, 3)
            a = out.state
            reset_launches()
            b, m = step.eager(b, *rows[ts], bg, 3)
            torch.cuda.synchronize()
            launches.append({k: v for k, v in cp.LAUNCHES.items() if v})
            loss_rel = max(loss_rel, abs(float(m["loss"]) - float(out.metrics["loss"]))
                           / abs(float(out.metrics["loss"])))
            worst = max(worst, max_rel(flatten_state(b), flatten_state(a)))
        res = dict(steps=N_SHARDED_STEPS, loss_max_rel=loss_rel, state_max_rel=worst[0],
                   state_worst_leaf=worst[1], exact=worst[0] == 0.0 and loss_rel == 0.0,
                   launches_per_step=launches, digest=state_digest(b),
                   host_staged=coll.host_staged(gt.device), padded_height=hp, form=step.form)
        log("sharded/nccl_1x1", backend=backend, **res)
        if not (loss_rel <= SHARDED_REL and worst[0] <= SHARDED_REL):
            raise AssertionError(f"the 1x1 sharded step left the single-device step: {res}")
        if any(x.get("composite_pairs_fwd") != 1 or x.get("composite_pairs_bwd") != 1
               for x in launches):
            raise AssertionError(f"rows 1 and 2 not once a sharded step: {launches}")
        total = {"composite_pairs_fwd": N_SHARDED_STEPS, "composite_pairs_bwd": N_SHARDED_STEPS}
        cap = sharded_captured_1x1(card, step, rows, bg, model, cfg, state0)
        states = dict(cap["states"], unsharded=a)
        rate_launches = sharded_rates_1x1(card, single, step, rows, gt, cam, bg, states)
        for run in (cap["launches"], rate_launches):
            for k in total:
                total[k] += run[k]
        step.drop()
        return total
    finally:
        dist.destroy_process_group()


def nudged_camera(cam, yaw: float, timestep: int):
    """`cam` turned by `yaw` radians about its own vertical axis, at
    `timestep`: another view of the scene from the same centre, the image
    shifted by about focal·yaw pixels."""
    c, s = math.cos(yaw), math.sin(yaw)
    turn = torch.eye(4, dtype=cam.world_view.dtype, device=cam.world_view.device)
    turn[0, 0], turn[0, 2], turn[2, 0], turn[2, 2] = c, s, -s, c
    w2v = turn @ cam.world_view
    return dataclasses.replace(cam, world_view=w2v, full_proj=cam.proj @ w2v, timestep=timestep)


def to_cpu_case(model, cfg, tile_cfg, state, cams, gt, bg, steps: int) -> dict:
    """A `tools/sharded_steps` case of the card's objects, on the CPU (the
    ranks move it to their device)."""
    from gaussianavatars_torch.training.optim import tree_map

    gen = state.generator
    cpu_state = dataclasses.replace(tree_map(lambda x: x.cpu(), dataclasses.replace(
        state, generator=None)), generator=gen)
    cpu_cams = [dataclasses.replace(c, **{f.name: getattr(c, f.name).cpu()
                                          for f in dataclasses.fields(c)
                                          if isinstance(getattr(c, f.name), torch.Tensor)})
                for c in cams]
    return dict(model=copy.deepcopy(model).to("cpu"), cfg=cfg, tile=tile_cfg, state=cpu_state,
                cameras=cpu_cams, gt=gt.cpu(), bg=bg.cpu(), sh_degree=3, steps=steps)


def sharded_ranks(card, model, cam, tile_cfg, setup, backend: str) -> dict:
    """Phase 18 (b): four ranks through the launcher over `backend` (gloo:
    time-sharing one card; NCCL: a card each, the step captured), running
    1x4, 1x4 with `gauss_shard` and 2x2 (`tools/sharded_steps`), each
    against the single-device step on the card from the same state: the
    CPU tests' bounds (loss rtol 1e-4; Adam's first moments within 1e-4 of
    each leaf's largest; grad_accum atol 1e-4; denom exact), and every
    rank's state digest equal after every step. The 2x2 rows are two
    views with their own ground truth (the camera at timestep 0 on the
    target, and the camera turned by SHARDED_YAW at timestep 1 on the
    target mirrored): its loss and first moments are the means of the two
    single-device steps', its grad_accum and denom increments their sums.
    Over NCCL the ranks run N_SHARDED_NCCL_STEPS steps, the last three
    replays of one capture, and the same steps eagerly: whether the
    captured digests equal the eager ones is printed (NCCL may sum in
    another order inside a graph)."""
    from gaussianavatars_torch.parallel.sharded import CAPTURED, EAGER_GLOO
    from gaussianavatars_torch.tools import sharded_steps
    from gaussianavatars_torch.training.trainer import make_train_step

    cfg, gt, bg, state0 = setup
    cams = [dataclasses.replace(cam, timestep=0), nudged_camera(cam, SHARDED_YAW, timestep=1)]
    gts = [gt, gt.flip(1)]
    single = make_train_step(model, cfg, tile_cfg)
    singles = [single(state0, g, c, c.timestep, bg, 3) for g, c in zip(gts, cams)]
    nccl = backend == "nccl"
    case = to_cpu_case(model, cfg, tile_cfg, state0, cams, torch.stack(gts), bg,
                       N_SHARDED_NCCL_STEPS if nccl else N_SHARDED_STEPS)
    t0 = time.perf_counter()
    # A captured step's collectives cannot be timed (it would synchronise
    # inside the capture): NCCL's are timed by (e)'s eager steps.
    runs = sharded_steps.run_cases([case], list(SHARDED_RUNS), device=SHARDED_DEVICE,
                                   backend=backend, timeout_s=SHARDED_TIMEOUT_S, timed=not nccl)
    wall = time.perf_counter() - t0
    launches = {"composite_pairs_fwd": 0, "composite_pairs_bwd": 0}
    out = {}
    for name, ranks in zip(SHARDED_RUNS, runs):
        res = [r["results"][0] for r in ranks]
        n_data = int(name[0])
        ref = singles[:n_data]
        st = res[0]["state_first"]
        m = res[0]["metrics"][0]
        aux0 = state0.aux

        def inc(key):
            return sum((getattr(o.state.aux, key) - getattr(aux0, key)).cpu().numpy()
                       for o in ref)

        checks = {
            "digests_equal": all(r["digests"] == res[0]["digests"] for r in res),
            "loss_rel": abs(m["loss"] - np.mean([float(o.metrics["loss"]) for o in ref]))
            / abs(np.mean([float(o.metrics["loss"]) for o in ref])),
            "grad_accum_abs": float(np.abs(st["aux/grad_accum"] - aux0.grad_accum.cpu().numpy()
                                           - inc("grad_accum")).max()),
            "denom_equal": bool(np.array_equal(st["aux/denom"] - aux0.denom.cpu().numpy(),
                                               inc("denom"))),
        }
        mu = {k: torch.from_numpy(st[f"adam/mu/{k}"]) for k in UPDATE_KEYS}
        want = {k: sum(getattr(o.state.adam.mu, k).cpu() for o in ref) / n_data
                for k in UPDATE_KEYS}
        checks["mu_max_rel"] = max_rel(mu, want)[0]
        checks["forms"] = sorted({r["form"] for r in res})
        checks["captures"] = [r["captures"] for r in res]
        if nccl:
            checks["captured_digests_equal_eager"] = [r["digests"] == r["eager_digests"]
                                                      for r in res]
        per_rank = [{
            "rank": r["rank"], "d": r["d"], "t": r["t"],
            "launches": r["results"][0]["launches"], "ms": r["results"][0]["ms"],
            "collectives": {k: {"calls": v["calls"], "bytes": v["bytes"], "ms": v["ms"]}
                            for k, v in r["results"][0]["collectives"][-1].items()},
        } for r in ranks]
        for r in res:
            for step_launches in r["launches"]:
                for k in launches:
                    launches[k] += step_launches.get(k, 0)
        out[name] = dict(checks=checks, per_rank=per_rank)
        log(f"sharded/{backend}_{name.replace(':', '_')}", card=card["nvidia_smi"], **checks,
            host_staged=res[0]["host_staged"], per_rank=per_rank)
        ok = (checks["digests_equal"] and checks["loss_rel"] <= 1e-4
              and checks["grad_accum_abs"] <= 1e-4 and checks["denom_equal"]
              and checks["mu_max_rel"] <= 1e-4
              and checks["forms"] == [CAPTURED if nccl else EAGER_GLOO]
              and checks["captures"] == [int(nccl)] * len(res)
              and all(x.get("composite_pairs_fwd") == 1 and x.get("composite_pairs_bwd") == 1
                      for r in res for x in r["launches"]))
        if not ok:
            raise AssertionError(f"sharded run {name} failed its checks: {checks}, "
                                 f"{[r['launches'] for r in res]}")
    log("sharded/ranks", backend=backend, seconds=wall, runs=list(SHARDED_RUNS),
        launches=launches)
    return dict(out, launches=launches)


def sharded_cli(card, backend: str) -> dict:
    """Phase 18 (c): `tools.train --mesh 2x2 --dist_backend <backend>` (four
    ranks) on phase 12's dataset, FLAME-bound, with a densify event,
    an eval and a save: only rank 0 printed and wrote, the step's form as
    the rule picks it (captured over NCCL), the ranks ended on one state
    digest (the loop checks it at every log and raises on a difference)."""
    from gaussianavatars_torch.parallel.sharded import step_form
    from gaussianavatars_torch.tools import train as ttrain

    model_dir = os.path.join(SHARDED_DIR, "cli")
    shutil.rmtree(model_dir, ignore_errors=True)
    res, _ = ttrain.main(["-s", LOOP_WORKDIR, "-m", model_dir, *SHARDED_CLI_FLAGS,
                          "--dist_backend", backend, "--launch_timeout", str(SHARDED_TIMEOUT_S),
                          "--device", SHARDED_DEVICE])
    out = res.stdout[0]
    line = [ln for ln in out.splitlines() if ln.startswith("[mesh 2x2] 4 ranks hold state")]
    files = sorted(os.listdir(model_dir))
    form_line = f"[mesh 2x2] sharded step: {step_form(SHARDED_DEVICE, backend, True)}"
    checks = dict(
        others_silent=all(s == "" for s in res.stdout[1:]),
        digest_line=line[-1] if line else None, form_line=form_line in out,
        densified="[densify 40]" in out, evaluated="[eval val]" in out,
        saved=os.path.exists(os.path.join(model_dir, "point_cloud",
                                          f"iteration_{SHARDED_CLI_ITERS}", "point_cloud.ply")),
        checkpoint=os.path.exists(os.path.join(model_dir, f"chkpnt{SHARDED_CLI_ITERS}.npz")),
        files=files, seconds=res.seconds,
        end_to_end_steps_per_s=SHARDED_CLI_ITERS / res.seconds)
    log("sharded/cli", card=card["nvidia_smi"], backend=backend, **checks,
        note="steps/s in the digest line: between the first and last log, events included; "
             "end_to_end: the launch's wall clock, rank start and set-up included")
    if not (checks["others_silent"] and line and checks["densified"] and checks["evaluated"]
            and checks["saved"] and checks["checkpoint"] and checks["form_line"]):
        raise AssertionError(f"the 2x2 CLI run failed its checks: {checks}\n{out[-3000:]}")
    return checks


def phase_sharded(card, model, cam, tile_cfg, setup) -> dict:
    """Phase 18. Returns rows 1 and 2's launches on its paths (this
    process's 1x1 runs and the ranks of (b))."""
    from gaussianavatars_torch.tools import multiproc_check, scaling_bench

    os.makedirs(SHARDED_DIR, exist_ok=True)
    t0 = time.perf_counter()
    seconds = {}

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t
        return out

    backend = ranks_backend()
    a = part("nccl_1x1", lambda: sharded_nccl_1x1(card, model, cam, tile_cfg, setup))
    b = part("ranks", lambda: sharded_ranks(card, model, cam, tile_cfg, setup, backend))
    part("cli", lambda: sharded_cli(card, backend))
    if part("multiproc_check", lambda: multiproc_check.main(
            ["--device", SHARDED_DEVICE, "--dist_backend", backend])) != 0:
        raise AssertionError("multiproc_check failed")
    scaling = {}
    dev = ["--device", SHARDED_DEVICE, *SHARDED_SCALING_SIZE]
    meshes, iters = SHARDED_SCALING_MESHES[backend]
    scaling.update(part("scaling_unsharded", lambda: scaling_bench.main(
        ["--unsharded", "--iters", "50", *dev])))
    scaling.update(part("scaling_1x1", lambda: scaling_bench.main(["--meshes", "1x1", *dev])))
    scaling.update(part("scaling_ranks", lambda: scaling_bench.main(
        ["--meshes", meshes, "--dist_backend", backend, "--iters", iters, *dev])))
    chunked = scaling["unsharded"]["steps_per_s"]
    cameras = {m: dict(form=r["form"], cameras_per_s=r["cameras_per_s"],
                       eager_cameras_per_s=r["eager_cameras_per_s"],
                       over_eager=r["cameras_per_s"] / r["eager_cameras_per_s"],
                       over_chunked_single_card=r["cameras_per_s"] / chunked,
                       time_shared=r["time_shared"])
               for m, r in scaling.items() if m != "unsharded"}
    log("sharded/scaling", card=card["nvidia_smi"], cards=torch.cuda.device_count(),
        backend=backend, results=scaling, cameras=cameras,
        chunked_single_card_steps_per_s=chunked,
        note="meshes of more ranks than cards time-share the card: their speed-ups are not "
             "scaling; the single card's yardstick is the chunked step (one camera a step)")
    log("sharded/seconds", seconds=time.perf_counter() - t0, parts=seconds)
    return {k: a[k] + b["launches"][k] for k in ("composite_pairs_fwd", "composite_pairs_bwd")}


# --- 19. chunks of training steps as CUDA graphs ------------------------------

N_CHUNK = 50              # steps a chunk: the JAX scripts' default --steps_per_call
CHUNK_REL = 1e-5          # (a): every leaf and metric against its largest magnitude
N_CHUNK_PROFILED = 4      # (b): replays under the profiler
N_CHUNK_BUSY = 10         # (d): steps of each profiled block (device-busy share)
CHUNK_FIT_REL = 1e-2      # (e): tests/test_torch_train.py's 3-step trajectory bound
CHUNK_FIT_LOSS_RTOL = 1e-4
CHUNK_FIT_DIR = os.path.join("build", "chip_smoke", "chunk_fit")
# Phase 12's recipe cut to 100 iterations, its events moved inside: evals
# and checkpoints at 50 and 100, an opacity reset at 75.
CHUNK_FIT_FLAGS = (*LOOP_FLAGS[:LOOP_FLAGS.index("--iterations")], "--iterations", "100",
                   "--log_every", "25", "--eval_every", "50", "--checkpoint_every", "50",
                   "--opacity_reset_interval", "75")


def chunk_views(cam, k: int) -> tuple:
    """k steps of the chunk phase: (views into the one-view cache, the
    cameras, their `stack_cameras` stack, timesteps). The benchmark camera
    and the camera turned SHARDED_YAW take turns, as do timesteps 0 and 1."""
    from gaussianavatars_torch.training.trainer import stack_cameras

    turned = nudged_camera(cam, SHARDED_YAW, 0)
    cams = [cam if i % 2 == 0 else turned for i in range(k)]
    return [0] * k, cams, stack_cameras(cams), [i % TRAIN_TIMESTEPS for i in range(k)]


def step_syncs(model, cfg, tile_cfg, setup, cam) -> dict:
    """The synchronising calls of one eager step (the chunk's graph can
    hold none), by site, with an int and with a tensor timestep."""
    from gaussianavatars_torch.training.trainer import make_train_step

    _cfg, gt, bg, state0 = setup
    step = make_train_step(model, cfg, tile_cfg)
    step(state0, gt, cam, 1, bg, 3)
    ts = torch.ones((), dtype=torch.int64, device=gt.device)
    res = {"int_timestep": sync_sites(lambda: step(state0, gt, cam, 1, bg, 3)),
           "tensor_timestep": sync_sites(lambda: step(state0, gt, cam, ts, bg, 3))}
    log("chunks/step_syncs", **res)
    return res


def kernel_busy_ms(fn, steps: int) -> tuple:
    """(device ms of every kernel `fn()` launches, per step; ms of the two
    compositor kernels per step by name) from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda and not e.is_user_annotation]
    counts = {n: sum(n in e.name for e in kernels) / steps for n in COMPOSITOR_KERNELS[:2]}
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    return busy, counts, len(kernels) / steps


def chunk_vs_steps(card, model, cfg, tile_cfg, state0, cache, cam, bg, label: str) -> dict:
    """(a): N_CHUNK `make_train_step` calls against one `make_train_chunk`
    call from the same state on the same views."""
    from gaussianavatars_torch.data.pipeline import gt_to_float
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.training.checkpoint import flatten_state
    from gaussianavatars_torch.training.trainer import make_train_chunk, make_train_step

    views, cams, stacked, ts = chunk_views(cam, N_CHUNK)
    step = make_train_step(model, cfg, tile_cfg)
    gt = gt_to_float(cache[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    st, rows = state0, []
    t0 = time.perf_counter()
    for i in range(N_CHUNK):
        out = step(st, gt, cams[i], ts[i], bg, 3)
        st = out.state
        rows.append(out.metrics)
    torch.cuda.synchronize()
    binding_launches(N_CHUNK, f"chunks/vs_steps/{label}/eager")
    eager = dict(launches=dict(cp.LAUNCHES), peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    eager["s"] = time.perf_counter() - t0
    chunk = make_train_chunk(model, cfg, tile_cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    st_c, m_c = chunk(state0, cache, views, stacked, ts, bg, 3)
    torch.cuda.synchronize()
    binding = binding_launches(N_CHUNK, f"chunks/vs_steps/{label}/chunk")
    chunked = dict(launches=dict(cp.LAUNCHES), peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                   s=time.perf_counter() - t0)
    m_e = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    leaf_rel, leaf = max_rel(flatten_state(st_c), flatten_state(st))
    metric_rel, metric = max_rel(m_c, m_e)
    diff = max_abs(flatten_state(st_c), flatten_state(st))
    res = dict(steps=N_CHUNK, captures=chunk.captures, largest_leaf_rel=leaf_rel,
               at_leaf=leaf, largest_metric_rel=metric_rel, at_metric=metric,
               largest_abs_diff=diff, eager_launches={k: v for k, v in eager["launches"].items()
                                                      if v},
               chunk_launches={k: v for k, v in chunked["launches"].items() if v},
               peak_mem_mib={"eager": eager["peak_mib"], "chunk": chunked["peak_mib"]},
               seconds={"eager": eager["s"], "chunk_with_capture": chunked["s"]},
               loss_first_last=[float(m_c["loss"][0]), float(m_c["loss"][-1])])
    log(f"chunks/vs_steps/{label}", **res, card=card["nvidia_smi"])
    want = {"composite_pairs_fwd": N_CHUNK,
            "composite_pairs_bwd" + ("_amp" if cfg.opt.use_amp else ""): N_CHUNK}
    if not (leaf_rel <= CHUNK_REL and metric_rel <= CHUNK_REL and chunk.captures == 1
            and res["eager_launches"] == want and res["chunk_launches"] == want
            and set(m_c) == set(m_e) and m_c["loss"].shape == (N_CHUNK,)):
        raise AssertionError(f"chunks/vs_steps/{label}: {res}")
    return dict(chunk=chunk, state=st_c,
                launches=dict(chunked["launches"], binding_segment_sum=binding))


def chunk_blocks(card, step, chunk, state, cache, cam, bg, label: str) -> dict:
    """(d): steps/s of eager steps and of chunks in alternating blocks of
    N_CHUNK steps (eager, chunk, chunk, eager), each kind continuing its
    own state; each kind's peak memory and device-busy share."""
    from gaussianavatars_torch.data.pipeline import gt_to_float
    from gaussianavatars_torch.training.checkpoint import _rebuild, flatten_state

    views, cams, stacked, ts = chunk_views(cam, N_CHUNK)
    gt = gt_to_float(cache[0])
    # The chunk continues `state` (which may be its graph's own buffers),
    # the eager steps a copy.
    states = {"chunk": state, "eager": _rebuild(state, "", {
        k: v.clone() for k, v in flatten_state(state).items()})}
    secs = {"eager": [], "chunk": []}
    peak = {"eager": 0.0, "chunk": 0.0}

    def eager_block(st, n):
        for i in range(n):
            st = step(st, gt, cams[i], ts[i], bg, 3).state
        return st

    # Warm-up: one eager step, and one chunk (which captures, if its graph
    # is not yet captured).
    states["eager"] = eager_block(states["eager"], 1)
    states["chunk"], _m = chunk(states["chunk"], cache, views, stacked, ts, bg, 3)
    for kind in ("eager", "chunk", "chunk", "eager"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if kind == "eager":
            states[kind] = eager_block(states[kind], N_CHUNK)
        else:
            states[kind], _m = chunk(states[kind], cache, views, stacked, ts, bg, 3)
        torch.cuda.synchronize()
        secs[kind].append(time.perf_counter() - t0)
        peak[kind] = max(peak[kind], torch.cuda.max_memory_allocated() / 2**20)
    rate = {k: N_CHUNK * len(v) / sum(v) for k, v in secs.items()}
    n = N_CHUNK_BUSY
    busy = {}
    for kind in ("eager", "chunk"):
        st = states[kind]
        fn = ((lambda: eager_block(st, n)) if kind == "eager" else
              (lambda: chunk(st, cache, views[:n], stacked, ts[:n], bg, 3)))
        ms, counts, ops = kernel_busy_ms(fn, n)
        busy[kind] = dict(device_busy_ms_per_step=ms, device_busy_share=ms * rate[kind] / 1e3,
                          kernels_per_step=ops, compositor_kernels_per_step=counts)
    res = dict(steps_per_s=rate, block_ms_per_step={k: [1e3 * x / N_CHUNK for x in v]
                                                    for k, v in secs.items()},
               speedup=rate["chunk"] / rate["eager"], peak_mem_mib=peak,
               peak_mem_chunk_minus_eager_mib=peak["chunk"] - peak["eager"], device=busy,
               captures=chunk.captures)
    log(f"chunks/steps_per_s/{label}", **res, card=card["nvidia_smi"],
        resolution=f"{cam.width}x{cam.height}")
    if not all(all_finite(s.params) for s in states.values()):
        raise AssertionError(f"chunks/steps_per_s/{label}: non-finite state")
    return res


def chunk_fit(card) -> dict:
    """(e): `tools/train_synthetic` on phase 12's recipe cut to
    CHUNK_FIT_FLAGS (phase 12's dataset), with `--steps_per_call 50` and
    `1`: the same events at the same iterations, the logged losses at rtol
    1e-4, `alive` and `binding` equal, and every parameter leaf within 1e-2
    of its largest move over the run; steps/s of both. Returns rows 1 and
    2's and the binding segment sum's launches of both runs."""
    from gaussianavatars_torch.tools import train_synthetic as ts
    from gaussianavatars_torch.training.checkpoint import flatten_state

    copy_dataset(LOOP_WORKDIR, CHUNK_FIT_DIR)
    init, train, runs = {}, ts.train, {}

    def first_state(harness, **kw):
        init.update({k: v.detach().cpu().clone() for k, v in flatten_state(harness.state).items()})
        return train(harness, **kw)

    reset_launches()
    ts.train = first_state
    try:
        for spc in (50, 1):
            args = ts.parse_args([*CHUNK_FIT_FLAGS, "--workdir", CHUNK_FIT_DIR,
                                  "--steps_per_call", str(spc)])
            harness, result = ts.run(args)
            runs[spc] = dict(
                leaves={k: v.detach().cpu() for k, v in flatten_state(harness.state).items()},
                events=[(e["kind"], e["iteration"]) for e in harness.events],
                loss=[r["loss"] for r in result["logs"]],
                steps_per_s=args.iterations / result["train_s"],
                between_events=rate_between_events(result["logs"], harness.events),
                captures=harness.chunk_captures)
    finally:
        ts.train = train
    launches = launch_counts()
    chunked, single = runs[50]["leaves"], runs[1]["leaves"]
    worst = {}
    for k, v in single.items():
        if k.startswith("params/") and v.is_floating_point():
            move = float((v.double() - init[k].double()).abs().max())
            err = float((chunked[k].double() - v.double()).abs().max())
            worst[k] = err / move if move else err
    exact = {k: torch.equal(chunked[k], single[k]) for k in ("aux/alive", "aux/binding")}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs[50]["loss"], runs[1]["loss"]))
    rates = {f"steps_per_call_{k}": r["steps_per_s"] for k, r in runs.items()}
    res = dict(iterations=args.iterations, events_equal=runs[50]["events"] == runs[1]["events"],
               events=runs[1]["events"], loss_rel_max=loss_rel,
               leaf_diff_over_largest_move=worst, equal=exact,
               leaves_bit_equal=all(torch.equal(chunked[k], single[k]) for k in single),
               captures=runs[50]["captures"], steps_per_s_whole_run=rates,
               steps_per_s_between_events={f"steps_per_call_{k}": r["between_events"]
                                           for k, r in runs.items()},
               speedup=rates["steps_per_call_50"] / rates["steps_per_call_1"],
               launches={k: v for k, v in launches.items() if v})
    log("chunks/fit", **res, card=card["nvidia_smi"])
    if not (res["events_equal"] and loss_rel <= CHUNK_FIT_LOSS_RTOL and all(exact.values())
            and max(worst.values()) <= CHUNK_FIT_REL):
        raise AssertionError(f"chunks/fit: {res}")
    return dict(res, launches=launches)


def phase_chunks(card, model, params, aux, cam, tile_cfg, setup) -> dict:
    """Phase 19. Returns rows 1 and 2's and the binding segment sum's launches on its
    paths."""
    from gaussianavatars_torch.config import Config
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.training.trainer import (
        init_train_state, make_train_chunk, make_train_step,
    )

    t0 = time.perf_counter()
    cfg, gt, bg, state0 = setup
    step_syncs(model, cfg, tile_cfg, setup, cam)
    cache = (torch.clamp(gt, 0.0, 1.0)[None] * 255).to(torch.uint8)
    launches = dict.fromkeys(launch_counts(), 0)

    def add(run):
        for k, v in run.items():
            launches[k] += v

    cfg_amp = Config(model=cfg.model, pipeline=cfg.pipeline,
                     opt=dataclasses.replace(cfg.opt, use_amp=True))
    a32 = chunk_vs_steps(card, model, cfg, tile_cfg, state0, cache, cam, bg, "float32")
    add(a32["launches"])
    a16 = chunk_vs_steps(card, model, cfg_amp, tile_cfg, state0, cache, cam, bg, "amp")
    add(a16["launches"])

    # (b) one chunk of N_CHUNK_PROFILED replays under the profiler.
    chunk, st = a32["chunk"], a32["state"]
    views, _cams, stacked, ts = chunk_views(cam, N_CHUNK_PROFILED)
    reset_launches()
    out = {}
    _busy, counts, ops = kernel_busy_ms(
        lambda: out.update(r=chunk(st, cache, views, stacked, ts, bg, 3)), N_CHUNK_PROFILED)
    binding_launches(N_CHUNK_PROFILED, "chunks/trace")
    add(launch_counts())
    st = out["r"][0]
    traced = dict(replays=N_CHUNK_PROFILED, compositor_kernels_per_step=counts,
                  kernels_per_step=ops, captures=chunk.captures,
                  launches={k: v for k, v in cp.LAUNCHES.items() if v})
    log("chunks/trace", **traced)
    if not (chunk.captures == 1 and all(v == 1 for v in counts.values())):
        raise AssertionError(f"chunks/trace: rows 1 and 2 not once a replayed step: {traced}")

    # (c) no host synchronisation while a chunk replays; one to read it.
    reset_launches()
    syncs = sync_count(lambda: out.update(r=chunk(st, cache, views, stacked, ts, bg, 3)))
    binding_launches(N_CHUNK_PROFILED, "chunks/syncs")
    add(launch_counts())
    st, m = out["r"]
    read = sync_count(lambda: float(m["loss"][-1]))
    log("chunks/syncs", syncs_in_chunk=syncs, syncs_to_read=read, steps=N_CHUNK_PROFILED)
    if syncs != 0:
        raise AssertionError(f"chunks/syncs: {syncs} synchronising calls in a chunk")

    # (d) steps/s: float32, amp and the step-level innovations.
    o = dataclasses.replace(cfg.opt, use_region_adaptive_loss=True,
                            use_color_calibration=True, use_contrastive_reg=True)
    cfg_inn = Config(model=cfg.model, pipeline=cfg.pipeline, opt=o)
    state_inn = init_train_state(
        params, aux, cfg_inn, num_timesteps=TRAIN_TIMESTEPS,
        n_expr=state0.flame.expr.shape[1], n_shape=state0.flame_static.shape.shape[0],
        num_verts=model.num_verts, generator=torch.Generator().manual_seed(13),
        image_hw=(cam.height, cam.width))
    rates = {}
    for label, c, st0, ch in (("float32", cfg, st, chunk),
                              ("amp", cfg_amp, a16["state"], a16["chunk"]),
                              ("innovations", cfg_inn, state_inn,
                               make_train_chunk(model, cfg_inn, tile_cfg))):
        reset_launches()
        rates[label] = chunk_blocks(card, make_train_step(model, c, tile_cfg), ch, st0,
                                    cache, cam, bg, label)
        ch.drop()
        add(launch_counts())

    # (e) the fit, chunked against single steps.
    fit = chunk_fit(card)
    add(fit["launches"])
    log("chunks/numbers", card=card["nvidia_smi"],
        steps_per_s={k: v["steps_per_s"] for k, v in rates.items()},
        speedup={k: v["speedup"] for k, v in rates.items()},
        fit_steps_per_s=fit["steps_per_s_whole_run"], seconds=time.perf_counter() - t0)
    return launches


N_FRAME_GRAPH = 300       # (a): frames of the captured-against-eager check, the jaw moving
N_FRAME_SYNC = 50         # (a): replays under the sync check
N_FRAME_BLOCK = 150       # (b): frames a block of the captured/eager alternation
N_FRAME_BUSY = 20         # (b): frames of each profiled block (device-busy share)
N_FPS_CHAIN = 200         # (c): frames a round of both FPS tools' chains
N_FPS_CHAIN_ROUNDS = 2
N_TABLE_GRAPH_FRAMES = 3  # (e): timed frames of each table form
N_TABLE_CHUNK = 50        # (e): steps of the table chunk against eager table steps
N_TABLE_RATE = 3          # (e): steps of the timed table blocks
TABLE_GRAPH_REL = 1e-5    # (e): every leaf, metric and image against its largest magnitude
# (e): the `--no_pallas` fit of phase 17 cut to 30 iterations (logs, so
# chunk ends, at 15 and 30), at --steps_per_call 50 and 1.
TABLE_GRAPH_FIT_ITERS = 30
FRAMES_FIT_DIR = os.path.join("build", "chip_smoke", "frames_fit")


def frame_poses(fl, n: int) -> list:
    """Phase 4's poses: the jaw moving every frame, device tensors."""
    dev = fl.jaw.device
    return [fl._replace(jaw=torch.tensor([[0.002 * (i % 150), 0.0, 0.0]], device=dev))
            for i in range(n)]


def outputs_equal(a, b):
    """(every field of two frames equal, their largest difference), on the
    device."""
    same = torch.ones((), dtype=torch.bool, device=a[0].device)
    diff = torch.zeros((), dtype=torch.float64, device=a[0].device)
    for x, y in zip(a, b):
        same &= (x == y).all()
        diff = torch.maximum(diff, (x.double() - y.double()).abs().max())
    return same, diff


def frames_serving(card, model, params, aux, fl, cam, tile_cfg) -> dict:
    """(a) and (b): `AvatarRenderer.render` captured against its eager
    frame, then frames/s of both in alternating blocks."""
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.render import AvatarRenderer

    dev = cam.world_view.device
    renderer = AvatarRenderer(model, params, aux, cam, tile_cfg, device=dev)
    poses = frame_poses(fl, N_FRAME_GRAPH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    outs = [renderer.render(p) for p in poses]
    torch.cuda.synchronize()
    graph_launches = cp.LAUNCHES["composite_pairs_fwd"]
    peak_graph = torch.cuda.max_memory_allocated() / 2**20
    same = torch.ones((), dtype=torch.bool, device=dev)
    diff = torch.zeros((), dtype=torch.float64, device=dev)
    for p, o in zip(poses, outs):
        s, d = outputs_equal(o, renderer.render_eager(p))
        same &= s
        diff = torch.maximum(diff, d)
    moved = float((outs[0].color - outs[149].color).abs().max())
    del outs
    syncs = sync_count(lambda: [renderer.render(p) for p in poses[:N_FRAME_SYNC]])
    res = dict(frames=N_FRAME_GRAPH, captures=renderer.captures, launches=graph_launches,
               every_frame_bit_equal=bool(same), largest_abs_diff=float(diff),
               jaw_image_max_diff=moved, syncs_in_replays=syncs, replays_synced=N_FRAME_SYNC,
               peak_mem_mib_graph_run=peak_graph)
    log("frames/serving_vs_eager", **res, card=card["nvidia_smi"])
    if not (res["every_frame_bit_equal"] and renderer.captures == 1
            and graph_launches == N_FRAME_GRAPH and syncs == 0 and moved > 0):
        raise AssertionError(f"frames/serving_vs_eager: {res}")

    # (b) frames/s in blocks: captured, eager, eager, captured.
    secs = {"graph": [], "eager": []}
    peak = {"graph": 0.0, "eager": 0.0}
    calls = {"graph": renderer.render, "eager": renderer.render_eager}
    for kind in ("graph", "eager", "eager", "graph"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(N_FRAME_BLOCK):
            calls[kind](poses[i])
        torch.cuda.synchronize()
        secs[kind].append(time.perf_counter() - t0)
        peak[kind] = max(peak[kind], torch.cuda.max_memory_allocated() / 2**20)
    rate = {k: N_FRAME_BLOCK * len(v) / sum(v) for k, v in secs.items()}
    busy = {}
    for kind, fn in calls.items():
        ms, counts, ops = kernel_busy_ms(
            lambda: [fn(poses[i]) for i in range(N_FRAME_BUSY)], N_FRAME_BUSY)
        busy[kind] = dict(device_busy_ms_per_frame=ms, device_busy_share=ms * rate[kind] / 1e3,
                          kernels_per_frame=ops, compositor_kernels_per_frame=counts)
    res = dict(frames_per_s=rate, block_ms_per_frame={k: [1e3 * x / N_FRAME_BLOCK for x in v]
                                                      for k, v in secs.items()},
               speedup=rate["graph"] / rate["eager"], peak_mem_mib=peak, device=busy,
               captures=renderer.captures)
    log("frames/serving_rate", **res, card=card["nvidia_smi"],
        resolution=f"{cam.width}x{cam.height}")
    if renderer.captures != 1:
        raise AssertionError(f"frames/serving_rate: recaptured: {res}")
    return dict(res, launches=dict(cp.LAUNCHES))


def eager_chain(frame, dev, n_iter: int, n_rounds: int) -> tuple:
    """The FPS benchmarks' chain issued frame by frame from the host, timed
    as `run_chain` times its rounds: (frames/s a round, last image, s)."""
    fps = []
    for _ in range(n_rounds):
        s = torch.zeros((), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_iter):
            img, s = frame(s)
        torch.cuda.synchronize()
        fps.append(n_iter / (time.perf_counter() - t0))
    return fps, img, s


def frames_fps(card) -> dict:
    """(c): both FPS tools' chains on phase 12's model directory, captured
    (`run_chain`, what the tools run) against the eager chain: the same
    final s and last image, frames/s a round."""
    from gaussianavatars_torch.models.io import checkpoint_ply_path
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.tools import fps_benchmark_dataset as fds
    from gaussianavatars_torch.tools import fps_benchmark_demo as fdemo
    from gaussianavatars_torch.viewers.local import AvatarViewerCore

    model_dir = os.path.join(LOOP_WORKDIR, "model")
    dev = torch.device("cuda")
    cores = {"demo": (AvatarViewerCore(checkpoint_ply_path(model_dir), device=dev), None),
             "dataset": fds.load(fds.parse_args(["-m", model_dir]))}
    res, launches = {}, dict.fromkeys(cp.LAUNCHES, 0)
    for tool, (core, cam) in cores.items():
        frame = fdemo.frame_chain(core, cam)
        reset_launches()
        fps_g, img_g, s_g = fdemo.run_chain(frame, dev, N_FPS_CHAIN, N_FPS_CHAIN_ROUNDS)
        torch.cuda.synchronize()
        n_graph = cp.LAUNCHES["composite_pairs_fwd"]
        with torch.inference_mode():
            fps_e, img_e, s_e = eager_chain(frame, dev, N_FPS_CHAIN, N_FPS_CHAIN_ROUNDS)
        for k, v in cp.LAUNCHES.items():
            launches[k] += v
        res[tool] = dict(frames_per_round=N_FPS_CHAIN, fps_graph=fps_g, fps_eager=fps_e,
                         speedup=sum(fps_g) / sum(fps_e), s_graph=float(s_g), s_eager=float(s_e),
                         image_bit_equal=bool(torch.equal(img_g, img_e)),
                         image_max=float(img_g.max()), graph_launches=n_graph,
                         expected_graph_launches=N_FPS_CHAIN * N_FPS_CHAIN_ROUNDS
                         + fdemo.N_WARMUP, resolution=f"{img_g.shape[1]}x{img_g.shape[0]}")
    log("frames/fps_tools", **res, card=card["nvidia_smi"])
    for tool, r in res.items():
        if not (r["s_graph"] == r["s_eager"] and r["image_bit_equal"] and r["image_max"] > 0
                and r["graph_launches"] == r["expected_graph_launches"]):
            raise AssertionError(f"frames/fps_tools/{tool}: {r}")
    return launches


def frames_eval(card, harness) -> dict:
    """(d): `evaluate_split` over val on phase 12's fit through one
    `make_render_fn` (captured) and through its eager frame: the same
    metrics, one capture."""
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.training import loop
    from gaussianavatars_torch.training.trainer import active_sh_degree

    cfg = harness.cfg
    render_fn = loop.make_render_fn(harness.model, cfg, harness.live_tile_config)
    sh = active_sh_degree(cfg.opt.iterations, cfg.model.sh_degree)
    reset_launches()
    n0 = harness.frame_captures
    out, secs = {}, {}
    for kind, fn in (("graph", render_fn), ("eager", render_fn.eager), ("graph_again", render_fn)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[kind] = loop.evaluate_split(harness, "val", fn, sh)
        secs[kind] = time.perf_counter() - t0
    res = dict(metrics=out, seconds=secs, captures=render_fn.captures,
               harness_frame_captures=harness.frame_captures - n0,
               fit_frame_captures=n0, fit_chunk_captures=harness.chunk_captures,
               launches={k: v for k, v in cp.LAUNCHES.items() if v})
    log("frames/eval", **res, card=card["nvidia_smi"])
    if not (out["graph"] == out["eager"] == out["graph_again"] and render_fn.captures == 1
            and res["harness_frame_captures"] == 1
            and cp.LAUNCHES["composite_pairs_fwd"] == 3 * out["graph"]["n"]):
        raise AssertionError(f"frames/eval: {res}")
    return dict(cp.LAUNCHES)


def max_abs(a: dict, b: dict) -> float:
    """The largest |a - b| over the leaves."""
    return max((float((a[k].double() - y.double()).abs().max()) for k, y in b.items()
                if y.numel()), default=0.0)


def timed_calls(fn, n: int, warm: bool = True) -> dict:
    """n calls of fn (after one more when `warm`): host ms and stream ms a
    call (CUDA events), peak memory."""
    if warm:
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return dict(host_ms=1e3 * (time.perf_counter() - t0) / n, device_ms=e0.elapsed_time(e1) / n,
                peak_mem_mib=torch.cuda.max_memory_allocated() / 2**20)


def frames_table(card, model, params, aux, fl, cam, setup) -> dict:
    """(e): the table pipeline at the sized benchmark table: a captured
    frame and a chunk of N_TABLE_CHUNK against eager calls, each form's
    time and peak memory, and the `--no_pallas` fit at --steps_per_call
    50 against 1."""
    from gaussianavatars_torch.config import Config
    from gaussianavatars_torch.data.pipeline import gt_to_float
    from gaussianavatars_torch.ops import composite_pairs as cp
    from gaussianavatars_torch.ops.rasterize_tiled import fixed_walk
    from gaussianavatars_torch.render import probe_tile_config
    from gaussianavatars_torch.training import loop
    from gaussianavatars_torch.training.checkpoint import flatten_state
    from gaussianavatars_torch.training.trainer import make_train_chunk, make_train_step

    cfg0, gt, bg, state0 = setup
    tile = probe_tile_config(model, params, aux, fl, cam, table=True)
    cfg = Config(model=cfg0.model, pipeline=dataclasses.replace(cfg0.pipeline, use_pallas=False),
                 opt=cfg0.opt)
    reset_launches()
    # Frames: the planned walk (eager), the fixed walk (eager), the graph.
    render_fn = loop.make_render_fn(model, cfg, tile)
    frame = {}
    with torch.no_grad():
        planned = render_fn.eager(state0, cam, 0, bg, 3)
        frame["eager_planned"] = timed_calls(lambda: render_fn.eager(state0, cam, 0, bg, 3),
                                             N_TABLE_GRAPH_FRAMES)
        with fixed_walk():
            frame["eager_fixed"] = timed_calls(lambda: render_fn.eager(state0, cam, 0, bg, 3), 1,
                                               warm=False)
        render_fn(state0, cam, 0, bg, 3)   # the warm-up; the next call captures
        t0 = time.perf_counter()
        graphed = render_fn(state0, cam, 0, bg, 3)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        frame["graph"] = timed_calls(lambda: render_fn(state0, cam, 0, bg, 3),
                                     N_TABLE_GRAPH_FRAMES)
    img_rel, _k = max_rel({"img": graphed}, {"img": planned})
    img_abs = max_abs({"img": graphed}, {"img": planned})
    frame_res = dict(forms=frame, capture_and_first_replay_s=capture_s,
                     image_rel_to_planned=img_rel, image_largest_abs_diff=img_abs,
                     captures=render_fn.captures, capacity=tile.capacity,
                     tiles_per_gaussian=tile.max_tiles_per_gaussian,
                     frames_per_s={k: 1e3 / v["host_ms"] for k, v in frame.items()})
    log("frames/table_frame", **frame_res, card=card["nvidia_smi"])
    del render_fn

    # Steps: a chunk (3 warm-up steps, a capture, replays; the fixed walk)
    # against eager steps (the planned walk) on the same views.
    cache = (torch.clamp(gt, 0.0, 1.0)[None] * 255).to(torch.uint8)
    gt8 = gt_to_float(cache[0])
    views, cams, stacked, ts = chunk_views(cam, N_TABLE_CHUNK)
    step = make_train_step(model, cfg, tile)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, rows = state0, []
    for i in range(N_TABLE_CHUNK):
        out = step(st, gt8, cams[i], ts[i], bg, 3)
        st, rows = out.state, rows + [out.metrics]
    torch.cuda.synchronize()
    eager_s, peak_eager = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**20
    chunk = make_train_chunk(model, cfg, tile)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st_c, m_c = chunk(state0, cache, views, stacked, ts, bg, 3)
    torch.cuda.synchronize()
    chunk_s, peak_chunk = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**20
    m_e = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    leaf_rel, leaf = max_rel(flatten_state(st_c), flatten_state(st))
    leaf_abs = max_abs(flatten_state(st_c), flatten_state(st))
    metric_rel, metric = max_rel(m_c, m_e)
    metric_abs = max_abs(m_c, m_e)
    del st, rows
    # Rates, host clock and CUDA events: a chunk of replays, eager steps
    # of the planned walk, and one eager step of the fixed walk.
    vk, _c, sk, tk = chunk_views(cam, N_TABLE_RATE)
    rate = {"graph": timed_calls(lambda: chunk(st_c, cache, vk, sk, tk, bg, 3), 1, warm=False),
            "eager_planned": timed_calls(lambda: [step(state0, gt8, cams[i], ts[i], bg, 3)
                                                  for i in range(N_TABLE_RATE)], 1)}
    rate = {k: dict(v, host_ms=v["host_ms"] / N_TABLE_RATE, device_ms=v["device_ms"] / N_TABLE_RATE)
            for k, v in rate.items()}
    with fixed_walk():
        rate["eager_fixed"] = timed_calls(lambda: step(state0, gt8, cam, 0, bg, 3), 1, warm=False)
    step_res = dict(steps=N_TABLE_CHUNK, captures=chunk.captures, largest_leaf_rel=leaf_rel,
                    at_leaf=leaf, leaf_largest_abs_diff=leaf_abs, largest_metric_rel=metric_rel,
                    at_metric=metric, metric_largest_abs_diff=metric_abs,
                    seconds={"eager_steps": eager_s, "chunk_with_capture": chunk_s},
                    peak_mem_mib={"eager": peak_eager, "chunk": peak_chunk},
                    per_step=rate, steps_per_s={k: 1e3 / v["host_ms"] for k, v in rate.items()},
                    launches={k: v for k, v in cp.LAUNCHES.items() if v})
    log("frames/table_chunk", **step_res, card=card["nvidia_smi"])
    chunk.drop()
    if not (img_rel <= TABLE_GRAPH_REL and leaf_rel <= TABLE_GRAPH_REL
            and metric_rel <= TABLE_GRAPH_REL and chunk.captures == 1
            and frame_res["captures"] == 1 and not any(cp.LAUNCHES.values())):
        raise AssertionError(f"frames/table: {frame_res} {step_res}")
    return dict(frame=frame_res, step=step_res, fit=frames_table_fit(card))


def frames_table_fit(card) -> dict:
    """(e): `train_synthetic --no_pallas` (phase 17's recipe, 30
    iterations) at --steps_per_call 50 and 1: the same events, the capacity
    doubled once, the logged losses within rtol 1e-4; steps/s of both."""
    from gaussianavatars_torch.tools import train_synthetic as ts

    shutil.rmtree(FRAMES_FIT_DIR, ignore_errors=True)
    h0, _r0 = ts.run(ts.parse_args([*TABLE_FIT_FLAGS, "--iterations", "0",
                                    "--workdir", FRAMES_FIT_DIR]))
    fullest, tiles = fullest_train_tile(h0)
    del h0
    runs = {}
    for spc in (50, 1):
        reset_launches()
        args = ts.parse_args([*TABLE_FIT_FLAGS, "--iterations", str(TABLE_GRAPH_FIT_ITERS),
                              "--capacity_per_tile", str(3 * fullest // 4),
                              "--max_tiles_per_gaussian", str(tiles),
                              "--workdir", FRAMES_FIT_DIR, "--steps_per_call", str(spc)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        harness, result = ts.run(args)
        runs[spc] = dict(
            events=[(e["kind"], e["iteration"]) for e in harness.events
                    if e["kind"] not in ("gt_cache",)],
            loss=[r["loss"] for r in result["logs"]],
            capacity_final=harness.live_tile_config.capacity,
            steps_per_s=args.iterations / result["train_s"],
            captures=harness.chunk_captures, peak_mem_mib=torch.cuda.max_memory_allocated() / 2**20,
            launches={k: v for k, v in cp_launches().items() if v})
        del harness
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs[50]["loss"], runs[1]["loss"]))
    res = dict(iterations=TABLE_GRAPH_FIT_ITERS, runs=runs, loss_rel_max=loss_rel,
               events_equal=runs[50]["events"] == runs[1]["events"],
               speedup=runs[50]["steps_per_s"] / runs[1]["steps_per_s"])
    log("frames/table_fit", **res, card=card["nvidia_smi"])
    grows = [e for e in runs[50]["events"] if e[0] == "grow_table"]
    if not (res["events_equal"] and loss_rel <= CHUNK_FIT_LOSS_RTOL and len(grows) == 1
            and runs[50]["captures"] >= 1 and not runs[50]["launches"]):
        raise AssertionError(f"frames/table_fit: {res}")
    return res


def phase_frames(card, model, params, aux, fl, cam, tile_cfg, setup, harness) -> dict:
    """Phase 20. Returns row 1's launches on its paths."""
    from gaussianavatars_torch.ops import composite_pairs as cp

    launches = dict.fromkeys(cp.LAUNCHES, 0)

    def add(run):
        for k, v in run.items():
            launches[k] += v

    t0 = time.perf_counter()
    with torch.no_grad():
        add(frames_serving(card, model, params, aux, fl, cam, tile_cfg)["launches"])
        add(frames_fps(card))
        add(frames_eval(card, harness))
    torch.set_grad_enabled(True)
    table = frames_table(card, model, params, aux, fl, cam, setup)
    log("frames/seconds", seconds=time.perf_counter() - t0,
        table_fit_steps_per_s={k: v["steps_per_s"] for k, v in table["fit"]["runs"].items()})
    return launches


# Binding layouts of phase 22: (slots, faces, live Gaussians a face), every
# padding slot on face 0 as in the fixed-capacity state.
BINDING_LAYOUTS = {
    "base_train": (98_304, 10_010, 9),
    "innov_train": (114_688, 10_010, 11),
    "initial_state": (131_072, 10_010, 1),
}
BINDING_WIDTHS = (3, 4, 1)   # the frames' centre, orientation and scaling
ATOMIC_OPCODES = ("ATOM", "ATOMS", "ATOMG", "RED")


def binding_bound(cap: int, n_faces: int) -> dict:
    """The segment sum's least time: each gradient row read once, the index
    (perm, offsets) read once, each face row written once, at 3.35 TB/s."""
    cols = sum(BINDING_WIDTHS)
    nbytes = 4 * (cap * cols + cap + n_faces + 1 + n_faces * cols)
    return dict(bytes=nbytes, bound_ms=nbytes / PEAK_BYTES_S * 1e3, bound_by="bytes")


def phase_binding_gather(card, built) -> dict:
    """Phase 22 (see the module's docstring); the kernels line's entry."""
    from gaussianavatars_torch import cuda_build
    from gaussianavatars_torch.ops import binding_gather as bg

    dev = torch.device("cuda")
    rep = {k: v for k, v in cuda_build.ptxas_report(built["binding_segment_sum"]["log"]).items()
           if "binding_segment_sum_kernel" in k}
    sass = cuda_build.library_sass("binding_segment_sum")
    atomics = sum(1 for line in sass.splitlines()
                  if any(f" {op}." in line or f" {op} " in line for op in ATOMIC_OPCODES))
    log("binding_gather/ptxas", kernels=rep, atomic_instructions=atomics)
    if len(rep) != 1 or any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
                            for r in rep.values()) or atomics:
        raise AssertionError(f"binding_segment_sum: missing, spills or atomics: {rep}, "
                             f"{atomics} atomic instructions")
    out = {}
    for name, (cap, n_faces, per_face) in BINDING_LAYOUTS.items():
        idx = torch.arange(cap, device=dev)
        binding = torch.where(idx < n_faces * per_face, idx % n_faces, 0)
        g = torch.Generator().manual_seed(22)
        grads = [torch.randn((cap, w), generator=g).to(dev) for w in BINDING_WIDTHS]
        index = bg.build_face_index(binding, n_faces)
        runs = index.offsets[1:] - index.offsets[:-1]
        got = bg.segment_sum(grads, index)
        plain = bg.segment_sum_reference(grads, index)
        parent = [torch.zeros_like(a).index_put_((binding,), x, accumulate=True)
                  for a, x in zip(got, grads)]
        short = runs <= bg.SLICE
        # Every face against its sum in float64, within the kernel's own
        # rounding: S = ceil(n / SLICE) slices of at most SLICE terms, then
        # S partial sums, so at most (SLICE + S) · 2^-24 · Σ|g|.
        slices = (runs + bg.SLICE - 1) // bg.SLICE
        err, face0, within = [], [], True
        for a, x in zip(got, grads):
            exact = torch.zeros(a.shape, dtype=torch.float64, device=dev).index_add_(
                0, binding, x.double())
            abs_sum = torch.zeros_like(exact).index_add_(0, binding, x.double().abs())
            e = (a.double() - exact).abs()
            bound = (bg.SLICE + slices[:, None]) * 2.0 ** -24 * abs_sum
            within = within and bool((e <= bound).all())
            err.append(float(e.max()))
            face0.append([float(e[0].max()), float(bound[0].min())])
        res = dict(slots=cap, faces=n_faces, face0_run=int(runs[0]),
                   longest_short_run=int(runs[short].max()),
                   equal_plain=all(torch.equal(a, p) for a, p in zip(got, plain)),
                   short_runs_equal_index_put=all(torch.equal(a[short], p[short])
                                                  for a, p in zip(got, parent)),
                   face0_vs_index_put=[float((a[0] - p[0]).abs().max())
                                       for a, p in zip(got, parent)],
                   max_err_vs_float64=err, face0_err_and_bound=face0,
                   within_rounding_bound=within)
        res.update(binding_bound(cap, n_faces))

        def kernel():
            bg.segment_sum(grads, index)

        def index_and_kernel():
            bg.segment_sum(grads, bg.build_face_index(binding, n_faces))

        def parent_path():
            for a, x in zip(got, grads):
                torch.zeros_like(a).index_put_((binding,), x, accumulate=True)

        res.update(
            kernel_ms=graph_ms(kernel, N_KERNEL_REPS),
            wrapper_ms=cuda_ms(kernel, N_KERNEL_REPS),
            index_ms=graph_ms(lambda: bg.build_face_index(binding, n_faces), N_KERNEL_REPS),
            backward_ms=graph_ms(index_and_kernel, N_KERNEL_REPS),
            library_ms=graph_ms(parent_path, N_KERNEL_REPS),
            plain_ms=cuda_ms(lambda: bg.segment_sum_reference(grads, index), 3))
        res["bound_share"] = res["bound_ms"] / res["kernel_ms"]
        log(f"binding_gather/{name}", **res, card=card["nvidia_smi"],
            note="device ms a call, a CUDA graph of 50 calls (plain_ms and wrapper_ms: CUDA "
                 "events around eager calls); library_ms: index_put_ with accumulate on the "
                 "three tables, the path the kernel replaces")
        if not (res["equal_plain"] and res["short_runs_equal_index_put"] and within
                and res["bound_share"] <= cuda_build.MAX_BOUND_SHARE):
            raise AssertionError(f"binding_gather/{name}: {res}")
        out[name] = res
    base = out["base_train"]
    return dict(name="binding_segment_sum", route="cuda",
                source="gaussianavatars_torch/csrc/binding_segment_sum.cu", replaces=None,
                max_abs_err=max(max(r["max_err_vs_float64"]) for r in out.values()),
                ms=base["wrapper_ms"], plain_ms=base["plain_ms"], bound_ms=base["bound_ms"],
                bound_by="bytes", library_ms=base["library_ms"])


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[], metavar="ROOT",
                    help="another checkout (e.g. the parent commit unpacked with git archive "
                         "into an ignored directory): build its compositor and micro-reduce "
                         "kernels and time rows 1-4 and micro_reduce_a-d beside this "
                         "checkout's in phases 3, 11 and 13")
    ap.add_argument("--sharded_only", action="store_true",
                    help="phases 1, 2 and 18 alone, with phase 12's dataset written and not "
                         "fitted: the multi-card proof on a machine with four cards")
    ap.add_argument("--chunks_only", action="store_true",
                    help="phases 1, 2, 12 and 19 alone: the chunks of training steps as "
                         "CUDA graphs")
    ap.add_argument("--frames_only", action="store_true",
                    help="phases 1, 2, 12 and 20 alone: the frames as CUDA graphs and the "
                         "table pipeline's graphs")
    ap.add_argument("--flame_only", action="store_true",
                    help="phases 1, 2, 16's FLAME-bound run (on phase 12's dataset, written "
                         "and not fitted) and 21: the real-FLAME import")
    ap.add_argument("--binding_only", action="store_true",
                    help="phases 1, 2 and 22 alone: the binding gathers' segment sum")
    return ap.parse_args(argv)


def sharded_only(card) -> int:
    """`--sharded_only`: phase 18 on the benchmark scene and phase 12's
    dataset (written, not fitted), then the last line."""
    from gaussianavatars_torch.render import build_scene, probe_tile_config
    from gaussianavatars_torch.tools import train_synthetic as ts

    dev = torch.device("cuda")
    model, params, aux, fl, cam, _n = build_scene(device=dev)
    tile_cfg = probe_tile_config(model, params, aux, fl, cam)
    setup = train_setup(dev, model, params, aux, fl, cam, tile_cfg)
    shutil.rmtree(LOOP_WORKDIR, ignore_errors=True)
    a = ts.parse_args([*LOOP_FLAGS, "--workdir", LOOP_WORKDIR])
    ts.write_dataset(a, *ts.build_reference_avatar(a, "cuda"))
    log("sharded_only/launches", **phase_sharded(card, model, cam, tile_cfg, setup))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def chunks_only(card) -> int:
    """`--chunks_only`: phase 12 (the chunked fit) and phase 19 on the
    benchmark scene, then the last line."""
    from gaussianavatars_torch.render import build_scene, probe_tile_config

    dev = torch.device("cuda")
    model, params, aux, fl, cam, _n = build_scene(device=dev)
    tile_cfg = probe_tile_config(model, params, aux, fl, cam)
    setup = train_setup(dev, model, params, aux, fl, cam, tile_cfg)
    step_syncs(model, setup[0], tile_cfg, setup, cam)
    phase_loop(card)
    t0 = time.perf_counter()
    launches = phase_chunks(card, model, params, aux, cam, tile_cfg, setup)
    log("chunks/seconds", seconds=time.perf_counter() - t0,
        launches={k: v for k, v in launches.items() if v})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def frames_only(card) -> int:
    """`--frames_only`: phase 12 (the fit that (c) and (d) read) and phase
    20 on the benchmark scene, then the last line."""
    from gaussianavatars_torch.render import build_scene, probe_tile_config

    dev = torch.device("cuda")
    model, params, aux, fl, cam, _n = build_scene(device=dev)
    tile_cfg = probe_tile_config(model, params, aux, fl, cam)
    setup = train_setup(dev, model, params, aux, fl, cam, tile_cfg)
    harness = phase_loop(card)["harness"]
    launches = phase_frames(card, model, params, aux, fl, cam, tile_cfg, setup, harness)
    log("frames/launches", **{k: v for k, v in launches.items() if v})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def flame_only(card) -> int:
    """`--flame_only`: phase 12's dataset (written, not fitted), phase 16's
    FLAME-bound run on the converted FLAME files and phase 21, then the
    last line."""
    from gaussianavatars_torch.render import build_scene
    from gaussianavatars_torch.tools import train_synthetic as ts

    shutil.rmtree(LOOP_WORKDIR, ignore_errors=True)
    a = ts.parse_args([*LOOP_FLAGS, "--workdir", LOOP_WORKDIR])
    ts.write_dataset(a, *ts.build_reference_avatar(a, "cuda"))
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(CLI_DIR)
    t0 = time.perf_counter()
    launches = cli_flame(card, *flame_files(card))
    log("cli/seconds", seconds=time.perf_counter() - t0,
        launches={k: v for k, v in launches.items() if v})
    phase_flame_import(card, FLAME_NPZ, build_scene(device=torch.device("cuda")))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = parse_args(argv)
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
    built = phase_build()
    if args.sharded_only:
        return sharded_only(card)
    if args.chunks_only:
        return chunks_only(card)
    if args.frames_only:
        return frames_only(card)
    if args.flame_only:
        return flame_only(card)
    if args.binding_only:
        phase_binding_gather(card, built)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    against = build_against(args.against) if args.against else []
    torch.set_grad_enabled(False)

    # --- 3. kernels against their plain versions ---------------------------
    small, small_table = parity_table(dev)
    k_small = compare_kernel("parity_128x256", small_table)
    if not (k_small["stopped_pixel_share"] > 0 and k_small["walk_past_first_chunk"]):
        raise AssertionError("parity scene must exercise early stops and multi-chunk walks")
    kb_small = compare_bwd_kernel("parity_128x256", small_table, k_small["outputs"], seed=21)
    if not kb_small["longest_walk"] > 512:   # v3 stages 256 pairs a chunk, v2 512
        raise AssertionError("parity scene must exercise multi-chunk backward walks")
    var_small = compare_variants("parity_128x256", small_table, k_small, kb_small)
    compare_16_rows("parity_128x256", small_table, k_small["outputs"], seed=24)
    kernel_resources(built)

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
    var_full = compare_variants("full_802x550", full_table, k_full, kb_full)
    for res in (k_small, kb_small, k_full, kb_full):   # free the card copies
        res.pop("plain")
    kb_small.pop("out")
    kb_full.pop("out")
    log("scene", gaussians=n_g, capacity=params.capacity, faces=model.num_faces,
        verts=model.num_verts, tiers=[cfg.base_budget, list(cfg.tiers)],
        expansion_slots=spec.expansion_size(params.capacity),
        total_pairs=int(plan0.total), budget_overflow=int(plan0.budget_overflow),
        max_footprint=int(plan0.max_footprint))
    if int(plan0.budget_overflow) != 0:
        raise AssertionError("tier budget overflow on the probe frame")

    fwd_res = time_fwd(full_table, k_full["outputs"][2])
    log("kernels/timing_full_802x550", **fwd_res,
        note="ms: the wrapper, its three allocations included; kernel_ms: the launch alone",
        card=card["nvidia_smi"])
    bwd_args = kb_full.pop("args")
    bwd_res = time_bwd("v3", False, k_full["outputs"][2], bwd_args)
    log("kernels/bwd_timing_full_802x550", **bwd_res,
        note=f"ms: the wrapper, allocation of the {list(dataT0.shape)} output included; "
             "kernel_ms: the launch alone, which writes rows 0..8 of every column",
        card=card["nvidia_smi"])
    var_timing = time_entries(full_table, k_full["outputs"], bwd_args)
    for name, res in var_timing.items():
        log(f"kernels/timing_full_802x550/{name}", **res, card=card["nvidia_smi"])
    if against:
        time_against("full_802x550", against, full_table, k_full["outputs"], bwd_args)
        time_against("parity_128x256", against, small_table, k_small["outputs"],
                     kb_small["args"])

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
    reset_launches()
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
    path_launches = launch_counts()
    binding_launches(0, "slice")   # frames build no index and sum nothing
    launches = path_launches["composite_pairs_fwd"]
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
    setup = train_setup(dev, model, params, aux, fl, cam, cfg)
    train = phase_train(model, params, aux, cam, cfg, card, setup)

    # --- 9. the kernel A/B entry point ---------------------------------------
    _ab, ab_launches = phase_ab(card)

    # --- 10. the training step with use_amp ----------------------------------
    train_amp = phase_train_amp(model, aux, cam, cfg, card, setup)

    # --- 11. the micro-reduce kernels ----------------------------------------
    micro = phase_micro_reduce(card, built, against)

    # --- 12. the host loop ---------------------------------------------------
    loop_res = phase_loop(card)

    # --- 13. the compositors on the fitted avatar ----------------------------
    harness = loop_res.pop("harness")
    phase_fitted_bwd(card, harness, against)

    # --- 14. replay of the fitted avatar ---------------------------------------
    t0 = time.perf_counter()
    replay_launches = phase_replay(card, harness, loop_res, (renderer, poses, N_FRAMES / wall_s))
    log("replay/seconds", seconds=time.perf_counter() - t0)

    # --- 15. the training innovations -------------------------------------------
    t0 = time.perf_counter()
    torch.set_grad_enabled(True)
    innov_loop = innovations_run(card)
    innov_step = innovations_step(card, model, params, aux, cam, cfg, setup)
    log("innovations/seconds", seconds=time.perf_counter() - t0)

    # --- 16. the training CLI ------------------------------------------------------
    t0 = time.perf_counter()
    cli_launches = phase_cli(card, harness)
    log("cli/seconds", seconds=time.perf_counter() - t0)

    # --- 17. the table pipeline, stage timings, roofline, profiler, viewers ----
    table_scene = dict(model=model, params=params, aux=aux, fl=fl, cam=cam, tile=cfg,
                       poses=poses, plan_counts=plan0.counts)
    table_launches = phase_table(card, table_scene, setup, harness, N_FRAMES / wall_s,
                                 train["steps_per_s"])

    # --- 18. multi-device training over a rank mesh ---------------------------
    torch.set_grad_enabled(True)
    sharded_launches = phase_sharded(card, model, cam, cfg, setup)
    log("sharded/launches", **sharded_launches)

    # --- 19. chunks of training steps as CUDA graphs ----------------------------
    t0 = time.perf_counter()
    chunk_launches = phase_chunks(card, model, params, aux, cam, cfg, setup)
    log("chunks/seconds", seconds=time.perf_counter() - t0)

    # --- 20. frames as CUDA graphs, the table pipeline's graphs -----------------
    frame_launches = phase_frames(card, model, params, aux, fl, cam, cfg, setup, harness)
    del harness

    # --- 21. the real-FLAME import: landmarks, root centring, project_gaussians --
    phase_flame_import(card, FLAME_NPZ, (model, params, aux, fl, cam, n_g))

    # --- 22. the binding gathers' segment sum ------------------------------------
    binding_kernel = phase_binding_gather(card, built)

    # Launches per entry point over the main paths: serving, training,
    # the A/B (float32 and amp), amp training, the loop, the replay, the
    # innovations' loop and step, the CLI, phase 17's sorted paths
    # (the serving and step comparisons, the stage timings, the profiled
    # steps, the two viewer tools), phase 18's (the 1x1 step in this
    # process and the four ranks' bands), phase 19's (chunks and eager
    # steps, float32, amp and the innovations) and phase 20's (captured and
    # eager frames of serving, both FPS tools and eval). The binding segment
    # sum's are counted on the training paths of phases 6, 10, 12, 15 and
    # 19, once a step.
    for run in (train["entry_launches"], ab_launches, train_amp["entry_launches"],
                loop_res["launches"], replay_launches, innov_loop["launches"],
                innov_step["launches"], cli_launches, table_launches, sharded_launches,
                chunk_launches, frame_launches):
        for e, k in run.items():
            path_launches[e] += k
    numbers = dict(var_timing)
    numbers["composite_pairs_fwd"] = fwd_res
    numbers["composite_pairs_bwd"] = bwd_res
    errors = {name: max(var_small[name]["max_abs_err"], var_full[name]["max_abs_err"])
              for name in var_small}
    errors["composite_pairs_fwd"] = max(
        k_small["max_abs_err_acc"], k_small["max_abs_err_t_final"],
        k_full["max_abs_err_acc"], k_full["max_abs_err_t_final"])
    errors["composite_pairs_bwd"] = max(kb_small["max_abs_err"], kb_full["max_abs_err"])
    not_launched = [e for e, k in path_launches.items() if k == 0]
    if not_launched:
        raise AssertionError(f"entry points no main path launched: {not_launched}")
    kernels = [{
        "name": name, "route": "cuda", "source": src, "replaces": rep, "amp": amp,
        "launches": path_launches[name], "max_abs_err": errors[name],
        "ms": numbers[name]["ms"], "plain_ms": numbers[name]["plain_ms"],
        "bound_ms": numbers[name]["bound_ms"], "bound_by": numbers[name]["bound_by"],
        "library_ms": None,
    } for name, (_kind, _impl, amp, src, rep) in compositor_entries().items()]
    for name, r in micro.items():
        kernels.append({
            "name": name, "route": "cuda", "source": "gaussianavatars_torch/csrc/micro_reduce.cu",
            "replaces": r["replaces"], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    kernels.append(dict(binding_kernel, launches=path_launches["binding_segment_sum"]))
    log("seconds", script_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
