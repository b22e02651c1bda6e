"""Scaling harness: the sharded train step over growing rank meshes.

The port of the JAX package's `scripts/scaling_bench.py`. For each mesh
`DxT` of `--meshes` (default 1x1) it starts D·T local ranks
(`parallel/distributed.launch`; the meshes of one world size share one
launch), each building the benchmark avatar (`render.build_scene`: FLAME-
bound, SH degree 3, 802×550 by default, probed tier budgets), and times
the sharded step (`parallel/sharded.py`, `--gauss_shard` to shard the
geometry too) in the form the loop runs it (`ShardedStep.form`: captured
in a CUDA graph on the card over NCCL, else eager) and its eager form
beside it, in alternating blocks of `--iters` steps (form, eager, eager,
form) after a warm-up (a captured step's capture included), each kind
continuing its own state: steps/s and cameras/s on rank 0's host clock,
synchronised around each block; then `--coll_iters` eager steps with
every collective timed (synchronised around each): the collectives'
milliseconds and bytes a step. `--unsharded` times the single-device step
on the same scene instead, in one launched process as fresh as a rank's,
in the form the single-device loop runs it (`trainer.make_train_chunk`,
chunks of `--iters` steps) beside the eager step, in the same blocks: the
yardstick a mesh's cameras/s is read against. It takes no mesh flags.

On one card the ranks of a mesh share it: they time-share its SMs and
its memory bandwidth, so a speed-up over 1×1 there is not scaling, and
the output says so.

    python -m gaussianavatars_torch.tools.scaling_bench --unsharded
    python -m gaussianavatars_torch.tools.scaling_bench --meshes 1x1
    python -m gaussianavatars_torch.tools.scaling_bench --meshes 1x2,1x4,2x2 \\
        --dist_backend gloo [--gauss_shard] [--device cpu --width 64 --height 48]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import torch

from ..models.flame.assets import bootstrap_template_env

# The real FLAME template of a reference checkout, when there is one.
bootstrap_template_env()

MODULE = "gaussianavatars_torch.tools.scaling_bench"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--width", type=int, default=802)
    p.add_argument("--height", type=int, default=550)
    p.add_argument("--per_face", type=int, default=9,
                   help="Gaussians a face (9: the 90,090-Gaussian benchmark avatar)")
    p.add_argument("--iters", type=int, default=20, help="steps a timed block")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--coll_iters", type=int, default=3,
                   help="steps with every collective timed")
    p.add_argument("--meshes", type=str, default=None,
                   help="comma list like 1x1,1x2,2x2 (data x tile); default 1x1")
    p.add_argument("--gauss_shard", action="store_true",
                   help="also shard per-Gaussian geometry over the tile axis")
    p.add_argument("--unsharded", action="store_true",
                   help="time the single-device train step on the same scene instead, "
                        "chunked as the single-device loop runs it and eager: the "
                        "yardstick of a mesh's cameras/s")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None)
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds the ranks of one world size may run")
    p.add_argument("--worker", default="", help=argparse.SUPPRESS)
    p.add_argument("--coordinator_address", default="", help=argparse.SUPPRESS)
    p.add_argument("--num_processes", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--process_id", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def scene(a, dev, n_cams: int):
    """(model, cfg, tile config, state, cameras, gt) of the benchmark."""
    from ..config import Config, ModelConfig
    from ..render import build_scene, probe_tile_config
    from ..training.trainer import init_train_state

    model, params, aux, fl, cam, _n = build_scene(per_face=a.per_face, width=a.width,
                                                  height=a.height, device=dev)
    tile = probe_tile_config(model, params, aux, fl, cam)
    cfg = Config(model=ModelConfig(capacity=params.capacity, n_shape=100, n_expr=50))
    state = init_train_state(params, aux, cfg, num_timesteps=max(2, n_cams), n_expr=50,
                             n_shape=100, num_verts=model.num_verts)
    cams = [dataclasses.replace(cam, timestep=i % 2) for i in range(n_cams)]
    gt = torch.full((n_cams, cam.height, cam.width, 3), 0.4, device=dev)
    return model, cfg, tile, state, cams, gt


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_steps(run_step, state, n: int, dev) -> tuple:
    """(state, seconds a call) over n calls, synchronised at both ends."""
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        state = run_step(state)
    _sync(dev)
    return state, (time.perf_counter() - t0) / n


BLOCKS = ("form", "eager", "eager", "form")


def alternate(blocks: dict, state, steps: int, dev, on_block=None) -> dict:
    """Seconds a step of each kind over BLOCKS, where `blocks[kind]`
    (state) → state runs `steps` steps, each kind continuing its own chain
    of states from `state`; `on_block(kind, before)` is called with True
    before each block and False after it."""
    states = dict.fromkeys(blocks, state)
    secs: dict = {k: [] for k in blocks}
    for kind in BLOCKS:
        if on_block:
            on_block(kind, True)
        states[kind], dt = time_steps(blocks[kind], states[kind], 1, dev)
        if on_block:
            on_block(kind, False)
        secs[kind].append(dt / steps)
    return {k: sum(v) / len(v) for k, v in secs.items()}


def _repeat(run_step, n: int):
    def block(st):
        for _ in range(n):
            st = run_step(st)
        return st
    return block


def _peak_mib(dev):
    return torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None


def unsharded(a) -> dict:
    from ..parallel.distributed import rank_device
    from ..training.trainer import make_train_chunk, make_train_step, stack_cameras

    dev = rank_device(a.device)
    model, cfg, tile, state, cams, gt = scene(a, dev, 1)
    step = make_train_step(model, cfg, tile)
    chunk = make_train_chunk(model, cfg, tile)
    bg = torch.zeros(3, device=dev)
    views = timesteps = [0] * a.iters
    stacked = stack_cameras(cams * a.iters)

    def run_eager(st):
        return step(st, gt[0], cams[0], 0, bg, 3).state

    def run_chunk(st):
        return chunk(st, gt, views, stacked, timesteps, bg, 3)[0]

    state, _ = time_steps(run_eager, state, a.warmup, dev)
    run_chunk(state)   # a chunk with no graph yet captures one
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sec = alternate({"form": run_chunk, "eager": _repeat(run_eager, a.iters)}, state, a.iters,
                    dev)
    return {"unsharded": {"form": "chunk" if dev.type == "cuda" else "eager loop",
                          "steps_per_call": a.iters, "captures": chunk.captures,
                          "ms": sec["form"] * 1e3, "steps_per_s": 1.0 / sec["form"],
                          "eager_ms": sec["eager"] * 1e3,
                          "eager_steps_per_s": 1.0 / sec["eager"], "peak_mib": _peak_mib(dev)}}


def worker(a) -> None:
    if a.unsharded:   # no world: the single-device step alone
        with open(os.path.join(a.worker, "rank0.json"), "w") as f:
            json.dump(unsharded(a), f)
        return
    from ..ops import composite_pairs as cp
    from ..parallel import distributed as pdist
    from ..parallel.mesh import make_rank_mesh
    from ..parallel.sharded import (
        camera_batch, make_sharded_train_step, pad_gt_for_mesh, padded_height,
    )
    from ..training.trainer import CHUNK_WARMUP

    backend = a.dist_backend or pdist.default_backend(a.device)
    pdist.initialize(a.coordinator_address, a.num_processes, a.process_id, backend=backend,
                     device=a.device)
    try:
        dev = pdist.rank_device(a.device)
        out = {}
        for m in a.meshes.split(","):
            d, t = (int(x) for x in m.lower().split("x"))
            mesh = make_rank_mesh(d, t)
            model, cfg, tile, state, cams, gt = scene(a, dev, d)
            coll = pdist.Collectives(backend)
            step = make_sharded_train_step(model, cfg, tile, mesh, cams[0],
                                           gauss_shard=a.gauss_shard, collectives=coll)
            hp = padded_height(cams[0].height, tile.tile_h, t)
            row_cams, row_gt = pdist.make_local_batch(mesh, camera_batch(cams),
                                                      pad_gt_for_mesh(gt, hp))
            bg = torch.zeros(3, device=dev)

            def run(st):
                return step(st, row_cams, row_gt, bg, 3)[0]

            def run_eager(st):
                return step.eager(st, row_cams, row_gt, bg, 3)[0]

            state, _ = time_steps(run_eager, state, a.warmup, dev)
            # The form's warm-up: a captured step's eager calls and its capture.
            time_steps(run, state, CHUNK_WARMUP + 1, dev)
            launches = dict.fromkeys(cp.LAUNCHES, 0)
            calls = {}

            def on_block(kind, before):
                if kind != "form":
                    return
                sign = -1 if before else 1
                for k, v in cp.LAUNCHES.items():
                    launches[k] += sign * v
                if before:
                    coll.reset()
                else:
                    calls["form"] = coll.summary()["calls"] / a.iters

            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            sec = alternate({"form": _repeat(run, a.iters), "eager": _repeat(run_eager, a.iters)},
                            state, a.iters, dev, on_block=on_block)
            n_form = a.iters * BLOCKS.count("form")
            coll.timed = True
            coll.reset()
            time_steps(run_eager, state, a.coll_iters, dev)
            per = {k: v / a.coll_iters for k, v in coll.summary().items()}
            step.drop()   # before the world is left
            out[m] = {"form": step.form, "captures": step.captures,
                      "ms": sec["form"] * 1e3, "steps_per_s": 1.0 / sec["form"],
                      "cameras_per_s": d / sec["form"], "eager_ms": sec["eager"] * 1e3,
                      "eager_steps_per_s": 1.0 / sec["eager"],
                      "eager_cameras_per_s": d / sec["eager"],
                      "coll_ms": per["ms"], "coll_bytes": per["bytes"],
                      "coll_calls": per["calls"], "coll_calls_form": calls["form"],
                      "launches_per_step": {k: v / n_form for k, v in launches.items() if v},
                      "peak_mib": _peak_mib(dev), "host_staged": coll.host_staged(dev),
                      "backend": backend}
        with open(os.path.join(a.worker, f"rank{mesh.rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        pdist.shutdown()


def main(argv=None) -> dict:
    a = parse_args(argv)
    if a.unsharded and (a.meshes is not None or a.gauss_shard):
        raise ValueError("--unsharded times the single-device step alone: it takes no "
                         "--meshes or --gauss_shard")
    a.meshes = a.meshes or "1x1"
    if a.worker:
        worker(a)
        return {}
    from ..parallel import distributed as pdist

    backend = a.dist_backend or pdist.default_backend(a.device)
    common = [f"--{k}={getattr(a, k)}" for k in ("width", "height", "per_face", "iters",
                                                 "warmup", "coll_iters", "device")]

    def run(size: int, argv_w: list) -> list:
        with tempfile.TemporaryDirectory(prefix="gsav_scaling_") as out_dir:
            pdist.launch(MODULE, ["--worker", out_dir, *common, *argv_w], size, a.timeout,
                         device=a.device).check()
            ranks = []
            for r in range(size):
                with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
        return ranks

    if a.unsharded:
        res = run(1, ["--unsharded"])[0]
        r = res["unsharded"]
        print(f"unsharded step ({r['form']}, {r['steps_per_call']} steps a call): "
              f"{r['ms']:8.2f} ms/iter ({r['steps_per_s']:6.2f} iters/s); eager "
              f"{r['eager_ms']:8.2f} ms/iter ({r['eager_steps_per_s']:6.2f} iters/s)")
        return res
    shapes = [tuple(int(x) for x in m.lower().split("x")) for m in a.meshes.split(",")]
    sizes = sorted({d * t for d, t in shapes})
    cards = torch.cuda.device_count() if torch.device(a.device).type == "cuda" else 0
    results = {}
    for size in sizes:
        meshes = ",".join(f"{d}x{t}" for d, t in shapes if d * t == size)
        pdist.check_backend(backend, a.device, size)
        ranks = run(size, ["--meshes", meshes, "--dist_backend", backend]
                    + (["--gauss_shard"] if a.gauss_shard else []))
        for m in meshes.split(","):
            res = dict(ranks[0][m])
            res["per_rank_ms"] = [rk[m]["ms"] for rk in ranks]
            res["per_rank_coll_ms"] = [rk[m]["coll_ms"] for rk in ranks]
            res["time_shared"] = cards > 0 and size > cards
            results[m] = res
            note = (f"  [{size} ranks time-share {cards} card(s): not scaling]"
                    if res["time_shared"] else "")
            print(f"mesh {m} ({backend}{', gauss_shard' if a.gauss_shard else ''}, "
                  f"{res['form']}): {res['ms']:8.2f} ms/iter ({res['steps_per_s']:6.2f} "
                  f"iters/s, {res['cameras_per_s']:6.2f} cameras/s; eager "
                  f"{res['eager_cameras_per_s']:6.2f} cameras/s), collectives "
                  f"{res['coll_ms']:.2f} ms (eager, timed) and "
                  f"{res['coll_bytes'] / 2**20:.2f} MiB a step{note}")
    if "1x1" in results:
        base = results["1x1"]["steps_per_s"]
        for m, r in results.items():
            d, t = (int(x) for x in m.split("x"))
            sp = r["steps_per_s"] * d / base
            note = " (time-shared: not scaling)" if r["time_shared"] else ""
            print(f"  ({m}) speed-up vs 1x1: {sp:.2f}x (efficiency {sp / (d * t):.0%}){note}")
    return results


if __name__ == "__main__":
    main()
    sys.stdout.flush()
