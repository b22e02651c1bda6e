"""Per-stage timings of the train step on the benchmark scene (one card).

The port of the JAX package's `scripts/stage_timings.py`. The stages nest
(geometry ⊂ geometry + binning, render forward ⊂ forward + backward ⊂ the
full step), so the differences between rows locate the cost; the two
kernel rows time the compositor alone on a fixed binned frame. Each row
chains `--iters` iterations, every one taking a scalar from the one before
(the jaw moves by s·1e-12), and times them with CUDA events around the
chain and one synchronisation at its end (the host clock on the CPU),
after one warm-up iteration. The last row, "full train step (scan
chunk)" as the JAX script names it, times the production dispatch: a
chunk of `--iters` steps (`trainer.make_train_chunk`, on the card one CUDA
graph of the step replayed once a step) after a first chunk that warms up
and captures, CUDA events around the chunk.

    python -m gaussianavatars_torch.tools.stage_timings [--iters 100] [--no_pallas] [--amp]

`--no_pallas` times the table pipeline: its binning (`bin_gaussians`) and
its compositor (`composite_tiles`, forward and backward on the fixed
table) in the binning and kernel rows, and the table path in the render
and step rows. `--amp` runs the full step under `use_amp`. `--width`,
`--height` and `--per_face` shrink the scene (the CPU at a test size).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..config import Config, ModelConfig, OptimizationConfig, PipelineConfig
from ..device import resolve_device
from ..models.binding import face_frames
from ..models.gaussians import world_gaussians
from ..ops.composite_pairs import bwd_call_pairs, fwd_call_pairs
from ..ops.projection import project_from_params
from ..ops.rasterize_sorted import depth_key, sort_gather
from ..ops.rasterize_tiled import (
    bin_gaussians, composite_tiles, detached, render_tiled, view_colors,
)
from ..ops.sort_binning import bbox_tiles
from ..render import HEIGHT, WIDTH, build_scene, probe_tile_config
from ..training.loss import ssim
from ..training.trainer import (
    init_train_state, make_train_chunk, make_train_step, stack_cameras,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--no_pallas", action="store_true")
    p.add_argument("--amp", action="store_true",
                   help="the full-step row under the bf16 mixed-precision policy "
                        "(OptimizationConfig.use_amp)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--width", type=int, default=WIDTH)
    p.add_argument("--height", type=int, default=HEIGHT)
    p.add_argument("--per_face", type=int, default=9)
    return p.parse_args(argv)


def chained_ms(body: Callable[[torch.Tensor], torch.Tensor], n_iter: int,
               device: torch.device) -> float:
    """Milliseconds an iteration of `s ← body(s)` over `n_iter` chained
    iterations, after one warm-up: CUDA events and one synchronisation on
    a card, the host clock on the CPU."""
    s = torch.zeros((), device=device)
    s = body(s)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iter):
            s = body(s)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n_iter
    t0 = time.perf_counter()
    for _ in range(n_iter):
        s = body(s)
    float(s)
    return (time.perf_counter() - t0) * 1e3 / n_iter


def main(argv=None) -> Dict[str, float]:
    """Prints one row a stage and returns {stage: ms an iteration}."""
    a = parse_args(argv)
    dev = resolve_device(a.device)
    model, params, aux, fl, cam, n = build_scene(per_face=a.per_face, width=a.width,
                                                 height=a.height, device=dev)
    tile = probe_tile_config(model, params, aux, fl, cam)
    use_pallas = not a.no_pallas
    print(f"device={dev} n={n} pallas={use_pallas} {a.width}x{a.height}", file=sys.stderr)
    h, w = cam.height, cam.width
    bg = torch.zeros(3, device=dev)
    nty, ntx = tile.grid(h, w)
    nt = nty * ntx
    spec = tile.tier_spec(params.capacity)
    rows: Dict[str, float] = {}

    def timed(name, body):
        ms = chained_ms(body, a.iters, dev)
        rows[name] = ms
        print(f"{name:34s} {ms:8.3f} ms")

    def flame_world(s, p=params):
        verts = model(fl._replace(jaw=torch.zeros((1, 3), device=dev) + s * 1e-12))
        return world_gaussians(p, aux, face_frames(verts[0], model.faces))

    def geometry(s):
        wg = flame_world(s)
        proj = project_from_params(wg.means, wg.scales, wg.quats, cam, alive=wg.alive)
        return proj, view_colors(wg.means, wg.sh, cam, 3), wg

    def binning(s):
        """The chosen pipeline's binning of this frame: (dataT, plan) sorted;
        (projection, colours, opacity, Binned) for the table."""
        proj, colors, wg = geometry(s)
        proj = detached(proj)
        opac = torch.where(proj.mask, wg.opacity, torch.zeros_like(wg.opacity))
        if not use_pallas:
            return proj, colors, opac, bin_gaussians(proj, h, w, tile, opacity=opac)
        tminx, tminy, bw, ntiles, _, _ = bbox_tiles(proj, h, w, tile.tile_h, tile.tile_w,
                                                    opacity=opac)
        ints = (tminx, tminy, bw, torch.where(proj.mask, ntiles, torch.zeros_like(ntiles)),
                depth_key(proj.depth))
        return sort_gather((nt, ntx, spec), proj.mean2d, proj.conic, colors, opac, ints)

    with torch.no_grad():
        timed("geometry (FLAME+proj+SH)", lambda s: s + geometry(s)[0].mean2d[0, 0] * 0)

        def bin_row(s):
            out = binning(s)
            if use_pallas:
                data_t, plan = out
                return s + data_t[0, 0] * 0 + plan.counts[0].float() * 0
            return s + out[3].counts[0].float() * 0 + out[3].idx[0, 0].float() * 0

        timed(f"geometry + {'sorted' if use_pallas else 'table'} binning", bin_row)

        def fwd(s, p=params):
            wg = flame_world(s, p)
            return render_tiled(wg.means, wg.scales, wg.quats, wg.opacity, cam, bg, sh=wg.sh,
                                sh_degree=3, alive=wg.alive, cfg=tile, use_pallas=use_pallas)

        timed("render fwd", lambda s: s + fwd(s).color[0, 0, 0] * 0)
        target = fwd(torch.zeros((), device=dev)).color

        # The compositor alone on a fixed binned frame.
        p_px = tile.tile_h * tile.tile_w
        rng = np.random.RandomState(0)
        g_acc = torch.as_tensor(rng.randn(nt, p_px, 3).astype(np.float32), device=dev)
        g_t = torch.as_tensor(rng.randn(nt, p_px).astype(np.float32), device=dev)
        if use_pallas:
            data_fix, plan = binning(torch.zeros((), device=dev))
            args = (plan.tile_starts, plan.counts, tile.tile_h, tile.tile_w, ntx)

            # Each iteration nudges one table entry by s·1e-30, in place.
            def kern_fwd(s):
                data_fix[0, 0].add_(s * 1e-30)
                acc, tfin, _stop = fwd_call_pairs(data_fix, *args)
                return s + acc[0, 0, 0] * 0 + tfin[0, 0] * 0

            acc0, tfin0, stop0 = fwd_call_pairs(data_fix, *args)

            def kern_bwd(s):
                data_fix[0, 0].add_(s * 1e-30)
                dg = bwd_call_pairs(data_fix, plan.tile_starts, plan.counts, acc0,
                                    tfin0, stop0, g_acc, g_t, tile.tile_h, tile.tile_w, ntx)
                return s + dg[0, 0] * 0

            timed("composite fwd kernel (fixed)", kern_fwd)
            timed("composite bwd kernel (fixed)", kern_bwd)
        else:
            proj_f, colors_f, opac_f, binned = binning(torch.zeros((), device=dev))
            k = min(int(binned.counts.max()), tile.capacity)
            idx = binned.idx[:, :k].long()
            packed = torch.cat([proj_f.mean2d, proj_f.conic, colors_f, opac_f[:, None]], -1)
            g = packed[idx.clamp_min(0)]
            slots = (g[..., 0:2], g[..., 2:5], g[..., 5:8], g[..., 8] * (idx >= 0))

            def scan_fwd(s):
                acc, tfin = composite_tiles(binned.tile_origin, slots[0] + s * 1e-30,
                                            *slots[1:], tile)
                return s + acc[0, 0, 0] * 0 + tfin[0, 0] * 0

            def scan_bwd(s):
                with torch.enable_grad():
                    leaves = [x.detach().requires_grad_() for x in slots]
                    acc, tfin = composite_tiles(binned.tile_origin, leaves[0] + s * 1e-30,
                                                *leaves[1:], tile)
                    d = torch.autograd.grad((acc, tfin), leaves, (g_acc, g_t))
                return s + d[0][0, 0, 0] * 0

            timed("composite_tiles fwd (fixed)", scan_fwd)
            timed("composite_tiles fwd+bwd (fixed)", scan_bwd)

    def fwd_bwd(loss_of):
        def body(s):
            leaves = world_leaves()
            with torch.enable_grad():
                loss = loss_of(fwd(s, leaves).color)
                g = torch.autograd.grad(loss, leaves.means)[0]
            return s + loss.detach() * 0 + g[0, 0] * 0
        return body

    def world_leaves():
        return dataclasses.replace(params, means=params.means.detach().requires_grad_())

    timed("render fwd+bwd (mse)", fwd_bwd(lambda img: ((img - target) ** 2).mean()))
    timed("render fwd+bwd (L1+SSIM)", fwd_bwd(
        lambda img: 0.8 * (img - target).abs().mean()
        + 0.2 * (1.0 - ssim(img.permute(2, 0, 1), target.permute(2, 0, 1)))))

    cfg = Config(
        model=ModelConfig(capacity=params.capacity, n_shape=100, n_expr=50),
        pipeline=PipelineConfig(tile_h=tile.tile_h, tile_w=tile.tile_w, use_pallas=use_pallas,
                                base_budget=tile.base_budget, tiers=tile.tiers),
        opt=OptimizationConfig(use_amp=a.amp),
    )
    step = make_train_step(model, cfg, tile)
    state = {"st": init_train_state(params, aux, cfg, num_timesteps=2, n_expr=50, n_shape=100,
                                    num_verts=model.num_verts)}
    gt = torch.clamp(target, 0, 1)

    def full_step(s):
        out = step(state["st"], gt + s * 0, cam, 0, bg, 3)
        state["st"] = out.state
        return s + out.metrics["loss"] * 0

    timed("full train step%s" % (" (amp)" if a.amp else ""), full_step)

    # The production dispatch: `--iters` steps a chunk (`make_train_chunk`,
    # one CUDA graph of the step replayed once a step on the card), the
    # second chunk timed after one that warms up and captures.
    chunk = make_train_chunk(model, cfg, tile)
    k = a.iters
    cache = (gt[None] * 255).to(torch.uint8)
    cams = stack_cameras([cam] * k)
    st, m = chunk(state["st"], cache, [0] * k, cams, [0] * k, bg, 3)
    float(m["loss"][-1])
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        st, m = chunk(st, cache, [0] * k, cams, [0] * k, bg, 3)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / k
    else:
        t0 = time.perf_counter()
        st, m = chunk(st, cache, [0] * k, cams, [0] * k, bg, 3)
        float(m["loss"][-1])
        ms = (time.perf_counter() - t0) * 1e3 / k
    chunk.drop()
    name = "full train step (scan chunk%s)" % (", amp" if a.amp else "")
    rows[name] = ms
    print(f"{name:34s} {ms:8.3f} ms")
    return rows


if __name__ == "__main__":
    main()
