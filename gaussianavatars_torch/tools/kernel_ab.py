"""A/B of the pair compositor's kernel implementations on the benchmark
scene, on one card.

The counterpart of the JAX package's `scripts/kernel_ab.py`: for each
implementation of `ops/composite_pairs` (`v2`, `v3`, `v4`, flipped through
the module's `_FWD_IMPL`/`_BWD_IMPL` switch), times the forward and the
backward kernel alone on one fixed sorted table, a full render with the jaw
perturbed, and a render forward + backward of an MSE against a target
rendered once. Each time is CUDA events around `--iters` calls, the best of
three. `--amp` runs the backward in its bf16-contraction mode.

    python -m gaussianavatars_torch.tools.kernel_ab [--iters 100] [--impls v2,v3] [--amp]

It needs a CUDA device and raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..models.binding import face_frames
from ..models.flame.assets import bootstrap_template_env
from ..models.gaussians import world_gaussians
from ..ops import composite_pairs as cp
from ..ops.projection import project_from_params
from ..ops.rasterize_sorted import depth_key, sort_gather
from ..ops.rasterize_tiled import render_tiled, view_colors
from ..ops.sort_binning import bbox_tiles
from ..render import HEIGHT, WIDTH, build_scene, probe_tile_config

# The real FLAME template of a reference checkout, when there is one.
bootstrap_template_env()


def _best_ms(fn, iters: int) -> float:
    """Best of three: device milliseconds per call over `iters` calls."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--impls", default="v2,v3")
    ap.add_argument("--amp", action="store_true", help="bf16-contraction backward")
    a = ap.parse_args(argv)
    impls = a.impls.split(",")
    for impl in impls:
        cp.fwd_entry(impl)          # an unknown name raises before any work
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab needs a CUDA device")
    dev = torch.device("cuda")

    model, params, aux, fl, cam, n = build_scene(device=dev)
    tile = probe_tile_config(model, params, aux, fl, cam)
    th, tw = tile.tile_h, tile.tile_w
    nty, ntx = tile.grid(HEIGHT, WIDTH)
    nt, p = nty * ntx, th * tw
    bg = torch.zeros(3, device=dev)

    with torch.no_grad():
        wg = world_gaussians(params, aux, face_frames(model(fl)[0], model.faces))
        proj = project_from_params(wg.means, wg.scales, wg.quats, cam, alive=wg.alive)
        colors = view_colors(wg.means, wg.sh, cam, 3)
        opac = torch.where(proj.mask, wg.opacity, torch.zeros_like(wg.opacity))
        tminx, tminy, bw, ntiles, _nty, _ntx = bbox_tiles(proj, HEIGHT, WIDTH, th, tw,
                                                          opacity=opac)
        ntiles_eff = torch.where(proj.mask, ntiles, torch.zeros_like(ntiles))
        dataT, plan = sort_gather((nt, ntx, tile.tier_spec(params.capacity)), proj.mean2d,
                                  proj.conic, colors, opac,
                                  (tminx, tminy, bw, ntiles_eff, depth_key(proj.depth)))
        target = render_tiled(wg.means, wg.scales, wg.quats, wg.opacity, cam, bg, sh=wg.sh,
                              sh_degree=3, alive=wg.alive, cfg=tile).color
    table = (dataT, plan.tile_starts, plan.counts, th, tw, ntx)
    print(f"scene: {n} splats, {int(plan.total)} pairs, max tile count "
          f"{int(plan.counts.max())}", flush=True)
    g_acc_t = torch.as_tensor(np.random.RandomState(0).randn(nt, p, 3), dtype=torch.float32,
                              device=dev)
    g_t = torch.as_tensor(np.random.RandomState(1).randn(nt, p), dtype=torch.float32,
                          device=dev)
    step = iter(range(1 << 62))

    def jaw_params():
        return fl._replace(jaw=torch.full((1, 3), 1e-9 * next(step), device=dev))

    def render(pr, amp=False):
        w2 = world_gaussians(pr, aux, face_frames(model(jaw_params())[0], model.faces))
        return render_tiled(w2.means, w2.scales, w2.quats, w2.opacity, cam, bg, sh=w2.sh,
                            sh_degree=3, alive=w2.alive, cfg=tile, amp=amp).color

    def fwd_bwd():
        leaves = dataclasses.replace(params, **{
            f.name: getattr(params, f.name).detach().requires_grad_()
            for f in dataclasses.fields(params)})
        loss = torch.mean((render(leaves, a.amp) - target) ** 2)
        torch.autograd.grad(loss, [getattr(leaves, f.name) for f in dataclasses.fields(leaves)])

    def timed(name, fn):
        ms = _best_ms(fn, a.iters)
        print(f"{name:40s} {ms:8.3f} ms", flush=True)
        return ms

    results = {}
    try:
        for impl in impls:
            cp._FWD_IMPL = cp._BWD_IMPL = impl
            with torch.no_grad():
                acc, tfin, stop = cp.fwd_call_pairs(*table)
                bwd_args = (dataT, plan.tile_starts, plan.counts, acc, tfin, stop, g_acc_t, g_t,
                            th, tw, ntx)
                print(f"--- impl {impl} ---", flush=True)
                r = {
                    "kern_fwd_ms": timed(f"[{impl}] fwd kernel (fixed table)",
                                         lambda: cp.fwd_call_pairs(*table)),
                    "kern_bwd_ms": timed(f"[{impl}] bwd kernel (fixed table)",
                                         lambda: cp.bwd_call_pairs(*bwd_args, amp=a.amp)),
                    "render_ms": timed(f"[{impl}] full render", lambda: render(params)),
                }
            r["fwd_bwd_ms"] = timed(f"[{impl}] render fwd+bwd (mse)", fwd_bwd)
            results[impl] = r
    finally:
        cp._FWD_IMPL = cp._BWD_IMPL = "v3"
    print(results, flush=True)
    return results


if __name__ == "__main__":
    main()
