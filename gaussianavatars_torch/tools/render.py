"""Offline rendering of a trained model's train/val/test splits.

The port of the JAX package's `scripts/render.py` (the reference's
`render.py:54-146`), with the same flags plus `--device`: loads the model
directory (`cfg_args.json`, the latest or the given
`point_cloud/iteration_N`, its `flame_param.npz`, and `flame_assets.npz`),
renders each split's views with the trained FLAME sequence through the
forward compositor, writes `renders/` and `gt/` PNGs under
`<model>/<split>/ours_<iteration>/` on a thread pool, and assembles an mp4
when `ffmpeg` is on the path. A model directory written by either package
renders the same. When `cfg_args.json` names no tier budgets, each view's
are probed from its own footprints (`render.probe_tile_config`); the JAX
script keeps the default budgets, which cut an avatar whose Gaussians span
more than 64 tiles.

    python -m gaussianavatars_torch.tools.render -m MODEL_DIR [--skip_train] \\
        [--n_frames N] [--render_mesh] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config, from_json
from ..data.pipeline import load_view
from ..data.scene import Scene
from ..device import resolve_device
from ..models.flame.assets import load_assets, synthetic_assets
from ..models.flame.flame_model import FlameConfig, FlameModel
from ..models.gaussians import GaussianAux, GaussianParams
from ..models.io import checkpoint_ply_path, find_latest_iteration, load_avatar
from ..ops.mesh_raster import render_mesh_preview
from ..render import probe_tile_config
from ..training.loop import _flame_params, flame_init_from_table, make_render_fn, tile_config
from ..training.trainer import FlameStatic, FlameTrainable, TrainState
from ..viewers.local import blend_mesh


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_val", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--render_mesh", action="store_true",
                   help="overlay the FLAME mesh preview (ops/mesh_raster)")
    p.add_argument("--n_frames", type=int, default=0, help="cap frames per split")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--flame_assets", type=str,
                   default=os.environ.get("GSAVATARS_FLAME_ASSETS", ""))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def write_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


def load_flame_model(cfg: Config, flame_assets: str, device="cuda",
                     verbose: bool = True) -> FlameModel:
    """The FLAME model of `cfg` from an assets `.npz`, or synthetic assets
    with a warning (when `verbose`) when there is none (the JAX package's
    `scripts/train.py:load_flame_model`)."""
    fc = FlameConfig(n_shape=cfg.model.n_shape, n_expr=cfg.model.n_expr,
                     add_teeth=cfg.model.add_teeth)
    if flame_assets and os.path.exists(flame_assets):
        assets = load_assets(flame_assets)
    else:
        if verbose:
            print("[warn] no FLAME assets npz — using synthetic statistical model "
                  "(real training needs the licensed FLAME 2023 files, imported once "
                  "with gaussianavatars_torch.models.flame.assets.convert_flame_pickle)")
        assets = synthetic_assets(n_shape=fc.n_shape, n_expr=fc.n_expr, seed=0)
    return FlameModel(assets, fc, device=device)


def replay_model(model_path: str, cfg: Config, flame_assets: str = "",
                 device="cuda") -> FlameModel:
    """The model directory's own topology (`flame_assets.npz`, teeth
    included) when it has one, else `load_flame_model`."""
    saved = os.path.join(model_path, "flame_assets.npz")
    if os.path.exists(saved):
        assets = load_assets(saved)
        return FlameModel(assets, FlameConfig(
            n_shape=assets.n_shape, n_expr=assets.shapedirs.shape[-1] - assets.n_shape,
            add_teeth=False,  # saved assets already include the teeth
        ), device=device)
    return load_flame_model(cfg, flame_assets, device=device)


def replay_state(params: GaussianParams, aux: GaussianAux,
                 flame_table: Optional[Dict[str, np.ndarray]],
                 model: Optional[FlameModel]) -> TrainState:
    """A render-only TrainState (no optimiser state) of a loaded avatar,
    with the FLAME sequence of `flame_table` fitted to `model`'s
    blendshape counts; no FLAME state for an unbound avatar."""
    flame = static = None
    if model is not None:
        dev = params.means.device
        fi = flame_init_from_table(flame_table, n_shape=model.cfg.n_shape,
                                   n_expr=model.cfg.n_expr)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        flame = FlameTrainable(expr=t(fi["expr"]), rotation=t(fi["rotation"]),
                               neck=t(fi["neck"]), jaw=t(fi["jaw"]), eyes=t(fi["eyes"]),
                               translation=t(fi["translation"]))
        static = FlameStatic(
            shape=t(fi["shape"]),
            static_offset=t(np.asarray(fi["static_offset"]).reshape(-1, 3)[: model.num_verts]),
        )
    return TrainState(params=params, aux=aux, adam=None, flame=flame, flame_static=static,
                      flame_adam=None)


def mesh_overlay(img: np.ndarray, model: FlameModel, state: TrainState, cam, t: int,
                 weight: float = 0.5) -> np.ndarray:
    """The FLAME mesh preview alpha-blended over the splat render (the
    reference `render.py` mesh option via NVDiffRenderer)."""
    with torch.no_grad():
        verts = model(_flame_params(state, t))[0]
    out = render_mesh_preview(verts, model.faces, cam)
    return blend_mesh(img, out["rgba"].cpu().numpy(), weight)


def view_tile_config(tcfg, model: Optional[FlameModel], state: TrainState, cam):
    """`tcfg` when it names tier budgets, else budgets probed from `cam`'s
    view at its timestep."""
    if tcfg.tiers:
        return tcfg
    fp = _flame_params(state, int(cam.timestep)) if model is not None else None
    return probe_tile_config(model, state.params, state.aux, fp, cam, tcfg.tile_h, tcfg.tile_w)


def main(argv=None) -> dict:
    """Render the splits; returns {split: {"views", "render_ms_per_view",
    "wall_s"}} for the splits rendered."""
    a = parse_args(argv)
    dev = resolve_device(a.device)
    with open(os.path.join(a.model_path, "cfg_args.json")) as f:
        cfg = from_json(f.read())

    iteration = find_latest_iteration(a.model_path) if a.iteration == -1 else a.iteration
    ply = checkpoint_ply_path(a.model_path, iteration)
    params, aux, flame_table = load_avatar(ply, capacity=cfg.model.capacity, device=dev)
    print(f"loaded {ply}: {int(aux.alive.sum())} Gaussians")

    model = (replay_model(a.model_path, cfg, a.flame_assets, device=dev)
             if flame_table is not None else None)
    state = replay_state(params, aux, flame_table, model)
    scene = Scene(
        cfg.model.source_path, resolution=cfg.model.resolution,
        white_background=cfg.model.white_background, eval_split=cfg.model.eval,
        target_path=cfg.model.target_path, select_camera_id=cfg.model.select_camera_id,
        num_verts_hint=model.num_verts if model else 0, device=dev,
    )
    tcfg = tile_config(cfg)
    bg = torch.ones(3, device=dev) if cfg.model.white_background else torch.zeros(3, device=dev)
    if a.render_mesh and model is None:
        print("[warn] --render_mesh ignored: model has no FLAME binding")

    stats = {}
    render_fns = {}
    for split, skip in (("train", a.skip_train), ("val", a.skip_val), ("test", a.skip_test)):
        if skip or not scene.cameras(split):
            continue
        out_dir = os.path.join(a.model_path, split, f"ours_{iteration}")
        rdir, gdir = os.path.join(out_dir, "renders"), os.path.join(out_dir, "gt")
        os.makedirs(rdir, exist_ok=True)
        os.makedirs(gdir, exist_ok=True)
        cams = scene.cameras(split)
        recs = scene.records(split)
        n = len(cams) if a.n_frames <= 0 else min(a.n_frames, len(cams))
        render_s = 0.0
        t_split = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
            for i in range(n):
                # One render fn (one CUDA graph on the card) a tile config.
                vt = view_tile_config(tcfg, model, state, cams[i])
                render_fn = render_fns.get(vt) or render_fns.setdefault(
                    vt, make_render_fn(model, cfg, vt))
                t0 = time.perf_counter()
                img = render_fn(state, cams[i], cams[i].timestep, bg,
                                cfg.model.sh_degree).cpu().numpy()
                render_s += time.perf_counter() - t0
                if a.render_mesh and model is not None:
                    img = mesh_overlay(img, model, state, cams[i], int(cams[i].timestep))
                gt = load_view(recs[i], cams[i])
                pool.submit(write_png, os.path.join(rdir, f"{i:05d}.png"), img)
                pool.submit(write_png, os.path.join(gdir, f"{i:05d}.png"), gt)
                if not a.quiet and i % 20 == 0:
                    print(f"[{split}] {i}/{n}")
        stats[split] = {"views": n, "render_ms_per_view": 1e3 * render_s / max(n, 1),
                        "wall_s": time.perf_counter() - t_split}
        if shutil.which("ffmpeg"):
            subprocess.run(
                ["ffmpeg", "-y", "-framerate", str(a.fps), "-i",
                 os.path.join(rdir, "%05d.png"), "-pix_fmt", "yuv420p",
                 os.path.join(out_dir, "renders.mp4")],
                check=False, capture_output=True,
            )
    print("done")
    return stats


if __name__ == "__main__":
    main()
