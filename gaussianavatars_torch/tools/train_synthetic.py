"""End-to-end system check: recover a known synthetic avatar.

The port of the JAX package's `scripts/train_synthetic.py`, with the same
flags (`--steps_per_call`, default 50: chunks of up to that many steps a
dispatch, on the card one CUDA graph of the step replayed once a step):
renders a DynamicNerf-format dataset from a randomised reference avatar
through the port's render path (the forward compositor kernel on a card),
then trains a fresh model on it with the host loop
(`training.loop`: densification, opacity resets, SH warm-up, eval, PLY
save, checkpoints) and reports PSNR on the held-out views. The reference
avatar's random draws come from a `torch.Generator`, so the dataset agrees
with the JAX script's in its distribution, not in its bits.

    python -m gaussianavatars_torch.tools.train_synthetic --workdir DIR [--device cuda] ...

Before training it also measures the untrained state's PSNR/SSIM on the
same held-out views (`eval_*_untrained` in the result), the floor a
healthy run must beat. `--all_innovations` turns on the five training
innovations with the progressive milestones at 1/3 and 2/3 of the run;
`--quality` is the JAX script's quality profile (`apply_quality_profile`:
802×550, 24,000 iterations, 131,072 slots, 12 timesteps × 8 cameras,
opacity resets every tenth of the run, all five innovations), whose
`--json_out` result `tools/quality_report.py` turns into a report.
`--no_pallas` renders the dataset and trains through the table pipeline
(`ops/rasterize_tiled.bin_gaussians` and `composite_tiles`) with the JAX
script's table budgets: 512 Gaussians a tile and 8 tiles a Gaussian
(`--capacity_per_tile`, `--max_tiles_per_gaussian`: flags of the port),
which the loop doubles on overflow.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..config import Config, ModelConfig, OptimizationConfig, PipelineConfig
from ..data.cameras import look_at_camera
from ..device import resolve_device
from ..models.binding import face_frames
from ..models.flame.assets import synthetic_assets
from ..models.flame.flame_model import FlameConfig, FlameModel, zero_params
from ..models.gaussians import init_bound, inverse_sigmoid, world_gaussians
from ..ops.rasterize_tiled import render_tiled
from ..render import probe_tile_config
from ..training.loop import (
    build_harness, evaluate_split, make_render_fn, probe_tier_budgets, tile_config, train,
)
from ..training.trainer import active_sh_degree


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", default="gsav_synthetic")
    p.add_argument("--device", default="cuda")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--timesteps", type=int, default=10)
    p.add_argument("--cameras", type=int, default=6)
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--capacity", type=int, default=65536)
    p.add_argument("--per_face", type=int, default=2)
    p.add_argument("--n_shape", type=int, default=50)
    p.add_argument("--n_expr", type=int, default=20)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--eval_every", type=int, default=500)
    p.add_argument("--no_pallas", action="store_true",
                   help="the table pipeline instead of the compositor kernels")
    p.add_argument("--capacity_per_tile", type=int, default=512,
                   help="the table pipeline's Gaussians a tile (doubled on overflow)")
    p.add_argument("--max_tiles_per_gaussian", type=int, default=8,
                   help="the table pipeline's tiles a Gaussian (doubled on overflow)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps_per_call", type=int, default=50,
                   help="training steps a dispatch (training/loop.train; 1: every step alone)")
    p.add_argument("--all_innovations", action="store_true")
    p.add_argument("--use_amp", action="store_true")
    p.add_argument("--opacity_reset_interval", type=int, default=0,
                   help="0 = never (default)")
    p.add_argument("--densify_grad_threshold", type=float, default=0.0002)
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="also write a resume checkpoint every N iterations (0 = final only)")
    p.add_argument("--start_checkpoint", default="",
                   help="resume a previous run from this TrainState .npz")
    p.add_argument("--json_out", default="",
                   help="write the log trajectory + final eval metrics here")
    p.add_argument("--quality", action="store_true")
    return p.parse_args(argv)


def build_reference_avatar(a, device):
    """The generating avatar: synthetic FLAME assets (seed `a.seed`) and
    `per_face` Gaussians per face with random local means (σ 0.15), scales
    uniform in [0.3, 0.8], random rotations and opacity 0.9, drawn from a
    generator seeded with `a.seed + 7`."""
    dev = resolve_device(device)
    assets = synthetic_assets(n_shape=a.n_shape, n_expr=a.n_expr, seed=a.seed)
    model = FlameModel(assets, FlameConfig(n_shape=a.n_shape, n_expr=a.n_expr, add_teeth=True),
                       device=dev)
    gen = torch.Generator().manual_seed(a.seed + 7)
    params, aux = init_bound(model.num_faces, capacity=a.capacity, generator=gen,
                             per_face=a.per_face, device=dev)
    shape3 = params.means.shape
    params = dataclasses.replace(
        params,
        means=(torch.randn(shape3, generator=gen) * 0.15).to(dev),
        log_scales=torch.log(torch.empty(shape3).uniform_(0.3, 0.8, generator=gen)).to(dev),
        quats=torch.randn(params.quats.shape, generator=gen).to(dev),
        logit_opacity=torch.full_like(params.logit_opacity, inverse_sigmoid(0.9)),
    )
    return model, params, aux


def _save_png(img: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray((img * 255).astype(np.uint8)).save(path)


@torch.no_grad()
def write_dataset(a, model, params, aux):
    """Render every (timestep, camera) view at `a.width`×`a.height` with the
    jaw opening over the timesteps and random expressions, and write the
    DynamicNerf layout: images, per-timestep FLAME npz files and the three
    transforms files (val: camera 0, a novel view; test: the middle
    timestep, a novel expression on the seen cameras). Each view's tier
    budgets are probed from its own footprints, so no view is truncated."""
    dev = params.means.device
    root = a.workdir
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "flame_param"), exist_ok=True)
    center = np.asarray(model.assets.v_template.mean(0))
    extent = float(np.abs(np.asarray(model.assets.v_template) - center).max())
    rng = np.random.default_rng(a.seed)
    bg = torch.zeros(3, device=dev)
    frames_meta = []
    for t in range(a.timesteps):
        jaw = np.zeros((1, 3), np.float32)
        jaw[0, 0] = 0.25 * t / max(a.timesteps - 1, 1)
        expr = (rng.normal(size=(1, a.n_expr)) * 0.3).astype(np.float32)
        np.savez(
            os.path.join(root, "flame_param", f"{t}.npz"),
            shape=np.zeros(a.n_shape, np.float32), expr=expr,
            rotation=np.zeros((1, 3), np.float32),
            neck_pose=np.zeros((1, 3), np.float32), jaw_pose=jaw,
            eyes_pose=np.zeros((1, 6), np.float32),
            translation=np.zeros((1, 3), np.float32),
            static_offset=np.zeros((1, model.num_verts, 3), np.float32),
        )
        fl = zero_params(a.n_shape, a.n_expr, batch=1, device=dev)._replace(
            jaw=torch.as_tensor(jaw, device=dev), expr=torch.as_tensor(expr, device=dev))
        wg = world_gaussians(params, aux, face_frames(model(fl)[0], model.faces))
        for c in range(a.cameras):
            ang = -0.5 + 1.0 * c / max(a.cameras - 1, 1)
            eye = center + np.array([np.sin(ang) * 4 * extent, 0.0, -np.cos(ang) * 4 * extent])
            cam = look_at_camera(eye=eye, target=center, fovy=0.5, width=a.width,
                                 height=a.height, device=dev)
            tcfg = probe_tile_config(model, params, aux, fl, cam)
            out = render_tiled(wg.means, wg.scales, wg.quats, wg.opacity, cam, bg, sh=wg.sh,
                               sh_degree=0, alive=wg.alive, cfg=tcfg,
                               use_pallas=not a.no_pallas)
            name = f"images/t{t:03d}_c{c}.png"
            _save_png(torch.clamp(out.color, 0, 1).cpu().numpy(), os.path.join(root, name))
            w2c = np.eye(4)
            w2c[:3, :] = cam.world_view.cpu().numpy().astype(np.float64)[:3, :]
            c2w = np.linalg.inv(w2c)
            c2w[:3, 1:3] *= -1
            frames_meta.append({
                "file_path": name, "transform_matrix": c2w.tolist(),
                "timestep_index": t, "camera_index": c,
                "camera_angle_x": float(cam.fovx),
                "flame_param_path": f"flame_param/{t}.npz",
                "w": a.width, "h": a.height,
            })
    t_test = a.timesteps // 2
    train_f = [f for f in frames_meta
               if f["camera_index"] != 0 and f["timestep_index"] != t_test]
    val_f = [f for f in frames_meta
             if f["camera_index"] == 0 and f["timestep_index"] != t_test]
    test_f = [f for f in frames_meta
              if f["timestep_index"] == t_test and f["camera_index"] != 0]
    for split, fr_list in (("train", train_f), ("val", val_f), ("test", test_f)):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"frames": fr_list}, f)
    print(f"dataset: {len(train_f)} train / {len(val_f)} val (novel view) / "
          f"{len(test_f)} test (novel timestep {t_test}) views at "
          f"{a.width}x{a.height}, {a.timesteps} timesteps")
    return len(frames_meta)


def apply_quality_profile(a, parser_defaults: dict) -> None:
    """The quality operating point of the JAX script
    (`scripts/train_synthetic.py:178-197`): the reference benchmark's
    geometry (802×550) with the 600k recipe cut down, densification,
    periodic opacity resets, SH warm-up and all five innovations. Only the
    knobs left at their defaults are changed."""
    def default(name, value):
        if getattr(a, name) == parser_defaults[name]:
            setattr(a, name, value)

    default("width", 802)
    default("height", 550)
    default("iterations", 24_000)
    default("capacity", 131072)
    default("timesteps", 12)
    default("cameras", 8)
    default("workdir", "gsav_quality")
    default("opacity_reset_interval", a.iterations // 10)
    a.all_innovations = True


def innovation_options(a) -> dict:
    """The OptimizationConfig knobs of `--all_innovations`: every innovation
    on, the progressive milestones at 1/3 and 2/3 of the run (the
    reference's 100k / 300k of 600k)."""
    if not a.all_innovations:
        return {}
    return dict(
        use_region_adaptive_loss=True,
        use_smart_densification=True,
        use_progressive_resolution=True,
        resolution_schedule=(0.5, 0.75, 1.0),
        resolution_milestones=(a.iterations // 3, 2 * a.iterations // 3),
        use_color_calibration=True,
        use_contrastive_reg=True,
    )


def make_config(a) -> Config:
    return Config(
        model=ModelConfig(
            source_path=a.workdir, model_path=os.path.join(a.workdir, "model"),
            bind_to_mesh=True, capacity=a.capacity, n_shape=a.n_shape,
            n_expr=a.n_expr, add_teeth=True, eval=True, sh_degree=3,
        ),
        pipeline=PipelineConfig(tile_h=32, tile_w=32, capacity_per_tile=a.capacity_per_tile,
                                max_tiles_per_gaussian=a.max_tiles_per_gaussian,
                                use_pallas=not a.no_pallas),
        opt=OptimizationConfig(
            iterations=a.iterations,
            position_lr_max_steps=a.iterations,
            densify_from_iter=500, densify_until_iter=a.iterations,
            densification_interval=250,
            opacity_reset_interval=(a.opacity_reset_interval or 10 * a.iterations),
            densify_grad_threshold=a.densify_grad_threshold,
            lambda_scale=0.1,
            use_amp=a.use_amp,
            **innovation_options(a),
        ),
    )


def checkpoint_iterations(a) -> list:
    return sorted({a.iterations} | (
        set(range(a.checkpoint_every, a.iterations + 1, a.checkpoint_every))
        if a.checkpoint_every > 0 else set()))


def run(a):
    """Dataset, harness, baseline eval, training, final eval. Returns
    (harness, result)."""
    if a.cameras < 2:
        raise SystemExit("--cameras must be >= 2 (camera 0 is held out for the val split)")
    if a.steps_per_call < 1:
        raise SystemExit(f"--steps_per_call must be >= 1, got {a.steps_per_call}")
    if a.quality:
        apply_quality_profile(a, vars(parse_args([])))
    dev = resolve_device(a.device)
    ref_model, ref_params, ref_aux = build_reference_avatar(a, dev)

    meta = {k: getattr(a, k) for k in ("width", "height", "timesteps", "cameras", "seed",
                                       "per_face", "n_shape", "n_expr")}
    meta["split_ver"] = 2
    meta["generator"] = "torch"
    meta_path = os.path.join(a.workdir, "dataset_meta.json")
    reuse = False
    if os.path.exists(os.path.join(a.workdir, "transforms_train.json")):
        try:
            with open(meta_path) as f:
                reuse = json.load(f) == meta
        except (OSError, ValueError):
            reuse = False
    write_s = 0.0
    if reuse:
        print(f"reusing dataset at {a.workdir}")
    else:
        t0 = time.perf_counter()
        write_dataset(a, ref_model, ref_params, ref_aux)
        write_s = time.perf_counter() - t0
        with open(meta_path, "w") as f:
            json.dump(meta, f)
    del ref_model, ref_params, ref_aux

    cfg = make_config(a)
    # The trained model has the generating topology (synthetic assets are
    # deterministic for a seed).
    model = FlameModel(synthetic_assets(n_shape=a.n_shape, n_expr=a.n_expr, seed=a.seed),
                       FlameConfig(n_shape=a.n_shape, n_expr=a.n_expr, add_teeth=True),
                       device=dev)
    harness = build_harness(cfg, model=model, generator=torch.Generator().manual_seed(a.seed),
                            start_checkpoint=a.start_checkpoint, device=dev)
    result = {"args": vars(a), "dataset_write_s": write_s}
    sh_final = active_sh_degree(a.iterations, cfg.model.sh_degree)

    def final_eval(prefix):
        # The loop may have grown the tile budgets: evaluate with at least those.
        live = harness.live_tile_config or tile_config(cfg)
        render_fn = make_render_fn(model, cfg, live)
        for split in ("val", "test"):
            m = evaluate_split(harness, split, render_fn, sh_final)
            if m:
                extra = f" lpips={m['lpips']:.4f}" if "lpips" in m else ""
                print(f"[{prefix} eval {split}] psnr={m['psnr']:.2f} ssim={m['ssim']:.4f}"
                      f"{extra} over {m['n']} views")
                result[f"{prefix}_{split}"] = m

    if harness.start_iteration == 0:
        harness.live_tile_config = probe_tier_budgets(
            tile_config(cfg), cfg, model, harness.state, harness.scene.train_cameras()[0],
            verbose=False)
        final_eval("eval_untrained")
    t0 = time.perf_counter()
    logs = train(harness, iterations=a.iterations, log_every=a.log_every,
                 eval_every=a.eval_every, save_iterations=[a.iterations],
                 checkpoint_iterations=checkpoint_iterations(a), seed=a.seed,
                 steps_per_call=a.steps_per_call)
    result["train_s"] = time.perf_counter() - t0
    result["logs"] = logs
    if logs:
        print(f"first logged loss {logs[0]['loss']:.4f} → last {logs[-1]['loss']:.4f}; "
              f"train psnr {logs[-1]['psnr']:.2f} dB; {logs[-1]['num_points']} Gaussians")
    final_eval("eval")
    if a.json_out:
        with open(a.json_out, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {a.json_out}")
    return harness, result


def main(argv=None) -> dict:
    return run(parse_args(argv))[1]


if __name__ == "__main__":
    main()
