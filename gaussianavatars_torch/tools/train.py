"""Training CLI — reference-parity flags (`train.py:397-427`,
`arguments/__init__.py:47-144`) over the port's host loop.

The port of the JAX package's `scripts/train.py`, with the same flags,
short forms and defaults plus `--device`. With `--bind_to_mesh` it fits a
FLAME-bound avatar (DynamicNerf layout); without it, vanilla 3DGS on a
COLMAP or Blender scene from the dataset's point cloud. The viewer GUI
server listens on `--port` (0: off) and is serviced after every step;
`--detect_anomaly` turns on autograd's anomaly detection and
`--debug_from` per-step finite checks.

    python -m gaussianavatars_torch.tools.train -s data/306 -m output/306 \\
        --bind_to_mesh --eval [--flame_assets FLAME.npz] [--device cuda|cpu]
    python -m gaussianavatars_torch.tools.train -s data/lego -m output/lego -w --eval

`--no_pallas` trains and evaluates through the table pipeline
(`ops/rasterize_tiled.bin_gaussians` and `composite_tiles`). Flags that
need a part of the JAX package not ported yet raise `NotImplementedError`
and name the `ROADMAP.md` item: `--mesh`, `--distributed`,
`--gauss_shard` and `--coordinator_address`, `--num_processes`,
`--process_id` other than their defaults (item 5). `--steps_per_call` is accepted and does nothing:
the port runs one step per iteration.
"""
from __future__ import annotations

import argparse
import os

from ..config import Config, ModelConfig, OptimizationConfig, PipelineConfig
from ..device import resolve_device
from ..training.loop import build_harness, train
from ..utils.debug import enable_nan_debugging
from .render import load_flame_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GaussianAvatars trainer (PyTorch/CUDA)")
    # ModelParams (`arguments/__init__.py:47-67`)
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--bind_to_mesh", action="store_true")
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--target_path", "-t", type=str, default="")
    p.add_argument("--select_camera_id", type=int, default=-1)
    p.add_argument("--capacity", type=int, default=131072)
    # FLAME assets
    p.add_argument("--flame_assets", type=str, default=os.environ.get("GSAVATARS_FLAME_ASSETS", ""),
                   help="converted flame2023 npz (see assets.convert_flame_pickle); "
                        "synthetic topology is used if absent")
    p.add_argument("--disable_teeth", action="store_true")
    # OptimizationParams (subset; the rest come from config defaults)
    p.add_argument("--iterations", type=int, default=600_000)
    p.add_argument("--interval", type=int, default=10_000,
                   help="eval/save cadence (`train.py:406-421`)")
    p.add_argument("--densify_from_iter", type=int, default=10_000)
    p.add_argument("--densify_until_iter", type=int, default=600_000)
    p.add_argument("--densification_interval", type=int, default=2_000)
    p.add_argument("--opacity_reset_interval", type=int, default=60_000)
    p.add_argument("--densify_grad_threshold", type=float, default=0.0002)
    p.add_argument("--lambda_dssim", type=float, default=0.2)
    p.add_argument("--lambda_xyz", type=float, default=1e-2)
    p.add_argument("--lambda_scale", type=float, default=1.0)
    p.add_argument("--lambda_laplacian", type=float, default=0.0)
    p.add_argument("--port", type=int, default=60000, help="viewer GUI port (0 = off)")
    # Innovations (`arguments/__init__.py:110-144`)
    p.add_argument("--use_region_adaptive_loss", action="store_true")
    p.add_argument("--use_smart_densification", action="store_true")
    p.add_argument("--use_progressive_resolution", action="store_true")
    p.add_argument("--use_color_calibration", action="store_true")
    p.add_argument("--use_contrastive_reg", action="store_true")
    p.add_argument("--all_innovations", action="store_true")
    # Runtime
    p.add_argument("--start_checkpoint", type=str, default="")
    p.add_argument("--test_iterations", type=int, nargs="*", default=None)
    p.add_argument("--save_iterations", type=int, nargs="*", default=None)
    p.add_argument("--checkpoint_iterations", type=int, nargs="*", default=None)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--detect_anomaly", action="store_true",
                   help="torch.autograd.set_detect_anomaly: a backward that makes NaN "
                        "raises and names its forward op (reference --detect_anomaly, "
                        "train.py:423-424)")
    p.add_argument("--debug_from", type=int, default=-1,
                   help="from this iteration: per-step finite assertions on "
                        "metrics/params (reference --debug_from, train.py:189-190)")
    p.add_argument("--color_net_lr", type=float, default=1e-3)
    p.add_argument("--use_amp", action="store_true",
                   help="mixed precision: bf16 operands for the SSIM blurs and the "
                        "backward compositor's contraction, float32 accumulation and "
                        "state (reference AMP, train.py:69-72)")
    p.add_argument("--no_pallas", action="store_true",
                   help="the table pipeline instead of the compositor kernels")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", type=str, default="",
                   help="multi-device mesh 'DATAxTILE': not ported (ROADMAP queue A item 5)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host: not ported (ROADMAP queue A item 5)")
    p.add_argument("--coordinator_address", type=str, default="",
                   help="multi-host: not ported (ROADMAP queue A item 5)")
    p.add_argument("--num_processes", type=int, default=-1)
    p.add_argument("--process_id", type=int, default=-1)
    p.add_argument("--gauss_shard", action="store_true",
                   help="with --mesh: not ported (ROADMAP queue A item 5)")
    p.add_argument("--steps_per_call", type=int, default=50,
                   help="accepted for the JAX script's command lines; the port runs "
                        "one step per iteration")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def check_supported(a) -> None:
    """Raise `NotImplementedError` for a flag whose path is not ported."""
    multi = {"--mesh": a.mesh != "", "--distributed": a.distributed,
             "--gauss_shard": a.gauss_shard,
             "--coordinator_address": a.coordinator_address != "",
             "--num_processes": a.num_processes != -1, "--process_id": a.process_id != -1}
    given = [flag for flag, on in multi.items() if on]
    if given:
        raise NotImplementedError(f"{', '.join(given)}: multi-device training is not "
                                  "ported (ROADMAP queue A item 5)")


def config_from_args(a) -> Config:
    inn = a.all_innovations
    return Config(
        model=ModelConfig(
            source_path=a.source_path, model_path=a.model_path,
            sh_degree=a.sh_degree, bind_to_mesh=a.bind_to_mesh,
            white_background=a.white_background, resolution=a.resolution,
            eval=a.eval, target_path=a.target_path,
            select_camera_id=a.select_camera_id, capacity=a.capacity,
            add_teeth=not a.disable_teeth,
        ),
        pipeline=PipelineConfig(use_pallas=not a.no_pallas),
        opt=OptimizationConfig(
            iterations=a.iterations,
            densify_from_iter=a.densify_from_iter,
            densify_until_iter=a.densify_until_iter,
            densification_interval=a.densification_interval,
            opacity_reset_interval=a.opacity_reset_interval,
            densify_grad_threshold=a.densify_grad_threshold,
            lambda_dssim=a.lambda_dssim, lambda_xyz=a.lambda_xyz,
            lambda_scale=a.lambda_scale, lambda_laplacian=a.lambda_laplacian,
            use_region_adaptive_loss=a.use_region_adaptive_loss or inn,
            use_smart_densification=a.use_smart_densification or inn,
            use_progressive_resolution=a.use_progressive_resolution or inn,
            use_color_calibration=a.use_color_calibration or inn,
            use_contrastive_reg=a.use_contrastive_reg or inn,
            color_net_lr=a.color_net_lr,
            use_amp=a.use_amp,
        ),
    )


def event_iterations(a) -> tuple:
    """(test, save, checkpoint) iterations: the given lists, else every
    `interval` for tests and every 6·`interval` plus the last for saves
    and checkpoints (`scripts/train.py:176-187`)."""
    iv = a.interval
    tests = a.test_iterations if a.test_iterations is not None else list(
        range(iv, a.iterations + 1, iv))
    every6 = sorted(set(list(range(iv * 6, a.iterations + 1, iv * 6)) + [a.iterations]))
    saves = a.save_iterations if a.save_iterations is not None else every6
    ckpts = a.checkpoint_iterations if a.checkpoint_iterations is not None else every6
    return tests, saves, ckpts


def main(argv=None):
    """Parse, build the harness, serve the GUI and train. Returns
    (harness, logs)."""
    a = parse_args(argv)
    check_supported(a)
    dev = resolve_device(a.device)
    cfg = config_from_args(a)
    if a.detect_anomaly:
        enable_nan_debugging()
        print("[debug] autograd anomaly detection enabled (--detect_anomaly)")
    gui = None
    try:
        model = load_flame_model(cfg, a.flame_assets, device=dev) if a.bind_to_mesh else None
        harness = build_harness(cfg, model=model, start_checkpoint=a.start_checkpoint,
                                device=dev)
        tests, saves, ckpts = event_iterations(a)
        if a.port:
            from ..viewers.network_gui import TrainingGuiServer

            try:
                gui = TrainingGuiServer("0.0.0.0", a.port)
                print(f"viewer GUI listening on :{a.port}")
            except OSError as e:
                print(f"[warn] GUI server unavailable: {e}")
        # Serviced every iteration (reference: train.py:143-172).
        gui_service = (lambda it: gui.service(harness, it)) if gui else None
        logs = train(harness, iterations=a.iterations, log_every=a.log_every, eval_every=None,
                     eval_iterations=tests, save_iterations=saves, checkpoint_iterations=ckpts,
                     seed=a.seed, gui_service=gui_service, debug_from=a.debug_from)
    finally:
        if gui is not None:
            gui.close()
        if a.detect_anomaly:
            enable_nan_debugging(False)
    return harness, logs


if __name__ == "__main__":
    main()
