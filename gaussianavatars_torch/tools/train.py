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
(`ops/rasterize_tiled.bin_gaussians` and `composite_tiles`).
`--steps_per_call K` (default 50, as the JAX script's) trains in chunks of
up to K steps a dispatch (`training/loop.train`, `trainer.make_train_chunk`:
on the card one captured CUDA graph of the step, replayed once a step);
1 dispatches every step. The loop single-steps while a viewer client is
connected and from `--debug_from` on; the mesh loop (`--mesh`) runs one
step a dispatch, as the JAX package's does.

Multi-device training (`training/loop.train_sharded` over a rank mesh,
`parallel/`): `--mesh DxT` trains D cameras a step, each composited in T
row bands (`--gauss_shard`: the per-Gaussian geometry split T ways too).
Without `--distributed` it starts D·T local ranks of this command
(`parallel/distributed.launch`, `--launch_timeout` seconds at most, 0: no
limit) and prints rank 0's output as it comes; with `--distributed`, or under
torchrun's environment, this process is one rank of an existing world
(`--coordinator_address host:port` or a `file://`/`tcp://` URL,
`--num_processes`, `--process_id`; torchrun's `MASTER_ADDR`, `RANK`, ...
otherwise), with a 1×N mesh when `--mesh` is not given.
`--dist_backend` is nccl on the card and gloo on the CPU by default; NCCL
takes one rank a device, so ranks that share a card need
`--dist_backend gloo` (asked for, never switched to).

    python -m gaussianavatars_torch.tools.train -s data/306 -m output/306 \\
        --bind_to_mesh --eval --mesh 2x2 --dist_backend gloo
    torchrun --nproc_per_node 4 -m gaussianavatars_torch.tools.train \\
        -s data/306 -m output/306 --bind_to_mesh --eval --mesh 1x4
"""
from __future__ import annotations

import argparse
import os
import sys

from ..config import Config, ModelConfig, OptimizationConfig, PipelineConfig
from ..device import resolve_device
from ..parallel import distributed as pdist
from ..parallel.mesh import make_rank_mesh
from ..training.loop import build_harness, train, train_sharded
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
                   help="multi-device mesh 'DATAxTILE' (e.g. 2x2): cameras a step over "
                        "'data', image row bands over 'tile' (parallel/sharded.py); "
                        "without --distributed, D*T local ranks are started")
    p.add_argument("--distributed", action="store_true",
                   help="this process is one rank of a world: the three flags below, "
                        "or torchrun's environment")
    p.add_argument("--coordinator_address", type=str, default="",
                   help="host:port of rank 0 (or a tcp:// or file:// URL)")
    p.add_argument("--num_processes", type=int, default=-1)
    p.add_argument("--process_id", type=int, default=-1)
    p.add_argument("--gauss_shard", action="store_true",
                   help="with --mesh: also shard per-Gaussian geometry over the tile axis")
    p.add_argument("--steps_per_call", type=int, default=50,
                   help="training steps a dispatch: chunks of up to this many steps, on "
                        "the card one CUDA graph of the step replayed once a step "
                        "(1: every step dispatched alone; the mesh loop runs one)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                   help="the ranks' torch.distributed backend (default: nccl on the card, "
                        "gloo on the CPU); ranks sharing one card need gloo")
    p.add_argument("--launch_timeout", type=float, default=0.0,
                   help="with --mesh and without --distributed: seconds the local ranks "
                        "may run (0: no limit)")
    return p.parse_args(argv)


def mesh_shape(a) -> tuple:
    """(data, tile) of `--mesh`, or (1, None) (a 1×N mesh) without it."""
    if not a.mesh:
        return 1, None
    try:
        d, t = (int(x) for x in a.mesh.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {a.mesh!r}: expected DATAxTILE, e.g. 2x2") from None
    return d, t


def joins_world(a) -> bool:
    """This process is a rank of an existing world: `--distributed`, or
    torchrun's environment."""
    return a.distributed or ("RANK" in os.environ and "WORLD_SIZE" in os.environ)


def check_supported(a) -> None:
    """Raise `ValueError` for flags that cannot run together, before
    anything starts: `--steps_per_call` below 1, a malformed `--mesh`, the world flags or
    `--gauss_shard` without a mesh to use them, and a backend that cannot
    place the ranks (`--dist_backend nccl` with two ranks on one device)."""
    d, t = mesh_shape(a)
    world = joins_world(a)
    if a.steps_per_call < 1:
        raise ValueError(f"--steps_per_call must be >= 1, got {a.steps_per_call}")
    if a.gauss_shard and not (a.mesh or world):
        raise ValueError("--gauss_shard needs --mesh or --distributed")
    given = [f for f, on in (("--coordinator_address", a.coordinator_address != ""),
                             ("--num_processes", a.num_processes != -1),
                             ("--process_id", a.process_id != -1)) if on]
    if given and not a.distributed:
        raise ValueError(f"{', '.join(given)} need --distributed")
    if a.mesh or world:
        backend = a.dist_backend or pdist.default_backend(a.device)
        ranks = int(os.environ.get("LOCAL_WORLD_SIZE", "1")) if world else d * t
        pdist.check_backend(backend, a.device, ranks)


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
    (harness, logs); with `--mesh` and without `--distributed`, the local
    ranks' `parallel.distributed.LaunchResult` in place of the harness (and
    no logs)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    a = parse_args(argv)
    check_supported(a)
    if a.mesh and not joins_world(a):
        return launch_ranks(a, argv), None
    world = joins_world(a)
    backend = a.dist_backend or pdist.default_backend(a.device)
    if world:
        pdist.initialize(a.coordinator_address or None,
                         a.num_processes if a.num_processes > 0 else None,
                         a.process_id if a.process_id >= 0 else None,
                         backend=backend, device=a.device)
    dev = pdist.rank_device(a.device) if world else resolve_device(a.device)
    coord = pdist.is_coordinator()
    cfg = config_from_args(a)
    if a.detect_anomaly:
        enable_nan_debugging()
        if coord:
            print("[debug] autograd anomaly detection enabled (--detect_anomaly)")
    gui = None
    try:
        model = (load_flame_model(cfg, a.flame_assets, device=dev, verbose=coord)
                 if a.bind_to_mesh else None)
        harness = build_harness(cfg, model=model, start_checkpoint=a.start_checkpoint,
                                device=dev, coordinator=coord)
        tests, saves, ckpts = event_iterations(a)
        if a.port and coord:
            from ..viewers.network_gui import TrainingGuiServer

            try:
                gui = TrainingGuiServer("0.0.0.0", a.port)
                print(f"viewer GUI listening on :{a.port}")
            except OSError as e:
                print(f"[warn] GUI server unavailable: {e}")
        # Serviced every iteration (reference: train.py:143-172).
        gui_service = (lambda it: gui.service(harness, it)) if gui else None
        kw = dict(iterations=a.iterations, log_every=a.log_every, eval_every=None,
                  eval_iterations=tests, save_iterations=saves, checkpoint_iterations=ckpts,
                  seed=a.seed, gui_service=gui_service, debug_from=a.debug_from)
        if world:
            logs = train_sharded(harness, make_rank_mesh(*mesh_shape(a)),
                                 gauss_shard=a.gauss_shard, **kw)
        else:
            logs = train(harness, steps_per_call=a.steps_per_call, **kw)
    finally:
        if gui is not None:
            gui.close()
        if a.detect_anomaly:
            enable_nan_debugging(False)
        if world:
            pdist.shutdown()
    return harness, logs


def launch_ranks(a, argv) -> "pdist.LaunchResult":
    """`--mesh DxT` without `--distributed`: D·T local ranks of this command,
    each with `--distributed` and the launcher's rendezvous; rank 0's output
    is printed as it comes. Raises when a rank fails or the time runs out."""
    d, t = mesh_shape(a)
    backend = a.dist_backend or pdist.default_backend(a.device)
    extra = ["--distributed", "--dist_backend", backend]
    return pdist.launch("gaussianavatars_torch.tools.train", [*argv, *extra], d * t,
                        a.launch_timeout or None, device=a.device, echo=True).check()


if __name__ == "__main__":
    main()
