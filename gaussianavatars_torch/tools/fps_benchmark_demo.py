"""FPS benchmark on a trained avatar (the reference protocol).

The port of the JAX package's `scripts/fps_benchmark_demo.py`
(`fps_benchmark_demo.py:53-80` of the reference): a fixed orbit-camera view
at 802×550, `n_iter` renders × `n_rounds`, the FLAME mesh updated in every
frame. The frames are a host loop of renders (FLAME forward, binding,
sorted binning, the forward compositor), synchronised at the end of each
round and timed by the host clock, as the reference times them. Each
frame's jaw is `jaw + s·1e-9` with `s` taken from the previous frame's
image, so every frame depends on the one before.

    python -m gaussianavatars_torch.tools.fps_benchmark_demo POINT_CLOUD.ply \\
        [--n_iter 500] [--n_rounds 3] [--device cuda|cpu]

`--no_pallas` raises: only the kernel pipeline is ported.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ..viewers.local import AvatarViewerCore

N_WARMUP = 5  # frames before the first round: allocator, library load, first launches


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("point_path", help="trained point_cloud.ply")
    p.add_argument("--flame_assets", default="")
    p.add_argument("--width", type=int, default=802)
    p.add_argument("--height", type=int, default=550)
    p.add_argument("--n_iter", type=int, default=500)
    p.add_argument("--n_rounds", type=int, default=3)
    p.add_argument("--no_pallas", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def run_benchmark(core: AvatarViewerCore, n_iter: int, n_rounds: int,
                  animate_timesteps: bool = True, camera=None) -> list:
    """Frames per second of each round: `n_iter` renders of timestep 0 from
    `camera` (default: the core's orbit camera), the mesh updated every
    frame when `animate_timesteps`."""
    dev = core.device
    cam = camera if camera is not None else core.cam.to_camera(device=dev)
    fp0 = core.flame_params_at(0) if core.model is not None else None
    bg = torch.zeros(3, device=dev)

    def frame(s: torch.Tensor) -> torch.Tensor:
        fp = fp0
        if fp0 is not None and animate_timesteps:
            fp = fp0._replace(jaw=fp0.jaw + s * 1e-9)
        img = core.render_tensor(fp, cam, sh_degree=3, bg=bg)
        return s + img[0, 0, 0] * 0

    s = torch.zeros((), device=dev)
    for _ in range(min(N_WARMUP, n_iter)):
        s = frame(s)
    _sync(dev)
    fps = []
    for _ in range(n_rounds):
        t0 = time.perf_counter()
        for _ in range(n_iter):
            s = frame(s)
        _sync(dev)
        fps.append(n_iter / (time.perf_counter() - t0))
    return fps


def main(argv=None) -> list:
    a = parse_args(argv)
    core = AvatarViewerCore(
        a.point_path, flame_assets=a.flame_assets, width=a.width, height=a.height,
        use_pallas=None if not a.no_pallas else False, device=a.device,
    )
    print(f"{core.num_points} Gaussians, {core.num_timesteps} timesteps")
    fps = run_benchmark(core, a.n_iter, a.n_rounds)
    for i, f in enumerate(fps):
        print(f"round {i}: {f:.1f} FPS")
    print(f"mean: {np.mean(fps):.1f} FPS at {a.width}x{a.height}")
    return fps


if __name__ == "__main__":
    main()
