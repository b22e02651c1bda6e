"""FPS benchmark on a trained avatar (the reference protocol).

The port of the JAX package's `scripts/fps_benchmark_demo.py`
(`fps_benchmark_demo.py:53-80` of the reference): a fixed orbit-camera view
at 802×550, `n_iter` renders × `n_rounds`, the FLAME mesh updated in every
frame. Each frame's jaw is `jaw + s·1e-9` with `s` carried from the
previous frame's image (`frame_chain`, the JAX script's `frame(c, i)`), so
every frame depends on the one before. As the JAX script chains its
frames in one jitted `fori_loop`, so that host dispatch is left out, the
port captures one frame of the chain in a CUDA graph on the card and
replays it `n_iter` times a round, synchronised once at the round's end
and timed by the host clock (`run_chain`); on the CPU the chain is a host
loop. `--no_pallas` renders through the table pipeline
(`AvatarViewerCore(use_pallas=False)`).

    python -m gaussianavatars_torch.tools.fps_benchmark_demo POINT_CLOUD.ply \\
        [--n_iter 500] [--n_rounds 3] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch

from ..utils.graphs import Captured, warm_up
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


def frame_chain(core: AvatarViewerCore, camera=None, animate_timesteps: bool = True) -> Callable:
    """The benchmark's frame as a function of the carried scalar, the JAX
    script's `frame(c, i)`: s → (image [H, W, 3], s + image[0, 0, 0]·0),
    timestep 0 from `camera` (default: the core's orbit camera) on a black
    background, its jaw `jaw + s·1e-9` when `animate_timesteps`."""
    dev = core.device
    cam = camera if camera is not None else core.cam.to_camera(device=dev)
    fp0 = core.flame_params_at(0) if core.model is not None else None
    bg = torch.zeros(3, device=dev)

    @torch.inference_mode()
    def frame(s: torch.Tensor) -> tuple:
        fp = fp0
        if fp0 is not None and animate_timesteps:
            fp = fp0._replace(jaw=fp0.jaw + s * 1e-9)
        img = core.render_tensor(fp, cam, sh_degree=3, bg=bg)
        return img, s + img[0, 0, 0] * 0

    return frame


@torch.inference_mode()
def run_chain(frame: Callable, dev: torch.device, n_iter: int, n_rounds: int) -> tuple:
    """`n_rounds` rounds of `n_iter` chained frames, each round from s = 0
    as the JAX script restarts its loop from `init`: (frames/s of each
    round, the last image, the last s). On the card, after N_WARMUP eager
    frames on a side stream, one frame of the chain is captured in a CUDA
    graph (`utils/graphs.Captured`) that writes its s back into the buffer
    it reads, and a round is `n_iter` replays and one synchronisation; on
    the CPU a round is a host loop."""
    s, img = torch.zeros((), device=dev), None
    if dev.type != "cuda":
        for _ in range(min(N_WARMUP, n_iter)):
            img, s = frame(s)
        fps = []
        for _ in range(n_rounds):
            s = torch.zeros((), device=dev)
            t0 = time.perf_counter()
            for _ in range(n_iter):
                img, s = frame(s)
            fps.append(n_iter / (time.perf_counter() - t0))
        return fps, img, s

    def warm():
        c = torch.zeros((), device=dev)
        for _ in range(N_WARMUP):
            _img, c = frame(c)

    def step():
        img, s_next = frame(s)
        s.copy_(s_next)
        return img

    warm_up(dev, warm)
    g = Captured(None, step)
    fps = []
    for _ in range(n_rounds):
        s.zero_()
        t0 = time.perf_counter()
        g.replay(n_iter)
        _sync(dev)
        fps.append(n_iter / (time.perf_counter() - t0))
    return fps, g.outputs.clone(), s.clone()


def run_benchmark(core: AvatarViewerCore, n_iter: int, n_rounds: int,
                  animate_timesteps: bool = True, camera=None) -> list:
    """Frames per second of each round: `n_iter` chained renders of
    timestep 0 from `camera` (default: the core's orbit camera), the mesh
    updated every frame when `animate_timesteps` (`run_chain`)."""
    return run_chain(frame_chain(core, camera, animate_timesteps), core.device, n_iter,
                     n_rounds)[0]


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
