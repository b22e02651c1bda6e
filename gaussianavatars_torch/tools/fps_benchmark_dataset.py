"""FPS benchmark from a dataset camera (the reference's
`fps_benchmark_dataset.py`).

The port of the JAX package's `scripts/fps_benchmark_dataset.py`, with
`--device`: loads the trained model directory and its dataset, and renders
the first camera of `--split` (the training split when that one is empty)
`n_iter` × `n_rounds` times with the FLAME mesh updated every frame, timed
as `fps_benchmark_demo.run_benchmark` times its frames. The tier budgets
are probed from that camera's view (the JAX script keeps the defaults).

    python -m gaussianavatars_torch.tools.fps_benchmark_dataset -m MODEL_DIR \\
        [--split test] [--n_iter 500] [--n_rounds 3] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os

from ..config import from_json
from ..data.scene import Scene
from ..models.io import checkpoint_ply_path
from ..viewers.local import AvatarViewerCore
from .fps_benchmark_demo import run_benchmark


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--split", default="test")
    p.add_argument("--n_iter", type=int, default=500)
    p.add_argument("--n_rounds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Frames per second of each round."""
    a = parse_args(argv)
    with open(os.path.join(a.model_path, "cfg_args.json")) as f:
        cfg = from_json(f.read())
    core = AvatarViewerCore(checkpoint_ply_path(a.model_path, a.iteration), device=a.device)
    scene = Scene(
        cfg.model.source_path, resolution=cfg.model.resolution,
        white_background=cfg.model.white_background, eval_split=cfg.model.eval,
        num_verts_hint=core.model.num_verts if core.model else 0, device=core.device,
    )
    cam = (scene.cameras(a.split) or scene.cameras("train"))[0]
    core.probe_tiles(cam)
    print(f"{core.num_points} Gaussians; view {cam.width}x{cam.height}")
    fps = run_benchmark(core, a.n_iter, a.n_rounds, camera=cam)
    for rd, f in enumerate(fps):
        print(f"round {rd}: {f:.1f} FPS")
    return fps


if __name__ == "__main__":
    main()
