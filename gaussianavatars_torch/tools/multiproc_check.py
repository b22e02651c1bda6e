"""Real multi-process check of the sharded step: two ranks, eight steps.

The port of the JAX package's `scripts/multiproc_check.py`. It starts TWO
ranks on this host (`parallel/distributed.launch`: `python -m` of this
module, meeting through a `file://` store in a fresh temporary directory)
on a data = 2 mesh, each rank training its own camera, and checks what a
single process cannot reach:

  * `initialize` from the explicit flags, `make_rank_mesh`,
    `local_data_rows` and `make_local_batch` (each rank reads its own
    row's ground truth only);
  * eight sharded steps;
  * at step 4 an eval-style render of the state on rank 0 alone (no
    collective) and a save from rank 0 only.

Exit 0: both ranks finished, their losses finite and bit-identical, their
final state digests equal, the rank-0 save present and no other, and the
loss fell.

    python -m gaussianavatars_torch.tools.multiproc_check [--device cpu|cuda] \\
        [--dist_backend gloo|nccl]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

N_PROC = 2
STEPS = 8
MODULE = "gaussianavatars_torch.tools.multiproc_check"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on the card, gloo on the CPU (two ranks on one card "
                        "need gloo)")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds the two ranks may run")
    p.add_argument("--worker", default="", help=argparse.SUPPRESS)
    p.add_argument("--coordinator_address", default="", help=argparse.SUPPRESS)
    p.add_argument("--num_processes", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--process_id", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def worker(a) -> None:
    from ..config import Config
    from ..data.cameras import look_at_camera
    from ..models.gaussians import init_from_points
    from ..ops.rasterize_tiled import TileConfig
    from ..parallel import distributed as pdist
    from ..parallel.mesh import make_rank_mesh
    from ..parallel.sharded import (
        camera_batch, make_sharded_train_step, pad_gt_for_mesh, padded_height, state_digest,
    )
    from ..training.loop import make_render_fn
    from ..training.trainer import init_train_state

    backend = a.dist_backend or pdist.default_backend(a.device)
    pdist.initialize(a.coordinator_address, a.num_processes, a.process_id, backend=backend,
                     device=a.device)
    try:
        dev = pdist.rank_device(a.device)
        tile = TileConfig(tile_h=8, tile_w=16, capacity=128, max_tiles_per_gaussian=16)
        mesh = make_rank_mesh(data=N_PROC, tile=1)
        # The same scene in every rank (the replicated-state invariant).
        rng = np.random.RandomState(0)
        pts = rng.randn(48, 3).astype(np.float32) * 0.3
        cols = rng.rand(48, 3).astype(np.float32)
        params, aux = init_from_points(pts, cols, capacity=64, device=dev)
        cams = [look_at_camera(eye=(0, 0, -2.5), fovy=0.8, width=32, height=32, device=dev),
                look_at_camera(eye=(0.3, 0.1, -2.4), fovy=0.8, width=32, height=32,
                               device=dev)]
        cfg = Config()
        state = init_train_state(params, aux, cfg)
        step = make_sharded_train_step(None, cfg, tile, mesh, cams[0])
        hp = padded_height(32, tile.tile_h, mesh.tile)
        gt_full = torch.stack([torch.tensor([0.3, 0.5, 0.7]).expand(32, 32, 3),
                               torch.tensor([0.6, 0.2, 0.1]).expand(32, 32, 3)])
        rows = pdist.local_data_rows(mesh)
        bg = torch.zeros(3, device=dev)
        losses = []
        for it in range(STEPS):
            # Each rank fetches its own rows' ground truth only.
            gt_local = pad_gt_for_mesh(gt_full[rows], hp).to(dev)
            row_cams, row_gt = pdist.make_local_batch(mesh, camera_batch(cams), gt_local)
            state, metrics = step(state, row_cams, row_gt, bg, 0)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"step {it}: loss {loss}")
            losses.append(loss)
            if it == STEPS // 2 and pdist.is_coordinator():
                # Eval-style: a render on rank 0 alone makes no collective.
                with torch.no_grad():
                    img = make_render_fn(None, cfg, tile)(state, cams[0], 0, bg, 0)
                if not bool(torch.isfinite(img).all()):
                    raise FloatingPointError("rank-0 render is not finite")
                np.savez(os.path.join(a.worker, "ckpt.npz"),
                         means=state.params.means.detach().cpu().numpy())
        with open(os.path.join(a.worker, f"proc{mesh.rank}.json"), "w") as f:
            json.dump({"losses": losses, "digest": state_digest(state),
                       "rows": rows}, f)
        if pdist.is_coordinator():
            print(f"[rank 0] done, losses {losses[0]:.5f} -> {losses[-1]:.5f}")
    finally:
        pdist.shutdown()


def main(argv=None) -> int:
    a = parse_args(argv)
    if a.worker:
        worker(a)
        return 0
    from ..parallel import distributed as pdist

    backend = a.dist_backend or pdist.default_backend(a.device)
    pdist.check_backend(backend, a.device, N_PROC)
    with tempfile.TemporaryDirectory(prefix="gsav_mp_") as out_dir:
        res = pdist.launch(MODULE, ["--worker", out_dir, "--device", a.device,
                                    "--dist_backend", backend], N_PROC, a.timeout,
                           device=a.device).check()
        logs = []
        for p in range(N_PROC):
            with open(os.path.join(out_dir, f"proc{p}.json")) as f:
                logs.append(json.load(f))
        saves = sorted(os.listdir(out_dir))
        if logs[0]["losses"] != logs[1]["losses"]:
            raise AssertionError(f"loss trajectories diverged across ranks: {logs}")
        if logs[0]["digest"] != logs[1]["digest"]:
            raise AssertionError("the ranks' final states differ")
        if [lg["rows"] for lg in logs] != [[0], [1]]:
            raise AssertionError(f"data rows {[lg['rows'] for lg in logs]}")
        if "ckpt.npz" not in saves or res.stdout[1]:
            raise AssertionError(f"rank-0 save missing or rank 1 printed: {saves}, "
                                 f"{res.stdout[1]!r}")
        if not logs[0]["losses"][-1] < logs[0]["losses"][0]:
            raise AssertionError(f"loss did not fall: {logs[0]['losses']}")
    sys.stdout.write(res.stdout[0])
    print(f"multiproc check OK: {N_PROC} ranks ({backend}, {a.device}), {STEPS} steps, loss "
          f"{logs[0]['losses'][0]:.5f} -> {logs[0]['losses'][-1]:.5f}, rank-0 save present, "
          f"{res.seconds:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
