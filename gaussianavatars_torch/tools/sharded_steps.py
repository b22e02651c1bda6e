"""Run the sharded train step in every rank of a mesh on saved cases, and
write what each rank holds after each step.

    python -m gaussianavatars_torch.tools.sharded_steps CASES.pt --out DIR \\
        --runs 1x4 1x4:gauss_shard 2x2 [--device cpu|cuda] [--dist_backend gloo|nccl] \\
        --coordinator_address URL --num_processes N --process_id R

Each run is a mesh `DxT` of the whole world (every run the same world
size), `:gauss_shard` to shard the geometry too; the runs go one after
another in the same ranks. `run_cases` does it from one process: it
saves the cases (`torch.save`), starts the ranks through
`parallel.distributed.launch` and returns each rank's results. A case is a dict: `model` (a `FlameModel` or None), `cfg`,
`tile` (a `TileConfig`), `state` (a `TrainState`), `cameras` (a
`Camera` a data row; a mesh of D rows takes the first D), `gt` [rows, H,
W, 3], `bg`, `sh_degree` and `steps`. A rank's result for a case: the
metrics of each step, the state digest after each step
(`sharded.state_digest`), rank 0's state leaves as numpy
(`checkpoint.flatten_state`) after the first step and the last, the compositor launches of each
step, each step's milliseconds (synchronised) and the collectives'
calls, bytes and milliseconds a step (timed with `--timed`).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist

from ..data.cameras import Camera
from ..ops import composite_pairs as cp
from ..parallel import distributed as pdist
from ..parallel.mesh import make_rank_mesh
from ..parallel.sharded import (
    camera_batch, make_sharded_train_step, pad_gt_for_mesh, padded_height, state_digest,
)
from ..training.checkpoint import flatten_state
from ..training.optim import tree_map

MODULE = "gaussianavatars_torch.tools.sharded_steps"


def portable(case: dict) -> dict:
    """The case with its state's generator as a state tensor (picklable on
    every torch)."""
    st = case["state"]
    gen = None if st.generator is None else st.generator.get_state()
    return {**case, "state": dataclasses.replace(st, generator=None), "generator_state": gen}


def to_device(case: dict, dev: torch.device) -> dict:
    st = tree_map(lambda x: x.to(dev), case["state"])
    if case.get("generator_state") is not None:
        st = dataclasses.replace(st, generator=torch.Generator().set_state(
            case["generator_state"]))
    cams = [dataclasses.replace(c, **{f.name: getattr(c, f.name).to(dev)
                                      for f in dataclasses.fields(Camera)
                                      if isinstance(getattr(c, f.name), torch.Tensor)})
            for c in case["cameras"]]
    model = case["model"]
    return {**case, "state": st, "cameras": cams, "gt": case["gt"].to(dev),
            "bg": case["bg"].to(dev), "model": None if model is None else model.to(dev)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cases")
    p.add_argument("--out", required=True)
    p.add_argument("--runs", nargs="+", required=True,
                   help="meshes DATAxTILE, each with an optional ':gauss_shard'")
    p.add_argument("--timed", action="store_true",
                   help="time every collective (synchronised)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dist_backend", default=None)
    p.add_argument("--coordinator_address", default="")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p.parse_args(argv)


def run_rank(case: dict, mesh, gauss_shard: bool, backend: str, timed: bool) -> dict:
    cams = case["cameras"][:mesh.data]
    tile = case["tile"]
    step = make_sharded_train_step(case["model"], case["cfg"], tile, mesh, cams[0],
                                   gauss_shard=gauss_shard,
                                   collectives=pdist.Collectives(backend, timed=timed))
    hp = padded_height(cams[0].height, tile.tile_h, mesh.tile)
    row_cams, row_gt = pdist.make_local_batch(mesh, camera_batch(cams),
                                              pad_gt_for_mesh(case["gt"][:mesh.data], hp))
    state = case["state"]
    out = {"metrics": [], "digests": [], "launches": [], "ms": [], "collectives": []}
    cuda = row_gt.is_cuda
    for _ in range(case["steps"]):
        before = dict(cp.LAUNCHES)
        step.collectives.reset()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, row_cams, row_gt, case["bg"], case["sh_degree"])
        if cuda:
            torch.cuda.synchronize()
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["launches"].append({k: v - before[k] for k, v in cp.LAUNCHES.items()
                                if v != before[k]})
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["digests"].append(state_digest(state))
        out["collectives"].append({k: dict(v) for k, v in step.collectives.stats.items()})
        if len(out["digests"]) == 1 and mesh.rank == 0:
            out["state_first"] = {k: v.detach().cpu().numpy()
                                  for k, v in flatten_state(state).items()}
    if mesh.rank == 0:
        out["state"] = {k: v.detach().cpu().numpy() for k, v in flatten_state(state).items()}
    out["host_staged"] = step.collectives.host_staged(row_gt.device)
    return out


def parse_run(run: str) -> tuple:
    """("DxT" or "DxT:gauss_shard") → (data, tile, gauss_shard)."""
    mesh, _, opt = run.partition(":")
    if opt not in ("", "gauss_shard"):
        raise ValueError(f"run {run!r}: expected DxT or DxT:gauss_shard")
    d, t = (int(x) for x in mesh.lower().split("x"))
    return d, t, opt == "gauss_shard"


def main(argv=None) -> None:
    a = parse_args(argv)
    backend = a.dist_backend or pdist.default_backend(a.device)
    pdist.initialize(a.coordinator_address or None, a.num_processes, a.process_id,
                     backend=backend, device=a.device)
    try:
        dev = pdist.rank_device(a.device)
        cases = torch.load(a.cases, weights_only=False)
        out = []
        for run in a.runs:
            d, t, gauss_shard = parse_run(run)
            mesh = make_rank_mesh(d, t)
            out.append({"run": run, "rank": mesh.rank, "d": mesh.d, "t": mesh.t,
                        "results": [run_rank(to_device(c, dev), mesh, gauss_shard, backend,
                                             a.timed) for c in cases]})
        torch.save(out, os.path.join(a.out, f"rank{dist.get_rank()}.pt"))
    finally:
        pdist.shutdown()


def run_cases(cases: list, runs, device="cpu", backend: str | None = None,
              timeout_s: float = 300.0, timed: bool = False) -> list:
    """Launch the ranks of `runs` (["1x4", "1x4:gauss_shard", ...], one
    world size) on `cases`: for each run, each rank's {"run", "rank", "d",
    "t", "results": [one dict a case]}. Raises when a rank fails or the
    time runs out."""
    sizes = {d * t for d, t, _ in map(parse_run, runs)}
    if len(sizes) != 1:
        raise ValueError(f"runs of different world sizes: {runs}")
    world = sizes.pop()
    with tempfile.TemporaryDirectory(prefix="gsav_cases_") as tmp:
        path = os.path.join(tmp, "cases.pt")
        torch.save([portable(c) for c in cases], path)
        argv = [path, "--out", tmp, "--runs", *runs, "--device", str(device)]
        if backend:
            argv += ["--dist_backend", backend]
        if timed:
            argv.append("--timed")
        pdist.launch(MODULE, argv, world, timeout_s, device=device).check()
        by_rank = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                   for r in range(world)]
    return [[rank[i] for rank in by_rank] for i in range(len(runs))]


if __name__ == "__main__":
    main()
