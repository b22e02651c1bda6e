"""Multi-process runtime plumbing over `torch.distributed`.

The port of the JAX package's `parallel/distributed.py`. One process is one
rank and drives one device (`rank_device`):

  * `initialize()` joins the world (idempotent): without arguments from
    torchrun's environment (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`,
    `RANK`, `LOCAL_RANK`), else from the JAX script's flags
    (`--coordinator_address`, `--num_processes`, `--process_id`);
  * `is_coordinator()` — the rank-0 guard for files, prints, TensorBoard
    and the viewer server;
  * `local_data_rows(mesh)` and `make_local_batch` — a rank trains its own
    data row's camera on its own row's ground truth (the counterpart of
    `make_global_batch`);
  * `Collectives` — the step's collectives in one place (sum and max
    all-reduces, the band all-gather, the reduce-scatter), with their
    calls, bytes and, when timed, host milliseconds;
  * `CoordinatorHold` — the other ranks wait, with no practical deadline,
    while rank 0 alone services the viewer or writes;
  * `launch()` — N local ranks as `python -m <module>` subprocesses,
    meeting through a `file://` store in a fresh temporary directory, with
    a wall-clock limit, the whole group killed when one rank fails.

NCCL refuses two ranks on one device ("Duplicate GPU detected"), so ranks
that share a card need gloo, which the caller asks for
(`--dist_backend gloo`, `check_backend`). The installed torch's gloo takes
CUDA tensors for every collective the step runs (all_reduce,
all_gather_into_tensor, reduce_scatter_tensor; checked on an H100 with
torch 2.11): it copies them through pinned host buffers itself, which
`Collectives.host_staged` reports.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import RankMesh

DEFAULT_TIMEOUT_S = 300.0   # a collective that waits longer raises
HOLD_TIMEOUT_S = 30 * 24 * 3600.0   # how long ranks wait for rank 0's viewer and I/O


def default_backend(device) -> str:
    """nccl on the card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device, ranks_on_host: int) -> None:
    """Raise when `backend` cannot put `ranks_on_host` ranks on this host's
    devices: NCCL takes one rank a device."""
    dev = torch.device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices; pass --dist_backend gloo")
    if backend == "nccl" and ranks_on_host > torch.cuda.device_count():
        raise ValueError(
            f"nccl cannot put {ranks_on_host} ranks on {torch.cuda.device_count()} device(s) "
            "(NCCL refuses two ranks on one device); pass --dist_backend gloo")


def rank_device(device="cuda") -> torch.device:
    """This rank's device: `cuda:{LOCAL_RANK % device_count}` for a CUDA
    request, the CPU when the caller asks for it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the world (idempotent).

    `coordinator_address` is `host:port` (a TCP store on rank 0), or a URL
    (`tcp://…`, `file://…`); it needs `num_processes` and `process_id`.
    Without it the world comes from torchrun's environment. `backend`
    defaults to `default_backend(device)`. A collective that waits longer
    than `timeout_s` raises."""
    if dist.is_initialized():
        return
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes and --process_id")
        url = coordinator_address if "://" in coordinator_address else (
            f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    else:
        url = "env://"
        world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else os.environ["RANK"])
    backend = backend or default_backend(device)
    dev = rank_device(device)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)


def shutdown() -> None:
    """Leave the world (when in one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_coordinator() -> bool:
    """Rank 0, or a process outside any world."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_data_rows(mesh: RankMesh) -> list[int]:
    """The `data` rows this rank trains: its own."""
    return [mesh.d]


def make_local_batch(mesh: RankMesh, cams, gt: torch.Tensor):
    """This rank's row of a batch: (cams [1], gt [1, H_pad, W, 3]).

    `cams` is a `sharded.CameraBatch` of every row (the sampler is seeded
    alike in every rank, so each builds the same batch); `gt` holds every
    row's ground truth or only this rank's (`local_data_rows`)."""
    if gt.shape[0] not in (1, mesh.data):
        raise ValueError(f"ground truth for {gt.shape[0]} rows on a mesh of {mesh.data}")
    row = cams.row(mesh.d)
    return row, (gt if gt.shape[0] == 1 else gt[mesh.d:mesh.d + 1])


class Collectives:
    """The collectives of the sharded step, with their bookkeeping.

    `stats[op]` holds the calls, the bytes (the operand: the gathered
    tensor of a gather, the input of a reduce-scatter) and, with `timed`,
    the host milliseconds from a synchronised start to a synchronised end.
    """

    def __init__(self, backend: str, timed: bool = False):
        self.backend = backend
        self.timed = timed
        self.stats: dict = {}

    def host_staged(self, device) -> str:
        """Where the operands of a collective on `device` travel."""
        if torch.device(device).type != "cuda":
            return "host memory (CPU tensors)"
        if self.backend == "gloo":
            return "host memory inside gloo (pinned buffers; every op, no port-side staging)"
        return "none (device to device)"

    def reset(self) -> None:
        self.stats = {}

    def _record(self, op: str, nbytes: int, fn, x: torch.Tensor):
        sync = self.timed and x.is_cuda
        if sync:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        with torch.no_grad():   # collectives take no part in autograd
            fn()
        if sync:
            torch.cuda.synchronize(x.device)
        s = self.stats.setdefault(op, {"calls": 0, "bytes": 0, "ms": 0.0})
        s["calls"] += 1
        s["bytes"] += int(nbytes)
        s["ms"] += 1e3 * (time.perf_counter() - t0) if self.timed else 0.0

    def all_reduce(self, x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
        """x reduced over `group` (None: the world) in place; `op` is "sum"
        or "max"."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        self._record(f"all_reduce_{op}", x.numel() * x.element_size(),
                     lambda: dist.all_reduce(x, op=red, group=group), x)
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
        """x of rank `src` (a world rank) into x of every rank, in place."""
        buf = x.view(torch.uint8) if x.dtype == torch.bool else x
        self._record("broadcast", x.numel() * x.element_size(),
                     lambda: dist.broadcast(buf, src, group=group), x)
        return x

    def all_gather(self, x: torch.Tensor, group) -> torch.Tensor:
        """The group's tensors stacked along dim 0, in group-rank order."""
        n = dist.get_world_size(group)
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        self._record("all_gather", out.numel() * out.element_size(),
                     lambda: gather(out, x, group=group), x)
        return out

    def reduce_scatter(self, x: torch.Tensor, group) -> torch.Tensor:
        """The group's sum of x, this rank's 1/n of it along dim 0."""
        n = dist.get_world_size(group)
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        self._record("reduce_scatter", x.numel() * x.element_size(),
                     lambda: scatter(out, x, group=group), x)
        return out

    def summary(self) -> dict:
        """Totals over every op: calls, bytes, ms."""
        return {k: (sum(s[k] for s in self.stats.values()))
                for k in ("calls", "bytes", "ms")}


class CoordinatorHold:
    """Where the other ranks wait for rank 0 while it does what only it
    does: service the viewer (a client may pause training, or keep the
    last iteration alive, for as long as it likes), evaluate, save.

    `wait` is a broadcast from rank 0 over a gloo group of its own, on a
    CPU tensor, whose timeout is HOLD_TIMEOUT_S: every rank's host blocks
    in it, so none has gone on to a collective of the step, which would
    raise after DEFAULT_TIMEOUT_S. Every rank makes the hold, in the same
    order as its other groups."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo",
                                    timeout=datetime.timedelta(seconds=HOLD_TIMEOUT_S))

    def wait(self, value: int = 0) -> int:
        """Rank 0's `value`, once rank 0 has come here."""
        flag = torch.tensor([int(value)], dtype=torch.int64)
        dist.broadcast(flag, 0, group=self.group)
        return int(flag)


# --------------------------------------------------------------------------
# The local launcher
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LaunchResult:
    rcs: list                # exit codes (None: killed before it ended)
    stdout: list             # each rank's standard output
    stderr: list
    seconds: float
    timed_out: bool

    @property
    def ok(self) -> bool:
        return not self.timed_out and all(rc == 0 for rc in self.rcs)

    def check(self) -> "LaunchResult":
        """Self when every rank exited 0; else raise with the first failing
        rank's error output."""
        if self.ok:
            return self
        bad = next((r for r, rc in enumerate(self.rcs) if rc not in (0, None)), 0)
        why = "timed out" if self.timed_out else f"rank {bad} exited {self.rcs[bad]}"
        raise RuntimeError(f"launch failed ({why}; exit codes {self.rcs}):\n"
                           f"{self.stderr[bad][-4000:]}")


def launch(module: str, argv: Sequence[str], world_size: int, timeout_s: Optional[float],
           device="cpu", env: Optional[dict] = None, cwd: Optional[str] = None,
           threads: int = 1, echo: bool = False) -> LaunchResult:
    """Run `python -m module *argv` as `world_size` local ranks.

    Each rank gets `--coordinator_address file://<fresh dir>/rendezvous
    --num_processes N --process_id r`, `LOCAL_RANK=r`,
    `LOCAL_WORLD_SIZE=N`, `OMP_NUM_THREADS=threads` (one intra-op
    thread: the ranks share the host's cores) and this checkout first on
    `PYTHONPATH`. On a CUDA `device` the
    kernels are built first, once, so the ranks load them and build none.
    The launcher waits at most `timeout_s` seconds of wall clock (None: no
    limit) and kills
    every rank when one exits non-zero or the time runs out. Each rank's
    output goes to `rank<r>.out` / `.err` in the run directory and comes
    back in the result; with `echo`, rank 0's is also copied to this
    process's `sys.stdout` / `sys.stderr` as it comes."""
    if torch.device(device).type == "cuda":
        from .. import cuda_build

        cuda_build.build()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, (env or {}).get("PYTHONPATH",
                                                             os.environ.get("PYTHONPATH")))
                           if p)
    run_dir = tempfile.mkdtemp(prefix="gsav_ranks_")
    url = f"file://{os.path.join(run_dir, 'rendezvous')}"
    procs, files = [], []
    t0 = time.perf_counter()
    for r in range(world_size):
        rank_env = {**os.environ, **(env or {}), "PYTHONPATH": path, "LOCAL_RANK": str(r),
                    "LOCAL_WORLD_SIZE": str(world_size), "OMP_NUM_THREADS": str(threads)}
        out = open(os.path.join(run_dir, f"rank{r}.out"), "w")
        err = open(os.path.join(run_dir, f"rank{r}.err"), "w")
        files.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--coordinator_address", url,
             "--num_processes", str(world_size), "--process_id", str(r)],
            stdout=out, stderr=err, stdin=subprocess.DEVNULL, env=rank_env, cwd=cwd))
    timed_out = False
    tails = [(open(os.path.join(run_dir, f"rank0.{ext}")), stream)
             for ext, stream in (("out", sys.stdout), ("err", sys.stderr))] if echo else []

    def copy_tails():
        for f, stream in tails:
            text = f.read()
            if text:
                stream.write(text)
                stream.flush()

    try:
        while True:
            rcs = [p.poll() for p in procs]
            copy_tails()
            if all(rc is not None for rc in rcs) or any(rc not in (None, 0) for rc in rcs):
                break
            if timeout_s is not None and time.perf_counter() - t0 > timeout_s:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for out, err in files:
            out.close()
            err.close()
        copy_tails()
        for f, _ in tails:
            f.close()
    seconds = time.perf_counter() - t0

    def read(r, ext):
        with open(os.path.join(run_dir, f"rank{r}.{ext}")) as f:
            return f.read()

    outs = [read(r, "out") for r in range(world_size)]
    errs = [read(r, "err") for r in range(world_size)]
    shutil.rmtree(run_dir, ignore_errors=True)
    # `rcs` as polled when the wait ended: None for the ranks killed then.
    return LaunchResult(rcs=rcs, stdout=outs, stderr=errs, seconds=seconds, timed_out=timed_out)
