"""Training on a ('data' × 'tile') mesh of cards: the program's sharded step
(`parallel/sharded.make_sharded_train_step`), one rank a card over NCCL
(gloo on the CPU), each rank one captured `ShardedStep` on the card.

Rank 0 is the harness's own process; it starts the other ranks as
`python -m avatar_bench.train_mesh --rank <k> …` and meets them at a TCP
store on localhost. Every rank makes the same inputs from the seed and
takes the same views: a step is `data` views (one a data row) of a seeded
shuffle over the ground-truth cache, each rank rasterising its row's view
in one of `tile` row bands. Rank 0 leads: before each run of steps it
broadcasts their number to the others over a gloo group (0: leave), so the
ranks run the same steps in the same order whatever rank 0 does between
them (copies for the check, the window's clock, the traced stretch).

A rank that dies or stalls ends the run. Rank 0 watches the others'
processes and the others watch rank 0's; a rank whose own steps make no
progress for `STALL_S` seconds (it waits on a peer that stalls) exits.
Whoever sees a fault first kills what it started and exits non-zero, so
the run ends within `STALL_S` + a few seconds of the fault and never
hangs. `AVATAR_BENCH_FAULT=kill:<rank>:<seconds>` plants a fault for the
check of that rule: rank <rank> kills itself <seconds> after the world
formed.

The check is `train.py`'s, on the mesh's steps: three eager steps from the
seed's inputs, a run of steps that captures, and one replayed step from
the state before it, each against `reference_mesh.step` (the plain
reference's single-view steps reduced over the data rows as the program
reduces them, then Adam). The ranks' final states must be the same bit
for bit (SHA-1 of every leaf); a rank that differs counts as failed. A
traced run stamps a stretch of steps on rank 0's stage clock
(`stages.stretch`: the spans `sharded/screen_reduce` and `sharded/reduce`)
and profiles one run of steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import os
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time

import torch

from . import check_steps, reference, reference_mesh, train
from .train import Schedule, _cpu

STALL_S = 90.0
POLL_S = 0.5
STOP = 0


class Watchdog:
    """The run's guard (see the module's docstring): a daemon thread that
    ends this process with exit code 4 when a rank it watches is gone or
    its own steps stall while `armed`."""

    def __init__(self, children=(), parent: int | None = None):
        self.children, self.parent = list(children), parent
        self.armed, self.last = False, time.monotonic()
        threading.Thread(target=self._watch, daemon=True).start()

    def beat(self) -> None:
        self.last = time.monotonic()

    def arm(self, on: bool = True) -> None:
        self.beat()
        self.armed = on

    def _end(self, why: str) -> None:
        print(f"train_mesh (pid {os.getpid()}, {time.time():.3f}): {why}; ending the run",
              file=sys.stderr, flush=True)
        for p in self.children:
            if p.poll() is None:
                p.kill()
        os._exit(4)

    def _watch(self) -> None:
        while True:
            time.sleep(POLL_S)
            for k, p in enumerate(self.children, 1):
                rc = p.poll()
                if rc not in (None, 0):
                    self._end(f"rank {k} exited {rc}")
            if self.parent is not None and os.getppid() != self.parent:
                self._end("rank 0 is gone")
            if self.armed and time.monotonic() - self.last > STALL_S:
                self._end(f"no step for {STALL_S:.0f} s")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _fault(rank: int):
    """The planted fault's deadline for this rank (monotonic), or None."""
    spec = os.environ.get("AVATAR_BENCH_FAULT", "")
    if not spec.startswith("kill:"):
        return None
    _, who, after = spec.split(":")
    return time.monotonic() + float(after) if int(who) == rank else None


class Rank:
    """One rank's program: its inputs, its sharded step and its state."""

    def __init__(self, r, rank: int, world: int, init: str, guard: Watchdog):
        import torch.distributed as dist
        from gaussianavatars_torch.parallel import distributed as pdist
        from gaussianavatars_torch.parallel.mesh import make_rank_mesh
        from gaussianavatars_torch.parallel.sharded import (
            camera_batch, make_sharded_train_step, pad_gt_for_mesh, padded_height,
        )
        from . import program

        self.r, self.rank, self.guard = r, rank, guard
        cfg, traffic = r.cfg, r.traffic
        n_data, n_tile = traffic["mesh"]
        if n_data * n_tile != world:
            raise ValueError(f"a {n_data} x {n_tile} mesh needs {n_data * n_tile} ranks")
        self.n_data = n_data
        self.inputs = train._inputs(r)
        arrays, leaves, binding, alive, shape, poses, cams, gt = self.inputs
        self.t_count = cfg["timesteps"]
        pcfg = program.program_config(cfg)
        model = program.flame_model(arrays, cfg, r.device)
        params, aux = program.gaussian_state(leaves, binding, alive)
        pcams = [program.camera(c) for c in cams]
        probe = torch.linspace(0, self.t_count - 1,
                               traffic["probe_timesteps"]).round().long().tolist()
        tile_cfg = program.probe_tile_config(
            model, params, aux,
            [(program.flame_params(shape, poses, t), c) for c in pcams for t in probe],
            cfg["tile"])
        self.state = program.train_state(params, aux, pcfg, shape, poses, self.t_count, leaves,
                                         (cams[0]["height"], cams[0]["width"]))
        backend = "nccl" if r.device.type == "cuda" else "gloo"
        guard.arm()     # a peer that never joins stalls the world's forming
        pdist.initialize(init, world, rank, backend=backend, device=r.device.type)
        guard.beat()
        self.dist = dist
        self.cmd = dist.new_group(backend="gloo")
        self.mesh = make_rank_mesh(n_data, n_tile)
        self.coll = pdist.Collectives(backend)
        self.step = make_sharded_train_step(model, pcfg, tile_cfg, self.mesh, pcams[0],
                                            cfg["spatial_lr_scale"], collectives=self.coll)
        h_pad = padded_height(cams[0]["height"], cfg["tile"], n_tile)
        self.gt = pad_gt_for_mesh(gt, h_pad)
        self.inputs = self.inputs[:-1] + (None,)
        del gt
        self.rows = [camera_batch([dataclasses.replace(c, timestep=0)]) for c in pcams]
        self.sched = Schedule(r.seed, len(cams) * self.t_count)
        self.bg = torch.zeros(3, device=r.device)
        self.fault = _fault(rank)
        self.overflowed = torch.zeros((), dtype=torch.int64, device=r.device)

    def command(self, k: int) -> int:
        """Rank 0's number of steps to run next, on every rank (0: leave)."""
        flag = torch.tensor([int(k)], dtype=torch.int64)
        self.dist.broadcast(flag, 0, group=self.cmd)
        self.guard.beat()
        return int(flag)

    def steps(self, k: int):
        """k steps from the state; the last step's metrics and the views."""
        m, taken = None, []
        for _ in range(k):
            views = self.sched.take(self.n_data)
            taken.append(views)
            v = views[self.mesh.d]
            cams = self.rows[v // self.t_count]._replace(
                timestep=torch.tensor([v % self.t_count], dtype=torch.int32))
            self.state, m = self.step(self.state, cams, self.gt[v:v + 1], self.bg,
                                      self.r.cfg["sh_degree"])
            self.overflowed += (m["budget_overflow"] > 0).to(torch.int64)
            self.guard.beat()
            if self.fault is not None and time.monotonic() > self.fault:
                print(f"train_mesh: rank {self.rank} kills itself (planted fault) at "
                      f"{time.time():.3f}", file=sys.stderr, flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
        return m, taken

    def lead(self, k: int):
        """Rank 0: have every rank run k steps."""
        self.command(k)
        return self.steps(k)

    def follow(self) -> None:
        """Ranks 1…: run what rank 0 commands until it says to leave."""
        while True:
            k = self.command(0)
            if k == STOP:
                return
            self.steps(k)

    def leave(self) -> list:
        """Every rank: the final states' digests by rank, then drop the step
        (NCCL destroys no communicator a live graph captured) and leave."""
        from gaussianavatars_torch.parallel import distributed as pdist
        from gaussianavatars_torch.parallel.sharded import state_digest

        digests = [None] * self.dist.get_world_size()
        self.dist.all_gather_object(digests, state_digest(self.state), group=self.cmd)
        self.step.drop()
        pdist.shutdown()
        self.guard.arm(False)
        return digests


def _spawn(r, world: int, init: str) -> list:
    env = dict(os.environ)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (here, env.get("PYTHONPATH")) if p)
    procs = []
    for k in range(1, world):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "avatar_bench.train_mesh", "--rank", str(k), "--world",
             str(world), "--init", init, "--workload", r.workload, "--seed", str(r.seed),
             "--seconds", str(r.seconds), "--trace", str(int(r.traced)), "--device",
             r.device.type],
            cwd=here, env=dict(env, LOCAL_RANK=str(k)), stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL))
    return procs


def run(r) -> None:
    from . import stages, trace

    n_data, n_tile = r.traffic["mesh"]
    world = n_data * n_tile
    if r.device.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"a {n_data} x {n_tile} mesh needs {world} cards")
    init = f"tcp://localhost:{_free_port()}"
    procs = _spawn(r, world, init)
    guard = Watchdog(children=procs)
    try:
        rk = Rank(r, 0, world, init, guard)
        _lead(r, rk, stages, trace)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    for k, p in enumerate(procs, 1):
        rc = p.wait(timeout=STALL_S)
        if rc != 0:
            raise RuntimeError(f"rank {k} exited {rc}")


def _lead(r, rk: Rank, stages, trace) -> None:
    from . import program

    traffic = r.traffic
    arrays, leaves, binding, alive, shape, poses, cams, _gt = rk.inputs
    start = dict(units=[], loss=[])
    for i in range(3):
        m, taken = rk.lead(1)
        start["units"] += taken
        start["loss"].append(float(m["loss"]))
        if i == 0:
            start["grad1"] = {k: v.detach().cpu() / 0.1
                              for k, v in program.adam_mu(rk.state).items()}
    start["leaves3"] = _cpu(program.state_leaves(rk.state))
    start["stats3"] = rk.state.aux.grad_accum.detach().cpu()
    k = traffic["steps_per_call"]
    rk.lead(k)
    before = program.reference_state(rk.state)
    before = {n: (_cpu(v) if isinstance(v, dict) else v.detach().cpu())
              for n, v in before.items()}
    m, taken = rk.lead(1)
    replay = dict(unit=taken[0], state=before, loss=float(m["loss"]),
                  leaves=_cpu(program.state_leaves(rk.state)),
                  grad={n: (v.detach().cpu() - 0.9 * before["mu"][n]) / 0.1
                        for n, v in program.adam_mu(rk.state).items()})
    r.sync()

    settle = time.perf_counter() + traffic["settle_s"]
    while time.perf_counter() < settle:
        m, _ = rk.lead(k)
        float(m["loss"])
    rk.overflowed.zero_()
    host, steps = [], 0
    r.start_window()
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        m, _ = rk.lead(k)
        host.append(time.perf_counter() - t0)
        last = float(m["loss"])
        t1 = time.perf_counter()
        steps += k
        if t1 - t_start >= r.seconds:
            break
    r.window_s = t1 - t_start
    dropped = int(rk.overflowed)
    r.attempted = steps * rk.n_data
    r.memory_peak = r.peak_memory()
    r.e2e["train_images_per_s"] = r.attempted / r.window_s
    r.host_ms = [h * 1e3 for h in host]
    r.captures = rk.step.captures
    r.note(f"steps {steps} ({r.attempted} views) in {r.window_s:.6f} s, run call ms median "
           f"{statistics.median(host) * 1e3:.6f}, last loss {last:.6f}, steps that dropped "
           f"tiles {dropped}; collectives since set-up {rk.coll.summary()}")
    traced = []
    if r.traced:
        def unit(_i):
            float(rk.lead(traffic["stamp_steps"])[0]["loss"])

        stages.stretch(r, unit, traffic["stamp_units"], 1, traffic["stamp_steps"])
        at_trace = _cpu(program.state_leaves(rk.state))

        def stretch():
            mu, taken = rk.lead(k)
            traced.extend(taken)
            return k
        r.trace = trace.profile(stretch, r.device)
    rk.command(STOP)
    digests = rk.leave()
    drift = sum(d != digests[0] for d in digests)
    r.note(f"final state digests by rank {digests}")
    used = sorted({v for p in start["units"] + [replay["unit"]] for v in p})
    gt_used = {v: rk.gt[v, :cams[0]["height"]].clone() for v in used}
    del rk, m
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    r.finish_check(check(r, arrays, leaves, binding, alive, shape, poses, cams, gt_used, start,
                         replay))
    r.failed += dropped + drift
    if traced:
        views = [v for p in traced for v in p]
        r.work = train.traced_work(r, arrays, at_trace, binding, alive, shape, cams,
                                   views[::traffic["trace_work_every"]])


def _reference(r, arrays, leaves, binding, alive, shape, poses, cams, gt_used, prec, fault=""):
    """The mesh reference's (initial state, step(state, views),
    rebuild(saved program state)) for `check_steps`."""
    flame = reference.Flame(arrays, r.device, prec)

    def step(st, views):
        return reference_mesh.step(r, flame, st, views, gt_used, cams, prec, fault)

    def rebuild(a):
        dev = lambda t: {k: x.to(r.device) for k, x in t.items()}  # noqa: E731
        return reference.TrainState(
            leaves=dev(a["leaves"]), mu=dev(a["mu"]), nu=dev(a["nu"]), step=int(a["step"]),
            binding=binding, alive=alive, shape=shape, grad_accum=a["grad_accum"].to(r.device),
            denom=a["denom"].to(r.device))
    return train._initial(r, leaves, binding, alive, shape, poses), step, rebuild


def check(r, arrays, leaves, binding, alive, shape, poses, cams, gt_used, start, replay) -> dict:
    """`check_steps.check` against `reference_mesh.step`."""
    st0, step, rebuild = _reference(r, arrays, leaves, binding, alive, shape, poses, cams,
                                    gt_used, reference.Precision())
    return check_steps.check(r, st0, start, replay, step, rebuild)


def control(r, kind: str) -> dict:
    """A stand-in for the ranks: the mesh reference in TF32 ("tf32"), or in
    float32 with the loss over the top half of the image ("half_image"),
    through the same steps; then the check as a run makes it."""
    if kind not in ("tf32", "half_image"):
        raise ValueError(f"training has no control {kind!r}")
    n_data = r.traffic["mesh"][0]
    arrays, leaves, binding, alive, shape, poses, cams, gt = train._inputs(r)
    sched = Schedule(r.seed, len(cams) * r.cfg["timesteps"])
    pairs = [sched.take(n_data) for _ in range(3)]
    sched.take(n_data * r.traffic["steps_per_call"])
    pair = sched.take(n_data)
    gt_used = {v: gt[v].clone() for p in pairs + [pair] for v in p}
    del gt
    prec = reference.precision("tf32" if kind == "tf32" else "float32")
    st0, stand_in, _ = _reference(r, arrays, leaves, binding, alive, shape, poses, cams,
                                  gt_used, prec, "half_image" if kind == "half_image" else "")
    _, step, rebuild = _reference(r, arrays, leaves, binding, alive, shape, poses, cams,
                                  gt_used, reference.Precision())
    return check_steps.control(r, st0, pairs, pair, stand_in, step, rebuild)


def worker(argv=None) -> int:
    """A rank other than 0: the same inputs, then rank 0's commands."""
    p = argparse.ArgumentParser(description="one rank of a mesh cell (started by rank 0)")
    for name in ("--workload", "--init", "--device"):
        p.add_argument(name, required=True)
    for name in ("--rank", "--world", "--seed", "--trace"):
        p.add_argument(name, type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    guard = Watchdog(parent=os.getppid())
    from . import run as bench

    if a.device == "cuda":
        from . import program  # noqa: F401  (the kernels, built by rank 0, load here)
        device = torch.device("cuda", a.rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    r = bench.Run.from_spec(bench.Spec(), a.workload, a.seed, a.seconds, bool(a.trace), device)
    r.cfg, r.traffic = _sized(r.cfg, r.traffic)
    rk = Rank(r, a.rank, a.world, a.init, guard)
    rk.follow()
    rk.leave()
    return 0


def _sized(cfg: dict, traffic: dict):
    """The configuration and traffic as rank 0 runs them: rank 0 passes a
    cut copy to the others through `AVATAR_BENCH_MESH_SIZE` (JSON), which
    only the benchmark's own tests set."""
    import json

    cut = os.environ.get("AVATAR_BENCH_MESH_SIZE")
    if not cut:
        return cfg, traffic
    c, t = json.loads(cut)
    return dict(cfg, **c), dict(traffic, **t)


if __name__ == "__main__":
    sys.exit(worker())
