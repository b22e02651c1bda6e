"""One run of one benchmark cell of the port (`gaussianavatars_torch`).

    python3 -m avatar_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name from `BENCHMARK.json`: the
configuration's file (`configs/`), the traffic mix's file (`traffic/`,
whose `mode` names the module that drives the program: `serve.py` or `train.py`), the check's
limits (`limits/<cell>.json`) and each per-layer metric's reader
(`metrics/<metric>.py`, a `read(run)` that returns a number or None).

A run makes its inputs from the seed on the card, sets up and warms up the
program, measures for `--seconds`, reads the peak memory, frees the
program, checks what the window produced against the plain reference
(`reference.py`), and prints one JSON line: the end-to-end metrics with
`--trace 0`, the per-layer metrics of a profiled stretch after the window
with `--trace 1`. The compared numbers and their limits come last, on
standard error and in the line. It exits non-zero, with no line, without
a card, or when the process holds JAX or the JAX package.

`--control tf32|half_image` runs the check's control (the reference in
TF32 in the program's place) or a planted fault instead of the program,
and prints the readings; the benchmark's own runs never pass it.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "gaussianavatars_tpu"}


def _process_age_s() -> float:
    """Seconds since this process started (the kernel's start time, so the
    interpreter's own start and imports count)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class Spec:
    """`BENCHMARK.json` and the files it names."""

    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        self.doc = json.loads(path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((ROOT / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    @staticmethod
    def traffic(name: str) -> dict:
        return json.loads((HERE / "traffic" / f"{name}.json").read_text())

    @staticmethod
    def limits(workload: str) -> dict:
        return json.loads((HERE / "limits" / f"{workload}.json").read_text())

    def end_to_end(self, workload: str) -> list[dict]:
        return [m for m in self.doc["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        return [m for m in self.doc["per_layer"] if workload in m["workloads"]]


def reader(metric: str):
    """The `read` function of `metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"avatar_bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """One run: what the cell is, and what the cell measured and checked."""

    def __init__(self, workload: str, chips: int, cfg: dict, traffic: dict, limits: dict,
                 seed: int, seconds: float, traced: bool, device):
        self.workload, self.chips, self.cfg, self.traffic = workload, chips, cfg, traffic
        self.limits, self.seed, self.seconds, self.traced = limits, seed, seconds, traced
        self.device = device
        self.e2e: dict = {}
        self.host_ms: list = []
        self.trace = None
        self.work: dict = {}          # the traced frames' or steps' work, a unit's mean
        self.window_work: dict = {}   # the compared frames' work (a sample of the window's)
        self.checks: dict = {}
        self.failed = 0
        self.compared = 0
        self.attempted = 0
        self.window_s = 0.0
        self.memory_peak = 0
        self.captures = 0
        self.setup_s = None

    @classmethod
    def from_spec(cls, spec: Spec, workload: str, seed: int, seconds: float, traced: bool,
                  device) -> "Run":
        w = spec.workload(workload)
        return cls(workload, w["chips"], spec.config(w["config"]), spec.traffic(w["traffic"]),
                   spec.limits(workload), seed, seconds, traced, device)

    def start_window(self) -> None:
        self.setup_s = _process_age_s()

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def peak_memory(self) -> int:
        import torch
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    @staticmethod
    def note(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def finish_check(self, res: dict) -> None:
        self.checks = {k: (v, self.limits[k]) for k, v in res["numbers"].items()}
        self.failed, self.compared = res["failed"], res["compared"]

    @property
    def correct(self) -> bool:
        return (self.compared > 0 and self.failed == 0
                and all(v <= lim for v, lim in self.checks.values()))


def mode_of(traffic: dict):
    return importlib.import_module(f"avatar_bench.{traffic['mode']}")


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "not read"


def forbidden_modules() -> set:
    return {m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN


def result(spec: Spec, r: Run, name: str) -> dict:
    if r.traced:
        metrics = {}
        for m in spec.per_layer(r.workload):
            v = reader(m["name"])(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(r.e2e, setup_s=r.setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(r.workload)}
    device = {"platform": "gpu", "kind": name, "count": r.chips,
              "memory_peak_bytes": int(r.memory_peak)}
    out = {"correct": r.correct, "attempted": r.attempted, "failed": r.failed,
           "metrics": metrics, "device": device}
    if r.trace is not None:
        device["busy_s"] = r.trace.busy_s()
        device["window_s"] = r.trace.window_s
        out["breakdown"] = {"device_ops": r.trace.top_ops(), "idle_gaps": r.trace.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in r.checks.items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32", "half_image"), default=None,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    # Build and kernel caches of the program live in fixed directories of
    # the checkout.
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

    import torch

    spec = Spec()
    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    r = Run.from_spec(spec, args.workload, args.seed, args.seconds, bool(args.trace), device)
    mode = mode_of(r.traffic)
    card = f"{torch.cuda.get_device_name(device)} ({power_limit()})"
    if args.control:
        res = mode.control(r, args.control)
        r.finish_check(res)
        r.note(f"control {args.control} on {card}: correct {r.correct}")
        print(json.dumps({"control": args.control, "correct": r.correct,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in r.checks.items()}}))
        return 0
    from . import program

    program.cuda_build.build()
    mode.run(r)
    bad = forbidden_modules()
    if bad:
        print(f"the process holds {sorted(bad)}: the port must not load them", file=sys.stderr)
        return 3
    out = result(spec, r, torch.cuda.get_device_name(device))
    r.note(f"card {card}; "
           f"captures {r.captures}; compared {r.compared}; "
           f"host ms median {statistics.median(r.host_ms):.6f}; work {r.work}")
    for k, (v, lim) in r.checks.items():
        r.note(f"check {k} {v:.9g} limit {lim:.9g}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
