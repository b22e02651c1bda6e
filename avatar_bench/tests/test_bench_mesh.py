"""The 2×2 mesh cell (`train_mesh.py`) on the CPU: four gloo ranks at the
tiny avatar's size (rank 0 hands the cut sizes to the others through
`AVATAR_BENCH_MESH_SIZE`). Its result line, traced and untraced; the
faults its check must fail (the control, a rank 0 whose step leaves its
state unchanged); and a rank killed mid-run ends the run non-zero within
the watchdog's time, never hanging."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from avatar_bench import run as bench
from avatar_bench import trace, train_mesh
from avatar_bench.tests.tiny import TINY
from avatar_bench.trace import Trace
from gaussianavatars_torch.parallel import sharded

CELL = "base-train-mesh2x2"
TRAFFIC = dict(steps_per_call=3, settle_s=0.2, probe_timesteps=2, stamp_units=1, stamp_steps=2)


def mesh_run(monkeypatch, seed: int = 123456789012) -> bench.Run:
    torch.set_num_threads(1)
    monkeypatch.setenv("AVATAR_BENCH_MESH_SIZE", json.dumps([TINY, TRAFFIC]))
    spec = bench.Spec()
    w = spec.workload(CELL)
    return bench.Run(CELL, w["chips"], dict(spec.config(w["config"]), **TINY),
                     dict(spec.traffic(w["traffic"]), **TRAFFIC), spec.limits(CELL), seed, 2.0,
                     False, torch.device("cpu"))


def test_untraced_and_traced_lines(monkeypatch):
    spec = bench.Spec()
    r = mesh_run(monkeypatch)
    r.start_window()
    train_mesh.run(r)
    assert r.correct, r.checks
    out = json.loads(json.dumps(bench.result(spec, r, "cpu")))
    assert set(out["metrics"]) == {"train_images_per_s", "setup_s"}
    assert out["attempted"] == r.attempted and r.attempted % 2 == 0 and out["failed"] == 0
    assert out["device"]["count"] == 4

    def fake_profile(fn, device):
        units = fn()
        return Trace(ops=[("ncclKernel", 0, 10**6)], host=[], window_s=1.0, units=units)

    monkeypatch.setattr(trace, "profile", fake_profile)
    r = mesh_run(monkeypatch)
    r.traced = True
    r.start_window()
    train_mesh.run(r)
    assert r.correct, r.checks
    assert r.work["pair_pixels"] > 0
    out = bench.result(spec, r, "cpu")
    # The CPU has no stage clock: the collectives' reading needs the card.
    assert set(out["metrics"]) == {"step_mfu.mesh"}
    assert out["metrics"]["step_mfu.mesh"]["value"] > 0


@pytest.mark.parametrize("kind", ["tf32", "half_image"])
def test_control_is_not_correct(monkeypatch, kind):
    r = mesh_run(monkeypatch)
    r.finish_check(train_mesh.control(r, kind))
    assert not r.correct, r.checks


def test_rank0_unchanged_is_not_correct(monkeypatch):
    """Rank 0's step runs (its collectives with it) but hands back the
    state it was given: the check fails, and so do the ranks' digests."""
    original = sharded.ShardedStep.__call__
    monkeypatch.setattr(sharded.ShardedStep, "__call__",
                        lambda self, state, *a, **k: (state, original(self, state, *a, **k)[1]))
    r = mesh_run(monkeypatch)
    train_mesh.run(r)
    assert not r.correct and r.failed > 0, (r.checks, r.failed)


def test_killed_rank_ends_the_run(monkeypatch, tmp_path):
    """Rank 2 kills itself 3 s after the world forms: the run exits non-zero
    well within the watchdog's limit."""
    script = tmp_path / "mesh.py"
    script.write_text(
        "import json, os, sys, torch\n"
        "from avatar_bench import run as bench, train_mesh\n"
        "size, traffic = json.loads(os.environ['AVATAR_BENCH_MESH_SIZE'])\n"
        "spec = bench.Spec(); w = spec.workload(sys.argv[1])\n"
        "r = bench.Run(w['name'], 4, dict(spec.config(w['config']), **size),\n"
        "              dict(spec.traffic(w['traffic']), **traffic), spec.limits(w['name']),\n"
        "              1, 60.0, False, torch.device('cpu'))\n"
        "train_mesh.run(r)\n")
    env = dict(os.environ, AVATAR_BENCH_MESH_SIZE=json.dumps([TINY, TRAFFIC]),
               AVATAR_BENCH_FAULT="kill:2:3", PYTHONPATH=str(bench.ROOT))
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, str(script), CELL], cwd=bench.ROOT, env=env,
                         capture_output=True, text=True, timeout=train_mesh.STALL_S + 60)
    assert out.returncode != 0
    assert time.monotonic() - t0 < train_mesh.STALL_S
    assert "rank 2 kills itself" in out.stderr, out.stderr[-2000:]
