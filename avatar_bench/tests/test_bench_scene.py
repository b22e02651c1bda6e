"""The unbound scene's cell (`train_scene.py`) on a tiny run on the CPU: its
result line, traced and untraced, and the faults its check must fail (the
control, a step that leaves the state unchanged, a loss over half the
image, a step whose binning dropped tiles)."""
import json

import pytest
import torch

from avatar_bench import run as bench
from avatar_bench import trace, train_scene
from avatar_bench.trace import Trace
from gaussianavatars_torch.ops import sort_binning
from gaussianavatars_torch.training import trainer

CELL = "bicycle-train"
SIZE = dict(gaussians=2000, capacity=2048, width=96, height=64, tile=8, images=10, cameras=8)
TRAFFIC = dict(steps_per_call=4, settle_s=0.2, trace_calls=1, trace_work_every=2)


def scene_run(seed: int = 123456789012, seconds: float = 2.0) -> bench.Run:
    torch.set_num_threads(1)
    spec = bench.Spec()
    w = spec.workload(CELL)
    return bench.Run(CELL, w["chips"], dict(spec.config(w["config"]), **SIZE),
                     dict(spec.traffic(w["traffic"]), **TRAFFIC), spec.limits(CELL), seed,
                     seconds, False, torch.device("cpu"))


def fake_profile(fn, device):
    units = fn()
    return Trace(ops=[("composite_pairs_bwd_kernel<false, false>", 0, 10**6)], host=[],
                 window_s=1.0, units=units)


def test_untraced_and_traced_lines(monkeypatch):
    spec = bench.Spec()
    r = scene_run()
    r.start_window()
    train_scene.run(r)
    assert r.correct, r.checks
    out = json.loads(json.dumps(bench.result(spec, r, "cpu")))
    assert set(out["metrics"]) == {"train_images_per_s", "setup_s"}
    assert out["attempted"] == r.attempted > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap", "stats_gap"}
    monkeypatch.setattr(trace, "profile", fake_profile)
    r = scene_run()
    r.traced = True
    r.start_window()
    train_scene.run(r)
    assert r.correct, r.checks
    assert 0 < r.binning["live_pairs"] <= r.binning["slots"] and r.binning["plans"] == 4
    assert r.work["pair_pixels"] > 0
    out = bench.result(spec, r, "cpu")
    assert set(out["metrics"]) == {m["name"] for m in spec.per_layer(CELL)}
    assert 0 < out["metrics"]["binning_fill.scene"]["value"] <= 100


def test_parent_without_the_multi_view_probe_stops_first(monkeypatch):
    from gaussianavatars_torch import render

    monkeypatch.delattr(render, "probe_tile_config_views")
    with pytest.raises(RuntimeError, match="probe_tile_config_views"):
        train_scene.run(scene_run())


@pytest.mark.parametrize("kind", ["tf32", "half_image"])
def test_control_is_not_correct(kind):
    r = scene_run()
    r.finish_check(train_scene.control(r, kind))
    assert not r.correct, r.checks


@pytest.mark.parametrize("fault", ["unchanged", "loss"])
def test_broken_step_is_not_correct(monkeypatch, fault):
    original = trainer.TrainChunk.__call__

    def broken(self, state, *args):
        new, metrics = original(self, state, *args)
        if fault == "unchanged":
            return state, metrics
        return new, dict(metrics, loss=metrics["loss"] * 1.01)

    monkeypatch.setattr(trainer.TrainChunk, "__call__", broken)
    r = scene_run()
    train_scene.run(r)
    assert not r.correct, r.checks


def test_dropped_tiles_fail_the_window(monkeypatch):
    """Tier budgets too small for the views: every step drops tiles, and
    each counts as failed."""
    from gaussianavatars_torch import render

    real = render.probe_tile_config_views

    def small(*args, **kwargs):
        import dataclasses
        cfg = real(*args, **kwargs)
        return dataclasses.replace(cfg, tiers=cfg.tiers[:1])

    monkeypatch.setattr(render, "probe_tile_config_views", small)
    r = scene_run()
    train_scene.run(r)
    assert not r.correct and r.failed >= r.attempted, (r.failed, r.attempted)
    assert sort_binning.PAIRS.read()["budget_overflow"] > 0
