"""The last line's schema, traced and untraced, on tiny runs; a traced
run counts its work on the steps it traced."""
import json

import pytest

from avatar_bench import run as bench
from avatar_bench import trace, train
from avatar_bench.trace import Trace
from avatar_bench.tests.tiny import tiny_run
from gaussianavatars_torch.training import trainer


@pytest.fixture(scope="module")
def served():
    r = tiny_run("base-serve")
    r.start_window()
    bench.mode_of(r.traffic).run(r)
    return r


def test_untraced_line(served):
    spec = bench.Spec()
    served.traced, served.trace = False, None
    out = json.loads(json.dumps(bench.result(spec, served, "cpu")))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    for m in spec.end_to_end("base-serve"):
        assert out["metrics"][m["name"]]["unit"] == m["unit"] and out["metrics"][m["name"]]["value"] > 0
    assert out["device"] == {"platform": "gpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    assert set(out["checks"]) == {"frame_mae", "frame_max"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


def test_traced_line(served):
    spec = bench.Spec()
    served.traced = True
    served.work = dict(served.window_work)
    served.trace = Trace(ops=[("void composite_pairs_fwd_kernel<4>", 0, 1000), ("sort", 500, 3000),
                              ("gather", 4000, 5000)],
                         host=[("cudaGraphLaunch", 0, 5000), ("cudaStreamSynchronize", 2900, 4100)],
                         window_s=1e-5, units=1)
    out = bench.result(spec, served, "cpu")
    assert set(out["metrics"]) == {m["name"] for m in spec.per_layer("base-serve")}
    assert out["device"]["busy_s"] == pytest.approx(4e-6)
    assert out["device"]["window_s"] == 1e-5
    busy_per_frame = 4e-6
    want = 100 * (1 - busy_per_frame / (served.window_s / served.attempted))
    assert out["metrics"]["device_idle.serve"]["value"] == pytest.approx(want)
    assert out["breakdown"]["device_ops"][0] == ["sort", 2.5e-6]
    assert out["breakdown"]["idle_gaps"] == [["cudaStreamSynchronize", 1e-6]]
    assert list(out)[-1] == "checks"


def test_reader_returns_nothing_without_a_trace(served):
    served.trace = None
    assert bench.reader("compositor_fwd_roofline.serve")(served) is None
    assert bench.reader("device_idle.serve")(served) is None


def test_traced_work_is_counted_on_the_traced_steps(monkeypatch):
    stretch, counted = [], {}
    inside = [False]
    original = trainer.TrainChunk.__call__

    def spy_chunk(self, state, gt, views, *args):
        if inside[0]:
            stretch.extend(views)
        return original(self, state, gt, views, *args)

    def fake_profile(fn, device):
        inside[0] = True
        units = fn()
        inside[0] = False
        return Trace(ops=[("composite_pairs_bwd_kernel<false, false>", 0, 10**6)], host=[],
                     window_s=1.0, units=units)

    real = train.traced_work

    def spy_work(r, arrays, at, binding, alive, shape, cams, views):
        counted["views"] = list(views)
        counted["work"] = real(r, arrays, at, binding, alive, shape, cams, views)
        return counted["work"]

    monkeypatch.setattr(trainer.TrainChunk, "__call__", spy_chunk)
    monkeypatch.setattr(trace, "profile", fake_profile)
    monkeypatch.setattr(train, "traced_work", spy_work)
    r = tiny_run("base-train")
    r.traced = True
    train.run(r)
    assert r.correct, r.checks
    assert counted["views"] == stretch
    assert len(stretch) == r.traffic["trace_calls"] * r.traffic["steps_per_call"]
    assert r.work == counted["work"] and r.work["pair_pixels"] > 0
    out = bench.result(bench.Spec(), r, "cpu")
    assert set(out["metrics"]) == {m["name"] for m in bench.Spec().per_layer("base-train")}
