"""The stage-clock readers: nothing without a stamped stretch or without the
program's set-up report, and the right number from a report; the stretch
itself on the card, over a tiny served frame."""
import time

import pytest
import torch

from avatar_bench import run as bench
from avatar_bench import stages
from avatar_bench.tests.tiny import tiny_run
from gaussianavatars_torch.utils import profiling

STAMPED = {
    "flame_bind_ms.serve": 0.25, "project_sh_ms.serve": 0.5, "binning_ms.serve": 0.75,
    "composite_ms.serve": 0.125, "frame_gap_ms.serve": 0.375,
    "geometry_fwd_ms.train": 1.5, "image_fwd_ms.train": 2.0, "image_bwd_ms.train": 3.0,
    "geometry_bwd_ms.train": 4.0, "update_ms.train": 0.5 + 1.25 + 0.0625,
    "innovations_ms.train": 0.03125 + 0.046875 + 0.25 + 0.0625, "step_gap_ms.train": 0.625,
}
SETUP = ["setup_program_s.serve", "setup_program_s.train"]


def _span(mean):
    return {"mean_ms": mean, "self_ms": mean, "parent": None, "count": 10}


def _report():
    frame = {"units": 10, "gaps": 9, "gap_ms": 0.375, "spans": {
        "frame": _span(2.0), "frame/flame_bind": _span(0.25), "frame/project_sh": _span(0.5),
        "sort_gather/fwd": _span(0.75), "frame/composite": _span(0.125)}}
    step = {"units": 10, "gaps": 9, "gap_ms": 0.625, "spans": {
        "train/step": _span(12.0), "train/geometry_fwd": _span(1.5),
        "train/image_fwd": _span(2.0), "train/image_bwd": _span(3.0),
        "train/geometry_bwd": _span(4.0), "train/densify_stats": _span(0.5),
        "train/adam": _span(1.25), "train/contrastive_update": _span(0.0625),
        "train/color_net": _span(0.03125), "train/region_map": _span(0.046875),
        "train/contrastive": _span(0.25)}}
    return {"stretch": {"kinds": {"frame": frame, "train/step": step}}}


def test_setup_readers_are_declared_and_stamped_ones_held():
    declared = {m["name"] for m in bench.Spec().doc["per_layer"]}
    assert set(SETUP) <= declared
    assert not set(STAMPED) & declared


@pytest.mark.parametrize("metric", sorted(STAMPED))
def test_stamped_reader_is_none_without_a_stretch_and_reads_a_report(metric):
    r = tiny_run("base-serve")
    stages.stretch(r, lambda i: None, 4, 1, 1)      # off the card: no stretch
    assert not hasattr(r, "stages")
    assert bench.reader(metric)(r) is None
    r.stages = _report()
    assert bench.reader(metric)(r) == pytest.approx(STAMPED[metric])


def test_update_reads_what_the_cell_has():
    """Without the contrastive term, the update is statistics and Adam."""
    r = tiny_run("base-train")
    rep = _report()
    del rep["stretch"]["kinds"]["train/step"]["spans"]["train/contrastive_update"]
    r.stages = rep
    assert bench.reader("update_ms.train")(r) == pytest.approx(1.75)
    rep["stretch"]["kinds"] = {}
    assert bench.reader("update_ms.train")(r) is None
    assert bench.reader("step_gap_ms.train")(r) is None


@pytest.mark.parametrize("metric", SETUP)
def test_setup_reader_sums_the_top_level_spans_before_the_window(metric, monkeypatch):
    r = tiny_run("base-serve")
    r.start_window()
    now = time.perf_counter()
    spans = [dict(name="flame_model/init", start_s=now - 9.0, seconds=2.5, depth=0, parent=None),
             dict(name="cuda_build/load", start_s=now - 8.0, seconds=0.5, depth=1,
                  parent="flame_model/init"),
             dict(name="graphs/capture", start_s=now - 5.0, seconds=1.25, depth=0, parent=None),
             dict(name="graphs/warm_up", start_s=now - 4.0, seconds=None, depth=0, parent=None),
             dict(name="graphs/capture", start_s=now + 60.0, seconds=0.75, depth=0,
                  parent=None)]
    monkeypatch.setattr(profiling, "setup_report", lambda: dict(spans=spans))
    assert bench.reader(metric)(r) == pytest.approx(3.75)
    monkeypatch.delattr(profiling, "setup_report")
    assert bench.reader(metric)(r) is None


@pytest.mark.gpu
def test_stretch_on_the_card():
    """A stamped stretch of a tiny served frame: every frame a complete row,
    each serving reader a number, the profiled frames aligned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from avatar_bench import program, serve

    r = tiny_run("base-serve")
    r.device = torch.device("cuda", 0)
    arrays, leaves, binding, alive, shape, pose, cam = serve._inputs(r)
    model = program.flame_model(arrays, r.cfg, r.device)
    params, aux = program.gaussian_state(leaves, binding, alive)
    pcam = program.camera(cam)
    inputs = [program.flame_params(shape, pose, i) for i in range(r.traffic["poses"])]
    tile_cfg = program.probe_tile_config(model, params, aux, [(inputs[0], pcam)], r.cfg["tile"])
    rend = program.AvatarRenderer(model, params, aux, pcam, tile_cfg,
                                  sh_degree=r.cfg["sh_degree"], device=r.device)
    for i in range(3):                          # eager, capture, replay
        rend.render(inputs[i])
    r.sync()
    r.start_window()

    def frame(i):
        rend.render(inputs[i % len(inputs)])
        r.sync()

    stages.stretch(r, frame, 40, 5, 1)
    assert profiling.clock_key() is None
    assert r.stages["stretch"]["kinds"]["frame"]["units"] == 40
    assert r.stages["profiled"]["align"]["rows_matched"] == 5
    for metric in ("flame_bind_ms.serve", "project_sh_ms.serve", "binning_ms.serve",
                   "composite_ms.serve"):
        assert bench.reader(metric)(r) > 0
    assert bench.reader("frame_gap_ms.serve")(r) >= 0
    assert bench.reader("setup_program_s.serve")(r) > 0
