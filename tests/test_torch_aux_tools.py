"""The port's auxiliary tools against the JAX package's:
`utils/roofline.py`, `utils/profiling.py`, `tools/stage_timings.py`,
`tools/local_viewer.py` and `tools/remote_viewer.py`.

* The roofline models on equal `ChipSpec` fields: every number within rtol
  1e-12 (the same float64 arithmetic in the same order); the port's default
  spec is the H100's.
* `StepTimer` as the JAX package's `tests/test_utils_aux.py:9`; `trace`
  writes a Chrome trace holding an `annotate` range, and lets an exception
  of its body through.
* `stage_timings` at a test size (the 415-face sparse sphere of
  `tests/test_torch_innovations_loop.py`, 64×48, one iteration), on both
  pipelines: every stage's ms is finite and positive.
* `local_viewer --headless` on a JAX-written model directory at 64×48: its
  PNGs are `AvatarViewerCore`'s frames byte for byte, and the table
  pipeline's (`--no_pallas`) within 1/255 of them; without `--headless`
  and without DearPyGui it falls back to headless, as the JAX script does.
* `remote_viewer --headless` against a `GuiServer` on localhost that answers
  with known frames: the PNGs hold them, and the server saw the client's
  orbit camera.
"""
import dataclasses
import json
import math
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianavatars_tpu.utils import roofline as jroof
from gaussianavatars_torch.models.io import checkpoint_ply_path
from gaussianavatars_torch.tools import local_viewer, remote_viewer, stage_timings
from gaussianavatars_torch.utils import profiling as tprof
from gaussianavatars_torch.utils import roofline as troof
from gaussianavatars_torch.viewers import network_gui as tgui
from gaussianavatars_torch.viewers.local import AvatarViewerCore
from torch_parity import torch_threads, write_jax_model_dir


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (`torch_parity.torch_threads`)."""
    with torch_threads(1):
        yield


# ------------------------------------------------------------------ roofline


def _spec_pair(**over):
    """One set of field values as both packages' ChipSpec."""
    fields = {f.name: getattr(troof.ChipSpec(), f.name) for f in dataclasses.fields(troof.ChipSpec)}
    fields.update(over)
    return jroof.ChipSpec(**fields), troof.ChipSpec(**fields)


@pytest.mark.parametrize("which", ["compositor", "sorted"])
def test_roofline_matches_jax_on_equal_specs(which):
    rng = np.random.RandomState(0)
    counts = rng.randint(0, 200, 468)
    for over in ({}, dict(vpu_flops=3.9e12, hbm_bw=8.19e11, sort_s_per_pair=2.2e-9)):
        js, ts = _spec_pair(**over)
        if which == "compositor":
            args = (counts, 128, 1024, 90112, 32.0, 550, 802)
            want = jroof.compositor_roofline(*args, chip=js)
            got = troof.compositor_roofline(*args, chip=ts)
            want2 = jroof.compositor_roofline(*args, chip=js, sort_pairs=5e5)
            got2 = troof.compositor_roofline(*args, chip=ts, sort_pairs=5e5)
            assert got2.keys() == want2.keys()
            for k in want2:
                assert got2[k] == pytest.approx(want2[k], rel=1e-12), k
        else:
            args = (counts, 1024, 90112, 200000, 550, 802)
            want = jroof.sorted_roofline(*args, chip=js)
            got = troof.sorted_roofline(*args, chip=ts)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert troof.FWD_FLOPS_PER_PAIR == jroof.FWD_FLOPS_PER_PAIR == 32.0
    assert troof.BWD_FLOPS_PER_PAIR == jroof.BWD_FLOPS_PER_PAIR == 33.0


def test_default_chip_spec_is_the_h100():
    spec = troof.ChipSpec()
    assert "H100" in spec.name
    # NVIDIA's H100 SXM5 datasheet: 67 TFLOP/s FP32, 989.4 dense BF16, 3.35 TB/s.
    assert (spec.vpu_flops, spec.mxu_flops, spec.hbm_bw) == (6.7e13, 9.894e14, 3.35e12)
    assert {f.name for f in dataclasses.fields(spec)} == {
        f.name for f in dataclasses.fields(jroof.ChipSpec)}
    rates = [getattr(spec, f.name) for f in dataclasses.fields(spec) if f.name.endswith(
        ("_per_pair", "_per_row", "_per_slot"))]
    assert len(rates) == 6 and all(0 < r < 1e-8 for r in rates)


def test_measure_primitive_rates_on_the_cpu():
    rates = troof.measure_primitive_rates("cpu", n=4096, reps=2)
    assert set(rates) == {"sort_s_per_pair", "gather_s_per_row", "wide_sort_s_per_pair",
                          "wsort_s_per_slot", "wsort2_s_per_slot", "stack_s_per_slot"}
    assert all(math.isfinite(v) and v > 0 for v in rates.values())
    spec = dataclasses.replace(troof.ChipSpec(), **rates)
    assert troof.sorted_roofline(np.ones(4), 16, 64, 128, 8, 8, chip=spec)["sol_render_fps"] > 0


# ----------------------------------------------------------------- profiling


def test_step_timer():
    t = tprof.StepTimer(sync_every=3)
    x = torch.ones((8, 8))
    samples = [t.step(sync_on=x) for _ in range(7)]
    assert samples[0] is None and samples[1] is None
    assert samples[2] is not None and samples[2] > 0
    assert samples[3] is None and samples[4] is None and samples[5] is not None
    assert t.ema_ms == samples[5]


def test_trace_writes_annotated_ranges_and_passes_exceptions(tmp_path):
    with tprof.trace(str(tmp_path / "ok")) as prof:
        with tprof.annotate("train/example"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert prof is not None
    with open(tmp_path / "ok" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "train/example" in names

    with pytest.raises(ZeroDivisionError):
        with tprof.trace(str(tmp_path / "bad")):
            1 / 0
    assert not (tmp_path / "bad").exists()


# ------------------------------------------------------------- stage timings


@pytest.fixture
def sparse_template(tmp_path, monkeypatch):
    from gaussianavatars_torch.models.flame.assets import NUM_VERTS, _uv_sphere

    verts, _uv, faces, _fuv = _uv_sphere(NUM_VERTS)
    obj = tmp_path / "sparse_sphere.obj"
    obj.write_text("".join(f"v {a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in verts)
                   + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces[::40]))
    monkeypatch.setenv("GSAVATARS_FLAME_TEMPLATE", str(obj))


@pytest.mark.parametrize("flags", [[], ["--no_pallas"]], ids=["sorted", "table"])
def test_stage_timings_runs_every_stage(sparse_template, flags):
    rows = stage_timings.main(["--device", "cpu", "--iters", "1", "--width", "64",
                               "--height", "48", "--per_face", "1", *flags])
    table = bool(flags)
    assert list(rows) == [
        "geometry (FLAME+proj+SH)",
        "geometry + table binning" if table else "geometry + sorted binning",
        "render fwd",
        "composite_tiles fwd (fixed)" if table else "composite fwd kernel (fixed)",
        "composite_tiles fwd+bwd (fixed)" if table else "composite bwd kernel (fixed)",
        "render fwd+bwd (mse)", "render fwd+bwd (L1+SSIM)", "full train step",
        "full train step (scan chunk)"]
    assert all(math.isfinite(v) and v > 0 for v in rows.values())


# ------------------------------------------------------------------- viewers


@pytest.fixture(scope="module")
def model_ply(tmp_path_factory):
    root = tmp_path_factory.mktemp("aux_viewer")
    model_dir = write_jax_model_dir(root / "ds", root / "model")[0]
    return checkpoint_ply_path(model_dir)


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def test_local_viewer_headless_writes_the_core_frames(model_ply, tmp_path):
    argv = [model_ply, "--headless", "-W", "64", "-H", "48", "--device", "cpu",
            "--n_frames", "3"]
    paths = local_viewer.main(argv + ["--out_dir", str(tmp_path / "k")])
    core = AvatarViewerCore(model_ply, width=64, height=48, device="cpu")
    assert len(paths) == 3 and core.num_timesteps == 2
    frames = [_png(p) for p in paths]
    for i, f in enumerate(frames):
        want = (np.clip(core.render(timestep=i % core.num_timesteps), 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(f, want)
    assert frames[0].any() and (frames[0] != frames[1]).any()
    table = local_viewer.main(argv + ["--out_dir", str(tmp_path / "t"), "--no_pallas"])
    for p, f in zip(table, frames):
        assert np.abs(_png(p).astype(int) - f.astype(int)).max() <= 1
    # Without DearPyGui (absent here) the window falls back to headless.
    gui = local_viewer.main([a for a in argv if a != "--headless"]
                            + ["--out_dir", str(tmp_path / "g"), "--n_frames", "1"])
    np.testing.assert_array_equal(_png(gui[0]), frames[0])


def test_remote_viewer_headless_saves_the_served_frames(tmp_path):
    w, h, n_frames = 16, 12, 2
    rng = np.random.RandomState(0)
    sent = [(rng.randint(0, 256, (h, w, 3)) / 255.0).astype(np.float32) for _ in range(n_frames)]
    server = tgui.GuiServer("127.0.0.1", 0)
    seen = []

    def serve():
        while not server.try_connect():
            threading.Event().wait(0.005)
        for i in range(n_frames):
            cam, msg = server.receive(device="cpu")
            seen.append((cam, msg))
            server.send(sent[i], {"frame": i})

    th = threading.Thread(target=serve)
    th.start()
    try:
        out = remote_viewer.main(["--port", str(server.port), "--headless", "--n_frames",
                                  str(n_frames), "-W", str(w), "-H", str(h), "--out_dir",
                                  str(tmp_path / "frames"), "--pause_training"])
    finally:
        th.join(timeout=30)
        server.close()
    assert not th.is_alive() and len(out) == n_frames
    for i, (path, stats) in enumerate(out):
        assert stats == {"frame": i}
        np.testing.assert_array_equal(_png(path), np.round(sent[i] * 255).astype(np.uint8))
    for i, (cam, msg) in enumerate(seen):
        assert (cam.width, cam.height, cam.timestep) == (w, h, i)
        assert msg["do_training"] is False and msg["keep_alive"] is True
    assert os.path.exists(tmp_path / "frames" / "00001.png")
