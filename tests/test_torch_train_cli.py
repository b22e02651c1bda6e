"""The port's training CLI (`tools/train.py`) and ablation runner
(`tools/run_ablation.sh`) against the JAX package's `scripts/train.py` and
`scripts/run_ablation.sh`:

* `parse_args`: every JAX action's dest, default, option strings, type,
  nargs and required flag (the port adds `--device`);
* `config_from_args`: the JAX script's configuration (its `to_json`,
  section by section, on the port's fields) for the default flags and for
  `--all_innovations --use_amp`;
* `--no_pallas` configures the table pipeline as the JAX script does; the
  six multi-device flags parse to the JAX script's configuration,
  `--mesh 2x2` starts four local ranks whose `main` reaches
  `train_sharded`, `--distributed` joins a world from the flags or
  torchrun's environment, and NCCL with two ranks on one device raises
  and names `--dist_backend gloo`; without `--device cpu` there is no card
  to run on;
* two short CPU runs through `main`: FLAME-bound on the 415-face sparse
  sphere of `tests/test_torch_innovations_loop.py` (2 cameras, 6
  iterations: a densify event, an opacity reset, evals at 3 and 6, the
  TensorBoard records at the JAX loop's tags), and unbound on the tiny
  Blender scene of `tests/test_torch_unbound.py` (6 iterations, with the
  GUI port taken so that the server warns and training goes on);
* `run_ablation.sh` under a `$PYTHON` stub that records its command
  lines: the JAX script's 21, with the port's tools.
"""
import argparse
import importlib.util
import json
import os
import pathlib
import socket
import subprocess

import numpy as np
import pytest
import torch

from gaussianavatars_tpu import config as jconfig
from gaussianavatars_torch import config as tconfig
from gaussianavatars_torch.data import ply as tply
from gaussianavatars_torch.tools import train as ttrain
from gaussianavatars_torch.training import checkpoint as tckpt
from gaussianavatars_torch.training import loop as tloop
from test_torch_unbound import write_blender_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
REQUIRED = ["-s", "SRC", "-m", "OUT"]


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_cli",
                                                  REPO / "scripts" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parser_of(parse_args, monkeypatch):
    """The ArgumentParser that `parse_args` builds."""
    seen = []
    orig = argparse.ArgumentParser.parse_args

    def capture(self, *a, **k):
        seen.append(self)
        return orig(self, *a, **k)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    parse_args(REQUIRED)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", orig)
    return seen[0]


def _actions(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs, a.required,
                     type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_parse_args_matches_jax(monkeypatch):
    want = _actions(_parser_of(_jax_script().parse_args, monkeypatch))
    got = _actions(_parser_of(ttrain.parse_args, monkeypatch))
    assert set(got) == set(want) | {"device", "dist_backend", "launch_timeout"}
    for dest, w in want.items():
        assert got[dest] == w, dest
    assert got["device"][:2] == (("--device",), "cuda")
    assert got["dist_backend"][:2] == (("--dist_backend",), None)
    assert len(want) == 48


@pytest.mark.parametrize("flags", [[], ["--all_innovations", "--use_amp"],
                                   ["--bind_to_mesh", "-w", "-r", "2", "--disable_teeth",
                                    "--use_contrastive_reg", "--lambda_laplacian", "0.5"]])
def test_config_from_args_matches_jax(flags):
    js = _jax_script()
    want = json.loads(jconfig.to_json(js.config_from_args(js.parse_args(REQUIRED + flags))))
    got = json.loads(tconfig.to_json(ttrain.config_from_args(
        ttrain.parse_args(REQUIRED + flags))))
    assert set(got) == set(want)
    for section in got:
        assert got[section] == {k: v for k, v in want[section].items() if k in got[section]}, \
            section


def test_no_pallas_configures_the_table_pipeline(tmp_path):
    """`--no_pallas` (once refused) passes the checks and gives the JAX
    script's configuration with `use_pallas=False`, whose step takes the
    table path (the table step's values: `test_torch_train_table.py`; a
    `--no_pallas` run on the card: `chip_smoke.py` phase 17)."""
    from gaussianavatars_torch.training import trainer as ttrainer

    a = ttrain.parse_args(REQUIRED + ["--no_pallas"])
    ttrain.check_supported(a)
    js = _jax_script()
    got = json.loads(tconfig.to_json(ttrain.config_from_args(a)))
    want = json.loads(jconfig.to_json(js.config_from_args(js.parse_args(
        REQUIRED + ["--no_pallas"]))))
    assert got["pipeline"] == {k: v for k, v in want["pipeline"].items()
                               if k in got["pipeline"]}
    assert got["pipeline"]["use_pallas"] is False
    cfg = ttrain.config_from_args(a)
    tile = tloop.tile_config(cfg)
    assert (tile.capacity, tile.max_tiles_per_gaussian) == (1024, 16)
    assert tloop.probe_tier_budgets(tile, cfg, None, None, None) is tile
    assert callable(ttrainer.make_train_step(None, cfg, tile))


MESH_FLAGS = [["--mesh", "2x4"], ["--distributed"], ["--mesh", "1x2", "--gauss_shard"],
              ["--distributed", "--coordinator_address", "host:1234"],
              ["--distributed", "--num_processes", "2"], ["--distributed", "--process_id", "0"]]


@pytest.mark.parametrize("flags", MESH_FLAGS, ids=lambda f: f[-2] if len(f) > 1 else f[0])
def test_mesh_flags_parse_to_the_jax_configuration(flags):
    """Each of the six multi-device flags parses as the JAX script's does,
    to the same configuration, and passes the checks (NCCL is not asked
    for on the CPU)."""
    js = _jax_script()
    a = ttrain.parse_args(REQUIRED + flags + ["--device", "cpu"])
    want = js.parse_args(REQUIRED + flags)
    for dest in ("mesh", "distributed", "coordinator_address", "num_processes", "process_id",
                 "gauss_shard"):
        assert getattr(a, dest) == getattr(want, dest), dest
    ttrain.check_supported(a)
    got = json.loads(tconfig.to_json(ttrain.config_from_args(a)))
    jgot = json.loads(jconfig.to_json(js.config_from_args(want)))
    assert set(got) == set(jgot)
    for section in got:   # the port's fields (it has no `data_device`, ...)
        assert got[section] == {k: v for k, v in jgot[section].items() if k in got[section]}
    assert got["parallel"] == jgot["parallel"]
    assert ttrain.mesh_shape(a) == ((2, 4) if "2x4" in flags else (1, 2) if "1x2" in flags
                                    else (1, None))


def test_mesh_2x2_starts_four_ranks_that_reach_train_sharded(tmp_path, monkeypatch):
    """`--mesh 2x2` without `--distributed` launches four ranks of the same
    command with `--distributed`; a rank (here a one-rank world in this
    process) builds its 1×1 mesh and calls `train_sharded`."""
    from gaussianavatars_torch.parallel import distributed as pdist

    seen = {}

    def fake_launch(module, argv, world, timeout, device="cpu", **kw):
        seen.update(module=module, argv=argv, world=world, timeout=timeout, device=device)
        return pdist.LaunchResult(rcs=[0] * world, stdout=["rank 0 says hi\n"] + [""] * 3,
                                  stderr=[""] * world, seconds=0.0, timed_out=False)

    monkeypatch.setattr(pdist, "launch", fake_launch)
    argv = ["-s", str(tmp_path), "-m", str(tmp_path / "out"), "--device", "cpu", "--mesh",
            "2x2", "--launch_timeout", "30"]
    res, logs = ttrain.main(argv)
    assert logs is None and res.ok
    assert seen["module"] == "gaussianavatars_torch.tools.train" and seen["world"] == 4
    assert seen["argv"] == argv + ["--distributed", "--dist_backend", "gloo"]
    assert seen["timeout"] == 30 and seen["device"] == "cpu"

    calls = []
    monkeypatch.setattr(ttrain, "build_harness", lambda cfg, **kw: ("harness", kw))
    monkeypatch.setattr(ttrain, "train_sharded",
                        lambda h, mesh, **kw: calls.append((h, mesh, kw)) or ["logs"])
    harness, logs = ttrain.main(argv[:6] + [
        "--dist_backend", "gloo", "--mesh", "1x1", "--gauss_shard", "--iterations", "3", "--distributed",
        "--coordinator_address", f"file://{tmp_path / 'rendezvous'}", "--num_processes", "1",
        "--process_id", "0"])
    assert logs == ["logs"] and harness[1]["coordinator"] is True
    (_h, mesh, kw), = calls
    assert (mesh.data, mesh.tile, mesh.rank) == (1, 1, 0)
    assert kw["gauss_shard"] is True and kw["iterations"] == 3
    assert not torch.distributed.is_initialized()   # the rank left its world


def test_initialize_maps_the_flags_and_torchrun_env(monkeypatch):
    from gaussianavatars_torch.parallel import distributed as pdist

    got = []
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: got.append((backend, kw)))
    pdist.initialize("127.0.0.1:29500", 2, 1, backend="gloo", device="cpu")
    pdist.initialize("file:///tmp/x", 4, 3, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    pdist.initialize(device="cpu")
    assert [(b, kw["init_method"], kw["world_size"], kw["rank"]) for b, kw in got] == [
        ("gloo", "tcp://127.0.0.1:29500", 2, 1), ("gloo", "file:///tmp/x", 4, 3),
        ("gloo", "env://", 8, 5)]
    assert got[0][1]["timeout"].total_seconds() == pdist.DEFAULT_TIMEOUT_S
    with pytest.raises(ValueError, match="--num_processes and --process_id"):
        pdist.initialize("host:1", None, 0, device="cpu")


def test_nccl_with_two_ranks_on_one_device_raises(tmp_path, monkeypatch):
    from gaussianavatars_torch.parallel import distributed as pdist

    argv = ["-s", str(tmp_path), "-m", str(tmp_path / "out"), "--mesh", "1x2",
            "--dist_backend", "nccl"]
    with pytest.raises(ValueError, match="--dist_backend gloo"):
        ttrain.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="two ranks on one device.*--dist_backend gloo"):
        ttrain.main(argv)
    pdist.check_backend("nccl", "cuda", 1)    # one rank a device: fine
    pdist.check_backend("gloo", "cuda", 4)    # gloo shares the card
    with pytest.raises(ValueError, match="need --distributed"):
        ttrain.main(["-s", "S", "-m", "M", "--device", "cpu", "--num_processes", "2"])
    with pytest.raises(ValueError, match="needs --mesh or --distributed"):
        ttrain.main(["-s", "S", "-m", "M", "--device", "cpu", "--gauss_shard"])
    assert not (tmp_path / "out").exists()


def test_train_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["-s", str(tmp_path), "-m", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_steps_per_call_is_accepted():
    assert ttrain.parse_args(REQUIRED + ["--steps_per_call", "1"]).steps_per_call == 1


class RecordingWriter:
    """Stands in for `SummaryWriter`: records (kind, tag, step)."""

    def __init__(self):
        self.records = []
        self.closed = False

    def add_scalar(self, tag, value, step):
        assert np.isfinite(value), tag
        self.records.append(("scalar", tag, step))

    def add_image(self, tag, img, step, dataformats="CHW"):
        assert dataformats == "HWC" and img.ndim == 3 and img.shape[-1] == 3, tag
        self.records.append(("image", tag, step))

    def add_histogram(self, tag, values, step):
        self.records.append(("histogram", tag, step))

    def close(self):
        self.closed = True


# The JAX loop's tags (`training/loop.py:477, 518-541, 885`).
TRAIN_TAGS = {"train/loss", "train/psnr", "train/num_points"}
DENSIFY_TAGS = {f"densify/{k}" for k in ("cloned", "split", "pruned", "dropped")}
EVAL_TAGS = {f"{s}/{k}" for s in ("val", "test") for k in ("psnr", "ssim", "render", "gt",
                                                           "error")}
SCENE_TAGS = {"scene/opacity", "scene/total_points"}


def test_error_map_matches_jax(monkeypatch):
    """The writer's error image, with matplotlib's colormap and without."""
    import sys

    from gaussianavatars_tpu.utils.image import error_map as jerror_map
    from gaussianavatars_torch.utils.image import error_map

    rng = np.random.RandomState(2)
    a, b = rng.uniform(0, 1, (2, 12, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(error_map(a, b), jerror_map(a, b))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = error_map(a, b)
    np.testing.assert_array_equal(got, jerror_map(a, b))
    assert got.shape == (12, 16, 3) and got.min() >= 0 and got.max() <= 1


def _flame_dataset(tmp_path, monkeypatch):
    """The 415-face sparse sphere (5,023 vertices, every 40th face, with
    the teeth) as $GSAVATARS_FLAME_TEMPLATE, and a dataset rendered from
    its reference avatar by `tools/train_synthetic` (64×48, 2 timesteps ×
    2 cameras)."""
    from gaussianavatars_torch.models.flame.assets import NUM_VERTS, _uv_sphere
    from gaussianavatars_torch.tools import train_synthetic as ts

    verts, _uv, faces, _fuv = _uv_sphere(NUM_VERTS)
    obj = tmp_path / "sparse_sphere.obj"
    obj.write_text("".join(f"v {a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in verts)
                   + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces[::40]))
    monkeypatch.setenv("GSAVATARS_FLAME_TEMPLATE", str(obj))
    a = ts.parse_args(["--workdir", str(tmp_path / "ds"), "--device", "cpu", "--width", "64",
                       "--height", "48", "--timesteps", "2", "--cameras", "2",
                       "--capacity", "1024", "--n_shape", "8", "--n_expr", "4"])
    ts.write_dataset(a, *ts.build_reference_avatar(a, "cpu"))
    return a.workdir


def test_train_cli_flame_bound_on_the_cpu(tmp_path, monkeypatch):
    root = _flame_dataset(tmp_path, monkeypatch)
    writer = RecordingWriter()
    monkeypatch.setattr(tloop, "_maybe_tensorboard", lambda path: writer)
    out = tmp_path / "out"
    harness, logs = ttrain.main([
        "-s", root, "-m", str(out), "--bind_to_mesh", "--eval", "--port", "0",
        "--device", "cpu", "--iterations", "6", "--interval", "3", "--capacity", "2048",
        "--densify_from_iter", "1", "--densification_interval", "4",
        "--densify_until_iter", "6", "--opacity_reset_interval", "5", "--log_every", "1",
        "--debug_from", "5"])
    assert [r["iteration"] for r in logs] == list(range(1, 7))
    assert all(np.isfinite(r["loss"]) for r in logs)
    assert harness.model.num_faces == 415 and harness.state.flame is not None
    kinds = [(e["kind"], e["iteration"]) for e in harness.events]
    assert ("densify", 4) in kinds and ("opacity_reset", 5) in kinds
    assert [(e["iteration"], e["split"]) for e in harness.events if e["kind"] == "eval"] == [
        (3, "val"), (3, "test"), (6, "val"), (6, "test")]
    for f in ("cfg_args.json", "cameras.json", "flame_assets.npz", "chkpnt6.npz",
              "point_cloud/iteration_6/point_cloud.ply",
              "point_cloud/iteration_6/flame_param.npz"):
        assert (out / f).exists(), f
    assert tply.load_gaussian_ply(str(out / "point_cloud/iteration_6/point_cloud.ply"))[
        "binding"] is not None
    js = _jax_script()
    argv = ["-s", root, "-m", str(out), "--bind_to_mesh", "--eval", "--iterations", "6",
            "--capacity", "2048", "--densify_from_iter", "1", "--densification_interval", "4",
            "--densify_until_iter", "6", "--opacity_reset_interval", "5"]
    want = json.loads(jconfig.to_json(js.config_from_args(js.parse_args(argv))))
    got = json.loads((out / "cfg_args.json").read_text())
    for section in got:
        assert got[section] == {k: v for k, v in want[section].items() if k in got[section]}
    tags = {tag for _k, tag, _s in writer.records}
    assert tags == TRAIN_TAGS | DENSIFY_TAGS | EVAL_TAGS | SCENE_TAGS
    assert {s for _k, tag, s in writer.records if tag.startswith("val/")} == {3, 6}
    assert writer.closed


def test_train_cli_unbound_on_the_cpu(tmp_path, capsys):
    root = write_blender_scene(str(tmp_path / "scene"), n_points=200)
    out = tmp_path / "out"
    with socket.socket() as taken:   # the GUI's port is in use: a warning, not a failure
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = taken.getsockname()[1]
        harness, logs = ttrain.main([
            "-s", root, "-m", str(out), "-w", "--eval", "--port", str(port), "--device", "cpu",
            "--iterations", "6", "--interval", "3", "--capacity", "1024",
            "--densify_from_iter", "1", "--densification_interval", "4",
            "--opacity_reset_interval", "5", "--log_every", "1", "--sh_degree", "1"])
    assert "[warn] GUI server unavailable" in capsys.readouterr().out
    assert harness.model is None and harness.state.flame is None
    assert all(np.isfinite(r["loss"]) for r in logs) and len(logs) == 6
    kinds = [(e["kind"], e["iteration"]) for e in harness.events]
    # White background: an opacity reset at densify_from_iter too.
    assert [k for k in kinds if k[0] in ("densify", "opacity_reset")] == [
        ("opacity_reset", 1), ("densify", 4), ("opacity_reset", 5)]
    # Blender has no val split: test views only.
    assert [(e["iteration"], e["split"]) for e in harness.events
            if e["kind"] == "eval" and e.get("n")] == [(3, "test"), (6, "test")]
    assert not (out / "flame_assets.npz").exists()
    ply = tply.load_gaussian_ply(str(out / "point_cloud/iteration_6/point_cloud.ply"))
    assert ply["binding"] is None and len(ply["means"]) == int(harness.state.aux.alive.sum())
    saved = np.load(out / "chkpnt6.npz")
    assert not any(k.startswith("flame") for k in saved.files)
    assert set(tckpt.flatten_state(harness.state)) == set(saved.files) - {
        "__iteration__", "key", tckpt.GENERATOR_KEY}
    assert json.loads((out / "cfg_args.json").read_text())["model"]["bind_to_mesh"] is False


def test_maybe_tensorboard(tmp_path, monkeypatch):
    assert tloop._maybe_tensorboard("") is None
    w = tloop._maybe_tensorboard(str(tmp_path / "tb"))
    if w is not None:
        w.add_scalar("train/loss", 1.0, 1)
        w.close()
        assert any(p.name.startswith("events.out.tfevents") for p in (tmp_path / "tb").iterdir())
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)
    assert tloop._maybe_tensorboard(str(tmp_path / "tb2")) is None


def _run_ablation(script, tmp_path, extra, name):
    log = tmp_path / f"{name}.txt"
    stub = tmp_path / f"{name}_python.sh"
    stub.write_text(f'#!/bin/sh\necho "$*" >> {log}\n')
    stub.chmod(0o755)
    subprocess.run(["bash", str(script), "SRC", "OUT", *extra], check=False, cwd=tmp_path,
                   env={**os.environ, "PYTHON": str(stub)}, capture_output=True, timeout=60)
    return log.read_text().splitlines()


def test_run_ablation_matches_jax(tmp_path):
    extra = ["--iterations", "6", "--interval", "3"]
    want = _run_ablation(REPO / "scripts" / "run_ablation.sh", tmp_path, extra, "jax")
    got = _run_ablation(REPO / "gaussianavatars_torch" / "tools" / "run_ablation.sh", tmp_path,
                        extra, "torch")
    assert len(want) == len(got) == 21
    scripts = REPO / "scripts"
    for g, w in zip(got, want):
        for tool in ("train", "render", "metrics"):
            w = w.replace(f"{scripts}/{tool}.py", f"-m gaussianavatars_torch.tools.{tool}")
        assert g == w
    # `--device` reaches the render and metrics tools too.
    dev = _run_ablation(REPO / "gaussianavatars_torch" / "tools" / "run_ablation.sh", tmp_path,
                        extra + ["--device", "cpu"], "torch_cpu")
    assert len(dev) == 21 and all(line.endswith("--device cpu") for line in dev)
    assert dev[0] == got[0] + " --device cpu" and dev[1] == got[1] + " --device cpu"
