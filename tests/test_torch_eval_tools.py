"""The replay tools on the CPU against the JAX package's scripts, on one
model directory written by the JAX package (`torch_parity.write_jax_model_dir`):

* `tools/render.main --device cpu` and `scripts/render.py` render the val
  and test splits (`--n_frames 2`, train skipped): every PNG of the port
  within 1/255 per channel of the script's PNG of the same view;
* `tools/metrics.main --device cpu` and `scripts/metrics.py` on the same
  PNG folders: PSNR and SSIM within rtol 1e-5;
* `--render_mesh` writes its overlaid frames;
* `training.loop.make_render_fn(None, ...)` renders an unbound model as
  the JAX package's does, within atol 1e-4.
"""
import dataclasses
import importlib.util
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaussianavatars_tpu import config as jconfig
from gaussianavatars_tpu.data.cameras import jit_static_key
from gaussianavatars_tpu.models.io import checkpoint_ply_path, load_avatar
from gaussianavatars_tpu.training import loop as jloop
from gaussianavatars_torch import config as tconfig
from gaussianavatars_torch.convert import gaussian_state_from_numpy
from gaussianavatars_torch.render import probe_tile_config
from gaussianavatars_torch.tools import metrics as tmetrics
from gaussianavatars_torch.tools import render as trender
from gaussianavatars_torch.training import loop as tloop
from torch_parity import dataclass_dict, jax_camera, torch_camera, write_jax_model_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = ("val", "test")


def script(name):
    """`scripts/<name>.py` as a module of its own name (no sys.path entry)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pngs(model_dir, split, kind):
    d = os.path.join(model_dir, split, "ours_777", kind)
    return {n: np.asarray(Image.open(os.path.join(d, n)), np.int16)
            for n in sorted(os.listdir(d)) if n.endswith(".png")}


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """The JAX-written model directory rendered by the JAX script, and a copy
    of it (before any render) rendered by the port's tool."""
    root = tmp_path_factory.mktemp("tools")
    jax_dir = write_jax_model_dir(root / "ds", root / "jax")[0]
    port_dir = str(root / "port")
    shutil.copytree(jax_dir, port_dir)
    argv = ["-m", jax_dir, "--skip_train", "--quiet", "--n_frames", "2"]
    script("render").main(argv)
    stats = trender.main(["-m", port_dir, "--skip_train", "--quiet", "--n_frames", "2",
                          "--device", "cpu"])
    return jax_dir, port_dir, stats


def test_render_tool_matches_the_jax_script(rendered):
    jax_dir, port_dir, stats = rendered
    assert sorted(stats) == sorted(SPLITS) and all(s["views"] == 2 for s in stats.values())
    assert not os.path.exists(os.path.join(port_dir, "train"))
    for split in SPLITS:
        for kind in ("renders", "gt"):
            got, want = pngs(port_dir, split, kind), pngs(jax_dir, split, kind)
            assert sorted(got) == sorted(want) == ["00000.png", "00001.png"], (split, kind)
            for name in want:
                assert got[name].shape == (48, 64, 3)
                assert np.abs(got[name] - want[name]).max() <= 1, (split, kind, name)
        # The render is of the avatar, not of the background.
        assert max(img.mean() for img in pngs(port_dir, split, "renders").values()) > 20


def test_metrics_tool_matches_the_jax_script(rendered):
    jax_dir, port_dir, _stats = rendered
    argv = ["-m", jax_dir, "--splits", *SPLITS, "--lpips_weights", ""]
    script("metrics").main(argv)
    want = json.load(open(os.path.join(jax_dir, "results.json")))
    want_views = json.load(open(os.path.join(jax_dir, "per_view.json")))
    out = tmetrics.main([*argv, "--device", "cpu"])
    got = json.load(open(os.path.join(jax_dir, "results.json")))
    got_views = json.load(open(os.path.join(jax_dir, "per_view.json")))
    assert out[jax_dir]["results"] == got
    assert sorted(got) == sorted(want) == sorted(f"{s}/ours_777" for s in SPLITS)
    for key in want:
        assert sorted(got[key]) == sorted(want[key]) == ["psnr", "ssim"]
        for m in ("psnr", "ssim"):
            np.testing.assert_allclose(got[key][m], want[key][m], rtol=1e-5, err_msg=key)
            for name, v in want_views[key][m].items():
                np.testing.assert_allclose(got_views[key][m][name], v, rtol=1e-5)
        assert got_views[key]["lpips"] == {}
    # On the port's own renders (equal to within 1/255): a faithful avatar.
    port = tmetrics.main(["-m", port_dir, "--splits", "val", "--device", "cpu"])
    assert port[port_dir]["results"]["val/ours_777"]["psnr"] > 25


def test_metrics_tool_raises_after_a_failed_model(rendered, tmp_path):
    jax_dir, _port_dir, _stats = rendered
    bad = tmp_path / "bad"
    (bad / "val" / "ours_1" / "renders").mkdir(parents=True)
    (bad / "val" / "ours_1" / "gt").mkdir(parents=True)
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(bad / "val" / "ours_1" / "renders" / "a.png")
    Image.fromarray(np.zeros((6, 6, 3), np.uint8)).save(bad / "val" / "ours_1" / "gt" / "a.png")
    with pytest.raises(RuntimeError, match="metrics failed"):
        tmetrics.main(["-m", str(bad), jax_dir, "--splits", "val", "--device", "cpu"])
    assert os.path.exists(os.path.join(jax_dir, "results.json"))


def test_render_mesh_writes_overlaid_frames(rendered, tmp_path):
    jax_dir, port_dir, _stats = rendered
    mesh_dir = str(tmp_path / "mesh")
    shutil.copytree(jax_dir, mesh_dir, ignore=shutil.ignore_patterns(*SPLITS, "*.json"))
    shutil.copy(os.path.join(jax_dir, "cfg_args.json"), mesh_dir)
    stats = trender.main(["-m", mesh_dir, "--skip_train", "--skip_test", "--quiet",
                          "--n_frames", "1", "--render_mesh", "--device", "cpu"])
    assert stats["val"]["views"] == 1
    mesh = pngs(mesh_dir, "val", "renders")["00000.png"]
    plain = pngs(port_dir, "val", "renders")["00000.png"]
    assert mesh.shape == plain.shape and np.abs(mesh - plain).mean() > 1


def test_render_probes_tiers_when_the_config_has_none(rendered, tmp_path):
    """A `cfg_args.json` without tier budgets: each view's are probed, and
    the frames equal those rendered with the frame-wide tier (no Gaussian
    cut in either)."""
    jax_dir, port_dir, _stats = rendered
    probe_dir = str(tmp_path / "probe")
    shutil.copytree(jax_dir, probe_dir, ignore=shutil.ignore_patterns(*SPLITS))
    cfg = json.load(open(os.path.join(probe_dir, "cfg_args.json")))
    cfg["pipeline"]["tiers"] = []
    json.dump(cfg, open(os.path.join(probe_dir, "cfg_args.json"), "w"))
    trender.main(["-m", probe_dir, "--skip_train", "--skip_test", "--quiet", "--n_frames", "2",
                  "--device", "cpu"])
    got, want = pngs(probe_dir, "val", "renders"), pngs(port_dir, "val", "renders")
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_unbound_render_matches_jax(rendered):
    """`make_render_fn(None, ...)`: the stored Gaussians as world-space
    points, no FLAME (`scripts/render.py:101-103`)."""
    jax_dir = rendered[0]
    jcfg = jconfig.from_json(open(os.path.join(jax_dir, "cfg_args.json")).read())
    jp, ja, _tab = load_avatar(checkpoint_ply_path(jax_dir))
    # World-space points in front of the camera of `jax_camera`.
    jp = dataclasses.replace(jp, means=jp.means * 4.0 + jnp.asarray([0.0, 0.0, 2.5]),
                             log_scales=jp.log_scales - 2.0)
    ja = dataclasses.replace(ja, binding=jnp.zeros_like(ja.binding))
    state = jloop.TrainState(params=jp, aux=ja, adam=None, flame=None, flame_static=None,
                             flame_adam=None, color_net=None, color_adam=None,
                             contrastive=None, key=jnp.zeros((2,), jnp.uint32))
    cam = jax_camera()
    want = jloop.make_render_fn(None, jcfg, jloop.tile_config(jcfg))(
        state, jit_static_key(cam), jnp.int32(0), jnp.zeros(3), 3)
    tp, ta = gaussian_state_from_numpy(dataclass_dict(jp), dataclass_dict(ja), device="cpu")
    tcfg = tconfig.from_json(jconfig.to_json(jcfg))
    got = tloop.make_render_fn(None, tcfg, tloop.tile_config(tcfg))(
        trender.replay_state(tp, ta, None, None), torch_camera(cam), 0, torch.zeros(3), 3)
    want = np.asarray(jax.device_get(want))
    assert want.max() > 0.05
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # Tier budgets probed for the unbound avatar (no FLAME) cut nothing here either.
    probed = probe_tile_config(None, tp, ta, None, torch_camera(cam), 8, 16)
    again = tloop.make_render_fn(None, tcfg, probed)(
        trender.replay_state(tp, ta, None, None), torch_camera(cam), 0, torch.zeros(3), 3)
    np.testing.assert_array_equal(again.numpy(), got.numpy())
