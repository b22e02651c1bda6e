"""Viewers: the port's `viewers/orbit.py` and `viewers/local.AvatarViewerCore`
against the JAX package's, and the FPS benchmarks on the CPU.

* `OrbitCamera` after orbit, pan and scale: `to_camera`'s matrices within
  atol 1e-6; `KeyframeTimeline.sample` and `KeyframeEditor.frames` equal,
  and the JSON one package saves loads in the other.
* `AvatarViewerCore` at 64×48 on one JAX-written model directory against
  the JAX core (sorted pipeline, Pallas compositor in interpret mode): the
  render within atol 1e-4 (the tolerance of `test_torch_render.py`), with
  a jaw override, with control enabled, with the mesh overlay, and with
  `motion_path`. The JAX side is the JAX core's `flame_params_at` and the
  body of its `render` under one `jax.jit` (`jax_core_render`): the core
  itself runs op by op, ~20 s for its first frame on the CPU.
* `fps_benchmark_demo.run_benchmark` and `fps_benchmark_dataset.main` give
  positive frame rates on the CPU; `use_pallas=False` and `--no_pallas`
  raise (the non-kernel pipelines are ROADMAP queue A item 4).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussianavatars_tpu.data.cameras import jit_static_key
from gaussianavatars_tpu.models.binding import face_frames as jax_face_frames
from gaussianavatars_tpu.models.gaussians import world_gaussians as jax_world_gaussians
from gaussianavatars_tpu.ops.mesh_raster import render_mesh_preview as jax_mesh_preview
from gaussianavatars_tpu.ops.rasterize_tiled import render_tiled as jax_render_tiled
from gaussianavatars_tpu.viewers import local as jlocal
from gaussianavatars_tpu.viewers import orbit as jorbit
from gaussianavatars_torch.models.io import checkpoint_ply_path
from gaussianavatars_torch.tools import fps_benchmark_dataset, fps_benchmark_demo
from gaussianavatars_torch.viewers import local as tlocal
from gaussianavatars_torch.viewers import orbit as torbit
from torch_parity import N_TIERS_TILES, TILE_H, TILE_W, camera_dict, write_jax_model_dir

ATOL = 1e-4


def moved(mod):
    cam = mod.OrbitCamera(width=64, height=48, radius=2.0, center=(0.1, -0.2, 0.3))
    cam.orbit(37.0, -21.0)
    cam.pan(4.0, -2.5)
    cam.scale(1.5)
    return cam


def test_orbit_camera_matches_jax():
    jc, tc = moved(jorbit), moved(torbit)
    np.testing.assert_array_equal(tc.pose, jc.pose)
    got = tc.to_camera(device="cpu")
    want = camera_dict(jc.to_camera())
    for k in ("world_view", "proj", "full_proj", "camera_center"):
        np.testing.assert_allclose(getattr(got, k).numpy(), want[k], atol=1e-6, err_msg=k)
    for k in ("fovx", "fovy", "width", "height"):
        assert getattr(got, k) == pytest.approx(want[k], abs=1e-12), k
    # A state saved by one package restores the other's camera.
    c2 = torbit.OrbitCamera()
    c2.load_state_dict(json.loads(json.dumps(jc.state_dict())))
    np.testing.assert_array_equal(c2.pose, jc.pose)


def keyframes(mod, cls):
    """Four keys in `mod`'s KeyframeTimeline or KeyframeEditor."""
    obj = mod.KeyframeTimeline() if cls == "KeyframeTimeline" else mod.KeyframeEditor(fps=4)
    for i, t in enumerate((0.0, 0.3, 0.6, 1.0)):
        c = mod.OrbitCamera(radius=1.0 + t)
        c.orbit(120 * t, 30 * i)
        if cls == "KeyframeTimeline":
            obj.add(t, c)
        else:
            obj.add(c)
    return obj


@pytest.mark.parametrize("n_keys", [2, 4])
def test_keyframe_timeline_and_editor_match_jax(tmp_path, n_keys):
    """Linear (2 keys) and cubic (4 keys) interpolation."""
    jt, tt = keyframes(jorbit, "KeyframeTimeline"), keyframes(torbit, "KeyframeTimeline")
    je, te = keyframes(jorbit, "KeyframeEditor"), keyframes(torbit, "KeyframeEditor")
    for obj in (jt, tt, je, te):
        del obj.keyframes[n_keys:]
    base_j, base_t = jorbit.OrbitCamera(), torbit.OrbitCamera()
    for time in (-0.1, 0.2, 0.45, 0.9, 1.3):
        a, b = tt.sample(time, base_t), jt.sample(time, base_j)
        np.testing.assert_array_equal(a.pose, b.pose)
    fj, ft = je.frames(), te.frames()
    assert sorted(ft) == sorted(fj) and te.timeline_length() == je.timeline_length() > 0
    for ch in fj:
        np.testing.assert_array_equal(ft[ch], fj[ch], err_msg=ch)
    # Files cross between the packages.
    jt.save(str(tmp_path / "tl.json"))
    te.save(str(tmp_path / "ed.json"))
    tl2, ed2 = torbit.KeyframeTimeline(), jorbit.KeyframeEditor()
    tl2.load(str(tmp_path / "tl.json"))
    ed2.load(str(tmp_path / "ed.json"))
    np.testing.assert_array_equal(tl2.sample(0.2, base_t).pose, jt.sample(0.2, base_j).pose)
    for ch, v in ed2.frames().items():
        np.testing.assert_array_equal(v, ft[ch], err_msg=ch)


@pytest.fixture(scope="module")
def avatar(tmp_path_factory):
    """A JAX-written model directory and both packages' viewer cores on its
    PLY, with the tier budgets of the frame."""
    root = tmp_path_factory.mktemp("viewer")
    model_dir = write_jax_model_dir(root / "ds", root / "model")[0]
    ply = checkpoint_ply_path(model_dir)
    tile = dict(tile_h=TILE_H, tile_w=TILE_W)
    tiers = ((1024, N_TIERS_TILES),)
    jcore = jlocal.AvatarViewerCore(ply, width=64, height=48, use_pallas=True,
                                    tile=dict(tile, tiers=tiers))
    tcore = tlocal.AvatarViewerCore(ply, width=64, height=48, tile=dict(tile, tiers=tiers),
                                    device="cpu")
    return model_dir, ply, jcore, tcore


@functools.partial(jax.jit, static_argnames=("model", "tile"))
def _jax_splat(params, aux, fp, cam, bg, model, tile):
    verts = model.forward(fp)[0]
    wg = jax_world_gaussians(params, aux, jax_face_frames(verts, model.faces))
    out = jax_render_tiled(wg.means, wg.scales, wg.quats, wg.opacity, cam, bg, sh=wg.sh,
                           sh_degree=3, alive=wg.alive, cfg=tile, use_pallas=True)
    return jnp.clip(out.color, 0, 1), verts


def jax_core_render(core, timestep, show_mesh, bg, mesh_opacity=0.5, model=None):
    """`jlocal.AvatarViewerCore.render` (splats, then the mesh overlay) with
    its splat path jitted. `model`: an equal FLAME model already compiled
    for (the core's own by default)."""
    cam = jit_static_key(core.cam.to_camera())
    img, verts = _jax_splat(core.params, core.aux, core.flame_params_at(timestep), cam,
                            jnp.asarray(bg, jnp.float32), model or core.model, core.tile)
    image = np.asarray(img)
    if show_mesh:
        out = jax_mesh_preview(verts, core.model.faces, cam, background=jnp.asarray(bg))
        rgb, alpha = np.asarray(out["rgba"][..., :3]), np.asarray(out["rgba"][..., 3:])
        image = rgb * alpha * mesh_opacity + image * (alpha * (1 - mesh_opacity) + (1 - alpha))
    return image


def _set(core, case):
    core.overrides.clear()
    core.reset_flame()
    core.control_enabled = False
    if case == "jaw_override":
        core.overrides["jaw"] = np.array([0.4, 0.0, 0.0], np.float32)
    elif case == "control":
        core.set_pose("eyes", 1, 0.3)
        core.set_pose("jaw", 0, 0.35)
        core.set_expr(1, 0.5)


@pytest.mark.parametrize("case", ["plain", "jaw_override", "control", "mesh", "motion"])
def test_viewer_core_matches_jax(avatar, tmp_path, case):
    model_dir, ply, jcore, tcore = avatar
    if case == "motion":
        tab = dict(np.load(ply.replace("point_cloud.ply", "flame_param.npz")))
        motion = {k: tab[k] for k in ("expr", "rotation", "neck_pose", "eyes_pose",
                                      "translation")}
        motion["jaw_pose"] = tab["jaw_pose"] + np.array([0.3, 0.0, 0.0], np.float32)
        np.savez(tmp_path / "motion.npz", **motion)
        jc = jlocal.AvatarViewerCore(ply, motion_path=str(tmp_path / "motion.npz"), width=64,
                                     height=48, use_pallas=True, tile=jcore.tile.__dict__)
        tc = tlocal.AvatarViewerCore(ply, motion_path=str(tmp_path / "motion.npz"), width=64,
                                     height=48, tile=dict(tile_h=TILE_H, tile_w=TILE_W,
                                                          tiers=tcore.tile.tiers),
                                     device="cpu")
    else:
        jc, tc = jcore, tcore
        _set(jc, case)
        _set(tc, case)
    assert tc.num_points == jc.num_points == 352 and tc.num_timesteps == jc.num_timesteps == 2
    if case == "control":  # the eyes slider drives both eyes
        np.testing.assert_allclose(tc.control["eyes"], [0, 0.3, 0, 0, 0.3, 0])
    kw = dict(timestep=1, show_mesh=case == "mesh", bg=(0.1, 0.2, 0.3))
    want = jax_core_render(jc, **kw, model=jcore.model)
    got = tc.render(**kw)
    assert got.shape == want.shape == (48, 64, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    if case != "plain":
        _set(tcore, "plain")
        base = tcore.render(timestep=1, bg=(0.1, 0.2, 0.3))
        assert np.abs(got - base).mean() > 1e-4, case   # the change moved the image


def test_viewer_core_rejects_the_non_kernel_pipeline(avatar):
    _dir, ply, _j, _t = avatar
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        tlocal.AvatarViewerCore(ply, use_pallas=False, device="cpu")
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        fps_benchmark_demo.main([ply, "--no_pallas", "--device", "cpu"])


def test_fps_benchmarks_run_on_the_cpu(avatar):
    model_dir, ply, _j, tcore = avatar
    _set(tcore, "plain")
    fps = fps_benchmark_demo.run_benchmark(tcore, n_iter=2, n_rounds=1)
    assert len(fps) == 1 and fps[0] > 0
    fps = fps_benchmark_demo.run_benchmark(tcore, n_iter=2, n_rounds=2, animate_timesteps=False)
    assert len(fps) == 2 and min(fps) > 0
    fps = fps_benchmark_dataset.main(["-m", model_dir, "--n_iter", "2", "--n_rounds", "1",
                                      "--device", "cpu"])
    assert len(fps) == 1 and fps[0] > 0
