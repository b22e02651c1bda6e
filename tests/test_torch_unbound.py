"""Unbound (point-cloud) training in the port against the JAX package:
`ops/knn.py`, `models/gaussians.init_from_points`, `data/colmap.py` with
`readers.read_colmap_scene`, the `model=None` step and the unbound
`build_harness`, on numpy-seeded inputs at `tests/raster_fixtures.py`'s
size (64×96, 200 points, 8×16 tiles).

Tolerances, each with its reason:
  * `mean_sq_dist_3nn`: atol 1e-6, rtol 1e-4 (‖a‖² − 2a·b + ‖b‖² in
    float32, rounded in another order by XLA's dot);
  * `init_from_points`: `log_scales` at atol 1e-4 (the log of the square
    root of those distances, where duplicate points give distances of a
    few ulps), every other leaf exact;
  * COLMAP: records, split, point cloud and normalisation exact (the same
    numpy code on the same bytes);
  * the step: `tests/test_torch_train.py`'s (image atol 1e-4, loss terms
    rtol 1e-4, each gradient leaf within 1e-4 of the leaf's largest).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu import config as jconfig
from gaussianavatars_tpu.data import colmap as jcolmap
from gaussianavatars_tpu.data import ply as jply
from gaussianavatars_tpu.data import readers as jreaders
from gaussianavatars_tpu.models import gaussians as jg
from gaussianavatars_tpu.ops.knn import mean_sq_dist_3nn as jknn
from gaussianavatars_tpu.ops.rasterize_tiled import TileConfig as JTileConfig
from gaussianavatars_tpu.training import checkpoint as jckpt
from gaussianavatars_tpu.training import loop as jloop
from gaussianavatars_tpu.training import trainer as jtrainer
from gaussianavatars_torch import config as tconfig
from gaussianavatars_torch.convert import train_state_from_numpy
from gaussianavatars_torch.data import colmap as tcolmap
from gaussianavatars_torch.data import ply as tply
from gaussianavatars_torch.data import readers as treaders
from gaussianavatars_torch.models import gaussians as tg
from gaussianavatars_torch.ops.knn import mean_sq_dist_3nn as tknn
from gaussianavatars_torch.ops.rasterize_tiled import TileConfig
from gaussianavatars_torch.training import checkpoint as tckpt
from gaussianavatars_torch.training import loop as tloop
from gaussianavatars_torch.training import trainer as ttrainer
from torch_parity import H, TILE_H, TILE_W, W, camera_dict, n, np_scene, t

PARAM_KEYS = ("means", "log_scales", "quats", "sh_dc", "sh_rest", "logit_opacity")
AUX_KEYS = ("alive", "binding", "grad_accum", "denom", "max_radii2d")
CAP = 256
TIERS = ((CAP, (H // TILE_H) * (W // TILE_W)),)   # one tier as wide as the frame


def _rel_close(got, want, rel, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max abs err {err:.3g} > {rel} × {scale:.3g}"


def _fields(obj) -> dict:
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def state_numpy(js) -> dict:
    """An unbound JAX TrainState as `train_state_from_numpy`'s arguments."""
    assert js.flame is None and js.flame_static is None and js.flame_adam is None
    return dict(params=_fields(js.params), aux=_fields(js.aux),
                adam={"mu": _fields(js.adam.mu), "nu": _fields(js.adam.nu),
                      "step": np.asarray(js.adam.step)})


# ----------------------------------------------------- knn and init


def _points(n_pts=1000, seed=0):
    """Points with duplicates (zero distances), N not a multiple of 1024."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1.0, 1.0, (n_pts, 3)).astype(np.float32)
    pts[500:520] = pts[:20]
    return pts, rng.uniform(0.0, 1.0, (n_pts, 3))


@pytest.mark.parametrize("block", [1024, 256])
def test_mean_sq_dist_3nn_matches_jax(block):
    pts, _ = _points()
    want = np.asarray(jknn(jnp.asarray(pts), block=block))
    got = tknn(torch.as_tensor(pts), block=block)
    assert got.dtype == torch.float32 and got.shape == (1000,)
    np.testing.assert_allclose(n(got), want, atol=1e-6, rtol=1e-4)
    # A duplicate pair: each the other's nearest (at 0), the same two next.
    np.testing.assert_array_equal(n(got)[500:520], n(got)[:20])


def test_init_from_points_matches_jax():
    pts, colors = _points()
    jp, ja = jg.init_from_points(pts, colors, capacity=1200)
    tp, ta = tg.init_from_points(pts, colors, capacity=1200, device="cpu")
    for k in PARAM_KEYS:
        got, want = n(getattr(tp, k)), np.asarray(getattr(jp, k))
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if k == "log_scales":
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    for k in AUX_KEYS:
        np.testing.assert_array_equal(n(getattr(ta, k)), np.asarray(getattr(ja, k)).astype(
            n(getattr(ta, k)).dtype), err_msg=k)
    assert int(tg.num_alive(ta)) == 1000
    with pytest.raises(ValueError, match="capacity"):
        tg.init_from_points(pts, colors, capacity=999, device="cpu")


# ----------------------------------------------------- COLMAP


def _colmap_model(n_images=9, n_points=40, seed=3):
    """Cameras (PINHOLE and SIMPLE_PINHOLE), images with keypoints (one
    with none) and points, as the JAX package's records."""
    rng = np.random.RandomState(seed)
    cams = {1: jcolmap.ColmapCamera(1, "PINHOLE", W, H, np.array([70.0, 71.5, W / 2, H / 2])),
            2: jcolmap.ColmapCamera(2, "SIMPLE_PINHOLE", W, H, np.array([66.0, W / 2, H / 2]))}
    images = {}
    for i in range(n_images):
        q = rng.randn(4)
        q = q / np.linalg.norm(q) * np.sign(q[0])
        npts = 0 if i == 4 else 3
        images[i + 1] = jcolmap.ColmapImage(
            i + 1, q, rng.randn(3), 1 + i % 2, f"view_{(7 * i) % n_images:02d}.png",
            rng.uniform(0, W, (npts, 2)), rng.randint(0, n_points, npts).astype(np.int64))
    pts = jcolmap.ColmapPoints(rng.randn(n_points, 3), rng.randint(0, 256, (n_points, 3))
                               .astype(np.uint8), rng.uniform(0, 2, n_points))
    return cams, images, pts


EXT = {"binary": "bin", "text": "txt"}


def _write(mod, sparse, cams, images, pts, fmt):
    os.makedirs(sparse, exist_ok=True)
    ext = EXT[fmt]
    getattr(mod, f"write_cameras_{fmt}")(cams, os.path.join(sparse, f"cameras.{ext}"))
    getattr(mod, f"write_images_{fmt}")(images, os.path.join(sparse, f"images.{ext}"))
    getattr(mod, f"write_points3d_{fmt}")(pts, os.path.join(sparse, f"points3D.{ext}"))


def _read(mod, sparse, fmt):
    ext = EXT[fmt]
    return (getattr(mod, f"read_cameras_{fmt}")(os.path.join(sparse, f"cameras.{ext}")),
            getattr(mod, f"read_images_{fmt}")(os.path.join(sparse, f"images.{ext}")),
            getattr(mod, f"read_points3d_{fmt}")(os.path.join(sparse, f"points3D.{ext}")))


def _model_equal(got, want):
    (gc, gi, gp), (wc, wi, wp) = got, want
    assert sorted(gc) == sorted(wc) and sorted(gi) == sorted(wi)
    for k in wc:
        assert (gc[k].id, gc[k].model, gc[k].width, gc[k].height) == (
            wc[k].id, wc[k].model, wc[k].width, wc[k].height)
        np.testing.assert_array_equal(gc[k].params, wc[k].params)
    for k in wi:
        assert (gi[k].id, gi[k].camera_id, gi[k].name) == (wi[k].id, wi[k].camera_id,
                                                            wi[k].name)
        for f in ("qvec", "tvec", "xys", "point3d_ids"):
            np.testing.assert_array_equal(getattr(gi[k], f), getattr(wi[k], f), err_msg=f)
    for f in ("xyz", "rgb", "errors"):
        np.testing.assert_array_equal(getattr(gp, f), getattr(wp, f), err_msg=f)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_colmap_binary_crosses_between_packages(writer, tmp_path):
    model = _colmap_model()
    sparse = str(tmp_path / "sparse" / "0")
    _write(tcolmap if writer == "torch" else jcolmap, sparse, *model, "binary")
    reader = jcolmap if writer == "torch" else tcolmap
    _model_equal(_read(reader, sparse, "binary"), model)
    _model_equal(_read(tcolmap, sparse, "binary"), _read(jcolmap, sparse, "binary"))


def test_colmap_text_reads_alike_in_both_packages(tmp_path):
    """The port writes text (the JAX package writes binary only); both
    packages read it back to the written records, bit for bit."""
    model = _colmap_model()
    sparse = str(tmp_path / "sparse" / "0")
    _write(tcolmap, sparse, *model, "text")
    _model_equal(_read(jcolmap, sparse, "text"), model)
    _model_equal(_read(tcolmap, sparse, "text"), model)


def test_quaternion_conversions_match_jax():
    rng = np.random.RandomState(5)
    for _ in range(20):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        R = jcolmap.qvec_to_rotmat(q)
        np.testing.assert_array_equal(tcolmap.qvec_to_rotmat(q), R)
        np.testing.assert_array_equal(tcolmap.rotmat_to_qvec(R), jcolmap.rotmat_to_qvec(R))


def _records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("uid", "fovx", "fovy", "width", "height", "image_path", "image_name",
                  "timestep", "camera_id"):
            assert getattr(g, k) == getattr(w, k), k
        for k in ("R", "T", "bg"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k), err_msg=k)


@pytest.mark.parametrize("fmt,eval_split", [("binary", True), ("text", True),
                                            ("binary", False)])
def test_read_colmap_scene_matches_jax(fmt, eval_split, tmp_path):
    cams, images, pts = _colmap_model()
    _write(tcolmap, str(tmp_path / "sparse" / "0"), cams, images, pts, fmt)
    # One image on disk at another size: its size comes from the file.
    from PIL import Image

    (tmp_path / "images").mkdir()
    Image.fromarray(np.zeros((20, 30, 3), np.uint8)).save(tmp_path / "images" / "view_03.png")
    got = treaders.read_colmap_scene(str(tmp_path), eval_split=eval_split)
    want = jreaders.read_colmap_scene(str(tmp_path), eval_split=eval_split)
    assert treaders.detect_scene_type(str(tmp_path)) == "colmap"
    for split in ("train_cameras", "val_cameras", "test_cameras"):
        _records_equal(getattr(got, split), getattr(want, split))
    if eval_split:   # llffhold 8: the 1st and 9th of the names in order
        assert [r.image_name for r in got.test_cameras] == ["view_00", "view_08"]
        assert len(got.train_cameras) == 7
    assert [r.image_name for r in got.train_cameras if r.width == 30] == ["view_03"]
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got.point_cloud, f), getattr(want.point_cloud, f))
    np.testing.assert_array_equal(got.nerf_normalization["translate"],
                                  want.nerf_normalization["translate"])
    assert got.nerf_normalization["radius"] == want.nerf_normalization["radius"]
    assert got.ply_path == want.ply_path


# ----------------------------------------------------- the unbound step


def _camera():
    """`torch_parity.jax_camera`'s view moved back by 2.5: the padded
    slots sit at the origin, and a camera there gives the JAX step NaN
    gradients in those dead slots (the port's are 0; ROADMAP queue C)."""
    from gaussianavatars_tpu.data.cameras import look_at_camera

    return look_at_camera(eye=np.array([0.0, 0.0, -2.5]), target=np.zeros(3), fovy=1.0,
                          width=W, height=H)


def _unbound_states(**opt):
    means, _s, _q, _o, colors = np_scene(n=200, seed=2)
    means = means - np.array([0.0, 0.0, 2.5], np.float32)
    jp, ja = jg.init_from_points(means, colors, capacity=CAP)
    rng = np.random.RandomState(9)
    # Visible, anisotropic and rotated (an isotropic splat has no rotation
    # gradient), some SH rest.
    jp = dataclasses.replace(
        jp, logit_opacity=jnp.where(ja.alive[:, None], 1.0, jp.logit_opacity),
        quats=jnp.asarray(rng.randn(CAP, 4).astype(np.float32)),
        log_scales=jp.log_scales + jnp.asarray(rng.uniform(-0.3, 0.3, (CAP, 3))
                                               .astype(np.float32)),
        sh_rest=jnp.asarray(rng.randn(CAP, 15, 3).astype(np.float32) * 0.05))
    jcfg = jconfig.Config(opt=jconfig.OptimizationConfig(**opt))
    tcfg = tconfig.Config(opt=tconfig.OptimizationConfig(**opt))
    js = jtrainer.init_train_state(jp, ja, jcfg)
    ts = train_state_from_numpy(**state_numpy(js), device="cpu")
    jstep = jtrainer.make_train_step(None, jcfg, JTileConfig(tile_h=TILE_H, tile_w=TILE_W,
                                                             tiers=TIERS))
    tstep = ttrainer.make_train_step(None, tcfg, TileConfig(tile_h=TILE_H, tile_w=TILE_W,
                                                            tiers=TIERS))
    gt = np.random.RandomState(4).uniform(0, 1, (H, W, 3)).astype(np.float32)
    return (jstep, js), (tstep, ts), gt


@pytest.mark.parametrize("region", [False, True])
def test_unbound_step_matches_jax(region):
    """Two steps from one JAX state: the first's image, loss terms,
    gradients (Adam's first moment, 0.1·g) and densification statistics,
    the second's loss terms."""
    (jstep, js), (tstep, ts), gt = _unbound_states(use_region_adaptive_loss=region)
    jcam = _camera()
    from gaussianavatars_torch.convert import camera_from_numpy

    tcam = camera_from_numpy(camera_dict(jcam), device="cpu")
    assert ts.flame is None and ts.flame_adam is None
    for k in range(2):
        out = tstep(ts, t(gt), tcam, 0, torch.zeros(3), 1)
        jout = jstep(js, jnp.asarray(gt), jcam, jnp.int32(0), jnp.zeros(3), sh_degree=1)
        jmet = {key: float(v) for key, v in jout.metrics.items()}
        assert set(out.metrics) == set(jmet)
        for key in ("l1", "ssim", "loss", "psnr"):
            np.testing.assert_allclose(float(out.metrics[key]), jmet[key], rtol=1e-4,
                                       err_msg=f"step {k}: {key}")
        assert int(out.metrics["num_visible"]) == int(jmet["num_visible"]) > 100
        assert int(out.metrics["budget_overflow"]) == 0
        if k == 0:
            np.testing.assert_allclose(n(out.image), np.asarray(jout.image), atol=1e-4)
            for key in PARAM_KEYS:
                _rel_close(n(getattr(out.state.adam.mu, key)),
                           getattr(jout.state.adam.mu, key), 1e-4, key)
            np.testing.assert_array_equal(n(out.state.aux.denom),
                                          np.asarray(jout.state.aux.denom))
            _rel_close(n(out.state.aux.grad_accum), jout.state.aux.grad_accum, 1e-4,
                       "grad_accum")
            assert out.state.flame is None and out.state.flame_adam is None
        ts, js = out.state, jout.state
    if region:   # the L1 is weighed by the heuristic face prior
        from gaussianavatars_torch.training.innovations import heuristic_weight_map
        from gaussianavatars_torch.training.loss import weighted_l1_loss

        wmap = heuristic_weight_map(H, W, 2.0, 2.0, 1.5, 1.2)
        want = weighted_l1_loss(out.image, t(gt), wmap[..., None]) * 0.8
        np.testing.assert_allclose(float(out.metrics["l1"]), float(want), rtol=1e-6)


# ----------------------------------------------------- the unbound harness


def write_blender_scene(root, n_train=3, n_test=1, n_points=300, seed=0, ply=True):
    """A tiny NeRF-synthetic scene: orbit cameras around the origin at
    64×48 (`camera_angle_x`), random images, and `points3d.ply` with
    `n_points` points on a sphere of radius 0.5 (unless `ply` is False)."""
    from PIL import Image

    from gaussianavatars_tpu.data.cameras import look_at_camera

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    wd, ht = 64, 48
    frames = {"train": [], "test": []}
    for i in range(n_train + n_test):
        split = "train" if i < n_train else "test"
        ang = 2 * np.pi * i / (n_train + n_test)
        cam = look_at_camera(eye=np.array([3 * np.sin(ang), 0.3, -3 * np.cos(ang)]),
                             target=np.zeros(3), fovy=0.6, width=wd, height=ht)
        w2c = np.eye(4)
        w2c[:3, :] = np.asarray(cam.world_view, np.float64)[:3, :]
        c2w = np.linalg.inv(w2c)
        c2w[:3, 1:3] *= -1
        name = f"{split}/r_{i}"
        Image.fromarray(rng.randint(0, 256, (ht, wd, 3)).astype(np.uint8)).save(
            os.path.join(root, name + ".png"))
        frames[split].append({"file_path": name, "transform_matrix": c2w.tolist()})
        fovx = float(cam.fovx)
    for split, fr in frames.items():
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": fr}, f)
    if ply:
        d = rng.randn(n_points, 3)
        xyz = 0.5 * d / np.linalg.norm(d, axis=1, keepdims=True)
        jply.save_point_ply(os.path.join(root, "points3d.ply"), xyz.astype(np.float32),
                            rng.uniform(0, 1, (n_points, 3)))
    return root


def unbound_config(root, model_path, cap=512, **opt):
    return jconfig.Config(
        model=jconfig.ModelConfig(source_path=root, model_path=model_path, bind_to_mesh=False,
                                  capacity=cap, eval=True, sh_degree=3),
        pipeline=jconfig.PipelineConfig(tile_h=8, tile_w=16),
        opt=jconfig.OptimizationConfig(**opt))


def test_unbound_build_harness_matches_jax(tmp_path):
    root = write_blender_scene(str(tmp_path / "scene"))
    jcfg = unbound_config(root, str(tmp_path / "j"))
    tcfg = tconfig.from_json(jconfig.to_json(
        unbound_config(root, str(tmp_path / "t"))))
    jh = jloop.build_harness(jcfg)
    th = tloop.build_harness(tcfg, device="cpu")
    assert th.model is None and jh.model is None
    assert th.spatial_lr_scale == jh.spatial_lr_scale > 0
    for split in ("train", "test"):
        jc, tc = jh.scene.cameras(split), th.scene.cameras(split)
        assert len(jc) == len(tc) > 0
        for a, b in zip(jc, tc):
            assert (a.width, a.height) == (b.width, b.height)
            np.testing.assert_allclose(n(b.full_proj), np.asarray(a.full_proj), atol=1e-6)
    for k in PARAM_KEYS:
        atol = 1e-4 if k == "log_scales" else 0
        np.testing.assert_allclose(n(getattr(th.state.params, k)),
                                   np.asarray(getattr(jh.state.params, k)), atol=atol, rtol=0,
                                   err_msg=k)
    for k in AUX_KEYS:
        np.testing.assert_array_equal(n(getattr(th.state.aux, k)),
                                      np.asarray(getattr(jh.state.aux, k)), err_msg=k)
    assert th.state.flame is None and jh.state.flame is None
    # The model directory: the config and no FLAME assets.
    assert (tmp_path / "t" / "cfg_args.json").exists()
    assert not (tmp_path / "t" / "flame_assets.npz").exists()
    assert not (tmp_path / "j" / "flame_assets.npz").exists()

    # Checkpoints cross both ways (no FLAME leaves).
    rng = np.random.RandomState(1)
    jstate = jax.tree_util.tree_map(
        lambda x: (x + jnp.asarray(rng.randn(*x.shape).astype(np.float32))
                   if x.dtype == jnp.float32 else x), jh.state)
    jckpt.save_train_state(str(tmp_path / "j.npz"), jstate, 5)
    ts, it = tckpt.load_train_state(str(tmp_path / "j.npz"), th.state)
    leaves = tckpt.flatten_state(ts)
    assert it == 5 and not any(k.startswith("flame") for k in leaves)
    jl = {jckpt._path_str(kp): np.asarray(v)
          for kp, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert set(leaves) == set(jl) - {"key"}
    for k, v in leaves.items():
        np.testing.assert_array_equal(n(v), jl[k].astype(n(v).dtype), err_msg=k)
    tckpt.save_train_state(str(tmp_path / "t.npz"), ts, 6)
    js2, it2 = jckpt.load_train_state(str(tmp_path / "t.npz"), jh.state)
    jl2 = {jckpt._path_str(kp): np.asarray(v)
           for kp, v in jax.tree_util.tree_flatten_with_path(js2)[0]}
    assert it2 == 6
    for k, v in leaves.items():
        np.testing.assert_array_equal(jl2[k], n(v).astype(jl[k].dtype), err_msg=k)

    # The PLY save of an unbound model: no binding column, as JAX writes it.
    tpath = th.scene.save(6, ts.params, ts.aux, None)
    jpath = jh.scene.save(6, jstate.params, jstate.aux, None)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    assert tply.load_gaussian_ply(tpath)["binding"] is None

    # A COLMAP scene without points3D: nothing to start from.
    no_pcd = tmp_path / "no_pcd"
    sparse = no_pcd / "sparse" / "0"
    sparse.mkdir(parents=True)
    cams, images, _pts = _colmap_model()
    tcolmap.write_cameras_binary(cams, str(sparse / "cameras.bin"))
    tcolmap.write_images_binary(images, str(sparse / "images.bin"))
    with pytest.raises(ValueError, match="point cloud"):
        tloop.build_harness(dataclasses.replace(tcfg, model=dataclasses.replace(
            tcfg.model, source_path=str(no_pcd), model_path="")), device="cpu")
