"""The port's data layer against the JAX package, on the rendered tiny
avatar dataset of `tests/fixtures_avatar.write_rendered_dataset`
(DynamicNerf layout, 64×48, 2 timesteps × 2 cameras).

Readers, the flame table, decoded images, the sampler order, PLY files
and asset files must agree exactly (the same numpy code, or the same bytes
on disk); camera matrices within atol 1e-6 (float32 products in another
framework).
"""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures_avatar import make_flame_model, reference_avatar, write_rendered_dataset
from gaussianavatars_tpu.data import pipeline as jpipe
from gaussianavatars_tpu.data import ply as jply
from gaussianavatars_tpu.data import readers as jreaders
from gaussianavatars_tpu.data.scene import Scene as JScene
from gaussianavatars_tpu.models.flame import assets as jassets
from gaussianavatars_torch.data import pipeline as tpipe
from gaussianavatars_torch.data import ply as tply
from gaussianavatars_torch.data import readers as treaders
from gaussianavatars_torch.data.scene import Scene as TScene
from gaussianavatars_torch.models.flame import assets as tassets

CAMERA_MATS = ("world_view", "proj", "full_proj", "camera_center")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    model = make_flame_model(tmp_path_factory.mktemp("mesh"))
    params, aux = reference_avatar(model)
    root = tmp_path_factory.mktemp("rendered_ds")
    write_rendered_dataset(str(root), model, params, aux)
    return str(root), model, params, aux


def _records_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in ("uid", "fovx", "fovy", "width", "height", "image_path", "image_name",
                  "timestep", "camera_id"):
            assert getattr(g, k) == getattr(w, k), k
        for k in ("R", "T", "bg"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k), err_msg=k)


def test_readers_match_jax(dataset, tmp_path):
    root = dataset[0]
    assert treaders.detect_scene_type(root) == jreaders.detect_scene_type(root) == "dynamic_nerf"
    for white in (False, True):
        t_info = treaders.read_dynamic_nerf(root, white_background=white)
        j_info = jreaders.read_dynamic_nerf(root, white_background=white)
        for split in ("train_cameras", "val_cameras", "test_cameras"):
            _records_equal(getattr(t_info, split), getattr(j_info, split))
        np.testing.assert_array_equal(t_info.nerf_normalization["translate"],
                                      j_info.nerf_normalization["translate"])
        assert t_info.nerf_normalization["radius"] == j_info.nerf_normalization["radius"]
        for k in ("train_meshes", "test_meshes"):
            tm, jm = getattr(t_info, k), getattr(j_info, k)
            assert sorted(tm) == sorted(jm)
            for ts in tm:
                for name in jm[ts]:
                    np.testing.assert_array_equal(tm[ts][name], jm[ts][name])
    # Blender layout (no val split, random point cloud from a seeded rng).
    blender = tmp_path / "blender"
    shutil.copytree(root, blender)
    os.remove(blender / "transforms_val.json")
    assert treaders.detect_scene_type(str(blender)) == "blender"
    t_info = treaders.read_nerf_synthetic(str(blender))
    j_info = jreaders.read_nerf_synthetic(str(blender))
    _records_equal(t_info.train_cameras, j_info.train_cameras)
    np.testing.assert_array_equal(t_info.point_cloud.points, j_info.point_cloud.points)
    # Records without w/h: the size comes from the image file.
    meta = json.loads((blender / "transforms_train.json").read_text())
    for f in meta["frames"]:
        f.pop("w"), f.pop("h")
    (blender / "transforms_train.json").write_text(json.dumps(meta))
    recs = treaders.read_cameras_from_transforms(str(blender), "transforms_train.json", False)
    assert (recs[0].width, recs[0].height) == (64, 48)
    # The same views as a COLMAP scene (written by the port), read by both.
    from gaussianavatars_torch.data import colmap as tcolmap

    colmap = tmp_path / "colmap"
    sparse = colmap / "sparse" / "0"
    sparse.mkdir(parents=True)
    shutil.copytree(os.path.join(root, "images"), colmap / "images")
    recs = t_info.train_cameras + t_info.test_cameras
    w, h = recs[0].width, recs[0].height
    fx, fy = treaders.fov_to_focal(recs[0].fovx, w), treaders.fov_to_focal(recs[0].fovy, h)
    tcolmap.write_cameras_binary(
        {1: tcolmap.ColmapCamera(1, "PINHOLE", w, h, np.array([fx, fy, w / 2, h / 2]))},
        str(sparse / "cameras.bin"))
    tcolmap.write_images_binary({i + 1: tcolmap.ColmapImage(
        i + 1, tcolmap.rotmat_to_qvec(r.R.T), r.T, 1, os.path.basename(r.image_path),
        np.zeros((0, 2)), np.zeros((0,), np.int64)) for i, r in enumerate(recs)},
        str(sparse / "images.bin"))
    pcd = t_info.point_cloud
    tcolmap.write_points3d_binary(tcolmap.ColmapPoints(
        pcd.points[:500], (pcd.colors[:500] * 255).astype(np.uint8), np.zeros(500)),
        str(sparse / "points3D.bin"))
    t_scene, j_scene = TScene(str(colmap), device="cpu"), JScene(str(colmap))
    assert t_scene.kind == "colmap" and t_scene.cameras_extent == j_scene.cameras_extent
    for split in ("train", "test"):
        tc, jc = t_scene.cameras(split), j_scene.cameras(split)
        assert len(tc) == len(jc) and len(t_scene.cameras("train")) == len(recs) - 1
        for a, b in zip(tc, jc):
            assert (a.width, a.height, a.image_name) == (b.width, b.height, b.image_name)
            np.testing.assert_allclose(a.full_proj.numpy(), np.asarray(b.full_proj), atol=1e-6)
    np.testing.assert_array_equal(t_scene.info.point_cloud.colors,
                                  j_scene.info.point_cloud.colors)


def test_scene_cameras_flame_table_and_cameras_json(dataset, tmp_path):
    root, model = dataset[0], dataset[1]
    t_scene = TScene(root, model_path=str(tmp_path / "t"), num_verts_hint=model.num_verts,
                     device="cpu")
    j_scene = JScene(root, model_path=str(tmp_path / "j"), num_verts_hint=model.num_verts)
    assert t_scene.cameras_extent == j_scene.cameras_extent
    assert t_scene.num_timesteps == j_scene.num_timesteps == 2
    for split in ("train", "val", "test"):
        tc, jc = t_scene.cameras(split), j_scene.cameras(split)
        assert len(tc) == len(jc) == 4
        for a, b in zip(tc, jc):
            for k in CAMERA_MATS:
                np.testing.assert_allclose(getattr(a, k).numpy(), np.asarray(getattr(b, k)),
                                           atol=1e-6, rtol=0, err_msg=k)
            for k in ("fovx", "fovy", "width", "height", "timestep", "camera_id", "image_name"):
                assert getattr(a, k) == getattr(b, k), k
    assert sorted(t_scene.flame_table) == sorted(j_scene.flame_table)
    for k, v in j_scene.flame_table.items():
        np.testing.assert_array_equal(t_scene.flame_table[k], v, err_msg=k)
    assert ((tmp_path / "t" / "cameras.json").read_bytes()
            == (tmp_path / "j" / "cameras.json").read_bytes())


@pytest.mark.parametrize("jax_decoder", ["pil", "native"])
def test_decode_and_ground_truth_match_jax(dataset, monkeypatch, jax_decoder):
    """The port decodes with PIL. It gives the JAX package's floats bit for
    bit against JAX's PIL path, with and without a resize, and against
    JAX's native decoder at the image's own size (a resize differs between
    the two decoders in the JAX package: PIL's BILINEAR downscale filters
    over a wider support)."""
    from gaussianavatars_tpu import native as jnative

    root = dataset[0]
    sizes = [(64, 48)]
    if jax_decoder == "pil":
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_load_failed", True)
        sizes.append((32, 24))
    elif not jnative.available():
        pytest.skip("the JAX package's native decoder does not build here")
    recs = jreaders.read_dynamic_nerf(root)
    for rec in recs.train_cameras:
        for size in sizes:
            for bg in (np.zeros(3, np.float32), np.array([1.0, 0.5, 0.25], np.float32)):
                got = tpipe.decode_image(rec.image_path, bg, *size)
                want = jpipe.decode_image(rec.image_path, bg, *size)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, want)
    u8 = (np.arange(256, dtype=np.uint8)).reshape(16, 16)
    np.testing.assert_array_equal(tpipe.gt_to_float(torch.as_tensor(u8)).numpy(),
                                  np.asarray(jpipe.gt_to_float(jnp.asarray(u8))))
    assert tpipe.image_size(recs.train_cameras[0].image_path) == (64, 48)


def test_epoch_sampler_and_prefetcher(dataset):
    t_it, j_it = iter(tpipe.EpochSampler(7, seed=3)), iter(jpipe.EpochSampler(7, seed=3))
    assert [next(t_it) for _ in range(50)] == [next(j_it) for _ in range(50)]
    root = dataset[0]
    scene = TScene(root, device="cpu")
    recs, cams = scene.records("train"), scene.cameras("train")
    order = iter(tpipe.EpochSampler(len(recs), seed=5))
    pf = tpipe.Prefetcher(recs, cams, "cpu", seed=5, workers=2)
    try:
        for _ in range(6):
            views, gt = pf.next()
            v = next(order)
            assert views == [v]
            np.testing.assert_array_equal(gt[0].numpy(), tpipe.load_view(recs[v], cams[v]))
    finally:
        pf.close()


@pytest.mark.parametrize("indices,batch_decode", [([2, 0], 1), ([1, 3, 2], 3)])
def test_prefetcher_indices_and_gt_cache_batch_decode_match_jax(dataset, indices, batch_decode):
    """`Prefetcher(indices=)` samples only those views, in the JAX
    Prefetcher's order (host arrays there, `device_put=False`);
    `DeviceGtCache(batch_decode=)` holds JAX's uint8 views."""
    from gaussianavatars_tpu.training.loop import DeviceGtCache as JCache
    from gaussianavatars_torch.training.loop import DeviceGtCache as TCache

    root = dataset[0]
    t_scene, j_scene = TScene(root, device="cpu"), JScene(root)
    recs = t_scene.records("train")
    t_cams, j_cams = t_scene.cameras("train"), j_scene.cameras("train")
    tp = tpipe.Prefetcher(recs, t_cams, "cpu", seed=9, workers=2, batch=2, indices=indices)
    jp = jpipe.Prefetcher(j_scene.records("train"), j_cams, seed=9, workers=2, batch=2,
                          device_put=False, indices=indices)
    try:
        for _ in range(4):
            (tv, tgt), (jv, jgt) = tp.next(), jp.next()
            assert tv == jv and set(tv) <= set(indices)
            np.testing.assert_array_equal(tgt.numpy(), jgt)
    finally:
        tp.close()
        jp.close()
    got = TCache(recs, t_cams, "cpu", batch_decode=batch_decode)
    want = JCache(j_scene.records("train"), j_cams, batch_decode=batch_decode)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


def test_ply_scene_save_and_assets_byte_identical(dataset, tmp_path):
    root, model, params, aux = dataset
    rng = np.random.RandomState(0)
    n = 50
    arrays = dict(means=rng.randn(n, 3).astype(np.float32),
                  sh_dc=rng.randn(n, 1, 3).astype(np.float32),
                  sh_rest=rng.randn(n, 15, 3).astype(np.float32),
                  logit_opacity=rng.randn(n, 1).astype(np.float32),
                  log_scales=rng.randn(n, 3).astype(np.float32),
                  quats=rng.randn(n, 4).astype(np.float32))
    for binding in (None, rng.randint(0, 300, n)):
        tply.save_gaussian_ply(str(tmp_path / "t.ply"), **arrays, binding=binding)
        jply.save_gaussian_ply(str(tmp_path / "j.ply"), **arrays, binding=binding)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
        back = tply.load_gaussian_ply(str(tmp_path / "t.ply"))
        np.testing.assert_array_equal(back["sh_rest"], arrays["sh_rest"])
    xyz, rgb = rng.randn(20, 3), rng.uniform(0, 1, (20, 3))
    tply.save_point_ply(str(tmp_path / "tp.ply"), xyz, rgb)
    jply.save_point_ply(str(tmp_path / "jp.ply"), xyz, rgb)
    assert (tmp_path / "tp.ply").read_bytes() == (tmp_path / "jp.ply").read_bytes()

    # Scene.save from the port's tensors and from JAX's arrays.
    t_scene = TScene(root, model_path=str(tmp_path / "ts"), device="cpu")
    j_scene = JScene(root, model_path=str(tmp_path / "js"))
    from gaussianavatars_torch.convert import gaussian_state_from_numpy
    tp, ta = gaussian_state_from_numpy(
        {k: np.asarray(getattr(params, k)) for k in arrays},
        {k: np.asarray(getattr(aux, k)) for k in ("alive", "binding", "grad_accum", "denom",
                                                  "max_radii2d")}, device="cpu")
    fp = dict(j_scene.flame_table)
    tpath = t_scene.save(7, tp, ta, {k: torch.as_tensor(v) for k, v in fp.items()})
    jpath = j_scene.save(7, params, aux, fp)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    tz = np.load(os.path.join(os.path.dirname(tpath), "flame_param.npz"))
    jz = np.load(os.path.join(os.path.dirname(jpath), "flame_param.npz"))
    assert sorted(tz.files) == sorted(jz.files)
    for k in jz.files:
        np.testing.assert_array_equal(tz[k], jz[k])

    tassets.save_assets(model.assets, str(tmp_path / "ta.npz"))
    jassets.save_assets(model.assets, str(tmp_path / "ja.npz"))
    tz, jz = np.load(tmp_path / "ta.npz"), np.load(tmp_path / "ja.npz")
    assert sorted(tz.files) == sorted(jz.files)
    for k in jz.files:
        np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
    back = tassets.load_assets(str(tmp_path / "ta.npz"))
    np.testing.assert_array_equal(back.faces, np.asarray(model.assets.faces))

