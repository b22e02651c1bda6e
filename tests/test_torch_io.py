"""Trained-avatar loading: the port's `models/io.py` against the JAX
package's on one model directory written by the JAX package's
`Scene.save` (`torch_parity.write_jax_model_dir`), and on one written by
the port's `Scene.save`, read by both. Every leaf must be equal exactly:
params, `alive`, `binding` (int64 in the port, int32 in JAX) and the FLAME
table, also with `disable_fid` and `motion_path`. `fid_except_region`
exactly."""
import os

import numpy as np
import pytest

import fixtures_avatar as fa
from gaussianavatars_tpu.data.ply import save_gaussian_ply
from gaussianavatars_tpu.models import io as jio
from gaussianavatars_tpu.models.flame import flame_model as jfm
from gaussianavatars_tpu.models.flame.assets import synthetic_assets as jax_synthetic_assets
from gaussianavatars_torch.convert import flame_assets_from_numpy, gaussian_state_from_numpy
from gaussianavatars_torch.data.scene import Scene as TScene
from gaussianavatars_torch.models import io as tio
from gaussianavatars_torch.models.flame import flame_model as tfm
from torch_parity import dataclass_dict, write_jax_model_dir

PARAM_KEYS = ("means", "log_scales", "quats", "sh_dc", "sh_rest", "logit_opacity")


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("io")
    return write_jax_model_dir(root / "ds", root / "model")


def assert_same_avatar(port, ref):
    """The port's load_avatar result equal to the JAX one, leaf for leaf."""
    (tp, ta, ttab), (jp, ja, jtab) = port, ref
    for k in PARAM_KEYS:
        got, want = getattr(tp, k).numpy(), np.asarray(getattr(jp, k))
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_array_equal(ta.alive.numpy(), np.asarray(ja.alive))
    assert str(ta.binding.dtype) == "torch.int64"
    np.testing.assert_array_equal(ta.binding.numpy(), np.asarray(ja.binding).astype(np.int64))
    for k in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(ta, k).numpy(), np.asarray(getattr(ja, k)))
    assert (ttab is None) == (jtab is None)
    if jtab is not None:
        assert sorted(ttab) == sorted(jtab)
        for k in jtab:
            np.testing.assert_array_equal(ttab[k], jtab[k], err_msg=k)


@pytest.mark.parametrize("case", ["plain", "capacity", "disable_fid", "motion"])
def test_load_avatar_matches_jax(jax_dir, tmp_path, case):
    model_dir, _model, _assets, params, _aux = jax_dir
    ply = jio.checkpoint_ply_path(model_dir, -1)
    kw = {}
    if case == "capacity":
        kw["capacity"] = 2048
    elif case == "disable_fid":
        kw["disable_fid"] = np.arange(0, 352, 3)
    elif case == "motion":
        motion = {k: np.full((5, n), 0.01 * (i + 1), np.float32)
                  for i, (k, n) in enumerate((("expr", fa.N_EXPR), ("rotation", 3),
                                              ("neck_pose", 3), ("jaw_pose", 3),
                                              ("eyes_pose", 6), ("translation", 3)))}
        np.savez(tmp_path / "motion.npz", **motion, shape=np.ones(fa.N_SHAPE, np.float32))
        kw["motion_path"] = str(tmp_path / "motion.npz")
    ref = jio.load_avatar(ply, **kw)
    port = tio.load_avatar(ply, device="cpu", **kw)
    assert_same_avatar(port, ref)
    n_live = int(port[1].alive.sum())
    if case == "disable_fid":
        assert n_live == 352 - len(kw["disable_fid"])
    else:
        assert n_live == 352
    if case == "motion":
        assert port[2]["jaw_pose"].shape == (5, 3)
        np.testing.assert_array_equal(port[2]["shape"], np.zeros(fa.N_SHAPE, np.float32))
    # The file's values: the saved slots in order, padded with zeros.
    np.testing.assert_array_equal(port[0].sh_rest.numpy()[:352],
                                  np.asarray(params.sh_rest)[:352])


def test_load_avatar_pads_sh_bands_and_checks_capacity(tmp_path):
    """A PLY stored at SH degree 1 without a binding: both packages pad the
    bands to degree 3 with zeros, give binding zeros and no flame table,
    and both refuse a capacity below the point count."""
    rng = np.random.RandomState(5)
    n = 40
    path = str(tmp_path / "deg1" / "point_cloud.ply")
    save_gaussian_ply(path, means=rng.randn(n, 3).astype(np.float32),
                      sh_dc=rng.randn(n, 1, 3).astype(np.float32),
                      sh_rest=rng.randn(n, 3, 3).astype(np.float32),
                      logit_opacity=rng.randn(n, 1).astype(np.float32),
                      log_scales=rng.randn(n, 3).astype(np.float32),
                      quats=rng.randn(n, 4).astype(np.float32))
    port, ref = tio.load_avatar(path, device="cpu"), jio.load_avatar(path)
    assert_same_avatar(port, ref)
    assert port[0].capacity == 1024 and port[2] is None
    assert not port[0].sh_rest[:, 3:].any()
    for load in (lambda: jio.load_avatar(path, capacity=16),
                 lambda: tio.load_avatar(path, capacity=16, device="cpu")):
        with pytest.raises(ValueError, match="capacity"):
            load()


def test_find_latest_iteration_and_ply_path(tmp_path):
    for it in (7, 30000, 600):
        os.makedirs(tmp_path / "m" / "point_cloud" / f"iteration_{it}")
    os.makedirs(tmp_path / "m" / "point_cloud" / "iteration_x")
    m = str(tmp_path / "m")
    assert tio.find_latest_iteration(m) == jio.find_latest_iteration(m) == 30000
    for it in (-1, 600):
        assert tio.checkpoint_ply_path(m, it) == jio.checkpoint_ply_path(m, it)
    for find in (jio.find_latest_iteration, tio.find_latest_iteration):
        with pytest.raises(FileNotFoundError):
            find(str(tmp_path / "empty"))


def test_port_written_dir_read_by_both(jax_dir, tmp_path):
    """The port's `Scene.save` (the loop's PLY and sidecar) read back by the
    JAX package's `load_avatar` and the port's to the same values, which
    are the saved live slots."""
    model_dir = jax_dir[0]
    jp, ja, jtab = jio.load_avatar(jio.checkpoint_ply_path(model_dir, -1))
    tp, ta = gaussian_state_from_numpy(dataclass_dict(jp), dataclass_dict(ja), device="cpu")
    # Hide a third of the slots so the save selects live slots.
    ta.alive[::3] = False
    root = os.path.dirname(jio.checkpoint_ply_path(model_dir, -1))
    source = os.path.dirname(os.path.dirname(os.path.dirname(root)))
    scene = TScene(os.path.join(source, "ds"), model_path=str(tmp_path / "port"),
                   num_verts_hint=178, device="cpu")
    ply = scene.save(12, tp, ta, flame_param=jtab)
    ref = jio.load_avatar(ply)
    port = tio.load_avatar(ply, device="cpu")
    assert_same_avatar(port, ref)
    live = ta.alive.numpy()
    n = int(live.sum())
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(getattr(port[0], k).numpy()[:n],
                                      getattr(tp, k).numpy()[live], err_msg=k)
    np.testing.assert_array_equal(port[1].binding.numpy()[:n], ta.binding.numpy()[live])


@pytest.fixture(scope="module")
def region_models():
    """Both packages' FLAME models on the default synthetic topology (the
    region tables are FLAME-5023 data, clipped to it)."""
    assets = jax_synthetic_assets(n_shape=4, n_expr=2, seed=0)
    jmodel = jfm.FlameModel(assets, jfm.FlameConfig(n_shape=4, n_expr=2, add_teeth=True))
    tmodel = tfm.FlameModel(flame_assets_from_numpy(assets._asdict()),
                            tfm.FlameConfig(4, 2, add_teeth=True), device="cpu")
    return jmodel, tmodel


@pytest.mark.parametrize("regions", [["mouth"], ["left_half"], ["nose", "eyelids", "teeth"],
                                     ["face"]])
def test_fid_except_region_matches_jax(region_models, regions):
    """The synthetic topology has no "face" mask (FLAME's own masks are
    not in the repository): no face is inside it, so every face is
    returned."""
    jmodel, tmodel = region_models
    got, want = tmodel.fid_except_region(regions), jmodel.fid_except_region(regions)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if regions == ["face"]:
        assert len(got) == tmodel.num_faces
    else:
        assert 0 < len(got) < tmodel.num_faces
