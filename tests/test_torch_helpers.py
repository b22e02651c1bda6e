"""PyTorch port vs JAX: the public helpers outside the main path.

SH (`sh_basis`, `eval_sh`, `eval_sh_color`, `sh0_to_rgb`, degrees 0-4),
the covariance helpers, `transform_points`, `compute_vertex_normals`,
`focal_to_fov`, `ndc_to_pixel`, `project_gaussians` (with and without
`alive`), `composite_order`, `binding_counter`, `local_scales`,
`init_from_points(init_scale=)`, `resolution_scaled`, `jit_static_key`
and the numpy `mse`/`psnr`. Every input is drawn with numpy from a seed,
at the size of `tests/raster_fixtures.py`, and handed to both packages.

Tolerances: 1e-6 absolute for SH and the covariance helpers (unit-scale
float32 values); 1e-5 relative for the projection (pixel positions up to
~100 px); 1e-5 absolute for the other float32 geometry; integer, boolean
and index outputs exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.data import cameras as jcam
from gaussianavatars_tpu.models import gaussians as jg
from gaussianavatars_tpu.ops import projection as jproj
from gaussianavatars_tpu.ops import quaternion as jq
from gaussianavatars_tpu.ops import rasterize_dense as jdense
from gaussianavatars_tpu.ops import sh as jsh
from gaussianavatars_tpu.ops import transforms as jtr
from gaussianavatars_tpu.utils import image as jimage
from gaussianavatars_torch.convert import gaussian_state_from_numpy
from gaussianavatars_torch.data import cameras as tcam
from gaussianavatars_torch.data import readers as treaders
from gaussianavatars_torch.models import gaussians as tg
from gaussianavatars_torch.ops import projection as tproj
from gaussianavatars_torch.ops import quaternion as tq
from gaussianavatars_torch.ops import rasterize_dense as tdense
from gaussianavatars_torch.ops import sh as tsh
from gaussianavatars_torch.ops import transforms as ttr
from gaussianavatars_torch.utils import image as timage

from torch_parity import dataclass_dict, jax_camera, n, np_scene, t, torch_camera

SH_ATOL = 1e-6
COV_ATOL = 1e-6
PROJ_RTOL = 1e-5
ATOL = 1e-5
N = 200  # splats, as tests/raster_fixtures.py


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _unit(shape, seed):
    v = _rand(shape, seed)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_helpers(degree):
    dirs = _unit((N, 3), 21)
    sh_ck = _rand((N, 3, 25), 22) * 0.3   # the reference's [..., C, K] layout
    jd, td = jnp.asarray(dirs), t(dirs)
    np.testing.assert_allclose(n(tsh.sh_basis(td, degree)),
                               np.asarray(jsh.sh_basis(jd, degree)), atol=SH_ATOL)
    assert tsh.sh_basis(td, degree).shape == (N, (degree + 1) ** 2)
    for name in ("eval_sh", "eval_sh_color"):
        out = getattr(tsh, name)(t(sh_ck), td, degree)
        ref = getattr(jsh, name)(jnp.asarray(sh_ck), jd, degree)
        np.testing.assert_allclose(n(out), np.asarray(ref), atol=SH_ATOL, err_msg=name)
    np.testing.assert_allclose(n(tsh.sh0_to_rgb(t(sh_ck[..., 0]))),
                               np.asarray(jsh.sh0_to_rgb(jnp.asarray(sh_ck[..., 0]))),
                               atol=SH_ATOL)


def _scale_quat(seed):
    return np.abs(_rand((N, 3), seed)) * 0.1 + 1e-3, _rand((N, 4), seed + 1)


COV_CASES = {
    "build_scaling_rotation": lambda: _scale_quat(31),
    "covariance_from_scaling_rotation": lambda: _scale_quat(33),
    "covariance_to_symm6": lambda: (np.asarray(jq.covariance_from_scaling_rotation(
        *map(jnp.asarray, _scale_quat(35)))),),
    "symm6_to_covariance": lambda: (_rand((N, 6), 37),),
}


@pytest.mark.parametrize("name", sorted(COV_CASES))
def test_covariance_helpers(name):
    args = COV_CASES[name]()
    out = getattr(tq, name)(*map(t, args))
    ref = getattr(jq, name)(*map(jnp.asarray, args))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=COV_ATOL)


def _mesh():
    """A closed octahedron scaled per vertex, plus one unreferenced vertex
    (its normal falls back to +z)."""
    rng = np.random.RandomState(41)
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                      [5, 5, 5]], np.float32)
    verts[:6] *= rng.uniform(0.5, 1.5, (6, 1)).astype(np.float32)
    faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                      [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return np.stack([verts, verts * 1.5]), faces


@pytest.mark.parametrize("name", ["transform_points", "compute_vertex_normals",
                                  "focal_to_fov"])
def test_transform_helpers(name):
    if name == "transform_points":
        mat = np.asarray(jax_camera().full_proj)
        pts = _rand((N, 3), 43) + np.array([0.0, 0.0, 2.5], np.float32)
        out = ttr.transform_points(t(mat), t(pts))
        ref = jtr.transform_points(jnp.asarray(mat), jnp.asarray(pts))
        np.testing.assert_allclose(n(out), np.asarray(ref), atol=ATOL, rtol=ATOL)
    elif name == "compute_vertex_normals":
        verts, faces = _mesh()
        out = ttr.compute_vertex_normals(t(verts), t(faces, torch.int64))
        ref = jtr.compute_vertex_normals(jnp.asarray(verts), jnp.asarray(faces))
        np.testing.assert_allclose(n(out), np.asarray(ref), atol=ATOL)
        np.testing.assert_array_equal(n(out)[:, 6], [[0, 0, 1], [0, 0, 1]])
    else:
        for focal, pixels in ((500.0, 802), (1200.5, 550), (30.0, 64)):
            assert ttr.focal_to_fov(focal, pixels) == jtr.focal_to_fov(focal, pixels)
        assert treaders.focal_to_fov is ttr.focal_to_fov  # one definition


@pytest.mark.parametrize("alive_frac", [None, 0.7])
def test_project_gaussians(alive_frac):
    means, scales, quats, _op, _col = np_scene(n=N, seed=51)
    alive = None if alive_frac is None else np.random.RandomState(52).rand(N) < alive_frac
    cov = np.asarray(jq.covariance_from_scaling_rotation(jnp.asarray(scales),
                                                         jnp.asarray(quats)))
    jc = jax_camera()
    ref = jproj.project_gaussians(jnp.asarray(means), jnp.asarray(cov), jc,
                                  alive=None if alive is None else jnp.asarray(alive))
    tc = torch_camera(jc)
    out = tproj.project_gaussians(t(means), t(cov), tc,
                                  alive=None if alive is None else t(alive))
    np.testing.assert_array_equal(n(out.mask), np.asarray(ref.mask))
    np.testing.assert_array_equal(n(out.radius), np.asarray(ref.radius))
    m = np.asarray(ref.mask)
    assert 0 < m.sum() < N if alive is not None else m.sum() > 0
    for name in ("mean2d", "depth", "conic", "cov2d"):
        np.testing.assert_allclose(n(getattr(out, name))[m], np.asarray(getattr(ref, name))[m],
                                   rtol=PROJ_RTOL, atol=PROJ_RTOL, err_msg=name)
    # The sorted path's projection of the same Gaussians gives the same bits.
    same = tproj.project_from_params(t(means), t(scales), t(quats), tc,
                                     alive=None if alive is None else t(alive))
    cov_t = tq.covariance_from_scaling_rotation(t(scales), t(quats))
    again = tproj.project_gaussians(t(means), cov_t, tc,
                                    alive=None if alive is None else t(alive))
    for name in same._fields:
        assert torch.equal(getattr(again, name), getattr(same, name)), name
    ndc = _rand((N,), 53)
    np.testing.assert_allclose(n(tproj.ndc_to_pixel(t(ndc), 96)),
                               np.asarray(jproj.ndc_to_pixel(jnp.asarray(ndc), 96)),
                               rtol=PROJ_RTOL)


@pytest.mark.parametrize("name", ["composite_order", "binding_counter", "local_scales"])
def test_gaussian_helpers(name):
    rng = np.random.RandomState(61)
    if name == "composite_order":
        depth = rng.uniform(0.5, 5.0, N).astype(np.float32)
        depth[::7] = depth[3]                       # ties keep their order
        mask = rng.rand(N) < 0.8
        np.testing.assert_array_equal(
            n(tdense.composite_order(t(depth), t(mask))),
            np.asarray(jdense.composite_order(jnp.asarray(depth), jnp.asarray(mask))))
        return
    cap, faces = 256, 40
    aux = {"alive": rng.rand(cap) < 0.6, "binding": rng.randint(0, faces, cap).astype(np.int32),
           "grad_accum": np.zeros(cap, np.float32), "denom": np.zeros(cap, np.float32),
           "max_radii2d": np.zeros(cap, np.float32)}
    params = {"means": _rand((cap, 3), 62), "log_scales": _rand((cap, 3), 63) * 0.5,
              "quats": _rand((cap, 4), 64), "sh_dc": _rand((cap, 1, 3), 65),
              "sh_rest": _rand((cap, 15, 3), 66), "logit_opacity": _rand((cap, 1), 67)}
    tp, ta = gaussian_state_from_numpy(params, aux, device="cpu")
    jp = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()})
    ja = jg.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()})
    if name == "binding_counter":
        out = tg.binding_counter(ta, faces)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(n(out), np.asarray(jg.binding_counter(ja, faces)))
    else:
        np.testing.assert_allclose(n(tg.local_scales(tp)), np.asarray(jg.local_scales(jp)),
                                   rtol=ATOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_init_from_points_with_init_scale(dtype):
    rng = np.random.RandomState(71)
    pts = rng.randn(50, 3).astype(np.float32)
    cols = rng.rand(50, 3).astype(np.float32)
    scale = rng.uniform(0.01, 0.2, 50).astype(dtype)
    jp, ja = jg.init_from_points(pts, cols, capacity=64, init_scale=scale)
    tp, ta = tg.init_from_points(pts, cols, capacity=64, init_scale=scale, device="cpu")
    for name, want in dataclass_dict(jp).items():
        np.testing.assert_allclose(n(getattr(tp, name)), want, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(n(tp.log_scales), dataclass_dict(jp)["log_scales"])
    for name, want in dataclass_dict(ja).items():
        np.testing.assert_array_equal(n(getattr(ta, name)), want, err_msg=name)


@pytest.mark.parametrize("scale", [1.0, 2.0, 3.0])
def test_camera_helpers(scale):
    jc = dataclasses.replace(jax_camera(width=97, height=65), timestep=3, camera_id=2,
                             image_name="cam_2")
    tc = torch_camera(jc)
    js, ts = jcam.resolution_scaled(jc, scale), tcam.resolution_scaled(tc, scale)
    assert (ts.width, ts.height) == (js.width, js.height)
    assert (ts is tc) == (js is jc) == (scale == 1.0)
    jk, tk = jcam.jit_static_key(js), tcam.jit_static_key(ts)
    for f in ("timestep", "camera_id", "image_name", "width", "height", "fovx", "fovy"):
        assert getattr(tk, f) == getattr(jk, f), f
    assert torch.equal(tk.full_proj, tc.full_proj)


def test_image_mse_psnr():
    rng = np.random.RandomState(81)
    a = rng.rand(48, 64, 3).astype(np.float32)
    b = np.clip(a + rng.randn(48, 64, 3).astype(np.float32) * 0.05, 0, 1)
    assert timage.mse(a, b) == jimage.mse(a, b)
    assert timage.psnr(a, b) == jimage.psnr(a, b)
    assert timage.psnr(a, a) == jimage.psnr(a, a) == float("inf")
