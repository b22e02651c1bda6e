"""PyTorch port vs JAX: quaternions, transforms, SH and projection.

Every input is drawn with numpy and handed to both packages. Tolerance:
float32 at atol 1e-5 — the two frameworks evaluate the same formulas but
may round differently (fused multiply-adds, reduction order, libm), which
stays orders of magnitude below 1e-5 for these unit-scale values. Pixel
positions (up to ~100 px) get the same bound relative to their size.
Integer outputs (`radius`, `mask`) are compared exactly.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

from gaussianavatars_tpu.ops import projection as jproj
from gaussianavatars_tpu.ops import quaternion as jq
from gaussianavatars_tpu.ops import sh as jsh
from gaussianavatars_tpu.ops import transforms as jtr
from gaussianavatars_torch.data.cameras import look_at_camera
from gaussianavatars_torch.ops import projection as tproj
from gaussianavatars_torch.ops import quaternion as tq
from gaussianavatars_torch.ops import sh as tsh
from gaussianavatars_torch.ops import transforms as ttr

from torch_parity import jax_camera, n, np_scene, t, torch_camera

ATOL = 1e-5


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _unit(shape, seed):
    v = _rand(shape, seed)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


QUAT_CASES = {
    "quat_normalize": lambda m: (m.quat_normalize, (_rand((64, 4), 0),)),
    "quat_mul": lambda m: (m.quat_mul, (_unit((64, 4), 1), _unit((64, 4), 2))),
    "quat_rotate": lambda m: (m.quat_rotate, (_unit((64, 4), 3), _rand((64, 3), 4))),
    "quat_to_rotmat": lambda m: (m.quat_to_rotmat, (_rand((64, 4), 5),)),
    "rotmat_to_quat": lambda m: (
        m.rotmat_to_quat, (np.asarray(jq.quat_to_rotmat(_rand((256, 4), 6))),)),
    "covariance_symm6_parts": lambda m: (
        m.covariance_symm6_parts, (np.abs(_rand((64, 3), 7)) * 0.1, _rand((64, 4), 8))),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quaternion_ops(name):
    jfn, args = QUAT_CASES[name](jq)
    tfn, _ = QUAT_CASES[name](tq)
    ref = jfn(*(jnp.asarray(a) for a in args))
    out = tfn(*(t(a) for a in args))
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(n(o), np.asarray(r), atol=ATOL)


def test_world_to_view_and_projection():
    R = np.asarray(jq.quat_to_rotmat(_unit((4,), 9)))
    tvec = _rand((3,), 10)
    np.testing.assert_allclose(
        n(ttr.world_to_view(R, tvec, (0.1, -0.2, 0.3), 1.5)),
        np.asarray(jtr.world_to_view(R, tvec, (0.1, -0.2, 0.3), 1.5)), atol=ATOL)
    np.testing.assert_allclose(
        n(ttr.projection_matrix(0.01, 100.0, 0.7, 0.5)),
        np.asarray(jtr.projection_matrix(0.01, 100.0, 0.7, 0.5)), atol=ATOL)
    assert ttr.fov_to_focal(0.7, 512) == jtr.fov_to_focal(0.7, 512)


def test_compute_face_orientation():
    verts = _rand((40, 3), 11)
    faces = np.random.RandomState(12).randint(0, 40, (60, 3)).astype(np.int32)
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                  & (faces[:, 0] != faces[:, 2])]
    Rj, sj = jtr.compute_face_orientation(jnp.asarray(verts), jnp.asarray(faces))
    Rt, st = ttr.compute_face_orientation(t(verts), t(faces).long())
    np.testing.assert_allclose(n(Rt), np.asarray(Rj), atol=ATOL)
    np.testing.assert_allclose(n(st), np.asarray(sj), atol=ATOL)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_color(degree):
    dirs = _unit((128, 3), 13)
    sh = _rand((128, 25, 3), 14) * 0.3
    ref = jsh.eval_sh_color_kc(jnp.asarray(sh), jnp.asarray(dirs), degree)
    out = tsh.eval_sh_color_kc(t(sh), t(dirs), degree)
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=ATOL)
    cols_j = jsh.basis_columns(jnp.asarray(dirs), degree)
    cols_t = tsh.basis_columns(t(dirs), degree)
    assert len(cols_t) == len(cols_j) == tsh.num_sh_coeffs(degree)
    for cj, ct in zip(cols_j, cols_t):
        np.testing.assert_allclose(n(ct), np.asarray(cj), atol=ATOL)
    np.testing.assert_allclose(
        n(tsh.rgb_to_sh0(t(sh[:, 0]))), np.asarray(jsh.rgb_to_sh0(sh[:, 0])), atol=ATOL)


def test_look_at_camera_matches():
    jc = jax_camera(width=96, height=64)
    tc = look_at_camera(eye=np.zeros(3), target=np.array([0.0, 0.0, 2.5]),
                        fovy=1.0, width=96, height=64, device="cpu")
    for name in ("world_view", "proj", "full_proj", "camera_center"):
        np.testing.assert_allclose(n(getattr(tc, name)), np.asarray(getattr(jc, name)),
                                   atol=ATOL, err_msg=name)
    assert (tc.width, tc.height) == (jc.width, jc.height)
    assert math.isclose(tc.fovx, jc.fovx) and math.isclose(tc.focal_y, jc.focal_y)


@pytest.mark.parametrize("seed,alive_frac", [(0, 1.0), (1, 0.7), (2, 1.0)])
def test_project_from_params(seed, alive_frac):
    means, scales, quats, _op, _col = np_scene(n=300, seed=seed)
    alive = np.random.RandomState(seed + 100).rand(300) < alive_frac
    jc = jax_camera()
    ref = jproj.project_from_params(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats), jc,
        alive=jnp.asarray(alive))
    out = tproj.project_from_params(t(means), t(scales), t(quats), torch_camera(jc),
                                    alive=t(alive))
    np.testing.assert_array_equal(n(out.mask), np.asarray(ref.mask))
    np.testing.assert_array_equal(n(out.radius), np.asarray(ref.radius))
    m = np.asarray(ref.mask)
    for name in ("mean2d", "depth", "conic", "cov2d"):
        r = np.asarray(getattr(ref, name))[m]
        o = n(getattr(out, name))[m]
        np.testing.assert_allclose(o, r, atol=ATOL, rtol=ATOL, err_msg=name)
