"""Mesh preview rasterizer: the port's `ops/mesh_raster.py` against the JAX
package's on the fixture sphere (`torch_parity.clamped_sphere_assets`) and
on two overlapping triangles, through the same camera and clip-space
vertices.

Tolerances: `face_id` exact except on pixels whose two nearest depths tie
within 1e-6 (counted; there are none on these inputs); `bary` and `depth`
within atol 1e-5; `render_mesh_preview`'s RGBA within atol 1e-5;
`face_normals` within atol 1e-6. The port's results are the same at two
chunk sizes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.data.cameras import look_at_camera as jax_look_at_camera
from gaussianavatars_tpu.ops import mesh_raster as jmr
from gaussianavatars_tpu.ops.transforms import compute_face_normals as jax_face_normals
from gaussianavatars_torch.data.cameras import look_at_camera
from gaussianavatars_torch.ops import mesh_raster as tmr
from gaussianavatars_torch.ops.transforms import compute_face_normals
from torch_parity import camera_dict, clamped_sphere_assets, torch_camera

W, H = 64, 48
ATOL = 1e-5


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """name → (verts [V, 3] float32, faces [F, 3] int32, JAX camera)."""
    assets = clamped_sphere_assets(tmp_path_factory.mktemp("sphere"))
    v = np.asarray(assets.v_template, np.float32)
    center = v.mean(0)
    extent = float(np.abs(v - center).max())
    sphere_cam = jax_look_at_camera(eye=center + np.array([0.3 * extent, 0.2 * extent,
                                                           -4 * extent]),
                                    target=center, fovy=0.6, width=W, height=H)
    # Triangle 0 behind (z = 1), triangle 1 in front (z = 0), overlapping
    # in the middle; both angled against the pixel grid.
    tri = np.array([[-0.61, -0.57, 1.0], [0.63, -0.41, 1.0], [0.07, 0.69, 1.0],
                    [-0.43, -0.37, 0.0], [0.41, -0.45, 0.1], [0.02, 0.52, 0.05]], np.float32)
    tri_cam = jax_look_at_camera(eye=np.array([0.0, 0.0, -3.0]), fovy=0.8, width=W, height=H)
    return {
        "sphere": (v, np.asarray(assets.faces, np.int32), sphere_cam),
        "overlap": (tri, np.array([[0, 1, 2], [3, 4, 5]], np.int32), tri_cam),
    }


def clip_verts(v, cam):
    """Clip-space vertices [V, 4], computed once in numpy and handed to both."""
    vh = np.concatenate([v, np.ones((v.shape[0], 1), np.float32)], -1)
    return (vh @ np.asarray(cam.full_proj).T).astype(np.float32)


def depth_ties(verts_clip, faces, height, width, tol=1e-6) -> int:
    """Pixels covered by two faces or more whose two nearest depths are
    within `tol`: every (face, pixel) depth at once, by the rasterizer's
    own inside test and interpolation (one chunk of all faces)."""
    clip = torch.from_numpy(verts_clip)
    ndc = clip[:, :3] / clip[:, 3:4]
    px = (ndc[:, 0] + 1.0) * 0.5 * width - 0.5
    py = (ndc[:, 1] + 1.0) * 0.5 * height - 0.5
    f = torch.from_numpy(faces).long()
    xy, z = torch.stack([px, py], -1)[f], ndc[:, 2][f]
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32),
                            torch.arange(width, dtype=torch.float32), indexing="ij")
    l1, l2, inside = tmr._bary_weights(xy, xs.reshape(1, -1), ys.reshape(1, -1))
    zpix = (1.0 - l1 - l2) * z[:, 0:1] + l1 * z[:, 1:2] + l2 * z[:, 2:3]
    zpix = torch.where(inside & (zpix > -1.0), zpix, torch.tensor(float("inf")))
    z2 = torch.sort(zpix, dim=0).values[:2].numpy()
    covered = np.isfinite(z2[1])
    return int((z2[1][covered] - z2[0][covered] < tol).sum())


@pytest.mark.parametrize("name", ["sphere", "overlap"])
def test_rasterize_mesh_matches_jax(meshes, name):
    v, faces, cam = meshes[name]
    clip = clip_verts(v, cam)
    want = jmr.rasterize_mesh(jnp.asarray(clip), jnp.asarray(faces), H, W)
    got = tmr.rasterize_mesh(torch.from_numpy(clip), torch.from_numpy(faces), H, W)
    w_id, g_id = np.asarray(want.face_id), got.face_id.numpy()
    assert g_id.dtype == np.int32
    hit = np.asarray(want.mask)
    assert 0.05 < hit.mean() < 0.95
    mismatched = g_id != w_id
    ties = depth_ties(clip, faces, H, W)
    print(f"{name}: {int(mismatched.sum())} face-id mismatches, {ties} depth ties")
    assert ties == 0 and not mismatched.any()
    np.testing.assert_array_equal(got.mask.numpy(), hit)
    np.testing.assert_allclose(got.bary.numpy(), np.asarray(want.bary), atol=ATOL)
    w_depth, g_depth = np.asarray(want.depth), got.depth.numpy()
    np.testing.assert_array_equal(np.isinf(g_depth), np.isinf(w_depth))
    np.testing.assert_allclose(g_depth[hit], w_depth[hit], atol=ATOL)
    if name == "overlap":
        assert g_id[H // 2, W // 2] == 1 and (g_id == 0).any()  # the front triangle wins


@pytest.mark.parametrize("name", ["sphere", "overlap"])
def test_chunk_size_does_not_change_the_result(meshes, name):
    v, faces, cam = meshes[name]
    clip, f = torch.from_numpy(clip_verts(v, cam)), torch.from_numpy(faces)
    a = tmr.rasterize_mesh(clip, f, H, W, chunk=8)
    b = tmr.rasterize_mesh(clip, f, H, W, chunk=2048)
    # The pair budget caps the chunk: 3,072 pixels allow 16 triangles.
    c = tmr.rasterize_mesh(clip, f, H, W, pair_budget=16 * H * W)
    for o in (b, c):
        np.testing.assert_array_equal(o.face_id.numpy(), a.face_id.numpy())
        np.testing.assert_array_equal(o.depth.numpy(), a.depth.numpy())
        np.testing.assert_allclose(o.bary.numpy(), a.bary.numpy(), atol=1e-6)


@pytest.mark.parametrize("antialias", [1, 2])
def test_render_mesh_preview_matches_jax(meshes, antialias):
    v, faces, cam = meshes["sphere"]
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    want = jmr.render_mesh_preview(jnp.asarray(v), jnp.asarray(faces), cam,
                                   color=(0.8, 0.7, 0.6), background=jnp.asarray(bg),
                                   antialias=antialias)
    got = tmr.render_mesh_preview(torch.from_numpy(v), torch.from_numpy(faces),
                                  torch_camera(cam), color=(0.8, 0.7, 0.6),
                                  background=torch.from_numpy(bg), antialias=antialias)
    for k in ("rgba", "diffuse", "normal"):
        assert tuple(got[k].shape) == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(got["face_id"].numpy(), np.asarray(want["face_id"]))
    alpha = got["rgba"][..., 3].numpy()
    if antialias == 1:
        assert set(np.unique(alpha)) <= {0.0, 1.0}
    else:
        assert ((alpha > 0.05) & (alpha < 0.95)).sum() > 10   # fractional edges


def test_face_normals_match_jax(meshes):
    v, faces, _cam = meshes["sphere"]
    want = jmr.face_normals(jnp.asarray(v), jnp.asarray(faces))
    got = tmr.face_normals(torch.from_numpy(v), torch.from_numpy(faces))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)
    raw = compute_face_normals(torch.from_numpy(v), torch.from_numpy(faces).long())
    np.testing.assert_allclose(raw.numpy(), np.asarray(jax_face_normals(jnp.asarray(v),
                                                                        jnp.asarray(faces))),
                               atol=1e-6)


def test_preview_through_port_camera_is_camera_dict_equal(meshes):
    """The port's own `look_at_camera` gives the JAX camera's matrices, so a
    preview needs no JAX camera."""
    _v, _f, cam = meshes["overlap"]
    port_cam = look_at_camera(eye=np.array([0.0, 0.0, -3.0]), fovy=0.8, width=W, height=H,
                              device="cpu")
    d = camera_dict(cam)
    for k in ("world_view", "full_proj", "camera_center"):
        np.testing.assert_allclose(getattr(port_cam, k).numpy(), d[k], atol=1e-6, err_msg=k)
