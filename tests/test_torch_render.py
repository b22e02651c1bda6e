"""The whole render slice: the port's `AvatarRenderer.render` against the JAX
chain `FlameModel.forward` → `face_frames` → `world_gaussians` →
`render_tiled` (sorted path, Pallas compositor in interpret mode).

Both sides get the same FLAME assets, Gaussian state, FLAME parameters and
camera, carried across as numpy by `convert.py`, and the same tier budgets.
Tolerance: image and alpha at atol 1e-4. The float32 geometry differs
between the frameworks by rounding (about 1e-6 relative), which moves
splat centres by ~1e-5 px and alphas by a few 1e-6; summed over the
overlapping splats of a pixel that stays below 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.data.cameras import look_at_camera as jax_look_at_camera
from gaussianavatars_tpu.models import binding as jbind
from gaussianavatars_tpu.models import gaussians as jg
from gaussianavatars_tpu.models.flame import assets as jassets
from gaussianavatars_tpu.models.flame import flame_model as jfm
from gaussianavatars_tpu.ops import rasterize_tiled as jrt
from gaussianavatars_torch import render as trender
from gaussianavatars_torch.convert import (
    camera_from_numpy, flame_assets_from_numpy, flame_params_from_numpy,
    gaussian_state_from_numpy,
)
from gaussianavatars_torch.models.flame import flame_model as tfm
from gaussianavatars_torch.ops.rasterize_tiled import TileConfig

from torch_parity import camera_dict, dataclass_dict, n

ATOL = 1e-4
H, W, TH, TW = 64, 128, 8, 16
N_SHAPE, N_EXPR = 10, 6


def _jax_scene(seed=0):
    assets = jassets.synthetic_assets(N_SHAPE, N_EXPR, seed=seed)
    model = jfm.FlameModel(assets, jfm.FlameConfig(N_SHAPE, N_EXPR, add_teeth=True))
    cap = -(-model.num_faces // 128) * 128
    params, aux = jg.init_bound(model.num_faces, cap, jax.random.PRNGKey(seed), per_face=1)
    rng = np.random.RandomState(seed)
    pd = dataclass_dict(params)
    pd["means"] = (rng.randn(cap, 3) * 0.1).astype(np.float32)
    pd["log_scales"] = np.log(rng.uniform(0.25, 0.7, (cap, 3))).astype(np.float32)
    pd["quats"] = rng.randn(cap, 4).astype(np.float32)
    pd["sh_rest"] = (rng.randn(cap, 15, 3) * 0.05).astype(np.float32)
    pd["logit_opacity"] = np.full((cap, 1), np.log(0.92 / 0.08), np.float32)
    center = assets.v_template.mean(0)
    extent = float(np.abs(assets.v_template - center).max())
    cam = jax_look_at_camera(eye=center + np.array([0.0, 0.0, -4.5 * extent]),
                             target=center, fovy=0.4, width=W, height=H)
    return assets, model, pd, dataclass_dict(aux), cam


def _flame_params(seed, jaw):
    rng = np.random.RandomState(seed)
    return {
        "shape": (rng.randn(N_SHAPE)).astype(np.float32),
        "expr": (rng.randn(1, N_EXPR)).astype(np.float32),
        "rotation": (rng.randn(1, 3) * 0.05).astype(np.float32),
        "neck": (rng.randn(1, 3) * 0.05).astype(np.float32),
        "jaw": np.array([[jaw, 0.0, 0.0]], np.float32),
        "eyes": np.zeros((1, 6), np.float32),
        "translation": np.zeros((1, 3), np.float32),
        "static_offset": None, "dynamic_offset": None,
    }


@pytest.mark.parametrize("jaw", [0.0, 0.3])
def test_avatar_render_matches_jax_chain(jaw):
    assets, jmodel, pd, ad, jcam = _jax_scene()
    fd = _flame_params(1, jaw)

    # Port: everything carried across as numpy.
    tmodel = tfm.FlameModel(flame_assets_from_numpy(assets._asdict()),
                            tfm.FlameConfig(N_SHAPE, N_EXPR, add_teeth=True), device="cpu")
    params, aux = gaussian_state_from_numpy(pd, ad, device="cpu")
    tcam = camera_from_numpy(camera_dict(jcam), device="cpu")
    fl = flame_params_from_numpy(fd, device="cpu")
    cfg = trender.probe_tile_config(tmodel, params, aux, fl, tcam, TH, TW)
    renderer = trender.AvatarRenderer(tmodel, params, aux, tcam, cfg,
                                      bg_color=torch.tensor([0.2, 0.1, 0.0]), device="cpu")
    out = renderer.render(fl)

    # JAX chain with the same tier budgets.
    jparams = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in pd.items()})
    jaux = jg.GaussianAux(**{k: jnp.asarray(v) for k, v in ad.items()})
    verts = jmodel.forward(jfm.FlameParams(**{
        k: None if v is None else jnp.asarray(v) for k, v in fd.items()}))
    wg = jg.world_gaussians(jparams, jaux, jbind.face_frames(verts[0], jmodel.faces))
    jcfg = jrt.TileConfig(tile_h=TH, tile_w=TW, base_budget=cfg.base_budget, tiers=cfg.tiers)
    ref = jrt.render_tiled(wg.means, wg.scales, wg.quats, wg.opacity, jcam,
                           jnp.asarray([0.2, 0.1, 0.0]), sh=wg.sh, sh_degree=3,
                           alive=wg.alive, cfg=jcfg)

    assert tuple(out.color.shape) == (H, W, 3)
    assert 0.2 < float(out.alpha.mean()) < 1.0   # the head covers part of the frame
    np.testing.assert_array_equal(n(out.radii), np.asarray(ref.radii))
    np.testing.assert_allclose(n(out.color), np.asarray(ref.color), atol=ATOL)
    np.testing.assert_allclose(n(out.alpha), np.asarray(ref.alpha), atol=ATOL)


def test_jaw_moves_the_image():
    assets, _jm, pd, ad, jcam = _jax_scene()
    tmodel = tfm.FlameModel(flame_assets_from_numpy(assets._asdict()),
                            tfm.FlameConfig(N_SHAPE, N_EXPR, add_teeth=True), device="cpu")
    params, aux = gaussian_state_from_numpy(pd, ad, device="cpu")
    tcam = camera_from_numpy(camera_dict(jcam), device="cpu")
    cfg = TileConfig(tile_h=TH, tile_w=TW)
    renderer = trender.AvatarRenderer(tmodel, params, aux, tcam, cfg, device="cpu")
    a = renderer.render(flame_params_from_numpy(_flame_params(1, 0.0), device="cpu"))
    b = renderer.render(flame_params_from_numpy(_flame_params(1, 0.4), device="cpu"))
    assert torch.isfinite(a.color).all() and torch.isfinite(b.color).all()
    assert float((a.color - b.color).abs().max()) > 1e-2


def test_build_scene_is_the_bench_scene():
    """The full-width scene's sizes, built on the CPU at a tiny image."""
    model, params, aux, fl, cam, n_g = trender.build_scene(width=64, height=48, device="cpu")
    assert (model.num_verts, model.num_faces) == (5143, 10010)
    assert n_g == 90090 and params.capacity == 90112
    assert int(aux.alive.sum()) == n_g
    assert (cam.width, cam.height) == (64, 48)
    assert torch.allclose(torch.sigmoid(params.logit_opacity), torch.tensor(0.92))


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trender.build_scene(per_face=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.zero_params(4, 4)
