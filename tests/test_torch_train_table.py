"""The table pipeline through the step and the loop: the port's
`make_train_step` with `use_pallas=False` (and `use_sorted=False`) against
the JAX package's, FLAME-bound and unbound, `make_render_fn` on the table
path, `tile_config` and `_grow_tile_budgets`' three outcomes.

Both packages start from the same JAX state (carried across as numpy). The
JAX table step is XLA code (`bin_gaussians` + the `lax.scan` compositor),
run as it is on the CPU.

Tolerances, with their reasons (those of `test_torch_train.py`):
  * the image at atol 1e-4, the loss terms at rtol 1e-4;
  * every gradient leaf (Adam's first moment, 0.1·g after one step) and
    the densification statistics within 1e-4 of the leaf's largest
    magnitude: the backward sums over pixels and slots in another order;
  * `overflow` and `budget_overflow`: exact (the binning is exact).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu import config as jconfig
from gaussianavatars_tpu.models import gaussians as jg
from gaussianavatars_tpu.ops.rasterize_tiled import TileConfig as JTileConfig
from gaussianavatars_tpu.training import loop as jloop
from gaussianavatars_tpu.training import trainer as jtrainer
from gaussianavatars_torch import config as tconfig
from gaussianavatars_torch.convert import (
    camera_from_numpy, flame_assets_from_numpy, train_state_from_numpy,
)
from gaussianavatars_torch.models.flame import flame_model as tfm
from gaussianavatars_torch.ops import rasterize_tiled as trt
from gaussianavatars_torch.ops.rasterize_tiled import TileConfig
from gaussianavatars_torch.training import loop as tloop
from gaussianavatars_torch.training import trainer as ttrainer

import fixtures_avatar as fa
from test_torch_train import FLAME_KEYS, N_T, PARAM_KEYS, TH, TW, _state_numpy, avatar  # noqa: F401
from test_torch_unbound import CAP, _camera as unbound_camera, state_numpy as unbound_numpy
from torch_parity import torch_threads, H, TILE_H, TILE_W, W, camera_dict, n, np_scene, t


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (`torch_parity.torch_threads`)."""
    with torch_threads(1):
        yield


def _rel_close(got, want, rel, name):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), f"{name}: max abs err {err:.3g}"


def _configs(pipeline: dict, **opt):
    return (jconfig.Config(pipeline=jconfig.PipelineConfig(**pipeline),
                           opt=jconfig.OptimizationConfig(**opt)),
            tconfig.Config(pipeline=tconfig.PipelineConfig(**pipeline),
                           opt=tconfig.OptimizationConfig(**opt)))


def _tiles(tcfg):
    p = tcfg.pipeline
    kw = dict(capacity=p.capacity_per_tile, max_tiles_per_gaussian=p.max_tiles_per_gaussian)
    return JTileConfig(tile_h=TH, tile_w=TW, **kw), TileConfig(tile_h=TH, tile_w=TW, **kw)


def _bound(avatar, pipeline, **opt):
    jmodel, params, aux, cam, flame_init, gt = avatar
    jcfg, tcfg = _configs(pipeline, **opt)
    params, aux = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), (params, aux))
    js = jtrainer.init_train_state(params, aux, jcfg, num_timesteps=N_T, n_expr=fa.N_EXPR,
                                   n_shape=fa.N_SHAPE, num_verts=jmodel.num_verts,
                                   flame_init=flame_init)
    jtile, ttile = _tiles(tcfg)
    jstep = jtrainer.make_train_step(jmodel, jcfg, jtile)
    tmodel = tfm.FlameModel(flame_assets_from_numpy(jmodel.assets._asdict()),
                            tfm.FlameConfig(fa.N_SHAPE, fa.N_EXPR, add_teeth=False),
                            device="cpu")
    ts = train_state_from_numpy(**_state_numpy(js), device="cpu")
    tstep = ttrainer.make_train_step(tmodel, tcfg, ttile)
    return (jstep, js, cam), (tstep, ts, camera_from_numpy(camera_dict(cam), device="cpu")), gt


def _compare_step(out, jout, terms, gt_keys=PARAM_KEYS):
    jmet = {k: float(v) for k, v in jout.metrics.items()}
    assert set(out.metrics) == set(jmet)
    np.testing.assert_allclose(n(out.image), np.asarray(jout.image), atol=1e-4)
    for k in terms:
        np.testing.assert_allclose(float(out.metrics[k]), jmet[k], rtol=1e-4, err_msg=k)
    for k in ("overflow", "budget_overflow", "max_footprint", "num_visible"):
        assert int(out.metrics[k]) == int(jmet[k]), k
    for k in gt_keys:
        _rel_close(n(getattr(out.state.adam.mu, k)), getattr(jout.state.adam.mu, k), 1e-4, k)
    for k in ("grad_accum", "denom", "max_radii2d"):
        _rel_close(n(getattr(out.state.aux, k)), getattr(jout.state.aux, k), 1e-4, k)
    return jmet


@pytest.mark.parametrize("capacity", [1024, 16], ids=["fits", "capacity_overflows"])
def test_table_step_matches_jax_flame_bound(avatar, capacity):
    (jstep, js, jcam), (tstep, ts, tcam), gt = _bound(
        avatar, dict(use_pallas=False, capacity_per_tile=capacity, max_tiles_per_gaussian=24),
        lambda_laplacian=0.3)
    out = tstep(ts, t(gt), tcam, 1, torch.zeros(3), 1)
    jout = jstep(js, jnp.asarray(gt), jcam, jnp.int32(1), jnp.zeros(3), sh_degree=1)
    jmet = _compare_step(out, jout, ("l1", "ssim", "xyz", "scale", "lap", "loss", "psnr"))
    for k in FLAME_KEYS:
        _rel_close(n(getattr(out.state.flame_adam.mu, k)), getattr(jout.state.flame_adam.mu, k),
                   1e-4, k)
    assert (jmet["overflow"] > 0) == (capacity == 16) and jmet["budget_overflow"] == 0
    assert int(out.metrics["max_footprint"]) == 0


def test_table_step_matches_jax_unbound():
    means, _s, _q, _o, colors = np_scene(n=200, seed=2)
    jp, ja = jg.init_from_points(means - np.array([0.0, 0.0, 2.5], np.float32), colors,
                                 capacity=CAP)
    rng = np.random.RandomState(9)
    # Anisotropic and rotated, as `test_torch_unbound.py`'s state (an
    # isotropic splat has no rotation gradient).
    jp = dataclasses.replace(
        jp, logit_opacity=jnp.where(ja.alive[:, None], 1.0, jp.logit_opacity),
        quats=jnp.asarray(rng.randn(CAP, 4).astype(np.float32)),
        log_scales=jp.log_scales + jnp.asarray(rng.uniform(-0.3, 0.3, (CAP, 3))
                                               .astype(np.float32)))
    jcfg, tcfg = _configs(dict(use_pallas=False, capacity_per_tile=64,
                               max_tiles_per_gaussian=2))
    js = jtrainer.init_train_state(jp, ja, jcfg)
    ts = train_state_from_numpy(**unbound_numpy(js), device="cpu")
    jtile, ttile = (JTileConfig(tile_h=TILE_H, tile_w=TILE_W, capacity=64,
                                max_tiles_per_gaussian=2),
                    TileConfig(tile_h=TILE_H, tile_w=TILE_W, capacity=64,
                               max_tiles_per_gaussian=2))
    jstep = jtrainer.make_train_step(None, jcfg, jtile)
    tstep = ttrainer.make_train_step(None, tcfg, ttile)
    jcam = unbound_camera()
    gt = np.random.RandomState(4).uniform(0, 1, (H, W, 3)).astype(np.float32)
    out = tstep(ts, t(gt), camera_from_numpy(camera_dict(jcam), device="cpu"), 0,
                torch.zeros(3), 1)
    jout = jstep(js, jnp.asarray(gt), jcam, jnp.int32(0), jnp.zeros(3), sh_degree=1)
    jmet = _compare_step(out, jout, ("l1", "ssim", "loss", "psnr"))
    # Two tiles a Gaussian truncate the larger bboxes; both report it.
    assert jmet["budget_overflow"] > 0


def test_sorted_off_pallas_on_steps_on_the_table_and_renders_sorted(avatar, monkeypatch):
    """`use_sorted=False, use_pallas=True`: the step takes the table path
    (and equals JAX's), the eval render the sorted one, as in JAX."""
    pipeline = dict(use_sorted=False, use_pallas=True, capacity_per_tile=1024,
                    max_tiles_per_gaussian=24)
    (jstep, js, jcam), (tstep, ts, tcam), gt = _bound(avatar, pipeline)
    calls = []
    for name in ("rasterize_binned", "rasterize_sorted"):
        real = getattr(ttrainer, name)
        monkeypatch.setattr(ttrainer, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    out = tstep(ts, t(gt), tcam, 1, torch.zeros(3), 0)
    assert calls == ["rasterize_binned"]
    jout = jstep(js, jnp.asarray(gt), jcam, jnp.int32(1), jnp.zeros(3), sh_degree=0)
    _compare_step(out, jout, ("l1", "ssim", "loss", "psnr"))

    jmodel = avatar[0]
    tcfg = tconfig.Config(pipeline=tconfig.PipelineConfig(**pipeline))
    tmodel = tfm.FlameModel(flame_assets_from_numpy(jmodel.assets._asdict()),
                            tfm.FlameConfig(fa.N_SHAPE, fa.N_EXPR, add_teeth=False),
                            device="cpu")
    tile = dataclasses.replace(tloop.tile_config(tcfg), tile_h=TH, tile_w=TW,
                               tiers=((ts.params.capacity, 24),))
    seen = []
    real_sorted = trt.rasterize_sorted
    monkeypatch.setattr(trt, "rasterize_sorted", lambda *a, **k: (
        seen.append(1), real_sorted(*a, **k))[1])
    img = tloop.make_render_fn(tmodel, tcfg, tile)(ts, tcam, 1, torch.zeros(3), 0)
    assert seen == [1]
    np.testing.assert_allclose(n(img), np.asarray(jout.image), atol=1e-3)


def test_make_render_fn_table_path_matches_jax(avatar):
    jmodel, params, aux, cam, flame_init, _gt = avatar
    jcfg, tcfg = _configs(dict(use_pallas=False, capacity_per_tile=1024,
                               max_tiles_per_gaussian=24))
    js = jtrainer.init_train_state(params, aux, jcfg, num_timesteps=N_T, n_expr=fa.N_EXPR,
                                   n_shape=fa.N_SHAPE, num_verts=jmodel.num_verts,
                                   flame_init=flame_init)
    ts = train_state_from_numpy(**_state_numpy(js), device="cpu")
    jtile, ttile = _tiles(tcfg)
    tmodel = tfm.FlameModel(flame_assets_from_numpy(jmodel.assets._asdict()),
                            tfm.FlameConfig(fa.N_SHAPE, fa.N_EXPR, add_teeth=False),
                            device="cpu")
    want = jloop.make_render_fn(jmodel, jcfg, jtile)(js, cam, 1, jnp.zeros(3), sh_degree=1)
    got = tloop.make_render_fn(tmodel, tcfg, ttile)(
        ts, camera_from_numpy(camera_dict(cam), device="cpu"), 1, torch.zeros(3), 1)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)
    assert float(np.asarray(want).max()) > 0.1


def test_tile_config_carries_the_table_budgets():
    for kw in (dict(), dict(capacity_per_tile=256, max_tiles_per_gaussian=4, use_pallas=False)):
        jcfg, tcfg = _configs(kw)
        j, tc = jloop.tile_config(jcfg), tloop.tile_config(tcfg)
        assert (tc.capacity, tc.max_tiles_per_gaussian) == (j.capacity, j.max_tiles_per_gaussian)
        assert tc.capacity == tcfg.pipeline.capacity_per_tile
        # Off the sorted path the tier probe changes nothing.
        if not tcfg.pipeline.use_pallas:
            assert tloop.probe_tier_budgets(tc, tcfg, None, None, None) is tc


@pytest.mark.parametrize("overflow,budget_overflow,sorted_mode", [
    (0, 0, False),       # nothing overflowed
    (0, 7, True),        # sorted: the tiers grow toward the footprint
    (5, 0, False),       # table: the capacity doubles
    (0, 3, False),       # table: the tiles a Gaussian double
    (2, 9, False),       # table: both
])
def test_grow_tile_budgets_three_outcomes_match_jax(overflow, budget_overflow, sorted_mode):
    kw = dict(tile_h=32, tile_w=32, capacity=512, max_tiles_per_gaussian=8)
    j = jloop._grow_tile_budgets(JTileConfig(**kw), overflow, budget_overflow, verbose=False,
                                 max_footprint=40, n_gauss=1024, sorted_mode=sorted_mode)
    tc = tloop._grow_tile_budgets(TileConfig(**kw), overflow, budget_overflow, verbose=False,
                                  max_footprint=40, n_gauss=1024, sorted_mode=sorted_mode)
    if j is None:
        assert tc is None
        return
    for f in ("capacity", "max_tiles_per_gaussian", "base_budget"):
        assert getattr(tc, f) == getattr(j, f), f
    assert tuple(tc.tiers) == tuple(j.tiers)
    assert tc != TileConfig(**kw)


def test_probe_tile_config_sizes_a_table_that_cuts_nothing(avatar):
    """`probe_tile_config(table=True)`: the smallest powers of two at or
    above the frame's largest bbox and fullest tile, so the table bins the
    frame with no overflow of either kind, where a table half as large
    overflows."""
    from gaussianavatars_torch.models.binding import face_frames
    from gaussianavatars_torch.models.flame.flame_model import FlameParams
    from gaussianavatars_torch.models.gaussians import world_gaussians
    from gaussianavatars_torch.ops.projection import project_from_params
    from gaussianavatars_torch.render import probe_tile_config

    _jax, (_step, ts, tcam), _gt = _bound(avatar, dict(use_pallas=False))
    tmodel = tfm.FlameModel(flame_assets_from_numpy(avatar[0].assets._asdict()),
                            tfm.FlameConfig(fa.N_SHAPE, fa.N_EXPR, add_teeth=False),
                            device="cpu")
    fp = FlameParams(shape=ts.flame_static.shape, expr=ts.flame.expr[:1],
                     rotation=ts.flame.rotation[:1], neck=ts.flame.neck[:1],
                     jaw=ts.flame.jaw[:1], eyes=ts.flame.eyes[:1],
                     translation=ts.flame.translation[:1],
                     static_offset=ts.flame_static.static_offset)
    tile = probe_tile_config(tmodel, ts.params, ts.aux, fp, tcam, TH, TW, table=True)
    assert tile.tiers and tile == dataclasses.replace(
        probe_tile_config(tmodel, ts.params, ts.aux, fp, tcam, TH, TW),
        capacity=tile.capacity, max_tiles_per_gaussian=tile.max_tiles_per_gaussian)
    with torch.no_grad():
        wg = world_gaussians(ts.params, ts.aux, face_frames(tmodel(fp)[0], tmodel.faces))
        proj = project_from_params(wg.means, wg.scales, wg.quats, tcam, alive=wg.alive)
        opac = torch.where(proj.mask, wg.opacity, torch.zeros_like(wg.opacity))
        binned = trt.bin_gaussians(proj, tcam.height, tcam.width, tile, opacity=opac)
        assert int(binned.overflow) == int(binned.budget_overflow) == 0
        for half in (dict(capacity=tile.capacity // 2),
                     dict(max_tiles_per_gaussian=tile.max_tiles_per_gaussian // 2)):
            cut = trt.bin_gaussians(proj, tcam.height, tcam.width,
                                    dataclasses.replace(tile, **half), opacity=opac)
            assert int(cut.overflow) + int(cut.budget_overflow) > 0, half
    for v in (tile.capacity, tile.max_tiles_per_gaussian):
        assert v & (v - 1) == 0
