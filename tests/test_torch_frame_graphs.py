"""Frames as CUDA graphs and the table pipeline's host-read-free form, on
the CPU, at `tests/raster_fixtures.py`'s size (64×96, 200 splats, 8×16
tiles) and on a 64×48 model directory of the tiny sphere written from
numpy (`cores`).

* The fixed walk (`ops/rasterize_tiled.fixed_walk`: every pass over every
  tile, all `capacity` slots gathered) against the planned walk that eager
  calls take, bit for bit: `composite_tiles`' outputs and its four
  gradients on the slot tables of `tests/test_torch_rasterize_tiled.py`,
  and `rasterize_binned`'s image, alpha and four gradients on a binned
  scene whose fullest tile holds fewer than `capacity` slots; both at
  `SLOT_CHUNK` 32 and 5. A pass that adds nothing multiplies T by exactly
  1 and adds exactly 0, so the two forms compute the same bits.
* The fixed walk against JAX's `composite_tiles` and `rasterize_binned`
  (its `lax.scan` over every slot) at the tolerances of
  `tests/test_torch_rasterize_tiled.py`: outputs at atol 1e-5, each
  gradient within 1e-5 of its largest magnitude.
* No host read: the table path's render, forward and backward, completes
  with `Tensor.item`, `.cpu`, `.tolist`, `__bool__`, `__int__` and
  `torch.nonzero` patched to raise (the planned walk trips them).
* `make_render_fn` with a 0-dim tensor timestep equals it with an int,
  bit for bit, on both pipelines, and JAX's jitted `make_render_fn` on the
  table pipeline within atol 1e-4 (the render tolerance of
  `tests/test_torch_viewers.py`).
* The FPS benchmark's chain (`fps_benchmark_demo.frame_chain` through
  `run_chain`, 3 frames, the table pipeline): its carried s equals the JAX
  script's `frame(c, i)` chained 3 times (rebuilt from the calls of
  `scripts/fps_benchmark_demo.py:45-62`), and its last image within atol
  1e-4 of JAX's.

The graphs themselves need the card: `tests/test_torch_gpu.py`.
"""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu import config as jconfig
from gaussianavatars_tpu.data.cameras import jit_static_key
from gaussianavatars_tpu.models.binding import face_frames as jax_face_frames
from gaussianavatars_tpu.models.gaussians import world_gaussians as jax_world_gaussians
from gaussianavatars_tpu.ops import rasterize_tiled as jrt
from gaussianavatars_tpu.training import loop as jloop
from gaussianavatars_tpu.training import trainer as jtrainer
from gaussianavatars_torch import config as tconfig
from gaussianavatars_torch.ops import projection as tproj
from gaussianavatars_torch.ops import rasterize_tiled as trt
from gaussianavatars_torch.tools import fps_benchmark_demo as tfps
from gaussianavatars_torch.tools import render as trender
from gaussianavatars_torch.training import loop as tloop
from test_torch_rasterize_tiled import JCFG, SCENES, TCFG, _rel_close, _slot_tables
from torch_parity import (
    H, TILE_H, TILE_W, W, jax_camera, n, np_scene, t, torch_camera, torch_threads,
)

ATOL = 1e-4
CHUNKS = [trt.SLOT_CHUNK, 5]
GRADS = ("mean2d", "conic", "color", "opacity")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (`torch_parity.torch_threads`)."""
    with torch_threads(1):
        yield


def _composite(origin, slots, cot, fixed: bool):
    leaves = [t(s).requires_grad_() for s in slots]
    with trt.fixed_walk() if fixed else contextlib.nullcontext():
        out = trt.composite_tiles(t(origin), *leaves, TCFG)
        grads = torch.autograd.grad(out, leaves, cot)
    return out, grads


def _cotangents(nt: int, seed: int):
    rng = np.random.RandomState(seed)
    p = TILE_H * TILE_W
    return (t(rng.randn(nt, p, 3).astype(np.float32)), t(rng.randn(nt, p).astype(np.float32)))


def _port_projected(seed=0, n_splats=200, **scene):
    """`test_torch_rasterize_tiled._projected`'s scene through the port's projection
    alone."""
    means, scales, quats, opacity, colors = np_scene(n=n_splats, seed=seed, **scene)
    pt = tproj.project_from_params(t(means), t(scales), t(quats), torch_camera(jax_camera()))
    opac = np.where(n(pt.mask), opacity, 0.0).astype(np.float32)
    return pt, opac, colors


def _port_slot_tables(scene: str):
    """`_slot_tables`, binned and gathered by the port (no JAX): the slot
    tensors the compositor gets, empty slots zero."""
    if scene == "flooded":
        return _slot_tables(scene)
    pt, opac, colors = _port_projected(**SCENES[scene])
    binned = trt.bin_gaussians(pt, H, W, TCFG, opacity=t(opac))
    packed = torch.cat([pt.mean2d, pt.conic, t(colors), t(opac)[:, None]], -1)
    g = n(trt._gather_slots(packed, binned.idx))
    return n(binned.tile_origin), (g[..., 0:2], g[..., 2:5], g[..., 5:8], g[..., 8]), None


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("scene", ["flooded", "saturating", "seed0"])
def test_fixed_walk_compositor_equals_planned_walk_bit_for_bit(scene, chunk, monkeypatch):
    monkeypatch.setattr(trt, "SLOT_CHUNK", chunk)
    origin, slots, _counts = _port_slot_tables(scene)
    cot = _cotangents(origin.shape[0], 3)
    out_p, g_p = _composite(origin, slots, cot, fixed=False)
    out_f, g_f = _composite(origin, slots, cot, fixed=True)
    for a, b in zip(out_f, out_p):
        assert torch.equal(a, b)
    for name, a, b in zip(GRADS, g_f, g_p):
        assert torch.equal(a, b), name


def _binned_scene(seed=0):
    """A scene binned into `TCFG`'s table, its fullest tile below capacity
    (the planned walk cuts the slots the fixed one walks)."""
    pt, opac, colors = _port_projected(seed=seed)
    binned = trt.bin_gaussians(pt, H, W, TCFG, opacity=t(opac))
    assert 0 < int(binned.counts.max()) < TCFG.capacity and int(binned.overflow) == 0
    return pt, opac, colors, binned


def _rasterize(pt, opac, colors, binned, fixed: bool, seed=4):
    leaves = [t(x).requires_grad_() for x in (n(pt.mean2d), n(pt.conic), colors, opac)]
    rng = np.random.RandomState(seed)
    w_img = t(rng.randn(H, W, 3).astype(np.float32))
    w_alpha = t(rng.randn(H, W).astype(np.float32))
    with trt.fixed_walk() if fixed else contextlib.nullcontext():
        img, alpha = trt.rasterize_binned(*leaves, binned, H, W, t(np.array([0.1, 0.2, 0.3],
                                                                            np.float32)), TCFG)
        grads = torch.autograd.grad((img * w_img).sum() + (alpha * w_alpha).sum(), leaves)
    return (img, alpha), grads, (w_img, w_alpha)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_fixed_walk_rasterize_binned_equals_planned_walk_bit_for_bit(chunk, monkeypatch):
    monkeypatch.setattr(trt, "SLOT_CHUNK", chunk)
    pt, opac, colors, binned = _binned_scene()
    out_p, g_p, _w = _rasterize(pt, opac, colors, binned, fixed=False)
    out_f, g_f, _w = _rasterize(pt, opac, colors, binned, fixed=True)
    for a, b in zip(out_f, out_p):
        assert torch.equal(a, b)
    for name, a, b in zip(GRADS, g_f, g_p):
        assert torch.equal(a, b) and bool(b.abs().max() > 0), name


@jax.jit
def _jax_composite_vjp(origin, slots, cot):
    out, vjp = jax.vjp(lambda *s: jrt.composite_tiles(origin, *s, JCFG), *slots)
    return out, vjp(cot)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_fixed_walk_matches_jax_scan(chunk, monkeypatch):
    """`composite_tiles` on the saturating slot table (early stops) and
    `rasterize_binned` on a binned scene, in the fixed walk, against JAX
    on the same slot tables and the same binned table (the port's
    binning: `test_torch_rasterize_tiled.py` holds it equal to JAX's)."""
    monkeypatch.setattr(trt, "SLOT_CHUNK", chunk)
    origin, slots, _counts = _port_slot_tables("saturating")
    cot = _cotangents(origin.shape[0], 11)
    out_f, g_f = _composite(origin, slots, cot, fixed=True)
    out_j, g_j = _jax_composite_vjp(jnp.asarray(origin), tuple(map(jnp.asarray, slots)),
                                    tuple(jnp.asarray(n(c)) for c in cot))
    for a, b in zip(out_f, out_j):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5, rtol=0)
    for name, a, b in zip(GRADS, g_f, g_j):
        _rel_close(n(a), np.asarray(b), 1e-5, name)

    pt, opac, colors, binned = _binned_scene(seed=1)
    (img, alpha), grads, (w_img, w_alpha) = _rasterize(pt, opac, colors, binned, fixed=True)
    jb = jrt.Binned(*(jnp.asarray(n(x)) for x in binned))
    (ji, ja), jg = _jax_rasterize_grad(jb, n(w_img), n(w_alpha), n(pt.mean2d), n(pt.conic),
                                       colors, opac)
    np.testing.assert_allclose(n(img), np.asarray(ji), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(alpha), np.asarray(ja), atol=1e-5, rtol=0)
    for name, a, b in zip(GRADS, grads, jg):
        _rel_close(n(a), np.asarray(b), 1e-5, name)


@jax.jit
def _jax_rasterize_grad(jb, w_img, w_alpha, *x):
    """JAX's `rasterize_binned` (background 0.1, 0.2, 0.3) and the
    gradients of Σ img·w_img + Σ alpha·w_alpha in its four inputs."""
    def loss(*x):
        img, alpha = jrt.rasterize_binned(*x, jb, H, W, jnp.asarray([0.1, 0.2, 0.3]), JCFG)
        return jnp.sum(img * w_img) + jnp.sum(alpha * w_alpha), (img, alpha)

    (_l, out), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(*x)
    return out, g


def test_table_path_reads_nothing_on_the_host(monkeypatch):
    """The table path's render (`render_tiled(use_pallas=False)`: binning,
    the gather, the compositor) and its backward, inside `fixed_walk()`,
    with every host read patched to raise; the same calls outside it
    (the planned walk) trip the patch."""
    means, scales, quats, opacity, colors = np_scene(n=200, seed=5)
    cam = torch_camera(jax_camera())
    leaves = [t(x).requires_grad_() for x in (means, scales, quats, opacity, colors)]
    bg = torch.zeros(3)

    def render_and_grad():
        out = trt.render_tiled(*leaves[:4], cam, bg, colors=leaves[4], cfg=TCFG,
                               use_pallas=False)
        return out, torch.autograd.grad(out.color.sum() + out.alpha.sum(), leaves)

    want, want_g = render_and_grad()

    def host_read(*_a, **_k):
        raise AssertionError("host read")

    for name in ("item", "cpu", "tolist", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    monkeypatch.setattr(torch, "nonzero", host_read)
    monkeypatch.setattr(torch.Tensor, "nonzero", host_read)
    with trt.fixed_walk():
        got, got_g = render_and_grad()
    with pytest.raises(AssertionError, match="host read"):
        render_and_grad()
    monkeypatch.undo()
    assert torch.equal(got.color, want.color) and torch.equal(got.alpha, want.alpha)
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def cores(tmp_path_factory):
    """A model directory written from numpy with the port's PLY writer (no
    dataset, no JAX op by op): the clamped tiny sphere's assets, one
    Gaussian a face at its origin (logit opacity 2, scale 0.6, seeded
    offsets, rotations and SH), two timesteps whose jaws differ; both
    packages' viewer cores on it at 64×48 on the table pipeline (JAX's
    `lax.scan` compiles in a third of the time of the sorted path's
    interpreted Pallas kernel), and each package's `Config` of that table."""
    import dataclasses

    from gaussianavatars_tpu.models.flame.assets import save_assets
    from gaussianavatars_tpu.viewers import local as jlocal
    from gaussianavatars_torch.data.ply import save_gaussian_ply
    from gaussianavatars_torch.viewers import local as tlocal
    import fixtures_avatar as fa
    from torch_parity import N_TIERS_TILES, clamped_sphere_assets

    root = tmp_path_factory.mktemp("frames")
    assets = clamped_sphere_assets(root)
    nf, nv = assets.faces.shape[0], assets.num_verts
    rng = np.random.RandomState(3)
    model_dir = root / "model"
    out = model_dir / "point_cloud" / "iteration_1"
    save_gaussian_ply(str(out / "point_cloud.ply"), means=rng.randn(nf, 3) * 0.05,
                      sh_dc=rng.uniform(0.2, 1.2, (nf, 1, 3)), sh_rest=rng.randn(nf, 15, 3) * 0.05,
                      logit_opacity=np.full((nf, 1), 2.0), log_scales=np.full((nf, 3), np.log(0.6)),
                      quats=rng.randn(nf, 4), binding=np.arange(nf))
    z = lambda *shape: np.zeros(shape, np.float32)  # noqa: E731
    np.savez(out / "flame_param.npz", shape=z(fa.N_SHAPE), expr=z(2, fa.N_EXPR),
             rotation=z(2, 3), neck_pose=z(2, 3),
             jaw_pose=np.array([[0.0, 0.0, 0.0], [0.15, 0.0, 0.0]], np.float32),
             eyes_pose=z(2, 6), translation=z(2, 3), static_offset=z(1, nv, 3))
    save_assets(assets, str(model_dir / "flame_assets.npz"))
    ply = str(out / "point_cloud.ply")
    tile = dict(tile_h=TILE_H, tile_w=TILE_W, tiers=((1024, N_TIERS_TILES),))
    jcore = jlocal.AvatarViewerCore(ply, width=64, height=48, use_pallas=False, tile=tile)
    tcore = tlocal.AvatarViewerCore(ply, width=64, height=48, use_pallas=False, tile=tile,
                                    device="cpu")
    jcfg = jconfig.Config(pipeline=jconfig.PipelineConfig(
        tile_h=TILE_H, tile_w=TILE_W, tiers=tile["tiers"], use_pallas=False))
    tcfg = tconfig.from_json(jconfig.to_json(jcfg))
    sorted_cfg = dataclasses.replace(tcfg, pipeline=dataclasses.replace(tcfg.pipeline,
                                                                        use_pallas=True))
    return jcore, tcore, jcfg, tcfg, sorted_cfg


def _jax_state(jcore):
    """The JAX `TrainState` of a render (`scripts/render.py:79-108`) from
    the JAX viewer core's avatar."""
    fi = jloop.flame_init_from_table(jcore.flame_table, n_shape=jcore.model.cfg.n_shape,
                                     n_expr=jcore.model.cfg.n_expr)
    f = {k: jnp.asarray(fi[k]) for k in ("expr", "rotation", "neck", "jaw", "eyes",
                                          "translation")}
    flame = jtrainer.FlameTrainable(**f)
    static = jtrainer.FlameStatic(shape=jnp.asarray(fi["shape"]), static_offset=jnp.asarray(
        np.asarray(fi["static_offset"]).reshape(-1, 3)[: jcore.model.num_verts]))
    return jtrainer.TrainState(params=jcore.params, aux=jcore.aux, adam=None, flame=flame,
                               flame_static=static, flame_adam=None, color_net=None,
                               color_adam=None, contrastive=None,
                               key=jnp.zeros((2,), jnp.uint32))


def test_render_fn_tensor_timestep_matches_int_and_jax(cores):
    """A 0-dim tensor timestep against an int, bit for bit, on both
    pipelines; the table pipeline's frame against JAX's jitted
    `make_render_fn`."""
    jcore, tcore, jcfg, tcfg, sorted_cfg = cores
    state = trender.replay_state(tcore.params, tcore.aux, tcore.flame_table, tcore.model)
    cam = tcore.cam.to_camera(device="cpu")
    bg = torch.tensor([0.1, 0.2, 0.3])
    for cfg in (sorted_cfg, tcfg):
        render_fn = tloop.make_render_fn(tcore.model, cfg, tloop.tile_config(cfg))
        by_int = render_fn(state, cam, 1, bg, 3)
        by_tensor = render_fn(state, cam, torch.ones((), dtype=torch.int64), bg, 3)
        assert by_int.shape == (48, 64, 3) and torch.equal(by_tensor, by_int)
        assert not torch.equal(render_fn(state, cam, 0, bg, 3), by_int)   # the timestep matters
    jrender = jloop.make_render_fn(jcore.model, jcfg, jloop.tile_config(jcfg))
    want = jrender(_jax_state(jcore), jit_static_key(jcore.cam.to_camera()), jnp.int32(1),
                   jnp.asarray(n(bg)), 3)
    assert float(n(by_tensor).max()) > 0.05
    np.testing.assert_allclose(n(by_tensor), np.asarray(want), atol=ATOL)


def test_fps_chain_matches_jax_frame_chain(cores):
    """`run_chain(frame_chain(core), ...)` over 3 frames against the JAX
    script's `frame(c, i)` chained 3 times."""
    from gaussianavatars_tpu.ops.rasterize_tiled import render_tiled as jax_render_tiled

    jcore, tcore = cores[:2]
    fps, img, s = tfps.run_chain(tfps.frame_chain(tcore), torch.device("cpu"), 3, 1)
    assert len(fps) == 1 and fps[0] > 0

    cam = jit_static_key(jcore.cam.to_camera())

    @jax.jit
    def frame(c):   # scripts/fps_benchmark_demo.py:45-62
        _img, s = c
        fp = jcore.flame_params_at(0)
        fp = fp._replace(jaw=fp.jaw + s * 1e-9)
        verts = jcore.model.forward(fp)
        frames = jax_face_frames(verts[0], jcore.model.faces)
        wg = jax_world_gaussians(jcore.params, jcore.aux, frames)
        out = jax_render_tiled(wg.means, wg.scales, wg.quats, wg.opacity, cam, jnp.zeros(3),
                               sh=wg.sh, sh_degree=3, alive=wg.alive, cfg=jcore.tile,
                               use_pallas=jcore.use_pallas)
        return (out.color, s + out.color[0, 0, 0] * 0)

    c = (jnp.zeros((cam.height, cam.width, 3)), jnp.zeros(()))
    for _ in range(3):
        c = frame(c)
    assert float(s) == float(c[1]) == 0.0
    assert img.shape == c[0].shape and float(n(img).max()) > 0.05
    np.testing.assert_allclose(n(img), np.asarray(c[0]), atol=ATOL)
