"""The port's training innovations against the JAX package's, on the CPU.

Each function of `training/innovations.py` against its JAX counterpart on
numpy-seeded inputs, then two FLAME-bound training steps with the
region-adaptive loss, the colour net and the contrastive regulariser on,
on the tiny sphere of `tests/fixtures_avatar.py` (faces clamped as in
`tests/test_torch_train.py`) with region masks that name its own vertices:
the FLAME-5023 region tables all lie past its 179 vertices, so on the
fixture as it is the region map would be all ones. The JAX step runs its
Pallas kernels in interpret mode and is compiled once for the module.

Tolerances, each with its reason:
  * the region map and smart densification's thresholds: exact (integer
    pixels from bit-identical projections; an element of the same sort);
  * the heuristic map: atol 1e-6 (`linspace` rounding);
  * the colour net, the contrastive loss and their gradients: rtol 1e-5
    (float32 rounding of the same formulas); `_downsample` atol 2e-6 on
    the JAX package's own pooling test inputs (its integral image against
    `adaptive_avg_pool2d`), and 3e-7 against float64 pooling;
  * a step: the image atol 1e-4 and every loss term rtol 1e-4, the
    gradients (Adam's first moment) within 1e-4 of their leaf's largest
    value, as `tests/test_torch_train.py`'s step; the colour net's update
    within 1e-4 of its largest (its gradients are all well above rounding
    noise); the cache's `count` and `head` exact, its images (means of
    the step's image) at the image's atol 1e-4, and each the exact pooling
    of the port's own image. Three updates of a cache: exact (inputs whose
    pooling is exact in float32; see `test_contrastive_updates_wrap_around`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures_avatar as fa
from gaussianavatars_tpu import config as jconfig
from gaussianavatars_tpu.data.cameras import look_at_camera
from gaussianavatars_tpu.models.flame import flame_model as jfm
from gaussianavatars_tpu.ops.rasterize_tiled import TileConfig as JTileConfig
from gaussianavatars_tpu.training import innovations as jinn
from gaussianavatars_tpu.training import trainer as jtrainer
from gaussianavatars_torch import config as tconfig
from gaussianavatars_torch.convert import (
    camera_from_numpy, color_net_from_numpy, contrastive_from_numpy, flame_assets_from_numpy,
    train_state_from_numpy,
)
from gaussianavatars_torch.models.flame import flame_model as tfm
from gaussianavatars_torch.ops.rasterize_tiled import TileConfig
from gaussianavatars_torch.training import innovations as tinn
from gaussianavatars_torch.training import trainer as ttrainer
from torch_parity import camera_dict, jax_camera, n, t, torch_camera

TH, TW = 8, 16
N_T = 2
PARAM_KEYS = ("means", "log_scales", "quats", "sh_dc", "sh_rest", "logit_opacity")
FLAME_KEYS = ("expr", "rotation", "neck", "jaw", "eyes", "translation")
INNOVATIONS = dict(use_region_adaptive_loss=True, use_color_calibration=True,
                   use_contrastive_reg=True, lambda_laplacian=0.3)


def _rel_close(got, want, rel, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max abs err {err:.3g} > {rel} × {scale:.3g}"


# ------------------------------------------------- 1. region-adaptive loss


@pytest.mark.parametrize("hw", [(64, 96), (55, 41)])
def test_heuristic_weight_map_matches_jax(hw):
    h, w = hw
    kw = dict(weight_eyes=2.5, weight_mouth=1.8, weight_nose=1.6, weight_face=1.3)
    got = n(tinn.heuristic_weight_map(h, w, **kw))
    want = np.asarray(jinn.heuristic_weight_map(h, w, **kw))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got.max() > 1.5


def _regions(n_verts, seed):
    """Four disjoint in-range region id sets."""
    perm = np.random.RandomState(seed).permutation(n_verts)
    return {"eyes_left": perm[:30], "eyes_right": perm[30:50], "mouth": perm[50:110],
            "nose": perm[110:140]}


@pytest.mark.parametrize("hw", [(64, 96), (121, 130)])
def test_flame_region_weight_map_matches_jax(hw):
    """Radius 1 and 2 (max(H, W) // 60); all four regions in range."""
    h, w = hw
    rng = np.random.RandomState(h)
    verts = (rng.randn(300, 3) * np.array([0.6, 0.5, 0.2]) + np.array([0, 0, 2.5]))
    verts = verts.astype(np.float32)
    regions = _regions(300, h)
    jcam = jax_camera(width=w, height=h)
    kw = dict(weight_eyes=2.0, weight_mouth=1.75, weight_nose=1.5)
    want = np.asarray(jinn.flame_region_weight_map(jnp.asarray(verts), regions, jcam, h, w,
                                                   **kw))
    got = n(tinn.flame_region_weight_map(t(verts), regions, torch_camera(jcam), h, w, **kw))
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {1.0, 1.5, 1.75, 2.0}


# ------------------------------------------------- 2. smart densification


@pytest.mark.parametrize("case", ["with_zeros", "all_zero"])
def test_smart_thresholds_match_jax(case):
    rng = np.random.RandomState(5)
    m = 1000
    denom = rng.randint(0, 4, m).astype(np.float32)
    accum = (rng.exponential(3e-4, m) * denom).astype(np.float32)
    accum[rng.rand(m) < 0.2] = 0.0
    if case == "all_zero":
        accum[:] = 0.0
    for max_grad, pc, ps in ((2e-4, 75.0, 90.0), (5e-5, 60.0, 97.5)):
        want = jinn.smart_thresholds(jnp.asarray(accum), jnp.asarray(denom), max_grad, pc, ps)
        got = tinn.smart_thresholds(t(accum), t(denom), max_grad, pc, ps)
        for g, w_ in zip(got, want):
            assert g.dtype == torch.float32 and g.dim() == 0
            assert float(g) == float(w_), (case, max_grad, float(g), float(w_))
        if case == "all_zero":
            assert float(got[0]) == float(got[1]) == np.float32(max_grad)


def test_resolution_scale_at_matches_jax():
    schedule, milestones = (0.5, 0.75, 1.0), (30, 60)
    for it in (0, 1, 29, 30, 31, 59, 60, 61, 10_000):
        want = jinn.resolution_scale_at(it, schedule, milestones)
        assert tinn.resolution_scale_at(it, schedule, milestones) == want
    for it in (0, 99_999, 100_000, 299_999, 300_000):
        assert tinn.resolution_scale_at(it) == jinn.resolution_scale_at(it)


# ------------------------------------------------- 4. colour calibration


def _color_net_numpy(p):
    return {"weights": [np.asarray(w) for w in p.weights],
            "biases": [np.asarray(b) for b in p.biases]}


def test_color_net_matches_jax():
    jp = jinn.color_net_init(jax.random.PRNGKey(3), hidden=16, layers=3)
    # Nonzero biases, so they enter the comparison.
    jp = jp._replace(biases=tuple(b + 0.1 * (i + 1) for i, b in enumerate(jp.biases)))
    tp = color_net_from_numpy(_color_net_numpy(jp), device="cpu")
    assert [tuple(w.shape) for w in tp.weights] == [(3, 16), (16, 16), (16, 3)]
    img = np.random.RandomState(0).uniform(0, 1, (24, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(n(tinn.color_net_apply(tp, t(img))),
                               np.asarray(jinn.color_net_apply(jp, jnp.asarray(img))),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tinn.color_net_reg(tp)), float(jinn.color_net_reg(jp)),
                               rtol=1e-5)

    def jloss(p, x):
        return jnp.sum(jinn.color_net_apply(p, x) ** 2) + jinn.color_net_reg(p)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(img))
    leaves = [w.clone().requires_grad_() for w in tp.weights]
    x = t(img).requires_grad_()
    p = tinn.ColorNetParams(weights=tuple(leaves), biases=tp.biases)
    (torch.sum(tinn.color_net_apply(p, x) ** 2) + tinn.color_net_reg(p)).backward()
    for i, w in enumerate(leaves):
        _rel_close(n(w.grad), jg_p.weights[i], 1e-5, f"d weights[{i}]")
    _rel_close(n(x.grad), jg_x, 1e-5, "d image")


def test_color_net_init_layout():
    """He-normal [in, out] weights from the generator, zero biases."""
    p = tinn.color_net_init(16, 3, generator=torch.Generator().manual_seed(1))
    assert [tuple(w.shape) for w in p.weights] == [(3, 16), (16, 16), (16, 3)]
    assert all(not b.any() for b in p.biases)
    again = tinn.color_net_init(16, 3, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(p.weights, again.weights))


# ------------------------------------------------- 5. contrastive regulariser


POOL_CASES = [((64, 48), 8), ((55, 41), 8), ((23, 37), 5)]


def _pool_images():
    """The images of the JAX package's own pooling test
    (`tests/test_train_step.py:148`): one RandomState(3), drawn in turn."""
    rng = np.random.RandomState(3)
    return [rng.rand(h, w, 3).astype(np.float32) for (h, w), _ in POOL_CASES]


def _pool_f64(img, out):
    """Exact adaptive average pooling in float64 (torch's bin edges)."""
    h, w, _ = img.shape
    res = np.zeros((out, out, 3))
    for i in range(out):
        for j in range(out):
            ys, ye = i * h // out, -(-(i + 1) * h // out)
            xs, xe = j * w // out, -(-(j + 1) * w // out)
            res[i, j] = img[ys:ye, xs:xe].astype(np.float64).mean((0, 1))
    return res


@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_downsample_matches_jax(case):
    """Against the JAX package's integral image on its own test's inputs
    and tolerance (atol 2e-6, `assert_allclose`'s rtol 1e-7); the integral
    image's float32 cumulative sums are the larger error (up to 3.3e-6 on
    other draws), so the port is also held to exact pooling in float64."""
    (_hw, out), img = POOL_CASES[case], _pool_images()[case]
    got = n(tinn._downsample(t(img), out))
    np.testing.assert_allclose(got, np.asarray(jinn._downsample(jnp.asarray(img), out)),
                               atol=2e-6)
    np.testing.assert_allclose(got, _pool_f64(img, out), atol=3e-7, rtol=0)


def _cache(count, head, seed=2):
    rng = np.random.RandomState(seed)
    return {"images": rng.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32),
            "count": np.int32(count), "head": np.int32(head)}


@pytest.mark.parametrize("count", [0, 2, 3])
def test_contrastive_loss_and_gradient_match_jax(count):
    d = _cache(count, count % 3)
    jc = jinn.ContrastiveCache(**{k: jnp.asarray(v) for k, v in d.items()})
    tc = contrastive_from_numpy(d, device="cpu")
    img = np.random.RandomState(count).uniform(0, 1, (55, 41, 3)).astype(np.float32)
    want, jgrad = jax.value_and_grad(lambda x: jinn.contrastive_loss(jc, x, 8))(jnp.asarray(img))
    x = t(img).requires_grad_()
    got = tinn.contrastive_loss(tc, x, 8)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    if count == 0:
        assert float(got.detach()) == 0.0 and not x.grad.any()
    else:
        assert float(got.detach()) > 0
        _rel_close(n(x.grad), jgrad, 1e-5, "d image")


def test_contrastive_updates_wrap_around():
    """Three updates into a 2-entry cache: the third overwrites entry 0.
    The images hold multiples of 1/256, whose sums here are exact in
    float32, so both poolings are exact and the caches equal bit for bit
    (on other values the JAX package's integral image rounds by up to
    4.4e-6, `test_downsample_matches_jax`)."""
    jc = jinn.contrastive_init(2, 48, 64, downsample=8)
    tc = tinn.contrastive_init(2, 48, 64, downsample=8)
    assert tc.count.dtype == tc.head.dtype == torch.int32
    rng = np.random.RandomState(9)
    for i in range(3):
        img = (rng.randint(0, 256, (48 + 8 * i, 64, 3)) / 256.0).astype(np.float32)
        jc = jinn.contrastive_update(jc, jnp.asarray(img), 8)
        tc = tinn.contrastive_update(tc, t(img), 8)
        assert int(tc.count) == int(jc.count) == min(i + 1, 2)
        assert int(tc.head) == int(jc.head) == (i + 1) % 2
        np.testing.assert_array_equal(n(tc.images), np.asarray(jc.images))
        np.testing.assert_array_equal(n(tc.images[i % 2]), _pool_f64(img, 8).astype(np.float32))


# ------------------------------------------------- the step


def region_masks(v_template: np.ndarray) -> dict:
    """Region masks of the sphere's own vertices, on the side facing the
    test camera (−z): eyes above the equator left and right, the mouth
    below, the nose at the centre."""
    c = v_template.mean(0)
    x, y, z = (v_template - c).T / np.abs(v_template - c).max()
    front = z < -0.3
    ids = np.arange(len(v_template), dtype=np.int32)
    return {
        "eyes_left": ids[front & (y > 0.15) & (x < -0.1)],
        "eyes_right": ids[front & (y > 0.15) & (x > 0.1)],
        "mouth": ids[front & (y < -0.2)],
        "nose": ids[front & (np.abs(x) < 0.4) & (np.abs(y) < 0.25)],
        "neck": ids[y < -0.9],
    }


@pytest.fixture(scope="module")
def regions_avatar(tmp_path_factory):
    """The tiny sphere with in-range region masks, a trained-looking state,
    a camera, FLAME initial values, a target; and the JAX step, built once."""
    obj = tmp_path_factory.mktemp("sphere") / "sphere.obj"
    fa.tiny_sphere_obj(str(obj))
    assets = fa.synthetic_assets(n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR, seed=0,
                                 template_obj=str(obj))
    assets = assets._replace(faces=np.minimum(assets.faces, assets.num_verts - 1))
    assets = assets._replace(vertex_masks=region_masks(np.asarray(assets.v_template)))
    jmodel = jfm.FlameModel(assets, jfm.FlameConfig(n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR,
                                                    add_teeth=False))
    cap = -(-jmodel.num_faces // 128) * 128
    params, aux = fa.reference_avatar(jmodel, capacity=cap)
    rng = np.random.RandomState(0)
    params = dataclasses.replace(
        params, sh_rest=jnp.asarray(rng.randn(cap, 15, 3).astype(np.float32) * 0.05),
        log_scales=jnp.asarray(np.log(rng.uniform(0.3, 0.9, (cap, 3))).astype(np.float32)),
        quats=jnp.asarray(rng.randn(cap, 4).astype(np.float32)))
    center = np.asarray(jmodel.assets.v_template.mean(0))
    extent = float(np.abs(np.asarray(jmodel.assets.v_template) - center).max())
    cam = look_at_camera(eye=center + np.array([0.3 * extent, 0.1 * extent, -4 * extent]),
                         target=center, fovy=0.6, width=fa.W, height=fa.H)
    flame_init = {
        "expr": (rng.randn(N_T, fa.N_EXPR) * 0.3).astype(np.float32),
        "jaw": (rng.randn(N_T, 3) * 0.05).astype(np.float32),
        "rotation": (rng.randn(N_T, 3) * 0.05).astype(np.float32),
        "shape": (rng.randn(fa.N_SHAPE) * 0.3).astype(np.float32),
    }
    gt = rng.uniform(0.0, 1.0, (fa.H, fa.W, 3)).astype(np.float32)
    jcfg = jconfig.Config(opt=jconfig.OptimizationConfig(**INNOVATIONS))
    tiers = ((cap, 24),)
    jstep = jtrainer.make_train_step(jmodel, jcfg, JTileConfig(tile_h=TH, tile_w=TW,
                                                               tiers=tiers))
    tmodel = tfm.FlameModel(flame_assets_from_numpy(jmodel.assets._asdict()),
                            tfm.FlameConfig(fa.N_SHAPE, fa.N_EXPR, add_teeth=False),
                            device="cpu")
    tcfg = tconfig.Config(opt=tconfig.OptimizationConfig(**INNOVATIONS))
    tstep = ttrainer.make_train_step(tmodel, tcfg, TileConfig(tile_h=TH, tile_w=TW,
                                                              tiers=tiers))
    return dict(jmodel=jmodel, tmodel=tmodel, params=params, aux=aux, cam=cam,
                flame_init=flame_init, gt=gt, jcfg=jcfg, jstep=jstep, tstep=tstep)


def _np_or_none(x):
    return None if x is None else np.asarray(x)


def state_numpy(js) -> dict:
    """A JAX TrainState (innovation leaves included) as the keyword
    arguments of `train_state_from_numpy`."""
    def fields(obj):
        return {f.name: _np_or_none(getattr(obj, f.name)) for f in dataclasses.fields(obj)}

    def adam(a, conv=fields):
        return {"mu": conv(a.mu), "nu": conv(a.nu), "step": np.asarray(a.step)}

    out = dict(params=fields(js.params), aux=fields(js.aux), adam=adam(js.adam),
               flame=fields(js.flame), flame_static=fields(js.flame_static),
               flame_adam=adam(js.flame_adam))
    if js.color_net is not None:
        out["color_net"] = _color_net_numpy(js.color_net)
        out["color_adam"] = adam(js.color_adam, _color_net_numpy)
    if js.contrastive is not None:
        out["contrastive"] = {k: np.asarray(v) for k, v in js.contrastive._asdict().items()}
    return out


def test_region_masks_are_in_range_and_weigh_the_view(regions_avatar):
    """The test model's regions survive `vid_by_region` in both packages,
    and the region map at the test camera has weights above 1."""
    jm, tm, cam = regions_avatar["jmodel"], regions_avatar["tmodel"], regions_avatar["cam"]
    for k in ("eyes_left", "eyes_right", "mouth", "nose"):
        ids = tm.vid_by_region([k])
        assert len(ids) >= 3, k
        np.testing.assert_array_equal(ids, jm.vid_by_region([k]))
    verts = np.asarray(jm.assets.v_template, np.float32)
    vids = {k: tm.vid_by_region([k]) for k in ("eyes_left", "eyes_right", "mouth", "nose")}
    wmap = n(tinn.flame_region_weight_map(t(verts), vids, torch_camera(cam), fa.H, fa.W))
    np.testing.assert_array_equal(wmap, np.asarray(jinn.flame_region_weight_map(
        jnp.asarray(verts), vids, cam, fa.H, fa.W)))
    assert set(np.unique(wmap)) == {1.0, 1.5, 2.0}


def _run_jax(ra, js, timestep):
    out = ra["jstep"](js, jnp.asarray(ra["gt"]), ra["cam"], jnp.int32(timestep), jnp.zeros(3),
                      sh_degree=1)
    return out.state, {k: float(v) for k, v in out.metrics.items()}, np.asarray(out.image)


def _check_step(out, ts_in, js_new, jmet, jimg):
    np.testing.assert_allclose(n(out.image), jimg, atol=1e-4)
    for k in ("l1", "ssim", "color_reg", "contrastive", "xyz", "scale", "lap", "loss", "psnr"):
        np.testing.assert_allclose(float(out.metrics[k]), jmet[k], rtol=1e-4, err_msg=k)
    assert int(out.metrics["num_visible"]) == int(jmet["num_visible"]) > 0
    for k in PARAM_KEYS:
        _rel_close(n(getattr(out.state.adam.mu, k)), getattr(js_new.adam.mu, k), 1e-4, k)
    for k in FLAME_KEYS:
        _rel_close(n(getattr(out.state.flame_adam.mu, k)), getattr(js_new.flame_adam.mu, k),
                   1e-4, k)
    _rel_close(n(out.state.aux.grad_accum), js_new.aux.grad_accum, 1e-4, "grad_accum")
    for i, (w, w0) in enumerate(zip(out.state.color_net.weights, ts_in.color_net.weights)):
        _rel_close(n(w - w0), np.asarray(js_new.color_net.weights[i]) - n(w0), 1e-4,
                   f"color_net.weights[{i}] update")
        _rel_close(n(out.state.color_adam.mu.weights[i]), js_new.color_adam.mu.weights[i],
                   1e-4, f"color_adam.mu.weights[{i}]")
    for i, (b, b0) in enumerate(zip(out.state.color_net.biases, ts_in.color_net.biases)):
        _rel_close(n(b - b0), np.asarray(js_new.color_net.biases[i]) - n(b0), 1e-4,
                   f"color_net.biases[{i}] update")
    assert int(out.state.color_adam.step) == int(js_new.color_adam.step)
    c, jc = out.state.contrastive, js_new.contrastive
    assert int(c.count) == int(jc.count) and int(c.head) == int(jc.head)
    assert c.count.dtype == c.head.dtype == torch.int32
    # The cached thumbnails are means of the images, held at the images'
    # own tolerance.
    np.testing.assert_allclose(n(c.images), np.asarray(jc.images), atol=1e-4, rtol=0)


def test_two_innovation_steps_match_jax(regions_avatar):
    """Step 1 from the JAX initial state (an empty cache: no contrastive
    gradient), step 2 from JAX's step-1 state (one cached render). Each
    package starts both steps from the same state."""
    ra = regions_avatar
    params, aux = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True),
                                         (ra["params"], ra["aux"]))
    js = jtrainer.init_train_state(params, aux, ra["jcfg"], num_timesteps=N_T,
                                   n_expr=fa.N_EXPR, n_shape=fa.N_SHAPE,
                                   num_verts=ra["jmodel"].num_verts,
                                   flame_init=ra["flame_init"], image_hw=(fa.H, fa.W))
    tcam = camera_from_numpy(camera_dict(ra["cam"]), device="cpu")
    contrastive = []
    for step in (1, 2):
        ts = train_state_from_numpy(**state_numpy(js), device="cpu")
        assert int(ts.contrastive.count) == step - 1
        out = ra["tstep"](ts, t(ra["gt"]), tcam, step % N_T, torch.zeros(3), 1)
        js, jmet, jimg = _run_jax(ra, js, step % N_T)
        _check_step(out, ts, js, jmet, jimg)
        contrastive.append(jmet["contrastive"])
        # The cached render is the calibrated image, the step's output.
        np.testing.assert_allclose(
            n(out.state.contrastive.images[step - 1]),
            n(tinn._downsample(out.image, 8)), atol=1e-7, rtol=0)
    assert contrastive[0] == 0.0 and contrastive[1] > 0
    assert jmet["color_reg"] > 0
