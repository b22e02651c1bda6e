"""The port's training slice against the JAX package: losses, Adam, the
densification statistics, the FLAME laplacian, and the FLAME-bound train
step itself, on the tiny sphere avatar of `tests/fixtures_avatar.py`
(178 vertices, 352 faces, 64×48 at 8×16 tiles).

Both packages start from the same state: the JAX `init_train_state`
output, carried across as numpy by `convert.train_state_from_numpy`. The
JAX step runs its Pallas kernels in interpret mode.

Tolerances, each with its reason:
  * losses, SSIM and their gradients: rtol 1e-5 (float32 rounding of the
    same formulas);
  * one step: every gradient leaf (read as Adam's first moment, 0.1·g
    after one step from zero moments) and the new aux stats at max abs
    error <= 1e-4 × max |JAX| of the leaf, the loss terms at rtol 1e-4
    (the compositor backward sums over pixels in another order);
  * a 3-step trajectory: the loss per step at rtol 1e-4, and the
    parameters. Adam turns a gradient of rounding noise into a ±lr step, so
    the parameter comparison leaves out the elements whose first-step
    gradient is nonzero but below 1e-7 × the leaf's largest (the test
    counts them and holds their share under 1 %; on this avatar, whose
    occluded back half gets gradients 1e-6 of the front's, it is at most
    0.7 %); the others move within 1e-2 × the leaf's largest move of the
    JAX step's (measured: at most 5.3e-3, in `quats`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu import config as jconfig
from gaussianavatars_tpu.models import binding as jbinding
from gaussianavatars_tpu.models import densify as jdensify
from gaussianavatars_tpu.models import gaussians as jg
from gaussianavatars_tpu.models.flame import flame_model as jfm
from gaussianavatars_tpu.ops.rasterize_tiled import TileConfig as JTileConfig
from gaussianavatars_tpu.training import loss as jloss
from gaussianavatars_tpu.training import optim as joptim
from gaussianavatars_tpu.training import trainer as jtrainer
from gaussianavatars_torch import config as tconfig
from gaussianavatars_torch.convert import (
    camera_from_numpy, flame_assets_from_numpy, train_state_from_numpy,
)
from gaussianavatars_torch.models import binding as tbinding
from gaussianavatars_torch.models import densify as tdensify
from gaussianavatars_torch.models.flame import flame_model as tfm
from gaussianavatars_torch.models.gaussians import GaussianAux
from gaussianavatars_torch.ops import rasterize_tiled as trt
from gaussianavatars_torch.ops.rasterize_tiled import TileConfig
from gaussianavatars_torch.training import loss as tloss
from gaussianavatars_torch.training import optim as toptim
from gaussianavatars_torch.training import trainer as ttrainer

import fixtures_avatar as fa
from torch_parity import camera_dict, n, t

TH, TW = 8, 16
N_T = 2                      # FLAME timesteps
PARAM_KEYS = ("means", "log_scales", "quats", "sh_dc", "sh_rest", "logit_opacity")
FLAME_KEYS = ("expr", "rotation", "neck", "jaw", "eyes", "translation")


def _rel_close(got, want, rel, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max abs err {err:.3g} > {rel} × {scale:.3g}"


# --------------------------------------------------------------- losses


def _images(seed=0, h=24, w=40):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    b = np.clip(a + rng.randn(3, h, w).astype(np.float32) * 0.1, 0, 1)
    return a, b


def test_losses_match_jax():
    a, b = _images()
    hwc_a, hwc_b = a.transpose(1, 2, 0), b.transpose(1, 2, 0)
    wmap = np.random.RandomState(1).uniform(0.5, 2, hwc_a.shape[:2] + (1,)).astype(np.float32)
    pairs = {
        "l1": (tloss.l1_loss(t(hwc_a), t(hwc_b)), jloss.l1_loss(hwc_a, hwc_b)),
        "l2": (tloss.l2_loss(t(hwc_a), t(hwc_b)), jloss.l2_loss(hwc_a, hwc_b)),
        "weighted_l1": (tloss.weighted_l1_loss(t(hwc_a), t(hwc_b), t(wmap)),
                        jloss.weighted_l1_loss(hwc_a, hwc_b, wmap)),
        "psnr": (tloss.psnr(t(hwc_a), t(hwc_b)), jloss.psnr(hwc_a, hwc_b)),
        "ssim": (tloss.ssim(t(a), t(b)), jloss.ssim(jnp.asarray(a), jnp.asarray(b))),
    }
    for name, (got, want) in pairs.items():
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, err_msg=name)


def test_ssim_gradient_matches_jax():
    a, b = _images(2)
    x = t(a).requires_grad_()
    tloss.ssim(x, t(b)).backward()
    g_jax = jax.grad(lambda v: jloss.ssim(v, jnp.asarray(b)))(jnp.asarray(a))
    _rel_close(n(x.grad), g_jax, 1e-5, "d ssim")


def test_safe_norm_value_and_zero_gradient():
    x = np.array([[0.0, 0.0, 0.0], [3.0, 4.0, 0.0], [1e-3, -2e-3, 5e-4]], np.float32)
    xt = t(x).requires_grad_()
    v = tloss.safe_norm(xt, dim=1)
    v.sum().backward()
    g_jax = jax.grad(lambda y: jloss.safe_norm(y, axis=1).sum())(jnp.asarray(x))
    np.testing.assert_allclose(n(v), np.asarray(jloss.safe_norm(jnp.asarray(x), axis=1)),
                               rtol=1e-6)
    np.testing.assert_allclose(n(xt.grad), np.asarray(g_jax), rtol=1e-6)
    assert not n(xt.grad)[0].any() and np.isfinite(n(xt.grad)).all()


def test_adam_and_expon_lr_match_jax():
    rng = np.random.RandomState(3)
    p = {"a": rng.randn(50, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}

    @dataclasses.dataclass
    class P:
        a: torch.Tensor
        b: torch.Tensor

    state_t = toptim.adam_init(P(t(p["a"]), t(p["b"])))
    params_t = P(t(p["a"]), t(p["b"]))
    params_j, state_j = p, joptim.adam_init(p)
    for step in range(1, 4):
        g = {"a": rng.randn(50, 3).astype(np.float32) * 10.0 ** -step,
             "b": rng.randn(7).astype(np.float32)}
        lr_t = toptim.expon_lr(step, 0.005, 0.00005, max_steps=1000)
        lr_j = joptim.expon_lr(step, 0.005, 0.00005, max_steps=1000)
        np.testing.assert_allclose(float(lr_t), float(lr_j), rtol=1e-6)
        params_t, state_t = toptim.adam_update(params_t, P(t(g["a"]), t(g["b"])), state_t,
                                               P(lr_t, 0.01))
        params_j, state_j = joptim.adam_update(params_j, g, state_j, {"a": lr_j, "b": 0.01})
    assert int(state_t.step) == int(state_j.step) == 3
    for k in ("a", "b"):
        np.testing.assert_allclose(n(getattr(state_t.mu, k)), np.asarray(state_j.mu[k]),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(n(getattr(state_t.nu, k)), np.asarray(state_j.nu[k]),
                                   rtol=1e-6, atol=1e-18)
        np.testing.assert_allclose(n(getattr(params_t, k)), np.asarray(params_j[k]),
                                   rtol=1e-6, atol=1e-7)
    delayed = toptim.expon_lr(30, 0.005, 0.00005, lr_delay_steps=100, lr_delay_mult=0.01)
    np.testing.assert_allclose(
        float(delayed), float(joptim.expon_lr(30, 0.005, 0.00005, lr_delay_steps=100,
                                              lr_delay_mult=0.01)), rtol=1e-6)


def test_densification_stats_match_jax():
    rng = np.random.RandomState(4)
    n_g = 300
    aux = {"alive": np.ones(n_g, bool), "binding": np.zeros(n_g, np.int64),
           "grad_accum": rng.uniform(0, 1, n_g).astype(np.float32),
           "denom": rng.randint(0, 5, n_g).astype(np.float32),
           "max_radii2d": rng.uniform(0, 9, n_g).astype(np.float32)}
    grad = rng.randn(n_g, 2).astype(np.float32) * 1e-3
    radii = rng.randint(0, 12, n_g).astype(np.int32)
    got = tdensify.add_densification_stats(
        GaussianAux(**{k: t(v) for k, v in aux.items()}), t(grad), t(radii), 96, 64)
    want = jdensify.add_densification_stats(
        jg.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()}), jnp.asarray(grad),
        jnp.asarray(radii), 96, 64)
    for k in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(n(getattr(got, k)), np.asarray(getattr(want, k)),
                                      err_msg=k)


# ---------------------------------------------------------- the avatar


@pytest.fixture(scope="module")
def avatar(tmp_path_factory):
    """JAX model, JAX state (init_bound with trained-avatar opacity and
    scales, means at the face origins), camera and target image."""
    obj = tmp_path_factory.mktemp("sphere") / "sphere.obj"
    fa.tiny_sphere_obj(str(obj))
    assets = fa.synthetic_assets(n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR, seed=0,
                                  template_obj=str(obj))
    # `tiny_sphere_obj` numbers the bottom pole one past the last vertex in
    # its bottom-cap faces; JAX's gathers clamp that index to the pole, the
    # port's indexing raises. Both packages get the faces it means.
    assets = assets._replace(faces=np.minimum(assets.faces, assets.num_verts - 1))
    jmodel = jfm.FlameModel(assets, jfm.FlameConfig(n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR,
                                                    add_teeth=False))
    cap = -(-jmodel.num_faces // 128) * 128
    params, aux = fa.reference_avatar(jmodel, capacity=cap)
    rng = np.random.RandomState(0)
    # Anisotropic scales and random rotations (an isotropic splat has no
    # rotation gradient); the means stay at the face origins.
    params = dataclasses.replace(
        params, sh_rest=jnp.asarray(rng.randn(cap, 15, 3).astype(np.float32) * 0.05),
        log_scales=jnp.asarray(np.log(rng.uniform(0.3, 0.9, (cap, 3))).astype(np.float32)),
        quats=jnp.asarray(rng.randn(cap, 4).astype(np.float32)))
    center = np.asarray(jmodel.assets.v_template.mean(0))
    extent = float(np.abs(np.asarray(jmodel.assets.v_template) - center).max())
    from gaussianavatars_tpu.data.cameras import look_at_camera
    cam = look_at_camera(eye=center + np.array([0.3 * extent, 0.1 * extent, -4 * extent]),
                         target=center, fovy=0.6, width=fa.W, height=fa.H)
    flame_init = {
        "expr": (rng.randn(N_T, fa.N_EXPR) * 0.3).astype(np.float32),
        "jaw": (rng.randn(N_T, 3) * 0.05).astype(np.float32),
        "rotation": (rng.randn(N_T, 3) * 0.05).astype(np.float32),
        "shape": (rng.randn(fa.N_SHAPE) * 0.3).astype(np.float32),
    }
    gt = rng.uniform(0.0, 1.0, (fa.H, fa.W, 3)).astype(np.float32)
    return jmodel, params, aux, cam, flame_init, gt


def _configs(**opt):
    return (jconfig.Config(opt=jconfig.OptimizationConfig(**opt)),
            tconfig.Config(opt=tconfig.OptimizationConfig(**opt)))


def _np_or_none(x):
    return None if x is None else np.asarray(x)


def _state_numpy(js) -> dict:
    """A JAX TrainState as the keyword arguments of train_state_from_numpy."""
    def fields(obj):
        return {f.name: _np_or_none(getattr(obj, f.name)) for f in dataclasses.fields(obj)}

    def adam(a):
        return {"mu": fields(a.mu), "nu": fields(a.nu), "step": np.asarray(a.step)}

    return dict(params=fields(js.params), aux=fields(js.aux), adam=adam(js.adam),
                flame=fields(js.flame), flame_static=fields(js.flame_static),
                flame_adam=adam(js.flame_adam))


def _both(avatar, dynamic_offset=False, **opt):
    jmodel, params, aux, cam, flame_init, gt = avatar
    jcfg, tcfg = _configs(**opt)
    if dynamic_offset:
        rng = np.random.RandomState(8)
        flame_init = dict(flame_init, dynamic_offset=(
            rng.randn(N_T, jmodel.num_verts, 3) * 0.01).astype(np.float32))
    # The JAX step donates its state: hand it copies of the fixture's arrays.
    params, aux = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), (params, aux))
    js = jtrainer.init_train_state(params, aux, jcfg, num_timesteps=N_T, n_expr=fa.N_EXPR,
                                   n_shape=fa.N_SHAPE, num_verts=jmodel.num_verts,
                                   flame_init=flame_init)
    # One tier as wide as the frame's 24 tiles: no budget overflow.
    tiers = ((params.means.shape[0], 24),)
    jstep = jtrainer.make_train_step(jmodel, jcfg, JTileConfig(tile_h=TH, tile_w=TW,
                                                               tiers=tiers))
    tmodel = tfm.FlameModel(flame_assets_from_numpy(jmodel.assets._asdict()),
                            tfm.FlameConfig(fa.N_SHAPE, fa.N_EXPR, add_teeth=False),
                            device="cpu")
    ts = train_state_from_numpy(**_state_numpy(js), device="cpu")
    tstep = ttrainer.make_train_step(tmodel, tcfg, TileConfig(tile_h=TH, tile_w=TW,
                                                              tiers=tiers))
    tcam = camera_from_numpy(camera_dict(cam), device="cpu")
    return (jstep, js, cam, jmodel), (tstep, ts, tcam, tmodel), gt


def _run_jax(jstep, js, cam, gt, timestep, sh_degree):
    out = jstep(js, jnp.asarray(gt), cam, jnp.int32(timestep), jnp.zeros(3),
                sh_degree=sh_degree)
    return out.state, {k: float(v) for k, v in out.metrics.items()}, out.image


@pytest.mark.parametrize("sh_degree,dyn", [(0, False), (1, True)])
def test_one_train_step_matches_jax(avatar, sh_degree, dyn):
    """sh_degree 1 also carries per-timestep dynamic offsets with both
    dynamic-offset regularisers on."""
    dyn_opt = dict(lambda_dynamic_offset=0.1, lambda_dynamic_offset_std=0.1) if dyn else {}
    (jstep, js, jcam, _jm), (tstep, ts, tcam, _tm), gt = _both(
        avatar, dynamic_offset=dyn, lambda_laplacian=0.3, **dyn_opt)
    ts_before = ts
    out = tstep(ts, t(gt), tcam, 1, torch.zeros(3), sh_degree)
    js_new, jmet, jimg = _run_jax(jstep, js, jcam, gt, 1, sh_degree)

    np.testing.assert_allclose(n(out.image), np.asarray(jimg), atol=1e-4)
    terms = ("l1", "ssim", "xyz", "scale", "lap", "loss", "psnr")
    if dyn:
        terms += ("dy_off", "dynamic_offset_std")
    for k in terms:
        np.testing.assert_allclose(float(out.metrics[k]), jmet[k], rtol=1e-4, err_msg=k)
    assert jmet["lap"] > 0 and int(out.metrics["budget_overflow"]) == 0
    assert int(out.metrics["num_visible"]) == int(jmet["num_visible"]) > 0

    # Gradients: Adam's first moment after one step is 0.1·g.
    for k in PARAM_KEYS:
        _rel_close(n(getattr(out.state.adam.mu, k)), getattr(js_new.adam.mu, k), 1e-4, k)
    for k in FLAME_KEYS + (("dynamic_offset",) if dyn else ()):
        _rel_close(n(getattr(out.state.flame_adam.mu, k)), getattr(js_new.flame_adam.mu, k),
                   1e-4, k)
        if k != "dynamic_offset":   # the std term reaches every timestep
            assert not n(getattr(out.state.flame_adam.mu, k))[0].any()
    if dyn:   # lr 0: the offsets never move
        np.testing.assert_array_equal(n(out.state.flame.dynamic_offset),
                                      n(ts.flame.dynamic_offset))
    assert np.abs(n(out.state.flame_adam.mu.expr)).max() > 0
    if sh_degree == 0:
        assert not n(out.state.adam.mu.sh_rest).any()
    else:
        assert np.abs(n(out.state.adam.mu.sh_rest)).max() > 0
    # Densification statistics: |g_screen[0]| scaled to NDC units.
    np.testing.assert_array_equal(n(out.state.aux.denom), np.asarray(js_new.aux.denom))
    np.testing.assert_array_equal(n(out.state.aux.max_radii2d),
                                  np.asarray(js_new.aux.max_radii2d))
    _rel_close(n(out.state.aux.grad_accum), js_new.aux.grad_accum, 1e-4, "grad_accum")
    # The step is functional: the given state is untouched.
    assert int(ts_before.adam.step) == 0 and not ts_before.adam.mu.means.any()
    # Dead slots: zero gradients, parameters unchanged bit for bit.
    dead = ~n(ts.aux.alive)
    assert dead.any()
    for k in PARAM_KEYS:
        assert np.array_equal(n(getattr(out.state.params, k))[dead],
                              n(getattr(ts.params, k))[dead]), k


def test_three_step_trajectory_matches_jax(avatar):
    (jstep, js, jcam, _jm), (tstep, ts, tcam, _tm), gt = _both(avatar, lambda_laplacian=0.3)
    p0 = {k: n(getattr(ts.params, k)) for k in PARAM_KEYS}
    f0 = {k: n(getattr(ts.flame, k)) for k in FLAME_KEYS}
    first_g = None
    for i in range(3):
        out = tstep(ts, t(gt), tcam, i % N_T, torch.zeros(3), 1)
        js, jmet, _img = _run_jax(jstep, js, jcam, gt, i % N_T, 1)
        ts = out.state
        np.testing.assert_allclose(float(out.metrics["loss"]), jmet["loss"], rtol=1e-4,
                                   err_msg=f"loss, step {i}")
        if first_g is None:
            first_g = {k: np.asarray(getattr(js.adam.mu, k)) for k in PARAM_KEYS}
    for k in PARAM_KEYS:
        g = np.abs(first_g[k])
        small = (g > 0) & (g < 1e-7 * g.max())
        assert small.mean() < 0.01, f"{k}: {small.sum()} of {g.size} below the floor"
        move = np.asarray(getattr(js.params, k)) - p0[k]
        got = n(getattr(ts.params, k)) - p0[k]
        err = np.abs(got - move)[~small]
        assert err.max() <= 1e-2 * np.abs(move).max(), (
            f"{k}: {err.max():.3g} vs max move {np.abs(move).max():.3g}, "
            f"{small.sum()} excluded")
    for k in FLAME_KEYS:
        _rel_close(n(getattr(ts.flame, k)) - f0[k], np.asarray(getattr(js.flame, k)) - f0[k],
                   1e-2, k)


# --------------------------------------------------------------- FLAME


def test_face_frames_rejects_out_of_range_faces(tmp_path):
    """A difference by design (ROADMAP queue C). `tiny_sphere_obj`'s
    bottom-cap faces name one vertex past the last. The JAX `face_frames`
    gathers it clamped to the last vertex without a word, the
    out-of-bounds gather the JAX trainer itself treats as a hazard
    (`training/trainer.py:231-233`); the port raises."""
    obj = tmp_path / "sphere.obj"
    fa.tiny_sphere_obj(str(obj))
    assets = fa.synthetic_assets(n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR, seed=0,
                                 template_obj=str(obj))
    faces = np.asarray(assets.faces)
    verts = np.asarray(assets.v_template, np.float32)
    assert faces.max() == assets.num_verts              # one past the last vertex
    with pytest.raises(IndexError):
        tbinding.face_frames(t(verts), torch.as_tensor(faces))
    clamped = np.minimum(faces, assets.num_verts - 1)
    want = jbinding.face_frames(jnp.asarray(verts), jnp.asarray(clamped))
    got = jbinding.face_frames(jnp.asarray(verts), jnp.asarray(faces))
    np.testing.assert_array_equal(np.asarray(got.center), np.asarray(want.center))
    # With the faces the mesh means, the two packages agree.
    t_frames = tbinding.face_frames(t(verts), torch.as_tensor(clamped))
    np.testing.assert_allclose(n(t_frames.center), np.asarray(want.center), atol=1e-6)



def test_laplacian_and_verts_cano_match_jax(avatar):
    jmodel = avatar[0]
    tmodel = tfm.FlameModel(flame_assets_from_numpy(jmodel.assets._asdict()),
                            tfm.FlameConfig(fa.N_SHAPE, fa.N_EXPR, add_teeth=False),
                            device="cpu")
    rng = np.random.RandomState(6)
    fd = {"shape": rng.randn(fa.N_SHAPE).astype(np.float32),
          "expr": rng.randn(1, fa.N_EXPR).astype(np.float32),
          "rotation": (rng.randn(1, 3) * 0.1).astype(np.float32),
          "neck": (rng.randn(1, 3) * 0.1).astype(np.float32),
          "jaw": (rng.randn(1, 3) * 0.1).astype(np.float32),
          "eyes": np.zeros((1, 6), np.float32), "translation": np.zeros((1, 3), np.float32)}
    jfp = jfm.FlameParams(**{k: jnp.asarray(v) for k, v in fd.items()})
    jv, jc = jmodel.forward(jfp, return_verts_cano=True)
    tfp = tfm.FlameParams(**{k: t(v).requires_grad_(k == "expr") for k, v in fd.items()})
    tv, tc = tmodel(tfp, return_verts_cano=True)
    np.testing.assert_allclose(n(tv), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(n(tc), np.asarray(jc), atol=1e-5)

    lap_t = tmodel.laplacian_loss(tv, tc)
    lap_t.backward()

    def lap_j(expr):
        v, c = jmodel.forward(jfp._replace(expr=expr), return_verts_cano=True)
        return jmodel.laplacian_loss(v, c)

    np.testing.assert_allclose(float(lap_t.detach()), float(lap_j(jfp.expr)), rtol=1e-5)
    assert float(lap_t.detach()) > 0
    _rel_close(n(tfp.expr.grad), jax.grad(lap_j)(jfp.expr), 1e-4, "d lap / d expr")
    assert list(tmodel.vid_by_region(["neck", "no_such_region"])) == list(
        jmodel.vid_by_region(["neck", "no_such_region"]))
    assert list(tmodel.fid_by_region(["neck"])) == list(jmodel.fid_by_region(["neck"]))


def test_unported_options_raise(avatar, monkeypatch):
    """The options the step once refused now build it: `use_sorted=False`,
    `use_pallas=False` or an explicit `compositor` select the table
    pipeline (one table binning, `rasterize_binned`), the defaults the
    sorted one. The table step's values against JAX's are in
    `test_torch_train_table.py`."""
    _jax, (_t, ts, tcam, tmodel), gt = _both(avatar)
    tile = TileConfig(tile_h=TH, tile_w=TW, tiers=((ts.params.capacity, 24),))
    calls = []
    for name in ("rasterize_binned", "rasterize_sorted", "bin_gaussians"):
        real = getattr(ttrainer, name)
        monkeypatch.setattr(ttrainer, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    spy = []

    def compositor(*a):
        spy.append(1)
        return trt.composite_tiles(*a)

    cases = [
        (dict(), None, ["rasterize_sorted"]),
        (dict(use_sorted=False), None, ["bin_gaussians", "rasterize_binned"]),
        (dict(use_pallas=False), None, ["bin_gaussians", "rasterize_binned"]),
        (dict(), compositor, ["bin_gaussians", "rasterize_binned"]),
    ]
    for pipeline, comp, want in cases:
        calls.clear()
        step = ttrainer.make_train_step(tmodel, tconfig.Config(
            pipeline=tconfig.PipelineConfig(**pipeline)), tile, compositor=comp)
        out = step(ts, t(gt), tcam, 0, torch.zeros(3), 0)
        assert calls == want, pipeline
        assert np.isfinite(float(out.metrics["loss"])) and int(out.metrics["overflow"]) == 0
    assert spy == [1]
    assert ttrainer.active_sh_degree(999) == 0 and ttrainer.active_sh_degree(3500) == 3
