"""The port's mixed-precision policy (`OptimizationConfig.use_amp`) against
the JAX package's: SSIM's bf16 blurs, the rasterizer's gradient through the
backward compositor's bf16 contraction, and the FLAME-bound training step.

Tolerances, each with its reason:
  * SSIM with `amp`, value and gradient: 1e-6 absolute. Both round the same
    operands (band matrices, images, the first product) to bf16 and
    accumulate in float32; what remains is float32 summation order (the
    gradient's scale is ~3e-4).
  * the rasterizer's gradients with `amp`: max |port − JAX| ≤ 1e-3 × max
    |JAX| per input, the compositor's `amp` bound
    (`test_torch_composite_variants.py`): a one-ulp float32 difference in a
    contraction operand can flip its bf16 rounding.
  * one `use_amp` train step: the tolerances of
    `test_torch_train.test_one_train_step_matches_jax` where they still hold
    (image at atol 1e-4, loss terms at rtol 1e-4, the densification counts
    exactly), and every gradient leaf at 1e-3 × max |JAX| of the leaf (the
    compositor's `amp` bound, in place of 1e-4).
  * the port's `amp` step against its float32 step: `tests/test_amp.py`'s
    criteria (relative loss difference < 1e-2; for means, log_scales,
    logit_opacity and sh_dc an update cosine > 0.98 and update norms within
    10 %).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.ops import rasterize_sorted as jrs
from gaussianavatars_tpu.ops import sort_binning as jsb
from gaussianavatars_tpu.training import loss as jloss
from gaussianavatars_torch.ops import rasterize_sorted as trs
from gaussianavatars_torch.ops import sort_binning as tsb
from gaussianavatars_torch.training import loss as tloss

from test_torch_raster_grad import NAMES, _screen, _torch_grads
from test_torch_train import (  # noqa: F401  (`avatar` is a fixture)
    FLAME_KEYS, PARAM_KEYS, _both, _rel_close, _run_jax, avatar,
)
from torch_parity import H, TILE_H, TILE_W, W, n, t

AMP_REL = 1e-3
UPDATE_KEYS = ("means", "log_scales", "logit_opacity", "sh_dc")


def _images(seed=1, h=48, w=64):
    rng = np.random.RandomState(seed)
    a = rng.rand(3, h, w).astype(np.float32)
    b = np.clip(a + 0.05 * rng.randn(3, h, w).astype(np.float32), 0, 1)
    return a, b


def test_ssim_amp_value_and_gradient_match_jax():
    a, b = _images()
    x = t(a).requires_grad_()
    s_t = tloss.ssim(x, t(b), amp=True)
    s_t.backward()
    s_j = jloss.ssim(jnp.asarray(a), jnp.asarray(b), amp=True)
    g_j = np.asarray(jax.grad(lambda v: jloss.ssim(v, jnp.asarray(b), amp=True))(jnp.asarray(a)))
    assert abs(float(s_t.detach()) - float(s_j)) <= 1e-6
    assert np.abs(n(x.grad) - g_j).max() <= 1e-6
    # The bf16 blur is a different function: it moves SSIM by far more.
    assert abs(float(tloss.ssim(t(a), t(b))) - float(s_j)) > 1e-5


def test_rasterizer_amp_gradients_match_jax():
    _geo, pj, colors, opac, wimg, walpha = _screen(3)
    bg = np.array([0.5, 0.4, 0.3], np.float32)
    tiers = ((256, 64),)

    def loss_jax(m2d, conic, col, op):
        img, alpha, _plan = jrs.rasterize_sorted(
            pj._replace(mean2d=m2d, conic=conic), col, op, H, W, jnp.asarray(bg),
            TILE_H, TILE_W, jsb.TierSpec(base=2, tiers=tiers), amp=True)
        return jnp.sum(img * wimg) + jnp.sum(alpha * walpha)

    g_jax = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(
        pj.mean2d, pj.conic, jnp.asarray(colors), jnp.asarray(opac))

    def sorted_port(proj, col, op):
        img, alpha, _plan = trs.rasterize_sorted(proj, col, op, H, W, t(bg), TILE_H, TILE_W,
                                                 tsb.TierSpec(base=2, tiers=tiers), amp=True)
        return img, alpha

    g_port = _torch_grads(pj, colors, opac, wimg, walpha, sorted_port)
    for name, a, b in zip(NAMES, g_port, g_jax):
        _rel_close(a, b, AMP_REL, name)
        assert not a[:10].any(), name      # culled Gaussians: exact zeros


def _updates(before, after):
    return {k: n(getattr(after.params, k)) - n(getattr(before.params, k)) for k in UPDATE_KEYS}


def test_amp_train_step_matches_jax(avatar):
    (jstep, js, jcam, _jm), (tstep, ts, tcam, _tm), gt = _both(
        avatar, lambda_laplacian=0.3, use_amp=True)
    out = tstep(ts, t(gt), tcam, 1, torch.zeros(3), 1)
    js_new, jmet, jimg = _run_jax(jstep, js, jcam, gt, 1, 1)

    np.testing.assert_allclose(n(out.image), np.asarray(jimg), atol=1e-4)
    for k in ("l1", "ssim", "xyz", "scale", "lap", "loss", "psnr"):
        np.testing.assert_allclose(float(out.metrics[k]), jmet[k], rtol=1e-4, err_msg=k)
    for k in PARAM_KEYS:
        _rel_close(n(getattr(out.state.adam.mu, k)), getattr(js_new.adam.mu, k), AMP_REL, k)
    for k in FLAME_KEYS:
        _rel_close(n(getattr(out.state.flame_adam.mu, k)), getattr(js_new.flame_adam.mu, k),
                   AMP_REL, k)
    np.testing.assert_array_equal(n(out.state.aux.denom), np.asarray(js_new.aux.denom))
    _rel_close(n(out.state.aux.grad_accum), js_new.aux.grad_accum, AMP_REL, "grad_accum")


def test_amp_train_step_tracks_float32(avatar):
    """The port's own `amp` step against its float32 step from one state,
    held to `tests/test_amp.py`'s criteria."""
    (_j, _js, _c, _m), (step32, ts, tcam, _tm), gt = _both(avatar, lambda_laplacian=0.3)
    (_j, _js, _c, _m), (step16, ts16, _c16, _tm16), _gt = _both(
        avatar, lambda_laplacian=0.3, use_amp=True)
    o32 = step32(ts, t(gt), tcam, 0, torch.zeros(3), 1)
    o16 = step16(ts16, t(gt), tcam, 0, torch.zeros(3), 1)
    l32, l16 = float(o32.metrics["loss"]), float(o16.metrics["loss"])
    assert abs(l32 - l16) / max(abs(l32), 1e-9) < 1e-2, (l32, l16)
    u32, u16 = _updates(ts, o32.state), _updates(ts16, o16.state)
    for k in UPDATE_KEYS:
        n32, n16 = np.linalg.norm(u32[k]), np.linalg.norm(u16[k])
        assert n32 > 0, k
        cos = float(np.sum(u32[k] * u16[k]) / (n32 * max(n16, 1e-12)))
        assert cos > 0.98, (k, cos)
        assert abs(n16 - n32) / n32 < 0.1, k
    # The two modes differ: the bf16 policy is really on.
    assert not np.array_equal(n(o16.state.adam.mu.means), n(o32.state.adam.mu.means))


@pytest.mark.parametrize("use_amp", [False, True])
def test_render_tiled_passes_amp_to_the_backward(use_amp, monkeypatch):
    """`render_tiled(amp=)` reaches `bwd_call_pairs(amp=)`."""
    from gaussianavatars_torch.ops import composite_pairs as tcp
    from gaussianavatars_torch.ops.rasterize_tiled import TileConfig, render_tiled
    from torch_parity import jax_camera, np_scene, torch_camera

    seen = []
    real = tcp.bwd_call_pairs

    def spy(*args, amp=False):
        seen.append(amp)
        return real(*args, amp=amp)

    monkeypatch.setattr(trs, "bwd_call_pairs", spy)
    means, scales, quats, opacity, colors = (t(x) for x in np_scene(n=60, seed=2))
    colors.requires_grad_()
    out = render_tiled(means, scales, quats, opacity, torch_camera(jax_camera()),
                       torch.zeros(3), colors=colors,
                       cfg=TileConfig(tile_h=TILE_H, tile_w=TILE_W, tiers=((128, 64),)),
                       amp=use_amp)
    out.color.sum().backward()
    assert seen == [use_amp] and colors.grad.abs().max() > 0
