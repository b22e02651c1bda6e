"""Gradients of the port's `rasterize_sorted` (the autograd Functions
`sort_gather` and `composite_sorted`, the backward compositor's plain
version and `reduce_expansion`) with respect to mean2d, conic, colours and
opacity, for the loss Σ img·wimg + Σ alpha·walpha with weights drawn from a
numpy seed:

  * against `jax.grad` of the JAX package's `rasterize_sorted` (Pallas
    kernels in interpret mode) on the same screen-space inputs;
  * against autograd through the port's dense ground truth `render_dense`
    with the same tile-rect culling.

Both at atol/rtol 2e-4, as `tests/test_rasterize_sorted.py` holds the JAX
package's sorted gradients against its scan compositor: the backward sums
over pixels in another order than either reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.ops import projection as jproj
from gaussianavatars_tpu.ops import rasterize_sorted as jrs
from gaussianavatars_tpu.ops import sort_binning as jsb
from gaussianavatars_torch.ops import rasterize_sorted as trs
from gaussianavatars_torch.ops import sort_binning as tsb
from gaussianavatars_torch.ops.projection import Projected
from gaussianavatars_torch.ops.rasterize_dense import render_dense

from torch_parity import H, TILE_H, TILE_W, W, jax_camera, n, np_scene, t, torch_camera

TOL = 2e-4
NAMES = ("mean2d", "conic", "colors", "opacity")


def _screen(seed):
    means, scales, quats, opacity, colors = np_scene(n=200, seed=seed, opac_hi=0.95)
    pj = jproj.project_from_params(jnp.asarray(means), jnp.asarray(scales),
                                   jnp.asarray(quats), jax_camera())
    # The first ten splats are culled, as a dead or off-screen Gaussian is.
    pj = pj._replace(mask=pj.mask.at[:10].set(False))
    opac = np.asarray(jnp.where(pj.mask, jnp.asarray(opacity), 0.0))
    rng = np.random.RandomState(seed + 100)
    wimg = rng.randn(H, W, 3).astype(np.float32)
    walpha = rng.randn(H, W).astype(np.float32)
    return (means, scales, quats), pj, colors, opac, wimg, walpha


def _torch_grads(pj, colors, opac, wimg, walpha, loss_of):
    proj = Projected(*(t(x) for x in pj))
    leaves = [proj.mean2d.clone().requires_grad_(), proj.conic.clone().requires_grad_(),
              t(colors).requires_grad_(), t(opac).requires_grad_()]
    proj = proj._replace(mean2d=leaves[0], conic=leaves[1])
    img, alpha = loss_of(proj, leaves[2], leaves[3])
    loss = (img * t(wimg)).sum() + (alpha * t(walpha)).sum()
    return [n(g) for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("seed", [3, 7])
def test_sorted_grads_match_jax_and_dense(seed):
    geo, pj, colors, opac, wimg, walpha = _screen(seed)
    bg = np.array([0.5, 0.4, 0.3], np.float32)
    tiers = ((256, 64),)

    def loss_jax(m2d, conic, col, op):
        img, alpha, _plan = jrs.rasterize_sorted(
            pj._replace(mean2d=m2d, conic=conic), col, op, H, W, jnp.asarray(bg),
            TILE_H, TILE_W, jsb.TierSpec(base=2, tiers=tiers))
        return jnp.sum(img * wimg) + jnp.sum(alpha * walpha)

    g_jax = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(
        pj.mean2d, pj.conic, jnp.asarray(colors), jnp.asarray(opac))

    def sorted_port(proj, col, op):
        img, alpha, plan = trs.rasterize_sorted(proj, col, op, H, W, t(bg), TILE_H, TILE_W,
                                                tsb.TierSpec(base=2, tiers=tiers))
        assert int(plan.budget_overflow) == 0
        return img, alpha

    cam = torch_camera(jax_camera())

    def dense_port(proj, col, op):
        out = render_dense(*(t(x) for x in geo), op, cam, t(bg), colors=col, projected=proj,
                           tile_cull=(TILE_H, TILE_W))
        return out.color, out.alpha

    g_sorted = _torch_grads(pj, colors, opac, wimg, walpha, sorted_port)
    g_dense = _torch_grads(pj, colors, opac, wimg, walpha, dense_port)
    for name, a, b, c in zip(NAMES, g_sorted, g_jax, g_dense):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL, err_msg=name)
        np.testing.assert_allclose(a, c, atol=TOL, rtol=TOL, err_msg=name)
        assert np.abs(a).max() > 1e-3, name     # the loss reaches every input
    # Culled Gaussians get exact zeros.
    for name, a in zip(NAMES, g_sorted):
        assert not a[:10].any(), name


def test_render_path_keeps_no_graph():
    """Under inference mode (the render path) the Functions record nothing."""
    _geo, pj, colors, opac, _wi, _wa = _screen(3)
    proj = Projected(*(t(x) for x in pj))
    with torch.inference_mode():
        img, _alpha, _plan = trs.rasterize_sorted(
            proj, t(colors), t(opac), H, W, torch.zeros(3), TILE_H, TILE_W,
            tsb.TierSpec(base=2, tiers=((256, 64),)))
    assert img.grad_fn is None and not img.requires_grad
