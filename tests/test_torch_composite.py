"""The port's forward pair compositor against the JAX package's.

The plain PyTorch compositor (what `fwd_call_pairs` runs on CPU tensors)
and the JAX `fwd_call_pairs` (its Pallas kernel in interpret mode) get the
same `dataT`/`starts`/`counts`, built by the JAX binning from numpy scenes.

Tolerances: `acc` and `t_final` at atol 1e-5 — the Pallas kernel adds each
64-slot group's colour as one dot product, the port adds slot by slot, so
the sums round differently (a few ulp of values <= 1). `stop` is compared
exactly: both walk the same transmittance chain in the same order.

The CUDA kernel itself is compared with this plain version on the card
(`tests/test_torch_gpu.py` and `chip_smoke.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.ops import projection as jproj
from gaussianavatars_tpu.ops import rasterize_sorted as jrs
from gaussianavatars_tpu.ops import sort_binning as jsb
from gaussianavatars_tpu.ops.pallas import composite_pairs as jcp
from gaussianavatars_torch.ops import composite_pairs as tcp
from gaussianavatars_torch.ops import projection as tproj
from gaussianavatars_torch.ops import rasterize_sorted as trs
from gaussianavatars_torch.ops import sort_binning as tsb
from gaussianavatars_torch.ops.rasterize_dense import render_dense

from torch_parity import (
    H, TILE_H, TILE_W, W, jax_camera, n, np_scene, t, torch_camera,
)

ATOL = 1e-5

# name → (np_scene kwargs, splat count, xy shift of the scene)
CASES = {
    "unaligned_starts": (dict(seed=0), 200, 0.0),
    "multi_chunk": (dict(seed=1, opac_lo=0.02, opac_hi=0.08,
                         spread=(0.08, 0.06, 0.3)), 1500, 0.0),
    "saturating": (dict(seed=2, opac_lo=0.9, opac_hi=0.99,
                        spread=(0.25, 0.2, 0.3)), 800, 0.0),
    "empty_tiles": (dict(seed=3, spread=(0.3, 0.2, 0.3)), 200, 0.6),
}


def _table(case):
    kw, n_splats, shift = CASES[case]
    means, scales, quats, opacity, colors = np_scene(n=n_splats, **kw)
    means[:, 0] += shift
    pj = jproj.project_from_params(jnp.asarray(means), jnp.asarray(scales),
                                   jnp.asarray(quats), jax_camera())
    opac = jnp.where(pj.mask, jnp.asarray(opacity), 0.0)
    tminx, tminy, bw, ntiles, nty, ntx = jsb.bbox_tiles(pj, H, W, TILE_H, TILE_W, opacity=opac)
    ntiles_eff = jnp.where(pj.mask, ntiles, 0)
    spec = jsb.TierSpec(base=2, tiers=((-(-n_splats // 128) * 128, int(ntiles_eff.max()) + 1),))
    depth_bits = jnp.maximum(pj.depth, 1e-20).view(jnp.int32)
    dataT, plan = jrs._sg_fwd_impl(
        (nty * ntx, ntx, spec), pj.mean2d, pj.conic, jnp.asarray(colors), opac,
        (tminx, tminy, bw, ntiles_eff, depth_bits))
    assert int(plan.budget_overflow) == 0
    return np.asarray(dataT), np.asarray(plan.tile_starts), np.asarray(plan.counts), ntx


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_compositor_matches_pallas(case):
    dataT, starts, counts, ntx = _table(case)
    acc_j, tf_j, stop_j = jcp.fwd_call_pairs(
        jnp.asarray(dataT), jnp.asarray(starts), jnp.asarray(counts), TILE_H, TILE_W, ntx)
    acc_t, tf_t, stop_t = tcp.fwd_call_pairs(
        t(dataT), t(starts), t(counts), TILE_H, TILE_W, ntx)
    np.testing.assert_allclose(n(acc_t), np.asarray(acc_j), atol=ATOL)
    np.testing.assert_allclose(n(tf_t), np.asarray(tf_j), atol=ATOL)
    np.testing.assert_array_equal(n(stop_t), np.asarray(stop_j))

    stop = n(stop_t)
    head = (starts % 128)[:, None]
    if case == "unaligned_starts":
        assert (starts[counts > 0] % 128 != 0).any()
    elif case == "multi_chunk":
        # Some pixel walks past the first 512 pairs of its segment.
        assert counts.max() > 512
        walked = np.where(stop == tcp.STOP_NEVER, counts[:, None], stop - head)
        assert walked.max() > 512
    elif case == "saturating":
        assert (stop != tcp.STOP_NEVER).mean() > 0.05
        assert (n(tf_t)[stop != tcp.STOP_NEVER] >= 1e-4).all()
    elif case == "empty_tiles":
        empty = counts == 0
        assert empty.any()
        assert (n(tf_t)[empty] == 1.0).all() and not n(acc_t)[empty].any()
        assert (stop[empty] == tcp.STOP_NEVER).all()


@pytest.mark.parametrize("seed", [0, 4])
def test_sorted_render_matches_dense(seed):
    """The port's sorted path (binning + plain compositor) against its dense
    ground truth with the same tile-rect culling. atol 1e-5: the dense path
    forms T with cumprod (another product order), which moves values by a
    few ulp; no stop decision flips in these scenes."""
    means, scales, quats, opacity, colors = np_scene(n=200, seed=seed, opac_hi=0.95)
    cam = torch_camera(jax_camera())
    proj = tproj.project_from_params(t(means), t(scales), t(quats), cam)
    opac = torch.where(proj.mask, t(opacity), torch.zeros(()))
    bg = torch.tensor([0.1, 0.2, 0.3])
    spec = tsb.TierSpec(base=2, tiers=((256, 64),))
    img, alpha, plan = trs.rasterize_sorted(proj, t(colors), opac, H, W, bg,
                                            TILE_H, TILE_W, spec)
    assert int(plan.budget_overflow) == 0
    ref = render_dense(t(means), t(scales), t(quats), opac, cam, bg, colors=t(colors),
                       projected=proj, tile_cull=(TILE_H, TILE_W))
    np.testing.assert_allclose(n(img), n(ref.color), atol=ATOL)
    np.testing.assert_allclose(n(alpha), n(ref.alpha), atol=ATOL)


def test_wrapper_checks_inputs():
    dataT, starts, counts, ntx = _table("unaligned_starts")
    with pytest.raises(ValueError):
        tcp.fwd_call_pairs(t(dataT).double(), t(starts), t(counts), TILE_H, TILE_W, ntx)
    for rows in (8, 12):   # 9 (the port's table) and 16 (JAX's) are taken
        with pytest.raises(ValueError):
            tcp.fwd_call_pairs(t(dataT)[:rows], t(starts), t(counts), TILE_H, TILE_W, ntx)
    with pytest.raises(ValueError):
        tcp.fwd_call_pairs(t(dataT), t(starts).long(), t(counts), TILE_H, TILE_W, ntx)
    with pytest.raises(ValueError):
        tcp.fwd_call_pairs(t(dataT), t(starts), t(counts)[:-1], TILE_H, TILE_W, ntx)
    # The plain version runs for CPU tensors and launches nothing.
    before = dict(tcp.LAUNCHES)
    tcp.fwd_call_pairs(t(dataT), t(starts), t(counts), TILE_H, TILE_W, ntx)
    assert tcp.LAUNCHES == before


@pytest.mark.parametrize("th, tw", [(8, 10), (16, 6), (64, 32)])
def test_kernel_wrappers_reject_tiles_the_kernels_do_not_take(th, tw):
    """The forward kernel takes up to 1,024 pixels a tile in rows of a
    multiple of 4 (a thread's 4 pixels lie in one row); the backward
    kernels a multiple of 32 up to 1,024. The launchers refuse other tiles
    before anything reaches the card, so this runs on the CPU."""
    dataT, starts, counts, ntx = _table("unaligned_starts")
    table = (t(dataT), t(starts), t(counts))
    nt, p = starts.shape[0], th * tw
    with pytest.raises(ValueError, match="multiple of 4"):
        tcp._launch_fwd_cuda(tcp._fwd_output(table[0], table[1], th, tw), *table, th, tw, ntx)
    if p % 32 or p > tcp.MAX_TILE_PIXELS:
        g = torch.zeros((nt, p))
        with pytest.raises(ValueError, match="multiple of 32"):
            tcp._launch_bwd_cuda(torch.zeros_like(table[0]), *table, torch.zeros((nt, 3, p)),
                                 g, g.int(), torch.zeros((nt, p, 3)), g, th, tw, ntx)
