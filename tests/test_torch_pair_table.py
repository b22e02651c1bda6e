"""The port's nine-row pair table against the JAX package's sixteen-row one.

`sort_gather` builds the table as [9, M + PAIR_CHUNK]: mx, my, conic a/b/c,
r, g, b and opacity. The JAX package pads the same rows to 16 for the TPU's
8-row tiles. The compositor's wrappers take either, read rows 0..8 and
return a gradient of the table's shape. On the JAX package's 16-row tables
of `test_torch_composite.py` (64×96, 8×16 tiles), with cotangents drawn
from a numpy seed:

  * the plain forward and backward (float32 and `amp`) on rows 0..8 equal
    rows 0..8 of their results on the 16-row table bit for bit, and the
    16-row gradient's rows 9..15 are exact zeros;
  * the gradients of `rasterize_sorted` through the 9-row table equal those
    through the same table padded to 16 rows, bit for bit.

(`test_torch_binning.py` holds `sort_gather`'s table against rows 0..8 of
JAX's, whose rows 9..15 are zeros.) The CUDA kernels are held to the same
on the card (`tests/test_torch_gpu.py`, `chip_smoke.py`).
"""
import numpy as np
import pytest
import torch

from gaussianavatars_torch.ops import composite_pairs as tcp
from gaussianavatars_torch.ops import rasterize_sorted as trs
from gaussianavatars_torch.ops import sort_binning as tsb
from gaussianavatars_torch.ops.projection import project_from_params

from test_torch_composite import _table
from torch_parity import H, TILE_H, TILE_W, W, jax_camera, np_scene, t, torch_camera


# The sparse tables: the parity of rows is a property of the layout, not of
# the walk, and the long-walk tables cost minutes on a CPU.
SPARSE = ("empty_tiles", "unaligned_starts")


@pytest.mark.parametrize("case", SPARSE)
def test_plain_forward_reads_rows_0_to_8(case):
    dataT, starts, counts, ntx = _table(case)
    assert dataT.shape[0] == 16 and not dataT[9:].any()
    out16 = tcp.fwd_call_pairs(t(dataT), t(starts), t(counts), TILE_H, TILE_W, ntx)
    out9 = tcp.fwd_call_pairs(t(dataT[:9]), t(starts), t(counts), TILE_H, TILE_W, ntx)
    for a, b in zip(out9, out16):
        assert torch.equal(a, b)


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("case", SPARSE)
def test_plain_backward_gives_the_tables_shape(case, amp):
    dataT, starts, counts, ntx = _table(case)
    table = (t(starts), t(counts))
    acc, tfin, stop = tcp.fwd_call_pairs(t(dataT[:9]), *table, TILE_H, TILE_W, ntx)
    rng = np.random.RandomState(11)
    nt, p = starts.shape[0], TILE_H * TILE_W
    g_acc_t = t(rng.randn(nt, p, 3).astype(np.float32))
    g_t = t(rng.randn(nt, p).astype(np.float32))
    rest = (*table, acc, tfin, stop, g_acc_t, g_t, TILE_H, TILE_W, ntx)
    d9 = tcp.bwd_call_pairs(t(dataT[:9]), *rest, amp=amp)
    d16 = tcp.bwd_call_pairs(t(dataT), *rest, amp=amp)
    assert d9.shape == (9, dataT.shape[1]) and d16.shape == dataT.shape
    assert torch.equal(d16[:9], d9) and not d16[9:].any()
    assert d9.any()


def _padded_sort_gather(geom, mean2d, conic, colors, opacity, ints):
    """`sort_gather` with its table padded to the JAX package's 16 rows."""
    dataT, *plan = trs._SortGather.apply(geom, mean2d, conic, colors, opacity, *ints)
    pad = torch.zeros((7, dataT.shape[1]), dtype=dataT.dtype)
    return torch.cat([dataT, pad]), tsb.SortPlan(*plan)


def test_raster_gradients_equal_with_16_rows(monkeypatch):
    means, scales, quats, opacity, colors = np_scene(n=200, seed=4, opac_hi=0.95)
    cam = torch_camera(jax_camera())
    rng = np.random.RandomState(5)
    wimg = t(rng.randn(H, W, 3).astype(np.float32))
    spec = tsb.TierSpec(base=2, tiers=((256, 64),))

    def grads():
        leaves = [t(x).requires_grad_() for x in (means, scales, colors, opacity)]
        proj = project_from_params(leaves[0], leaves[1], t(quats), cam)
        op = torch.where(proj.mask, leaves[3], torch.zeros_like(leaves[3]))
        img, _alpha, plan = trs.rasterize_sorted(proj, leaves[2], op, H, W, torch.zeros(3),
                                                 TILE_H, TILE_W, spec)
        assert int(plan.budget_overflow) == 0
        return torch.autograd.grad((img * wimg).sum(), leaves)

    g9 = grads()
    monkeypatch.setattr(trs, "sort_gather", _padded_sort_gather)
    g16 = grads()
    for a, b in zip(g9, g16):
        assert torch.equal(a, b) and a.any()
