"""PyTorch port vs JAX: tile bboxes, tier specs and the sorted binning.

Everything here is compared exactly. The two packages get the same
projected inputs (the JAX projection's arrays, carried across as numpy), so
the bbox arithmetic and the sorts see identical bits. The scenes have no
tied depths, so the (tile, depth) order of live pairs is unique and JAX's
unstable sort and the port's stable one must agree on the live table,
`starts`, `counts` and `total` (ties in the footprint order may still
permute `pos` and `gidx_fp`, which are not compared).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.ops import projection as jproj
from gaussianavatars_tpu.ops import rasterize_sorted as jrs
from gaussianavatars_tpu.ops import sort_binning as jsb
from gaussianavatars_torch.ops import projection as tproj
from gaussianavatars_torch.ops import rasterize_sorted as trs
from gaussianavatars_torch.ops import sort_binning as tsb

from torch_parity import H, TILE_H, TILE_W, W, jax_camera, n, np_scene, t


def _projected(seed, n_splats=200, **kw):
    """JAX projection of a numpy scene, and the same arrays as a torch
    Projected."""
    means, scales, quats, opacity, colors = np_scene(n=n_splats, seed=seed, **kw)
    pj = jproj.project_from_params(jnp.asarray(means), jnp.asarray(scales),
                                   jnp.asarray(quats), jax_camera())
    pt = tproj.Projected(**{k: t(getattr(pj, k)) for k in pj._fields})
    opac = np.where(np.asarray(pj.mask), opacity, 0.0).astype(np.float32)
    return pj, pt, opac, colors


@pytest.mark.parametrize("with_opacity", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_bbox_tiles_exact(seed, with_opacity):
    pj, pt, opac, _ = _projected(seed)
    ref = jsb.bbox_tiles(pj, H, W, TILE_H, TILE_W,
                         opacity=jnp.asarray(opac) if with_opacity else None)
    out = tsb.bbox_tiles(pt, H, W, TILE_H, TILE_W,
                         opacity=t(opac) if with_opacity else None)
    for r, o in zip(ref[:4], out[:4]):
        np.testing.assert_array_equal(n(o), np.asarray(r))
    assert tuple(out[4:]) == tuple(ref[4:])


@pytest.mark.parametrize("capacity", [128, 10112, 90112])
def test_default_tiers_and_blocks(capacity):
    a, b = tsb.default_tiers(capacity), jsb.default_tiers(capacity)
    assert (a.base, a.tiers) == (b.base, b.tiers)
    assert a.blocks(capacity) == b.blocks(capacity)
    assert a.expansion_size(capacity) == b.expansion_size(capacity)
    assert a.max_budget() == b.max_budget()
    rank = np.arange(capacity, dtype=np.int32)
    np.testing.assert_array_equal(n(a.budget_for_rank(t(rank))),
                                  np.asarray(b.budget_for_rank(jnp.asarray(rank))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_and_grow_tiers(seed):
    rng = np.random.RandomState(seed)
    fp = np.minimum(rng.geometric(0.25 / (seed + 1), size=5000), 700).astype(np.int32)
    fp[rng.rand(5000) < 0.2] = 0
    a, b = tsb.probe_tiers(t(fp)), jsb.probe_tiers(fp)
    assert (a.base, a.tiers) == (b.base, b.tiers)
    for n_gauss in (None, 5000):
        ga = tsb.grow_tiers(a, int(fp.max()) + 7, n_gauss)
        gb = jsb.grow_tiers(b, int(fp.max()) + 7, n_gauss)
        assert (ga.base, ga.tiers) == (gb.base, gb.tiers)
    empty = tsb.grow_tiers(tsb.TierSpec(base=1), 5, 1000)
    assert empty.tiers == jsb.grow_tiers(jsb.TierSpec(base=1), 5, 1000).tiers


def test_tier_spec_rejects_bad_specs():
    with pytest.raises(ValueError):
        tsb.TierSpec(base=2, tiers=((100, 8),))
    with pytest.raises(ValueError):
        tsb.TierSpec(base=2, tiers=((256, 8), (128, 8)))
    with pytest.raises(ValueError):
        tsb.TierSpec(base=2, tiers=((128, 8), (256, 16)))


def _ints(pj, opac):
    tminx, tminy, bw, ntiles, _nty, ntx = jsb.bbox_tiles(
        pj, H, W, TILE_H, TILE_W, opacity=jnp.asarray(opac))
    ntiles_eff = jnp.where(pj.mask, ntiles, 0)
    depth_bits = jax.lax.bitcast_convert_type(
        jnp.maximum(pj.depth, 1e-20).astype(jnp.float32), jnp.int32)
    return (tminx, tminy, bw, ntiles_eff, depth_bits), ntx


SPECS = {
    "one_tier": jsb.TierSpec(base=2, tiers=((256, 16),)),
    "three_tiers": jsb.TierSpec(base=1, tiers=((256, 8), (256, 24), (128, 64))),
}


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("seed", [0, 2, 5])
def test_sort_gather_table_exact(seed, spec_name):
    pj, pt, opac, colors = _projected(seed, n_splats=250, opac_hi=0.95)
    ints, ntx = _ints(pj, opac)
    live_depth = np.asarray(pj.depth)[np.asarray(ints[3]) > 0]
    assert len(np.unique(live_depth)) == len(live_depth)   # no tied depths
    nt = (H // TILE_H) * ntx
    jspec = SPECS[spec_name]
    tspec = tsb.TierSpec(base=jspec.base, tiers=jspec.tiers)

    dj, plan_j = jrs._sg_fwd_impl((nt, ntx, jspec), pj.mean2d, pj.conic,
                                  jnp.asarray(colors), jnp.asarray(opac), ints)
    dt, plan_t = trs.sort_gather((nt, ntx, tspec), pt.mean2d, pt.conic, t(colors),
                                 t(opac), tuple(t(x) for x in ints))
    total = int(plan_j.total)
    assert total > 0 and int(plan_t.total) == total
    assert int(plan_j.budget_overflow) == 0 == int(plan_t.budget_overflow)
    np.testing.assert_array_equal(n(plan_t.tile_starts), np.asarray(plan_j.tile_starts))
    np.testing.assert_array_equal(n(plan_t.counts), np.asarray(plan_j.counts))
    assert int(plan_t.max_footprint) == int(plan_j.max_footprint)
    assert tuple(dt.shape) == tuple(dj.shape)
    np.testing.assert_array_equal(n(dt)[:, :total], np.asarray(dj)[:, :total])
    assert not n(dt)[9:].any() and not n(dt)[:, -tsb.PAIR_CHUNK:].any()
    # pos is a permutation of the expansion slots.
    assert np.array_equal(np.sort(n(plan_t.pos)), np.arange(dt.shape[1] - tsb.PAIR_CHUNK))


def test_budget_overflow_counted_like_jax():
    pj, pt, opac, colors = _projected(6, opac_lo=0.8, opac_hi=0.95)
    ints, ntx = _ints(pj, opac)
    nt = (H // TILE_H) * ntx
    ref = jsb.sort_bin_forward(
        [jnp.asarray(opac)] * 9, *ints, ntx, nt, jsb.TierSpec(base=1))
    out = tsb.sort_bin_forward(
        [t(opac)] * 9, *(t(x) for x in ints), ntx, nt, tsb.TierSpec(base=1))
    assert int(ref[4]) > 0
    assert int(out[4]) == int(ref[4])


@pytest.mark.parametrize("bw_v", [41, 47, 55, 61, 82])
def test_wide_bbox_row_split_exact(bw_v):
    """dy = j // bw must be exact integer division for wide bboxes: a float
    reciprocal puts j = k·bw one row early (smallest failing bw = 41)."""
    i32 = torch.int32
    n_splats, ntx, nty = 128, 64, 4
    nt = ntx * nty
    rows = 2 if bw_v <= 64 else 1
    ntiles = bw_v * rows
    spec = tsb.TierSpec(base=2, tiers=((128, ntiles + 2),))
    ntiles_eff = torch.zeros((n_splats,), dtype=i32)
    ntiles_eff[0] = ntiles
    args = (torch.zeros((n_splats,), dtype=i32), torch.zeros((n_splats,), dtype=i32),
            torch.full((n_splats,), bw_v, dtype=i32), ntiles_eff,
            torch.arange(n_splats, dtype=i32))
    data_cols = [torch.arange(n_splats, dtype=torch.float32)] * 9
    s_data, s_tile, _pos, _g, overflow = tsb.sort_bin_forward(
        data_cols, *args, ntx, nt, spec)
    assert int(overflow) == 0
    live = n(s_tile)
    live = live[live < nt]
    expect = np.array([(j // bw_v) * ntx + (j % bw_v) for j in range(ntiles)])
    np.testing.assert_array_equal(live, expect)   # already in tile order

    ref = jsb.sort_bin_forward(
        [jnp.asarray(n(c)) for c in data_cols], *(jnp.asarray(n(a)) for a in args),
        ntx, nt, jsb.TierSpec(base=spec.base, tiers=spec.tiers))
    np.testing.assert_array_equal(n(s_tile), np.asarray(ref[1]))
