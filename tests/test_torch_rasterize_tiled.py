"""PyTorch port vs JAX: the padded-table pipeline of `ops/rasterize_tiled.py`
(`expand_sorted_pairs`, `bin_gaussians`, `composite_tiles` with its custom
VJP, `rasterize_binned`, `render_tiled(use_pallas=False)`).

None of the JAX side is Pallas: it runs as it is on the CPU. Both packages
get the same numpy scene (`torch_parity.np_scene`), 64×96 in 8×16 tiles.

Tolerances, with their reasons:
  * Binning: exact. Both sides bin the JAX projection's arrays; the bbox
    arithmetic is the same float32 sequence, the depth ranks come from a
    stable argsort in both, and the (tile, rank) keys are unique.
  * `composite_tiles` forward on the same slot tables: atol 1e-5 (exp and
    the quadratic form round differently by an ulp or two; each pixel sums
    up to 64 slots, the port a pass of slots at a time). The slot tables
    come from two random scenes and a saturating one whose pixels stop
    early, each at the default pass length and at 5 slots a pass.
  * Its backward under random cotangents: each gradient within 1e-5 of its
    largest magnitude (max |port − JAX| ≤ 1e-5 · max |JAX|; measured
    ≤ 3.2e-7). The replay divides by 1 − α back to front, which grows the
    forward's ulps by the inverse transmittance, so the bound keeps a
    margin of 30×.
  * `render_tiled(use_pallas=False)` end to end: image and alpha at atol
    1e-5; the five parameter gradients within 1e-5 of their largest
    magnitude (measured ≤ 6e-7: the projections of the two frameworks
    round differently by ~1e-7 relative).
  * The table path against the port's own sorted path: image and alpha at
    atol 1e-5, the screen-space gradients within 1e-4 of their largest
    (the sorted compositor sums in another order).
  * The max-count loop against the full-capacity loop: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.ops import projection as jproj
from gaussianavatars_tpu.ops import rasterize_tiled as jrt
from gaussianavatars_torch.ops import projection as tproj
from gaussianavatars_torch.ops import rasterize_tiled as trt

from torch_parity import torch_threads, H, TILE_H, TILE_W, W, jax_camera, n, np_scene, t, torch_camera


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (`torch_parity.torch_threads`)."""
    with torch_threads(1):
        yield


JCFG = jrt.TileConfig(tile_h=TILE_H, tile_w=TILE_W, capacity=64, max_tiles_per_gaussian=16)
TCFG = trt.TileConfig(tile_h=TILE_H, tile_w=TILE_W, capacity=64, max_tiles_per_gaussian=16)
# Tier budgets as wide as the table's (one tier of 256 ≥ the 200 splats at
# 16 tiles each): the sorted path cuts no Gaussian either.
WIDE = dataclasses.replace(TCFG, tiers=((256, TCFG.max_tiles_per_gaussian),))
CASES = {
    "tight": dict(),
    "loose": dict(),
    "capacity_overflows": dict(capacity=4),
    "budget_truncates": dict(max_tiles_per_gaussian=2),
}


def _cfgs(**kw):
    return (jrt.TileConfig(**{**JCFG.__dict__, **kw}),
            trt.TileConfig(**{**TCFG.__dict__, **kw}))


# Slot tables: two random scenes, one whose opaque splats stop pixels
# early (T < 1e-4), so the stop index and the replay from it are
# exercised, and a built one ("flooded") whose tiles stop whole at
# different depths, so that passes skip the finished tiles.
SCENES = {"seed0": dict(seed=0), "seed1": dict(seed=1),
          "saturating": dict(seed=3, n_splats=80, opac_lo=0.9, opac_hi=0.99,
                             spread=(0.3, 0.2, 0.3)),
          "flooded": None}


def _projected(seed=0, n_splats=200, height=H, width=W, **scene):
    means, scales, quats, opacity, colors = np_scene(n=n_splats, seed=seed, **scene)
    pj = jproj.project_from_params(jnp.asarray(means), jnp.asarray(scales),
                                   jnp.asarray(quats), jax_camera(width=width, height=height))
    pt = tproj.Projected(**{k: t(getattr(pj, k)) for k in pj._fields})
    opac = np.where(np.asarray(pj.mask), opacity, 0.0).astype(np.float32)
    return pj, pt, opac, colors


def _assert_binned_equal(tb, jb):
    for f in jrt.Binned._fields:
        np.testing.assert_array_equal(n(getattr(tb, f)), np.asarray(getattr(jb, f)), err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_binning_matches_jax_exactly(case):
    pj, pt, opac, _ = _projected()
    jcfg, tcfg = _cfgs(**CASES[case])
    jop = None if case == "loose" else jnp.asarray(opac)
    top = None if case == "loose" else t(opac)
    ref = jrt.expand_sorted_pairs(pj, H, W, jcfg, opacity=jop)
    out = trt.expand_sorted_pairs(pt, H, W, tcfg, opacity=top)
    for r, o in zip(ref[:3], out[:3]):
        np.testing.assert_array_equal(n(o), np.asarray(r))
    assert tuple(out[3:]) == tuple(ref[3:])
    jb = jrt.bin_gaussians(pj, H, W, jcfg, opacity=jop)
    tb = trt.bin_gaussians(pt, H, W, tcfg, opacity=top)
    _assert_binned_equal(tb, jb)
    if case == "capacity_overflows":
        assert int(tb.overflow) > 0 and int(tb.budget_overflow) == 0
    elif case == "budget_truncates":
        assert int(tb.budget_overflow) > 0
    else:
        assert int(tb.overflow) == int(tb.budget_overflow) == 0
    if case == "loose":   # the tight bbox drops pairs the 3σ circle keeps
        tight = trt.bin_gaussians(pt, H, W, tcfg, opacity=t(opac))
        assert int(tight.counts.sum()) < int(tb.counts.sum())


def _flooded_table(nt=48, c=40):
    """Tile k: k % 12 faint slots, then broad opaque ones (every pixel stops
    a few slots later), then 4–13 empty slots; every fourth tile stays
    faint throughout and never stops."""
    rng = np.random.RandomState(7)
    ty, tx = np.divmod(np.arange(nt), W // TILE_W)
    origin = np.stack([tx * TILE_W, ty * TILE_H], -1).astype(np.float32)
    centre = origin + np.array([TILE_W / 2, TILE_H / 2], np.float32)
    mean2d = centre[:, None] + rng.uniform(-2, 2, (nt, c, 2))
    conic = np.broadcast_to(np.array([0.002, 0.0, 0.002]), (nt, c, 3)).copy()
    color = rng.uniform(0, 1, (nt, c, 3))
    opac = np.full((nt, c), 0.05)
    for k in range(nt):
        if k % 4:
            opac[k, k % 12:] = rng.uniform(0.9, 0.99, c - k % 12)
        opac[k, c - 4 - k % 10:] = 0.0
    counts = (opac > 0).sum(1)
    slots = tuple(x.astype(np.float32) for x in (mean2d, conic, color, opac))
    return origin, slots, counts


def _slot_tables(scene="seed0"):
    """The slot tensors `rasterize_binned` hands the compositor, from the
    JAX binning (numpy), for both packages."""
    if scene == "flooded":
        return _flooded_table()
    pj, pt, opac, colors = _projected(**SCENES[scene])
    jb = jrt.bin_gaussians(pj, H, W, JCFG, opacity=jnp.asarray(opac))
    idx = np.asarray(jb.idx)
    packed = np.concatenate([np.asarray(pj.mean2d), np.asarray(pj.conic), colors,
                             opac[:, None]], -1).astype(np.float32)
    g = packed[np.maximum(idx, 0)]
    slots = (g[..., 0:2], g[..., 2:5], g[..., 5:8], g[..., 8] * (idx >= 0))
    return np.asarray(jb.tile_origin), slots, np.asarray(jb.counts)


# Pass lengths: the default, and 5 slots (padded last passes, many passes).
CHUNKS = [trt.SLOT_CHUNK, 5]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_composite_tiles_forward_matches_jax(scene, chunk, monkeypatch):
    monkeypatch.setattr(trt, "SLOT_CHUNK", chunk)
    origin, slots, _ = _slot_tables(scene)
    acc_j, t_j = jrt.composite_tiles(jnp.asarray(origin), *map(jnp.asarray, slots), JCFG)
    acc_t, t_t = trt.composite_tiles(t(origin), *map(t, slots), TCFG)
    np.testing.assert_allclose(n(acc_t), np.asarray(acc_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(t_t), np.asarray(t_j), atol=1e-5, rtol=0)
    assert float(np.asarray(t_j).min()) < 0.5   # the tiles are well covered
    _a, _t, stop = jrt._composite_fwd_scan(jnp.asarray(origin), *map(jnp.asarray, slots), JCFG)
    stopped = (np.asarray(stop) < slots[3].shape[1])
    assert stopped.any() == (scene in ("saturating", "flooded")), stopped.sum()
    # Whole tiles stop before their last slot only in the built table.
    assert (stopped.all(1).sum() > 10) == (scene == "flooded")


def _rel_close(got, want, rel, name):
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert scale > 0 and err <= rel * scale, (name, err, scale)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_composite_tiles_backward_matches_jax_vjp(scene, chunk, monkeypatch):
    monkeypatch.setattr(trt, "SLOT_CHUNK", chunk)
    origin, slots, _ = _slot_tables(scene)
    rng = np.random.RandomState(10 + len(scene))
    nt, p = origin.shape[0], TILE_H * TILE_W
    g_acc = rng.randn(nt, p, 3).astype(np.float32)
    g_t = rng.randn(nt, p).astype(np.float32)
    _, vjp = jax.vjp(lambda *s: jrt.composite_tiles(jnp.asarray(origin), *s, JCFG),
                     *map(jnp.asarray, slots))
    want = vjp((jnp.asarray(g_acc), jnp.asarray(g_t)))
    leaves = [t(s).requires_grad_() for s in slots]
    acc, tf = trt.composite_tiles(t(origin), *leaves, TCFG)
    got = torch.autograd.grad((acc, tf), leaves, (t(g_acc), t(g_t)))
    for name, gt_, w in zip(("mean2d", "conic", "color", "opacity"), got, want):
        _rel_close(n(gt_), np.asarray(w), 1e-5, name)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("scene", ["saturating", "flooded"])
def test_max_count_loop_equals_full_capacity_loop_bit_for_bit(scene, chunk, monkeypatch):
    """The slots past the fullest tile change nothing: the first
    min(max(counts), capacity) slots give the same outputs and gradients,
    bit for bit, and the full loop's other slots get zero gradients."""
    monkeypatch.setattr(trt, "SLOT_CHUNK", chunk)
    origin, slots, counts = _slot_tables(scene)
    k = int(counts.max())
    assert 0 < k < JCFG.capacity
    rng = np.random.RandomState(3)
    nt, p = origin.shape[0], TILE_H * TILE_W
    cot = (t(rng.randn(nt, p, 3).astype(np.float32)), t(rng.randn(nt, p).astype(np.float32)))
    full = [t(s).requires_grad_() for s in slots]
    cut = [t(s[:, :k]).requires_grad_() for s in slots]
    out_full = trt.composite_tiles(t(origin), *full, TCFG)
    out_cut = trt.composite_tiles(t(origin), *cut, TCFG)
    for a, b in zip(out_full, out_cut):
        assert torch.equal(a, b)
    g_full = torch.autograd.grad(out_full, full, cot)
    g_cut = torch.autograd.grad(out_cut, cut, cot)
    for a, b in zip(g_full, g_cut):
        assert torch.equal(a[:, :k], b) and not a[:, k:].any()


def test_empty_slot_with_positive_power_keeps_gradients_finite():
    """An empty slot of the JAX package's table holds Gaussian 0's
    geometry with opacity 0. Where its power is > 0 and large, 0·exp(power)
    = 0·inf = NaN: `composite_tiles` selects with `where` as JAX does, so
    on that table every gradient is finite and equals JAX's. The port's
    `rasterize_binned` fills empty slots with zeros instead: its image
    equals JAX's on the same inputs, its gradients are finite."""
    pj, pt, opac, colors = _projected()
    jb = jrt.bin_gaussians(pj, H, W, JCFG, opacity=jnp.asarray(opac))
    idx = np.asarray(jb.idx)
    assert (idx < 0).any()
    mean2d = np.asarray(pj.mean2d).copy()
    conic = np.asarray(pj.conic).copy()
    # Gaussian 0: a negative-definite "conic" far off screen → power ≫ 0.
    mean2d[0] = (-300.0, -300.0)
    conic[0] = (-1.0, 0.0, -1.0)
    packed = np.concatenate([mean2d, conic, colors, opac[:, None]], -1).astype(np.float32)
    g = packed[np.maximum(idx, 0)]
    slots = (g[..., 0:2], g[..., 2:5], g[..., 5:8], g[..., 8] * (idx >= 0))
    origin = np.asarray(jb.tile_origin)
    with torch.no_grad():
        _a, _u, power, _dx, _dy = trt._slot_alpha(t(slots[0]), t(slots[1]), t(slots[3]),
                                                  *(p[:, None] for p in trt._pixels(t(origin),
                                                                                    TCFG)))
        assert torch.isinf(torch.exp(power)[t(idx) < 0]).any()   # the trap is armed
    rng = np.random.RandomState(4)
    cot = (rng.randn(origin.shape[0], TILE_H * TILE_W, 3).astype(np.float32),
           rng.randn(origin.shape[0], TILE_H * TILE_W).astype(np.float32))
    leaves = [t(x).requires_grad_() for x in slots]
    got = torch.autograd.grad(trt.composite_tiles(t(origin), *leaves, TCFG), leaves,
                              tuple(map(t, cot)))
    _, vjp = jax.vjp(lambda *x: jrt.composite_tiles(jnp.asarray(origin), *x, JCFG),
                     *map(jnp.asarray, slots))
    for name, a, b in zip(("mean2d", "conic", "color", "opacity"), got,
                          vjp(tuple(map(jnp.asarray, cot)))):
        assert torch.isfinite(a).all(), name
        _rel_close(n(a), np.asarray(b), 1e-5, name)

    tb = trt.bin_gaussians(pt, H, W, TCFG, opacity=t(opac))
    leaves = [t(x).requires_grad_() for x in (mean2d, conic, colors, opac)]
    img, alpha = trt.rasterize_binned(*leaves, tb, H, W, torch.zeros(3), TCFG)
    (img.sum() + alpha.sum()).backward()
    for x in leaves:
        assert torch.isfinite(x.grad).all()
    jimg, jalpha = jrt.rasterize_binned(jnp.asarray(mean2d), jnp.asarray(conic),
                                        jnp.asarray(colors), jnp.asarray(opac), jb, H, W,
                                        jnp.zeros(3), JCFG)
    np.testing.assert_allclose(n(img), np.asarray(jimg), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(alpha), np.asarray(jalpha), atol=1e-5, rtol=0)


def _render_both(height, width, seed=0, sh_degree=1):
    """`render_tiled(use_pallas=False)` in both packages: outputs and the
    gradients of a fixed random linear loss with respect to means, scales,
    quats, opacity and SH."""
    means, scales, quats, opacity, _colors = np_scene(n=200, seed=seed)
    rng = np.random.RandomState(seed + 5)
    sh = (rng.randn(200, (sh_degree + 1) ** 2, 3) * 0.3).astype(np.float32)
    wimg = rng.randn(height, width, 3).astype(np.float32)
    walpha = rng.randn(height, width).astype(np.float32)
    jcam = jax_camera(width=width, height=height)
    inputs = (means, scales, quats, opacity, sh)
    bg = np.array([0.1, 0.2, 0.3], np.float32)

    def jloss(*x):
        out = jrt.render_tiled(x[0], x[1], x[2], x[3], jcam, jnp.asarray(bg), sh=x[4],
                               sh_degree=sh_degree, cfg=JCFG, use_pallas=False)
        return jnp.sum(out.color * wimg) + jnp.sum(out.alpha * walpha), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(5)), has_aux=True)(
        *map(jnp.asarray, inputs))
    leaves = [t(x).requires_grad_() for x in inputs]
    tout = trt.render_tiled(*leaves[:4], torch_camera(jcam), t(bg), sh=leaves[4],
                            sh_degree=sh_degree, cfg=TCFG, use_pallas=False)
    (tout.color * t(wimg)).sum().add((tout.alpha * t(walpha)).sum()).backward()
    return jout, jgrads, tout, [x.grad for x in leaves]


@pytest.mark.parametrize("height,width", [(H, W), (61, 93)], ids=["even", "odd_size"])
def test_render_tiled_table_path_matches_jax(height, width):
    jout, jgrads, tout, tgrads = _render_both(height, width)
    assert tout.color.shape == (height, width, 3) and tout.alpha.shape == (height, width)
    np.testing.assert_allclose(n(tout.color), np.asarray(jout.color), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(tout.alpha), np.asarray(jout.alpha), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(n(tout.radii), np.asarray(jout.radii))
    for name, g, w in zip(("means", "scales", "quats", "opacity", "sh"), tgrads, jgrads):
        _rel_close(n(g), np.asarray(w), 1e-5, name)


def test_table_path_matches_the_sorted_path():
    means, scales, quats, opacity, colors = np_scene(n=200, seed=2)
    cam = torch_camera(jax_camera())
    outs = {}
    for path in ("table", "sorted"):
        leaves = [t(x).requires_grad_() for x in (means, scales, quats, opacity, colors)]
        out = trt.render_tiled(*leaves[:4], cam, torch.zeros(3), colors=leaves[4], cfg=WIDE,
                               use_pallas=path == "sorted")
        rng = np.random.RandomState(0)
        loss = (out.color * t(rng.randn(H, W, 3).astype(np.float32))).sum()
        (loss + out.alpha.sum()).backward()
        outs[path] = (out, [x.grad for x in leaves])
    (ot, gt_), (os_, gs) = outs["table"], outs["sorted"]
    np.testing.assert_allclose(n(ot.color), n(os_.color), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(ot.alpha), n(os_.alpha), atol=1e-5, rtol=0)
    for name, a, b in zip(("means", "scales", "quats", "opacity", "colors"), gt_, gs):
        _rel_close(n(a), n(b), 1e-4, name)


def test_selection_rule(monkeypatch):
    """`sorted_data = use_pallas and compositor is None`, unless given."""
    means, scales, quats, opacity, colors = (t(x) for x in np_scene(n=200, seed=0))
    cam = torch_camera(jax_camera())
    calls = []
    real_sorted = trt.rasterize_sorted

    def spy_sorted(*a, **k):
        calls.append("sorted")
        return real_sorted(*a, **k)

    def spy_compositor(*a):
        calls.append("compositor")
        return trt.composite_tiles(*a)

    monkeypatch.setattr(trt, "rasterize_sorted", spy_sorted)
    render = lambda **kw: trt.render_tiled(means, scales, quats, opacity, cam, torch.zeros(3),
                                           colors=colors, cfg=WIDE, **kw)
    ref = render(use_pallas=False)
    cases = [
        (dict(), ["sorted"]),
        (dict(use_pallas=False), []),
        (dict(compositor=spy_compositor), ["compositor"]),
        (dict(use_pallas=False, sorted_data=True), ["sorted"]),
        (dict(compositor=spy_compositor, sorted_data=False), ["compositor"]),
    ]
    for kw, want in cases:
        calls.clear()
        out = render(**kw)
        assert calls == want, kw
        np.testing.assert_allclose(n(out.color), n(ref.color), atol=1e-5, rtol=0)
