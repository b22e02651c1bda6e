"""The work counts and the yardstick against hand counts on a tiny scene."""
import pytest
import torch

from avatar_bench import reference, work


def screen_scene(n: int, opacity: float, tile: int = 4, width: int = 4, height: int = 4):
    """`n` wide Gaussians over every pixel of a `width`×`height` image, each
    at nearly constant alpha = `opacity`, front to back by index."""
    mean2d = torch.full((n, 2), 1.5)
    conic = torch.tensor([[1e-6, 0.0, 1e-6]]).repeat(n, 1)
    proj = dict(mean2d=mean2d, conic=conic, depth=torch.arange(1, n + 1).float(),
                cov_a=torch.full((n,), 1e6), cov_c=torch.full((n,), 1e6),
                radius=torch.full((n,), 40.0), mask=torch.ones(n, dtype=torch.bool))
    opac = torch.full((n,), opacity)
    colors = torch.rand((n, 3), generator=torch.Generator().manual_seed(0))
    cam = dict(width=width, height=height)
    lists = reference.tile_lists(proj, opac, height, width, tile)
    return reference.render_screen((mean2d, conic, colors, opac), lists, cam, torch.zeros(3),
                                   tile, reference.Precision()), colors


def test_walk_stops_at_the_pair_that_would_end_the_ray():
    # T after each pair: 0.05, 0.0025, 1.25e-4, 6.25e-6: the fourth ends the
    # ray and is walked but not composited; the fifth is never reached.
    frame, colors = screen_scene(5, 0.95)
    assert frame.work == dict(pair_pixels=16 * 4, pairs_read=4, pairs=5, pixels=16, tiles=1)
    a = torch.clamp_max(0.95 * torch.exp(torch.tensor(-0.5 * 1e-6 * 2 * 2.25)), 0.99)
    t = torch.cumprod(torch.full((3,), 1 - float(a)), 0)
    want = a * (colors[0] + t[0] * colors[1] + t[1] * colors[2])
    assert torch.allclose(frame.image[0, 0], want, rtol=1e-5)


def test_short_lists_are_walked_whole_and_padding_pixels_not_counted():
    frame, _ = screen_scene(2, 0.5, tile=4, width=6, height=3)
    # Two tiles, each with both Gaussians; 18 pixels in the image of the
    # 2 × 16 tile pixels.
    assert frame.work == dict(pair_pixels=18 * 2, pairs_read=4, pairs=4, pixels=18, tiles=2)


def test_compositor_counts():
    w = dict(pair_pixels=64, pairs_read=4, pairs=5, pixels=16, tiles=1)
    assert work.compositor_fwd(w) == (32 * 64, 4.0 * (9 * 4 + 2 * 1 + 5 * 16))
    assert work.compositor_bwd(w) == (33 * 64, 4.0 * (9 * 4 + 9 * 16 + 9 * 5))


@pytest.mark.parametrize("flops,nbytes,bound", [(67e12, 1.0, "operations"),
                                                (1.0, 3.35e12, "bytes")])
def test_least_time_and_its_bound(flops, nbytes, bound):
    assert work.least_s(flops, nbytes) == pytest.approx((1.0, bound))


def test_flame_count_by_hand():
    cfg = dict(n_shape=3, n_expr=2, gaussians=0)
    # 2 · V · 3 · (5 components + 5 joints + 36 pose) + 2 · V · (5 · 12 + 12)
    assert work.flame_flops(cfg, 10) == 2 * 10 * 3 * 46 + 2 * 10 * 72
    assert work.geometry_flops(cfg, 10, 4) == work.flame_flops(cfg, 10) + 80 * 4
