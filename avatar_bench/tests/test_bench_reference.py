"""The plain reference against the port's plain CPU path: the splatting at
the size of `tests/raster_fixtures.py` (200 Gaussians, 64×96), FLAME with
teeth at FLAME 2023's widths, and whole tiny cells (frames and training
steps) through the harness."""
import numpy as np
import pytest
import torch

from avatar_bench import program, reference, scene
from avatar_bench import run as bench
from avatar_bench.tests.tiny import tiny_run
from gaussianavatars_torch.ops.rasterize_tiled import TileConfig, render_tiled

H, W = 64, 96


def fixture_scene(n=200, seed=0):
    g = torch.Generator().manual_seed(seed)
    means = torch.randn((n, 3), generator=g) * torch.tensor([0.8, 0.6, 0.3]) + torch.tensor(
        [0.0, 0.0, 2.5])
    scales = 0.01 + 0.11 * torch.rand((n, 3), generator=g)
    quats = torch.randn((n, 4), generator=g)
    opacity = 0.2 + 0.7 * torch.rand((n,), generator=g)
    colors = torch.rand((n, 3), generator=g)
    cam = scene.look_at([0.0, 0.0, 0.0], [0.0, 0.0, 2.5], 1.0, W, H, "cpu")
    return means, scales, quats, opacity, colors, cam


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splatting_matches_the_port(seed):
    means, scales, quats, opacity, colors, cam = fixture_scene(seed=seed)
    bg = torch.tensor([0.1, 0.2, 0.3])
    alive = torch.ones(means.shape[0], dtype=torch.bool)
    proj = reference.project(means, scales, quats, cam, alive)
    opac = torch.where(proj["mask"], opacity, torch.zeros_like(opacity))
    lists = reference.tile_lists(proj, opac, H, W, 16)
    ref = reference.render_screen((proj["mean2d"], proj["conic"], colors, opac), lists, cam, bg,
                                  16, reference.Precision())
    port = render_tiled(means, scales, quats, opacity, program.camera(cam), bg, colors=colors,
                        cfg=TileConfig(tile_h=16, tile_w=16, tiers=((256, 64),)))
    assert ref.work["pairs"] > 0
    assert torch.allclose(ref.image, port.color, atol=2e-6)


def test_flame_with_teeth_matches_the_port():
    cfg = dict(num_verts=5023, n_shape=300, n_expr=100, add_teeth=True)
    gen = scene.generator(7, "cpu")
    arrays = scene.flame_arrays(cfg, gen)
    pose = scene.trajectory(cfg, {"cycles": [0.01, 0.05], "ranges": dict(
        expr=1.0, rotation=0.1, neck=0.1, jaw=0.2, eyes=0.1, translation=0.01)}, 4, gen)
    shape = scene.shape_coeffs(cfg, gen)
    want = program.flame_model(arrays, cfg, "cpu")(program.flame_params(shape, pose, slice(0, 4)))
    got, _ = reference.Flame(arrays, "cpu")(shape, **pose)
    assert got.shape == (4, 5143, 3)
    assert torch.allclose(got, want, atol=1e-6)
    faces = reference.with_teeth(arrays)["faces"]
    assert np.array_equal(faces, program.flame_model(arrays, cfg, "cpu").faces.numpy())


@pytest.mark.parametrize("cell", [w["name"] for w in bench.Spec().doc["workloads"]])
def test_tiny_cell_is_correct(cell):
    r = tiny_run(cell)
    bench.mode_of(r.traffic).run(r)
    assert r.attempted > 0 and r.compared > 0
    assert r.correct, r.checks
