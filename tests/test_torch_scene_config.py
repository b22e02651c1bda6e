"""The benchmark's unbound scene (`avatar_bench/scene_3dgs.py`), its plain
reference (`avatar_bench/reference_scene.py`) and the mesh reference
(`avatar_bench/reference_mesh.py`), on the CPU at a tiny size.

* The port's unbound chunk (`make_train_chunk(None, …)`, the CPU's loop of
  steps) against `reference_scene.train_step` for three steps from the
  iteration the cell starts at, on the configuration's scene cut to 2,000
  Gaussians at 64×96 in 8×8 tiles (the reference composites square tiles,
  as every cell's configuration has them; the floaters cover tens of
  tiles). Tolerances, each with its reason:
  - the loss of each step: rtol 1e-5 (float32 sums in another order: the
    reference's padded blocks against the compositor's walk, its banded
    SSIM blur against the port's convolution);
  - each step's gradient, every leaf within 1e-4 of the leaf's largest
    (`tests/test_torch_train.py`'s bound for the same rounding carried
    through the backward);
  - the state after Adam: each leaf's move within 1e-3 of the leaf's
    largest move, over the elements whose gradient, in some step, is above
    1e-3 of its leaf's largest, at least 50 a leaf (Adam's first steps move an element by
    about its learning rate whatever its gradient's size, so an element
    whose gradients are rounding noise moves by the sign of that noise);
    the statistics' accumulators at rtol 1e-4.
* `scene_3dgs` is the same under a seed, differs under another, and keeps
  its groups' shares and places; the rig's extent is the configuration's
  `spatial_lr_scale`.
* The mesh reference's reduction of the data rows is the mean of the
  single-view reference steps' gradients and losses and the sum of their
  statistics, and with the same view in both rows its step is the
  single-view step.
"""
import dataclasses
import math

import pytest
import torch

from avatar_bench import reference, reference_mesh, reference_scene, scene, scene_3dgs, train
from avatar_bench import run as bench
from avatar_bench.tests.tiny import TINY
from gaussianavatars_torch.render import probe_tile_config_views
from gaussianavatars_torch.training.trainer import init_train_state, make_train_chunk

SPEC = bench.Spec()
CELL = "bicycle-train"
SCENE = dict(SPEC.config("3dgs-mipnerf360-bicycle"), gaussians=2000, capacity=2048, width=96,
             height=64, tile=8, images=10, cameras=8)
LEAVES = reference.GAUSS_LEAVES


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed: int, cfg: dict = SCENE):
    gen = scene.generator(seed, torch.device("cpu"))
    leaves, binding, alive = scene_3dgs.gaussians(cfg, gen)
    return leaves, binding, alive, scene_3dgs.rig(cfg, "cpu"), scene_3dgs.ground_truth(cfg, gen)


def _run(cell: str, cfg: dict, traffic: dict = None) -> bench.Run:
    w = SPEC.workload(cell)
    return bench.Run(cell, w["chips"], cfg, traffic or SPEC.traffic(w["traffic"]),
                     SPEC.limits(cell), 7, 1.0, False, torch.device("cpu"))


def test_unbound_chunk_matches_the_reference_scene():
    from avatar_bench import program

    leaves, binding, alive, cams, gt = _scene(123456789012)
    cfg, start = SCENE, SCENE["start_iteration"]
    params, aux = program.gaussian_state(leaves, binding, alive)
    pcams = [program.camera(c) for c in cams]
    tile = probe_tile_config_views(None, params, aux, [(None, c) for c in pcams], 8, 8)
    assert max(b for _c, b in tile.tiers) >= 20
    state = init_train_state(params, aux, program.program_config(cfg))
    state = dataclasses.replace(state, adam=state.adam._replace(
        step=torch.tensor(start, dtype=torch.int32)))
    chunk = make_train_chunk(None, program.program_config(cfg), tile, cfg["spatial_lr_scale"])
    stacked = program.rig_cameras(cams)
    bg = torch.zeros(3)
    views = [3, 0, 5]
    got = []
    for v in views:
        mu0 = {k: getattr(state.adam.mu, k).clone() for k in LEAVES}
        state, m = chunk(state, gt, [v], program.camera_rows(stacked, torch.tensor([v])), [0],
                         bg, cfg["sh_degree"])
        assert int(m["budget_overflow"][0]) == 0
        got.append((float(m["loss"][0]),
                    {k: (getattr(state.adam.mu, k) - 0.9 * mu0[k]) / 0.1 for k in LEAVES}))
    opt = dict(cfg["opt"], spatial_lr_scale=cfg["spatial_lr_scale"])
    zeros = torch.zeros(binding.shape)
    st = st0 = reference.TrainState(
        leaves=dict(leaves), mu={k: torch.zeros_like(v) for k, v in leaves.items()},
        nu={k: torch.zeros_like(v) for k, v in leaves.items()}, step=start, binding=binding,
        alive=alive, shape=None, grad_accum=zeros, denom=zeros.clone())
    clear = {k: torch.zeros_like(v, dtype=torch.bool) for k, v in leaves.items()}
    for v, (loss, grads) in zip(views, got):
        st, want_loss, want, _w = reference_scene.train_step(st, gt[v].float() / 255.0, cams[v],
                                                             bg, opt, cfg["tile"])
        assert loss == pytest.approx(want_loss, rel=1e-5, abs=0)
        for k in LEAVES:
            scale = float(want[k].abs().max())
            assert scale > 0, k
            assert float((grads[k] - want[k]).abs().max()) <= 1e-4 * scale, k
            clear[k] |= want[k].abs() > 1e-3 * scale
    for k in LEAVES:
        move, want_move = getattr(state.params, k) - st0.leaves[k], st.leaves[k] - st0.leaves[k]
        largest = float(want_move.abs().max())
        assert int(clear[k].sum()) >= 50, k
        assert float((move - want_move)[clear[k]].abs().max()) <= 1e-3 * largest, k
    torch.testing.assert_close(state.aux.grad_accum, st.grad_accum, rtol=1e-4, atol=1e-6)
    assert torch.equal(state.aux.denom, st.denom)


def test_scene_is_the_seeds_and_keeps_its_groups():
    a, _b, alive, cams, gt = _scene(5)
    again = _scene(5)
    other = _scene(6)
    for k in LEAVES:
        assert torch.equal(a[k], again[0][k]), k
        assert not torch.equal(a[k][:2000], other[0][k][:2000]), k
    assert torch.equal(gt, again[4]) and not torch.equal(gt, other[4])
    sizes = scene_3dgs.group_sizes(SCENE)
    assert sum(sizes.values()) == SCENE["gaussians"] == int(alive.sum())
    for g, n in sizes.items():
        assert abs(n - SCENE["groups"][g] * SCENE["gaussians"]) <= 2, g
    centre = torch.tensor(SCENE["centre"])
    bounds = [0]
    for g in scene_3dgs.GROUPS:
        bounds.append(bounds[-1] + sizes[g])
    means = a["means"]
    ground = means[bounds[0]:bounds[1]]
    assert float(torch.linalg.norm(ground[:, [0, 2]], dim=1).max()) <= SCENE["ground_radius"]
    assert float(ground[:, 1].abs().max()) < 0.6
    objects = torch.linalg.norm(means[bounds[1]:bounds[2]] - centre, dim=1)
    assert float(objects.max()) <= SCENE["object_ball"] + SCENE["object_axes"][1]
    shell = torch.linalg.norm(means[bounds[2]:bounds[3]] - centre, dim=1)
    lo, hi = SCENE["shell_radius"]
    assert float(shell.min()) >= lo - 1e-4 and float(shell.max()) <= hi + 1e-4
    floaters = torch.linalg.norm(means[bounds[3]:bounds[4]] - centre, dim=1)
    assert float(floaters.max()) <= SCENE["floater_radius"] + 1e-4
    assert torch.allclose(torch.linalg.norm(a["quats"], dim=1), torch.ones(SCENE["capacity"]))
    assert len(cams) == SCENE["cameras"] and gt.shape == (8, 64, 96, 3)
    full = SPEC.config("3dgs-mipnerf360-bicycle")
    rig = scene_3dgs.rig(full, "cpu")
    assert len(rig) == full["cameras"] == 169
    assert scene_3dgs.camera_extent(rig) == pytest.approx(full["spatial_lr_scale"], rel=1e-12)
    assert math.degrees(rig[0]["fovx"]) == pytest.approx(full["fovx_deg"], rel=1e-9)


def test_mesh_reference_reduces_the_rows_as_the_sharded_step():
    cell = "base-train-mesh2x2"
    cfg = dict(SPEC.config(SPEC.workload(cell)["config"]), **TINY)
    traffic = SPEC.traffic(SPEC.workload(cell)["traffic"])
    r = _run(cell, cfg, traffic)
    arrays, leaves, binding, alive, shape, poses, cams, gt = train._inputs(r)
    prec = reference.Precision()
    flame = reference.Flame(arrays, r.device, prec)
    st = train._initial(r, leaves, binding, alive, shape, poses)
    gt_used = {v: gt[v] for v in (1, 4)}
    rows = reference_mesh.row_steps(r, flame, st, (1, 4), gt_used, cams, prec)
    singles = [train._step(r, flame, st, gt_used, cams, v, prec) for v in (1, 4)]
    loss, grads, accum, denom = reference_mesh.reduce_rows(rows)
    assert loss == pytest.approx((singles[0][1] + singles[1][1]) / 2, rel=1e-12)
    for k, g in grads.items():
        assert torch.equal(g, (singles[0][2][k] + singles[1][2][k]) / 2), k
    assert torch.equal(accum, singles[0][0].grad_accum + singles[1][0].grad_accum)
    assert torch.equal(denom, singles[0][0].denom + singles[1][0].denom)
    same, same_loss, _g = reference_mesh.step(r, flame, st, (4, 4), gt_used, cams, prec)
    single = singles[1][0]
    assert same_loss == pytest.approx(singles[1][1], rel=1e-12) and same.step == single.step
    for k, v in single.leaves.items():
        assert torch.equal(same.leaves[k], v), k
        assert torch.equal(same.mu[k], single.mu[k]) and torch.equal(same.nu[k], single.nu[k]), k
    assert torch.equal(same.grad_accum, 2 * single.grad_accum)
