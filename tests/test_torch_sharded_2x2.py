"""The port's sharded step on the 2×2 mesh (two cameras a step, two row
bands a camera) against the JAX sharded step on 2×2 and the port's
single-device step, in the cases and at the bounds of
`test_torch_sharded.py`; and the 1×1 mesh of a one-rank gloo world in
this process, whose step is the single-device step's, bit for bit, and
whose captured form's body over its buffers, run eagerly, is the eager
step's bit for bit and within JAX's bounds of the JAX sharded step on 1×1."""
import dataclasses

import jax
import pytest
import torch
import torch.distributed as dist

from gaussianavatars_torch.models.densify import reset_opacity
from gaussianavatars_torch.parallel import distributed as pdist
from gaussianavatars_torch.parallel import mesh as tmesh
from gaussianavatars_torch.parallel import sharded as tsh
from gaussianavatars_torch.training import trainer as ttrainer
from gaussianavatars_torch.training.checkpoint import flatten_state
from test_torch_sharded import CASES, build_case, check_case, jax_sharded, port_single, run_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def run_2x2(tmp_path_factory):
    return run_mesh("2x2", tmp_path_factory.mktemp("sphere"))


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASES)
def test_sharded_step_2x2(run_2x2, i):
    check_case(run_2x2, i)


def test_2x2_ranks_sit_where_jax_puts_devices(run_2x2):
    ranks = run_2x2["ranks"][False]
    assert [(r["rank"], r["d"], r["t"]) for r in ranks] == [
        (0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]


@pytest.fixture(scope="module")
def one_rank_world(tmp_path_factory):
    store = tmp_path_factory.mktemp("store") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        yield tmesh.make_rank_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["unbound", "flame_laplacian", "innovations", "table"])
def test_1x1_step_is_the_single_device_step(one_rank_world, name, tmp_path):
    case = build_case(name, 1, tmp_path)["case"]
    cam = case["cameras"][0]
    tile = case["tile"]
    single = ttrainer.make_train_step(case["model"], case["cfg"], tile)
    step = tsh.make_sharded_train_step(case["model"], case["cfg"], tile, one_rank_world, cam,
                                       collectives=pdist.Collectives("gloo"))
    hp = tsh.padded_height(cam.height, tile.tile_h, 1)
    cams, gt = pdist.make_local_batch(one_rank_world, tsh.camera_batch([cam]),
                                      tsh.pad_gt_for_mesh(case["gt"], hp))
    assert hp == cam.height
    a = b = case["state"]
    with torch.no_grad():
        for i in range(2):
            out = single(a, case["gt"][0], cam, cam.timestep, case["bg"], 0)
            a = out.state
            b, metrics = step(b, cams, gt, case["bg"], 0)
            for k, v in out.metrics.items():
                assert float(metrics[k]) == float(v), (i, k)
    fa, fb = flatten_state(a), flatten_state(b)
    assert list(fa) == list(fb)
    for k in fa:
        torch.testing.assert_close(fb[k], fa[k], rtol=0, atol=0, msg=k)
    assert tsh.state_digest(a) == tsh.state_digest(b)
    stats = step.collectives.stats
    assert stats["all_gather"]["calls"] == 2 and stats["all_reduce_sum"]["calls"] == 4


def _opacity_reset(state):
    params, mu, nu = reset_opacity(state.params, state.adam.mu, state.adam.nu)
    return dataclasses.replace(state, params=params, adam=state.adam._replace(mu=mu, nu=nu))


@pytest.mark.parametrize("name", ["unbound", "flame_laplacian", "innovations"])
def test_1x1_buffer_body_is_the_eager_step(one_rank_world, name, tmp_path):
    """Three steps through the captured form's body over its buffers (run
    eagerly: the CPU has no graphs), an opacity reset between the second
    and the third, against three eager sharded steps: bit for bit, the
    metrics and every leaf; the first step within JAX's bounds of the JAX
    sharded step on a 1×1 mesh, at timestep 1 (the buffers' device
    timestep selects the FLAME row)."""
    c = build_case(name, 1, tmp_path)
    case = c["case"]
    c["jcams"] = [dataclasses.replace(x, timestep=1) for x in c["jcams"]]
    case["cameras"] = [dataclasses.replace(x, timestep=1) for x in case["cameras"]]
    cam, tile = case["cameras"][0], case["tile"]
    step = tsh.make_sharded_train_step(case["model"], case["cfg"], tile, one_rank_world, cam,
                                       collectives=pdist.Collectives("gloo"))
    assert step.form == tsh.EAGER_CPU
    cams, gt = pdist.make_local_batch(one_rank_world, tsh.camera_batch([cam]),
                                      tsh.pad_gt_for_mesh(case["gt"], cam.height))
    a = b = case["state"]
    res = {"digests": [], "metrics": []}
    with torch.no_grad():
        for i in range(3):
            if i == 2:
                a, b = _opacity_reset(a), _opacity_reset(b)
            a, ma = step.eager(a, cams, gt, case["bg"], 0)
            b, mb = step.through_buffers(b, cams, gt, case["bg"], 0)
            assert list(mb) == list(ma)
            for k in ma:
                assert mb[k].dtype == ma[k].dtype and torch.equal(mb[k], ma[k]), (i, k)
            fa, fb = flatten_state(a), flatten_state(b)
            assert list(fa) == list(fb)
            for k in fa:
                assert torch.equal(fb[k], fa[k]), (i, k)
            res["digests"].append(tsh.state_digest(b))
            res["metrics"].append({k: float(v) for k, v in mb.items()})
            if i == 0:
                res["state_first"] = {k: v.numpy().copy() for k, v in fb.items()}
    # The buffers hold the state: handed back, nothing is copied in.
    assert all(x is y for x, y in zip(flatten_state(b).values(), step.buffers.leaves.values()))
    with torch.no_grad():
        singles = port_single(c)
    case["steps"] = 3
    check_case({"cases": [c], "ranks": {False: [{"results": [res]}]},
                "jax": [jax_sharded(c, 1, 1, {})], "singles": [singles]}, 0)


def test_collective_counts_of_a_captured_step(one_rank_world):
    """A captured step's collectives leave `stats` (`since`) and come back
    once a replay (`add`): `stats` counts steps, eager or replayed."""
    coll = pdist.Collectives("gloo")
    x = torch.ones(5)
    coll.all_reduce(x)
    before = coll.snapshot()
    coll.all_reduce(x)
    coll.all_gather(x, one_rank_world.tile_group)
    per = coll.since(before)
    assert coll.stats == before and coll.stats["all_reduce_sum"]["calls"] == 1
    assert per == {"all_reduce_sum": {"calls": 1, "bytes": 20},
                   "all_gather": {"calls": 1, "bytes": 20}}
    coll.add(per)
    coll.add(per)
    assert coll.stats["all_reduce_sum"]["calls"] == 3
    assert coll.stats["all_gather"] == {"calls": 2, "bytes": 40, "ms": 0.0}
