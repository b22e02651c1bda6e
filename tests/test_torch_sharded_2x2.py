"""The port's sharded step on the 2×2 mesh (two cameras a step, two row
bands a camera) against the JAX sharded step on 2×2 and the port's
single-device step, in the cases and at the bounds of
`test_torch_sharded.py`; and the 1×1 mesh of a one-rank gloo world in
this process, whose step is the single-device step's, bit for bit."""
import jax
import pytest
import torch
import torch.distributed as dist

from gaussianavatars_torch.parallel import distributed as pdist
from gaussianavatars_torch.parallel import mesh as tmesh
from gaussianavatars_torch.parallel import sharded as tsh
from gaussianavatars_torch.training import trainer as ttrainer
from gaussianavatars_torch.training.checkpoint import flatten_state
from test_torch_sharded import CASES, build_case, check_case, run_mesh

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
