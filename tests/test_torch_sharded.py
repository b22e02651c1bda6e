"""The port's multi-device step (`gaussianavatars_torch/parallel/`) against
the JAX package's `parallel/` on the CPU.

* `rank_layout` / `make_rank_mesh` against `make_device_mesh` (layout and
  errors), and the groups of a one-rank gloo world;
* `padded_height`, `pad_gt_for_mesh` and `camera_batch` against JAX;
* the sharded step in ranks launched as subprocesses over gloo
  (`tools/sharded_steps.run_cases`), on the 1×4 mesh and the 1×4 mesh with
  `gauss_shard` here and on 2×2 in `test_torch_sharded_2x2.py`, in the
  cases of JAX `tests/test_sharded.py`: unbound (50 points, capacity 64,
  48×64), FLAME-bound with `lambda_laplacian=0.1` (the clamped tiny
  sphere of `fixtures_avatar`, 64×48), the three step innovations, mixed
  intrinsics (a second camera with another fov on the data axis; on a
  one-row mesh that camera alone) and the table pipeline.

Each case is held, in the test process, against the JAX sharded step on
the same mesh shape over the 8 virtual devices (the `gauss_shard` run
against the JAX sharded step on 1×4: JAX `test_gauss_shard_matches_single_chip`
holds JAX's `gauss_shard` step to the same values) and against the port's
single-device step from the same state (on two data rows: the mean of the
two cameras' losses, the sums of their statistics' increments). The
bounds are JAX's own: loss rtol 1e-4, parameters atol 5e-5, `grad_accum`
atol 1e-4, `denom` exact; and each Adam first moment (0.1·g after one
step) within 1e-4 of the leaf's largest, `tests/test_torch_train.py`'s
bound. Every rank's state equals rank 0's bit for bit, after each step.

The ranks run while the test process compiles the JAX steps. Each launch
has a wall-clock limit (`LAUNCH_TIMEOUT_S`).
"""
import concurrent.futures
import re
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import fixtures_avatar as fa
from gaussianavatars_tpu.config import Config as JConfig
from gaussianavatars_tpu.config import OptimizationConfig as JOpt
from gaussianavatars_tpu.config import PipelineConfig as JPipe
from gaussianavatars_tpu.data.cameras import look_at_camera as jlook_at
from gaussianavatars_tpu.models.flame import flame_model as jfm
from gaussianavatars_tpu.models.gaussians import init_from_points
from gaussianavatars_tpu.ops.rasterize_tiled import TileConfig as JTileConfig
from gaussianavatars_tpu.parallel import sharded as jsh
from gaussianavatars_tpu.parallel.mesh import make_device_mesh
from gaussianavatars_tpu.training.trainer import init_train_state as jinit
from gaussianavatars_torch import config as tconfig
from gaussianavatars_torch.convert import flame_assets_from_numpy, train_state_from_numpy
from gaussianavatars_torch.models.flame import flame_model as tfm
from gaussianavatars_torch.ops.rasterize_tiled import TileConfig
from gaussianavatars_torch.parallel import mesh as tmesh
from gaussianavatars_torch.parallel import sharded as tsh
from gaussianavatars_torch.tools import sharded_steps
from gaussianavatars_torch.training import trainer as ttrainer
from torch_parity import clamped_sphere_assets, n, torch_camera

TILE = dict(tile_h=8, tile_w=16, capacity=128, max_tiles_per_gaussian=16)
CASES = ("unbound", "flame_laplacian", "innovations", "mixed_intrinsics", "table")
INNOVATIONS = dict(use_region_adaptive_loss=True, use_color_calibration=True,
                   use_contrastive_reg=True)
PARAM_KEYS = ("means", "log_scales", "quats", "logit_opacity", "sh_dc")
LAUNCH_TIMEOUT_S = 240.0

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


# ------------------------------------------------------------- the mesh


@pytest.mark.parametrize("data,tile,world", [(1, None, 8), (2, None, 8), (2, 4, 8), (4, 2, 8),
                                             (1, 1, 1), (3, None, 8), (2, 3, 8)])
def test_rank_layout_matches_device_mesh(data, tile, world):
    devices = jax.devices()[:world]
    try:
        want = np.vectorize(lambda d: d.id)(np.asarray(make_device_mesh(data, tile,
                                                                         devices).devices))
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tmesh.rank_layout(data, tile, world)
        return
    np.testing.assert_array_equal(tmesh.rank_layout(data, tile, world), want)


def test_rank_mesh_of_a_one_rank_world(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        m = tmesh.make_rank_mesh(1, 1)
        assert (m.data, m.tile, m.rank, m.d, m.t, m.size) == (1, 1, 0, 0, 0, 1)
        assert m.shape == {"data": 1, "tile": 1}
        assert dist.get_world_size(m.data_group) == dist.get_world_size(m.tile_group) == 1
        with pytest.raises(ValueError, match="data\\*tile = 2 != 1"):
            tmesh.make_rank_mesh(1, 2)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------- batches and padding


@pytest.mark.parametrize("height,tile_h,n_tile", [(48, 8, 4), (64, 8, 4), (550, 32, 4),
                                                  (550, 32, 1), (47, 16, 3)])
def test_padded_height_matches_jax(height, tile_h, n_tile):
    got = tsh.padded_height(height, tile_h, n_tile)
    assert got == jsh.padded_height(height, tile_h, n_tile)
    assert got % (tile_h * n_tile) == 0 and (got // n_tile) % tile_h == 0


def test_pad_gt_for_mesh_matches_jax():
    gt = np.random.RandomState(0).uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    for hp in (48, 64):
        np.testing.assert_array_equal(n(tsh.pad_gt_for_mesh(torch.from_numpy(gt), hp)),
                                      np.asarray(jsh.pad_gt_for_mesh(jnp.asarray(gt), hp)))
    u8 = (gt * 255).astype(np.uint8)
    got = tsh.pad_gt_for_mesh(torch.from_numpy(u8), 64)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(n(got), np.asarray(jsh.pad_gt_for_mesh(jnp.asarray(u8), 64)))


def test_camera_batch_matches_jax():
    cams = [jlook_at(eye=(0.0, 0.0, -2.5), fovy=0.8, width=48, height=64),
            dataclasses.replace(jlook_at(eye=(0.2, 0.1, -2.0), fovy=1.2, width=48, height=64),
                                timestep=1)]
    got = tsh.camera_batch([torch_camera(c) for c in cams])
    want = jsh.camera_batch(cams)
    for k in want._fields:
        np.testing.assert_allclose(n(getattr(got, k)), np.asarray(getattr(want, k)),
                                   rtol=1e-6, err_msg=k)
    assert got.timestep.dtype == torch.int32
    row = got.row(1)
    assert row.world_view.shape == (1, 4, 4) and int(row.timestep[0]) == 1
    # The row's projection constants are the camera's own, bit for bit.
    tc = torch_camera(cams[1])
    assert float(row.tan_half_fovx[0]) == tc.tan_half_fovx


# ----------------------------------------------------------- the cases


def _np_or_none(x):
    return None if x is None else np.asarray(x)


def state_numpy(js) -> dict:
    """A JAX TrainState as the keyword arguments of train_state_from_numpy
    (unbound and innovation leaves included)."""
    def fields(obj):
        return None if obj is None else {f.name: _np_or_none(getattr(obj, f.name))
                                         for f in dataclasses.fields(obj)}

    def net(c):
        return {"weights": [np.asarray(w) for w in c.weights],
                "biases": [np.asarray(b) for b in c.biases]}

    def adam(a, conv=fields):
        return None if a is None else {"mu": conv(a.mu), "nu": conv(a.nu),
                                       "step": np.asarray(a.step)}

    out = dict(params=fields(js.params), aux=fields(js.aux), adam=adam(js.adam),
               flame=fields(js.flame), flame_static=fields(js.flame_static),
               flame_adam=adam(js.flame_adam))
    if js.color_net is not None:
        out["color_net"] = net(js.color_net)
        out["color_adam"] = adam(js.color_adam, net)
    if js.contrastive is not None:
        out["contrastive"] = {k: np.asarray(v) for k, v in js.contrastive._asdict().items()}
    return out


def _unbound(cap=64):
    rng = np.random.RandomState(0)
    pts = rng.randn(50, 3).astype(np.float32) * 0.3
    cols = rng.rand(50, 3).astype(np.float32)
    return init_from_points(pts, cols, capacity=cap, init_scale=np.full(50, 0.08, np.float32))


def build_case(name: str, n_data: int, tmp_dir) -> dict:
    """A case of JAX `tests/test_sharded.py` for n_data camera rows: the
    JAX model, config, state, cameras and ground truth, and the port's
    (`tmp_dir` takes the tiny sphere's OBJ)."""
    flame = name == "flame_laplacian"
    if flame:
        assets = clamped_sphere_assets(tmp_dir)
        jmodel = jfm.FlameModel(assets, jfm.FlameConfig(n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR,
                                                        add_teeth=False))
        tmodel = tfm.FlameModel(flame_assets_from_numpy(assets._asdict()),
                                tfm.FlameConfig(fa.N_SHAPE, fa.N_EXPR, add_teeth=False),
                                device="cpu")
        params, aux = fa.reference_avatar(jmodel, capacity=384)
        # Anisotropic scales and random rotations, as `test_torch_train.py`'s
        # avatar: an isotropic splat has only a rounding-noise rotation
        # gradient.
        rng = np.random.RandomState(0)
        params = dataclasses.replace(
            params,
            log_scales=jnp.asarray(np.log(rng.uniform(0.3, 0.9, (384, 3))).astype(np.float32)),
            quats=jnp.asarray(rng.randn(384, 4).astype(np.float32)))
        v = np.asarray(assets.v_template)
        center = v.mean(0)
        extent = float(np.abs(v - center).max())
        cam = jlook_at(eye=center + np.array([0.3 * extent, 0.1 * extent, -4 * extent]),
                       target=center, fovy=0.6, width=fa.W, height=fa.H)
        cams = [dataclasses.replace(cam, timestep=i % 2) for i in range(n_data)]
        rng = np.random.RandomState(4)
        gt = rng.uniform(0, 1, (n_data, fa.H, fa.W, 3)).astype(np.float32)
    else:
        jmodel = tmodel = None
        params, aux = _unbound()
        cam0 = jlook_at(eye=(0, 0, -2.5), fovy=0.8, width=48, height=64)
        cam1 = (jlook_at(eye=(0.2, 0.1, -2.0), fovy=1.2, width=48, height=64)
                if name == "mixed_intrinsics" else
                jlook_at(eye=(0.3, 0.1, -2.4), fovy=0.8, width=48, height=64))
        cams = [cam1] if (name == "mixed_intrinsics" and n_data == 1) else [cam0, cam1][:n_data]
        base = np.tile(np.array([0.3, 0.5, 0.7], np.float32), (64, 48, 1))
        gt = np.stack([base, base * 0.5][:n_data])
    opt = dict(lambda_laplacian=0.1) if flame else (INNOVATIONS if name == "innovations"
                                                    else {})
    pipe = dict(use_pallas=False) if name == "table" else {}
    jcfg = JConfig(opt=JOpt(**opt), pipeline=JPipe(**pipe))
    tcfg = tconfig.Config(opt=tconfig.OptimizationConfig(**opt),
                          pipeline=tconfig.PipelineConfig(**pipe))
    hw = (cams[0].height, cams[0].width)
    if flame:
        js = jinit(params, aux, jcfg, num_timesteps=2, n_expr=fa.N_EXPR, n_shape=fa.N_SHAPE,
                   num_verts=jmodel.num_verts)
    else:
        js = jinit(params, aux, jcfg, image_hw=hw)
    ts = train_state_from_numpy(**state_numpy(js), device="cpu")
    # The avatar's splats span many tiles: one tier as wide as the frame
    # (24 tiles) cuts no bbox, on the frame or on a band.
    tile = dict(TILE, tiers=((384, 24),)) if flame else TILE
    case = dict(model=tmodel, cfg=tcfg, tile=TileConfig(**tile), state=ts,
                cameras=[torch_camera(c) for c in cams], gt=torch.from_numpy(gt),
                bg=torch.zeros(3), sh_degree=0, steps=2)
    return dict(name=name, jmodel=jmodel, jcfg=jcfg, jstate=js, jcams=cams, gt=gt,
                jtile=JTileConfig(**tile), case=case)


def jax_sharded(c: dict, data: int, tile: int, steps: dict) -> tuple:
    """The JAX sharded step's (new state, metrics) on a data × tile mesh.
    `steps` keeps the compiled steps: the unbound and mixed-intrinsics
    cases share one (the fovs are traced)."""
    key = "unbound" if c["name"] == "mixed_intrinsics" else c["name"]
    if key not in steps:
        mesh = make_device_mesh(data=data, tile=tile, devices=jax.devices()[:data * tile])
        steps[key] = jsh.make_sharded_train_step(c["jmodel"], c["jcfg"], c["jtile"], mesh,
                                                 c["jcams"][0])
    step = steps[key]
    hp = jsh.padded_height(c["jcams"][0].height, TILE["tile_h"], tile)
    state = jax.tree_util.tree_map(jnp.array, c["jstate"])
    new, m = step(state, jsh.camera_batch(c["jcams"]),
                  jsh.pad_gt_for_mesh(jnp.asarray(c["gt"]), hp), jnp.zeros(3), sh_degree=0)
    return new, {k: float(v) for k, v in m.items()}


def port_single(c: dict) -> list:
    """The port's single-device step on each camera row from the case's
    state: [(new state, metrics)]."""
    case = c["case"]
    step = ttrainer.make_train_step(case["model"], case["cfg"], case["tile"])
    return [(o.state, o.metrics) for o in (
        step(case["state"], case["gt"][i], cam, cam.timestep, case["bg"], 0)
        for i, cam in enumerate(case["cameras"]))]


def run_mesh(mesh: str, tmp_dir, gauss_shards=(False,)) -> dict:
    """Every case on `mesh`: the port's ranks (one launch: a run for each
    `gauss_shard` setting) run in a thread while this process computes the
    JAX sharded step and the port's single-device steps."""
    d, t = (int(x) for x in mesh.split("x"))
    cases = [build_case(name, d, tmp_dir) for name in CASES]

    def ranks():
        runs = [mesh + (":gauss_shard" if gs else "") for gs in gauss_shards]
        out = sharded_steps.run_cases([c["case"] for c in cases], runs, device="cpu",
                                      timeout_s=LAUNCH_TIMEOUT_S)
        return dict(zip(gauss_shards, out))

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(ranks)
        with torch.no_grad():
            singles = [port_single(c) for c in cases]
        compiled = {}
        refs = [jax_sharded(c, d, t, compiled) for c in cases]
        by_gs = fut.result()
    return {"cases": cases, "singles": singles, "jax": refs, "ranks": by_gs}


def _rel_close(got, want, rel, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max abs err {err:.3g} > {rel} × {scale:.3g}"


def check_case(run: dict, i: int, gauss_shard: bool = False) -> None:
    """Case i of a mesh run against JAX and the port's single-device step."""
    c = run["cases"][i]
    res = [r["results"][i] for r in run["ranks"][gauss_shard]]
    got = res[0]
    # Every rank holds rank 0's state (the digest of every leaf's bytes),
    # after every step.
    for r in res[1:]:
        assert r["digests"] == got["digests"]
        assert r["metrics"] == got["metrics"]
        assert "state" not in r
    assert len(got["digests"]) == c["case"]["steps"]
    assert all(np.isfinite(m["loss"]) for m in got["metrics"])
    m, st = got["metrics"][0], got["state_first"]
    js, jm = run["jax"][i]
    singles = run["singles"][i]
    # The first step against the JAX sharded step on the same mesh shape.
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-4)
    assert m["num_visible"] == jm["num_visible"] > 0
    assert m["budget_overflow"] == m["overflow"] == 0
    for k in PARAM_KEYS:
        _rel_close(st[f"adam/mu/{k}"], getattr(js.adam.mu, k), 1e-4, f"adam/mu/{k}")
        if js.flame is None:   # JAX's cases that hold the parameters
            np.testing.assert_allclose(st[f"params/{k}"], np.asarray(getattr(js.params, k)),
                                       atol=5e-5, err_msg=k)
    np.testing.assert_allclose(st["aux/grad_accum"], np.asarray(js.aux.grad_accum), atol=1e-4)
    np.testing.assert_array_equal(st["aux/denom"], np.asarray(js.aux.denom))
    np.testing.assert_array_equal(st["aux/max_radii2d"], np.asarray(js.aux.max_radii2d))
    if js.flame is not None:
        for k in ("expr", "rotation", "jaw"):
            _rel_close(st[f"flame_adam/mu/{k}"], getattr(js.flame_adam.mu, k), 1e-4, k)
    if js.color_net is not None:
        for j, w in enumerate(js.color_adam.mu.weights):
            _rel_close(st[f"color_adam/mu/weights/{j}"], w, 1e-4, f"color_adam/mu/{j}")
        np.testing.assert_allclose(st["contrastive/images"], np.asarray(js.contrastive.images),
                                   atol=1e-4)
    # ... and against the port's single-device step on each camera row.
    np.testing.assert_allclose(m["loss"], np.mean([float(s[1]["loss"]) for s in singles]),
                               rtol=1e-4)
    aux0 = c["case"]["state"].aux
    np.testing.assert_allclose(
        st["aux/grad_accum"] - n(aux0.grad_accum),
        sum(n(s[0].aux.grad_accum - aux0.grad_accum) for s in singles), atol=1e-4)
    np.testing.assert_array_equal(st["aux/denom"] - n(aux0.denom),
                                  sum(n(s[0].aux.denom - aux0.denom) for s in singles))
    if len(singles) == 1:
        s0 = singles[0][0]
        for k in PARAM_KEYS:
            _rel_close(st[f"adam/mu/{k}"], n(getattr(s0.adam.mu, k)), 1e-4, f"adam/mu/{k}")
            if js.flame is None:
                np.testing.assert_allclose(st[f"params/{k}"], n(getattr(s0.params, k)),
                                           atol=5e-5, err_msg=k)


@pytest.fixture(scope="module")
def run_1x4(tmp_path_factory):
    return run_mesh("1x4", tmp_path_factory.mktemp("sphere"), gauss_shards=(False, True))


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASES)
def test_sharded_step_1x4(run_1x4, i):
    check_case(run_1x4, i)


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASES)
def test_sharded_step_1x4_gauss_shard(run_1x4, i):
    check_case(run_1x4, i, gauss_shard=True)


def test_collectives_a_step(run_1x4):
    """The collectives of a step, as `parallel/sharded.py`'s docstring
    lists them (on the CPU the bands composite through the plain
    compositors, which count no launch)."""
    res = run_1x4["ranks"][False][0]["results"][0]
    assert res["launches"] == [{}, {}]
    coll = res["collectives"][0]
    h_pad, w, cap = 64, 48, 64
    assert coll["all_gather"]["bytes"] == h_pad * w * 3 * 4
    assert coll["all_reduce_sum"]["calls"] == 2 and coll["all_reduce_max"]["calls"] == 1
    gs = run_1x4["ranks"][True][0]["results"][0]["collectives"][0]
    assert gs["reduce_scatter"]["bytes"] == cap * 9 * 4
    assert gs["all_gather"]["calls"] == 3
