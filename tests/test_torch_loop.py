"""The port's host loop against the JAX package's, on the rendered tiny
avatar dataset (`tests/fixtures_avatar.py`: the 178-vertex sphere, 64×48,
8×16 tiles), the faces clamped for both packages as in
`tests/test_torch_train.py`.

* Checkpoints cross over: a JAX `save_train_state` loads into the port and
  the port's into JAX `load_train_state`, leaf for leaf.
* `build_harness` + `train` for 12 iterations with one densify event at
  iteration 10, on a clone-only configuration (percent_dense so large
  that every selected Gaussian clones; no split, so no random draws). The
  port starts from the JAX harness's own initial state (through a JAX
  checkpoint) and takes its configuration from the JAX `cfg_args.json`.
  The densify threshold is placed in a gap of the JAX run's mean
  gradients, asserted to be more than 1e-2 relative away from every one of
  them. Both runs start from anisotropic scales and random rotations (an
  isotropic splat's rotation gradient is rounding noise, which Adam turns
  into ±lr steps of either sign). Then the densify report, `alive` and
  `binding` must be exact, the logged losses within rtol 1e-4 (as the
  3-step trajectory of `tests/test_torch_train.py`), and every parameter
  within 1e-4 of its leaf's largest move over the run (measured: at most
  2.2e-5, in `means`); leaves that do not move (`sh_rest` at SH degree 0)
  exactly.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures_avatar as fa
from gaussianavatars_tpu import config as jconfig
from gaussianavatars_tpu.models.flame import flame_model as jfm
from gaussianavatars_tpu.training import checkpoint as jckpt
from gaussianavatars_tpu.training import loop as jloop
from gaussianavatars_torch import config as tconfig
from gaussianavatars_torch.convert import flame_assets_from_numpy
from gaussianavatars_torch.models.flame import flame_model as tfm
from gaussianavatars_torch.training import checkpoint as tckpt
from gaussianavatars_torch.training import loop as tloop

PARAM_KEYS = ("means", "log_scales", "quats", "sh_dc", "sh_rest", "logit_opacity")
ITERS, DENSIFY_AT = 12, 10


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    obj = tmp_path_factory.mktemp("sphere") / "sphere.obj"
    fa.tiny_sphere_obj(str(obj))
    assets = fa.synthetic_assets(n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR, seed=0,
                                 template_obj=str(obj))
    # The bottom-cap faces name one vertex past the last (ROADMAP queue C):
    # both packages get the faces the mesh means.
    assets = assets._replace(faces=np.minimum(assets.faces, assets.num_verts - 1))
    jmodel = jfm.FlameModel(assets, jfm.FlameConfig(n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR,
                                                    add_teeth=False))
    tmodel = tfm.FlameModel(flame_assets_from_numpy(assets._asdict()),
                            tfm.FlameConfig(fa.N_SHAPE, fa.N_EXPR, add_teeth=False),
                            device="cpu")
    root = tmp_path_factory.mktemp("rendered_ds")
    params, aux = fa.reference_avatar(jmodel)
    fa.write_rendered_dataset(str(root), jmodel, params, aux)
    return jmodel, tmodel, str(root)


def _jax_config(root, model_path, thr=0.0002):
    cap = 512
    return jconfig.Config(
        model=jconfig.ModelConfig(source_path=root, model_path=model_path, bind_to_mesh=True,
                                  capacity=cap, n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR,
                                  add_teeth=False, sh_degree=3, eval=True),
        # One tier as wide as the frame's 24 tiles: no budget overflow and
        # no probe, so both packages bin with the same budgets.
        pipeline=jconfig.PipelineConfig(tile_h=8, tile_w=16, tiers=((cap, 24),)),
        opt=jconfig.OptimizationConfig(
            iterations=ITERS, densify_from_iter=5, densify_until_iter=15,
            densification_interval=DENSIFY_AT, opacity_reset_interval=10_000,
            position_lr_max_steps=ITERS, lambda_scale=0.1, percent_dense=100.0,
            densify_grad_threshold=thr),
    )


def _jax_leaves(state):
    return {jckpt._path_str(kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}


def _port_leaves(state):
    return {k: v.detach().numpy() for k, v in tckpt.flatten_state(state).items()}


def test_checkpoints_cross_between_packages(models, tmp_path):
    jmodel, tmodel, root = models
    jh = jloop.build_harness(_jax_config(root, str(tmp_path / "j")), model=jmodel)
    th = tloop.build_harness(tconfig.from_json(jconfig.to_json(_jax_config(root, ""))),
                             model=tmodel, device="cpu")
    # Perturb the JAX state so every leaf differs from the port's own init.
    rng = np.random.RandomState(1)
    js = jax.tree_util.tree_map(
        lambda x: (x + jnp.asarray(rng.randn(*x.shape).astype(np.float32))
                   if x.dtype == jnp.float32 else x), jh.state)
    jckpt.save_train_state(str(tmp_path / "j.npz"), js, 7)
    ts, it = tckpt.load_train_state(str(tmp_path / "j.npz"), th.state)
    assert it == 7
    jl, tl = _jax_leaves(js), _port_leaves(ts)
    assert set(tl) == set(jl) - {"key"}
    for k, v in tl.items():
        np.testing.assert_array_equal(v, jl[k].astype(v.dtype), err_msg=k)
    assert ts.params.means.dtype == torch.float32 and ts.aux.binding.dtype == torch.int64

    # The port's checkpoint into JAX: every JAX leaf found, values equal.
    ts = dataclasses.replace(ts, params=dataclasses.replace(ts.params,
                                                            means=ts.params.means * 2.0))
    tckpt.save_train_state(str(tmp_path / "t.npz"), ts, 9)
    js2, it2 = jckpt.load_train_state(str(tmp_path / "t.npz"), jh.state)
    assert it2 == 9
    jl2 = _jax_leaves(js2)
    for k, v in _port_leaves(ts).items():
        np.testing.assert_array_equal(jl2[k], v.astype(jl2[k].dtype), err_msg=k)
    np.testing.assert_array_equal(jl2["key"], np.asarray(jax.random.PRNGKey(0)))
    # The port's generator state rides along; a shape change is refused.
    ts3, _ = tckpt.load_train_state(str(tmp_path / "t.npz"), th.state)
    assert torch.equal(ts3.generator.get_state(), ts.generator.get_state())
    assert tckpt.latest_checkpoint(str(tmp_path)) is None
    os.makedirs(tmp_path / "m")
    for i in (3, 12, 5):
        tckpt.save_train_state(str(tmp_path / "m" / f"chkpnt{i}.npz"), ts, i)
    assert tckpt.latest_checkpoint(str(tmp_path / "m")).endswith("chkpnt12.npz")
    small = dataclasses.replace(th.state, params=dataclasses.replace(
        th.state.params, means=th.state.params.means[:256]))
    with pytest.raises(ValueError, match="params/means"):
        tckpt.load_train_state(str(tmp_path / "t.npz"), small)


@pytest.fixture(scope="module")
def short_runs(models, tmp_path_factory):
    """The JAX loop and the port's loop, 12 iterations each from the same
    state, with the densify event's inputs and report captured."""
    jmodel, tmodel, root = models
    out = tmp_path_factory.mktemp("runs")
    jcfg = _jax_config(root, str(out / "jax"))
    jh = jloop.build_harness(jcfg, model=jmodel)
    # Anisotropic scales and random rotations: `init_bound`'s isotropic
    # splats have no rotation gradient, only rounding noise that Adam turns
    # into ±lr steps of either sign.
    rng = np.random.RandomState(0)
    cap = jcfg.model.capacity
    jh.state = dataclasses.replace(jh.state, params=dataclasses.replace(
        jh.state.params,
        log_scales=jnp.asarray(np.log(rng.uniform(0.3, 0.9, (cap, 3))).astype(np.float32)),
        quats=jnp.asarray(rng.randn(cap, 4).astype(np.float32))))
    ckpt0 = str(out / "init.npz")
    jckpt.save_train_state(ckpt0, jh.state, 0)

    captured = {}
    orig_j = jloop.densify_event

    def jax_densify(harness, iteration):
        aux = harness.state.aux
        grads = np.asarray(jnp.where(aux.denom > 0, aux.grad_accum / jnp.maximum(aux.denom, 1.0),
                                     0.0))[np.asarray(aux.alive)]
        g = np.sort(grads[grads > 0])
        # The threshold: the middle of the widest relative gap between
        # neighbouring gradients in the upper half of the sorted list.
        lo, hi = g[len(g) // 2:-1], g[len(g) // 2 + 1:]
        i = int(np.argmax(hi / lo))
        thr = float(np.sqrt(lo[i] * hi[i]))
        captured["thr"] = thr
        captured["margin"] = float(np.min(np.abs(grads - thr) / thr))
        harness.cfg = dataclasses.replace(harness.cfg, opt=dataclasses.replace(
            harness.cfg.opt, densify_grad_threshold=thr))
        captured["jax_report"] = orig_j(harness, iteration)
        captured["jax_alive_after"] = np.asarray(harness.state.aux.alive)
        return captured["jax_report"]

    jloop.densify_event = jax_densify
    try:
        jlogs = jloop.train(jh, iterations=ITERS, log_every=4, eval_every=0,
                            checkpoint_iterations=[DENSIFY_AT], prefetch_workers=2)
    finally:
        jloop.densify_event = orig_j
    assert captured["margin"] > 1e-2, captured

    tcfg = tconfig.from_json(jconfig.to_json(jcfg))
    tcfg = dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, model_path=str(out / "port")),
        opt=dataclasses.replace(tcfg.opt, densify_grad_threshold=captured["thr"]))
    th = tloop.build_harness(tcfg, model=tmodel, start_checkpoint=ckpt0, device="cpu")
    orig_t = tloop.densify_event

    def port_densify(harness, iteration):
        captured["port_report"] = orig_t(harness, iteration)
        captured["port_alive_after"] = harness.state.aux.alive.numpy().copy()
        return captured["port_report"]

    tloop.densify_event = port_densify
    try:
        tlogs = tloop.train(th, iterations=ITERS, log_every=4, eval_every=0,
                            checkpoint_iterations=[DENSIFY_AT], prefetch_workers=2)
    finally:
        tloop.densify_event = orig_t
    return jh, jlogs, th, tlogs, captured


def test_short_train_matches_jax(short_runs):
    """Losses, the densify event and the parameters (tolerances in the
    module docstring)."""
    jh, jlogs, th, tlogs, cap = short_runs
    assert [r["iteration"] for r in tlogs] == [r["iteration"] for r in jlogs] == [4, 8, 12]
    for a, b in zip(tlogs, jlogs):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        assert a["num_points"] == b["num_points"]
    assert tlogs[-1]["loss"] < tlogs[0]["loss"]
    assert cap["port_report"] == cap["jax_report"]
    assert cap["port_report"]["cloned"] > 0 and cap["port_report"]["split"] == 0
    np.testing.assert_array_equal(cap["port_alive_after"], cap["jax_alive_after"])
    np.testing.assert_array_equal(th.state.aux.alive.numpy(), np.asarray(jh.state.aux.alive))
    np.testing.assert_array_equal(th.state.aux.binding.numpy(),
                                  np.asarray(jh.state.aux.binding))
    init = np.load(os.path.join(os.path.dirname(jh.cfg.model.model_path), "init.npz"))
    for k in PARAM_KEYS:
        got = getattr(th.state.params, k).numpy()
        want = np.asarray(getattr(jh.state.params, k))
        move = np.abs(want - init[f"params/{k}"]).max()
        err = np.abs(got - want).max()
        assert err <= 1e-4 * move, (k, float(err), float(move))


def test_loop_artifacts_and_resume(short_runs, models, tmp_path):
    """`tests/test_loop.py`'s artifacts, then a resume from a checkpoint."""
    jmodel, tmodel, root = models
    _jh, _jl, th, _tl, _cap = short_runs
    cfg = tconfig.from_json(jconfig.to_json(_jax_config(root, str(tmp_path / "out"))))
    h = tloop.build_harness(cfg, model=tmodel, device="cpu")
    assert h.scene.num_timesteps == 2
    logs = tloop.train(h, iterations=6, log_every=3, eval_every=3, save_iterations=[6],
                       checkpoint_iterations=[4, 6], prefetch_workers=2)
    assert np.isfinite(logs[-1]["loss"])
    out = tmp_path / "out"
    for f in ("cfg_args.json", "cameras.json", "flame_assets.npz", "chkpnt4.npz", "chkpnt6.npz",
              "point_cloud/iteration_6/point_cloud.ply",
              "point_cloud/iteration_6/flame_param.npz"):
        assert (out / f).exists(), f
    side = np.load(out / "point_cloud" / "iteration_6" / "flame_param.npz")
    assert side["expr"].shape == (2, fa.N_EXPR)
    assert tconfig.from_json((out / "cfg_args.json").read_text()) == cfg
    kinds = {e["kind"] for e in h.events}
    assert {"gt_cache", "eval", "save", "checkpoint"} <= kinds

    h2 = tloop.build_harness(cfg, model=tmodel, start_checkpoint=str(out / "chkpnt4.npz"),
                             device="cpu")
    assert h2.start_iteration == 4
    saved = np.load(out / "chkpnt4.npz")
    for k, v in tckpt.flatten_state(h2.state).items():
        np.testing.assert_array_equal(v.numpy(), saved[k].astype(v.numpy().dtype), err_msg=k)
    logs2 = tloop.train(h2, iterations=7, log_every=2, eval_every=0, prefetch_workers=2)
    assert [r["iteration"] for r in logs2] == [6, 7] and np.isfinite(logs2[-1]["loss"])
    # Prefetcher path (no device cache), with the GUI service after every
    # step and the finite checks from iteration 0 on.
    h3 = tloop.build_harness(cfg, model=tmodel, device="cpu")
    served = []
    logs3 = tloop.train(h3, iterations=2, log_every=1, device_cache_bytes=0, prefetch_workers=2,
                        debug_from=0, gui_service=served.append)
    assert len(logs3) == 2 and np.isfinite(logs3[-1]["loss"]) and served == [1, 2]
    # Unbound training needs a point cloud, which a DynamicNerf dataset lacks.
    with pytest.raises(ValueError, match="point cloud"):
        tloop.build_harness(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, bind_to_mesh=False)), model=tmodel, device="cpu")


def test_train_synthetic_no_pallas_takes_the_jax_table_config():
    """`--no_pallas` (once refused) selects the table pipeline with the JAX
    script's budgets: its Config equals the JAX script's, the loop's
    `tile_config` carries 512 Gaussians a tile and 8 tiles a Gaussian, and
    `--capacity_per_tile` (a flag of the port) sets the first. The fit
    itself runs on the card (`chip_smoke.py` phase 17)."""
    from gaussianavatars_torch.tools import train_synthetic

    from test_torch_innovations_loop import _jax_script, _jax_script_config

    js = _jax_script()
    ja, ta = js.parse_args(["--no_pallas"]), train_synthetic.parse_args(["--no_pallas"])
    ta.workdir = ja.workdir
    got = json.loads(tconfig.to_json(train_synthetic.make_config(ta)))
    want = json.loads(jconfig.to_json(_jax_script_config(js, ja)))
    assert got["pipeline"] == {k: v for k, v in want["pipeline"].items() if k in got["pipeline"]}
    assert got["pipeline"]["use_pallas"] is False
    tile = tloop.tile_config(train_synthetic.make_config(ta))
    assert (tile.capacity, tile.max_tiles_per_gaussian) == (512, 8)
    small = train_synthetic.make_config(train_synthetic.parse_args(
        ["--no_pallas", "--capacity_per_tile", "64"]))
    assert tloop.tile_config(small).capacity == 64


@pytest.mark.parametrize("argv,error", [
    (["--cameras", "1"], SystemExit),
    (["--steps_per_call", "1"], SystemExit),
])
def test_train_synthetic_rejects_what_is_not_ported(argv, error, tmp_path):
    """`tools/train_synthetic` refuses a lone camera before it writes
    anything, and has no `--steps_per_call` (the port runs one step per
    iteration)."""
    from gaussianavatars_torch.tools import train_synthetic

    with pytest.raises(error):
        train_synthetic.run(train_synthetic.parse_args(
            ["--workdir", str(tmp_path / "syn"), "--device", "cpu", *argv]))
    assert not (tmp_path / "syn").exists()


def test_evaluate_split_and_metrics_match_jax(models):
    """`evaluate_split` on the same state in both packages (PSNR, SSIM),
    and the flame table export."""
    jmodel, tmodel, root = models
    jcfg = _jax_config(root, "")
    jh = jloop.build_harness(jcfg, model=jmodel)
    th = tloop.build_harness(tconfig.from_json(jconfig.to_json(jcfg)), model=tmodel,
                             device="cpu")
    path = os.path.join(os.path.dirname(root), "eval_state.npz")
    jckpt.save_train_state(path, jh.state, 0)
    th.state, _ = tckpt.load_train_state(path, th.state)
    jm = jloop.evaluate_split(jh, "val", jloop.make_render_fn(jmodel, jcfg,
                                                              jloop.tile_config(jcfg)),
                              sh_degree=1, max_views=2)
    tm = tloop.evaluate_split(th, "val", tloop.make_render_fn(tmodel, th.cfg,
                                                              tloop.tile_config(th.cfg)),
                              sh_degree=1, max_views=2)
    assert tm["n"] == jm["n"] == 2
    np.testing.assert_allclose(tm["psnr"], jm["psnr"], rtol=1e-5)
    np.testing.assert_allclose(tm["ssim"], jm["ssim"], rtol=1e-5)
    jt = jloop.flame_table_from_state(jh.state, jh.scene.flame_table)
    tt = tloop.flame_table_from_state(th.state, th.scene.flame_table)
    assert sorted(jt) == sorted(tt)
    for k in jt:
        np.testing.assert_array_equal(tt[k], np.asarray(jt[k]), err_msg=k)
    init = tloop.flame_init_from_table(th.scene.flame_table, n_shape=3, n_expr=6)
    ref = jloop.flame_init_from_table(jh.scene.flame_table, n_shape=3, n_expr=6)
    for k in ref:
        np.testing.assert_array_equal(init[k], ref[k], err_msg=k)


def test_port_imports_no_jax():
    """Nothing under gaussianavatars_torch/, nor chip_smoke.py, imports JAX
    or the JAX package: by its source (every import statement), and when
    every module is imported with both blocked."""
    import ast
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((repo / "gaussianavatars_torch").rglob("*.py")) + [repo / "chip_smoke.py"]
    banned = ("jax", "jaxlib", "gaussianavatars_tpu")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in banned, f"{path.name} imports {name}"
    modules = [".".join(p.relative_to(repo).with_suffix("").parts) for p in files[:-1]]
    code = ("import sys\n"
            f"for b in {banned!r}: sys.modules[b] = None\n"
            f"for m in {modules!r}: __import__(m.removesuffix('.__init__'))\n")
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True, timeout=300)
