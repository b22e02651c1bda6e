"""The host side of the port's training innovations against the JAX
package, on the rendered tiny-avatar dataset of `tests/fixtures_avatar.py`
(the 179-vertex sphere, 64×48, 8×16 tiles, faces clamped as in
`tests/test_torch_train.py`):

* progressive resolution: the port's per-scale camera sizes equal the JAX
  `Scene`'s, and a port `train` of 6 iterations with milestones (2, 4)
  steps at 0.5, 0.75, 0.75, 1.0, 1.0, 1.0, holds no ground-truth cache of
  an evicted scale, and resumes at iteration 3 at scale 0.75 (no JAX loop
  run);
* `densify_event` with smart densification on one state in both
  packages, JAX's split draws handed to the port as `noise`, as
  `tests/test_torch_densify_events.py` does: thresholds, report, `alive`
  and `binding` exact, parameters and moments within atol 1e-6 (that
  file's tolerance: the children's means are a rotation times the draws);
* checkpoints with the innovations' leaves cross both ways;
* `tools/train_synthetic`: `--all_innovations` and `--quality` give the
  JAX script's configuration, and an `--all_innovations` run at the test
  size finishes and writes its eval metrics.
"""
import dataclasses
import importlib.util
import json
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures_avatar as fa
from gaussianavatars_tpu import config as jconfig
from gaussianavatars_tpu.data.scene import Scene as JScene
from gaussianavatars_tpu.models import densify as jdensify
from gaussianavatars_tpu.models.flame import flame_model as jfm
from gaussianavatars_tpu.training import checkpoint as jckpt
from gaussianavatars_tpu.training import innovations as jinn
from gaussianavatars_tpu.training import loop as jloop
from gaussianavatars_tpu.training import trainer as jtrainer
from gaussianavatars_torch import config as tconfig
from gaussianavatars_torch.convert import flame_assets_from_numpy, train_state_from_numpy
from gaussianavatars_torch.data.scene import Scene as TScene
from gaussianavatars_torch.models import densify as tdensify
from gaussianavatars_torch.models.flame import flame_model as tfm
from gaussianavatars_torch.training import checkpoint as tckpt
from gaussianavatars_torch.training import loop as tloop
from gaussianavatars_torch.training import trainer as ttrainer
from test_torch_innovations import state_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent
PARAM_KEYS = ("means", "log_scales", "quats", "sh_dc", "sh_rest", "logit_opacity")
SCALES = (0.5, 0.75, 1.0)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    obj = tmp_path_factory.mktemp("sphere") / "sphere.obj"
    fa.tiny_sphere_obj(str(obj))
    assets = fa.synthetic_assets(n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR, seed=0,
                                 template_obj=str(obj))
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


def _config(root, model_path, **opt):
    cap = 512
    return tconfig.Config(
        model=tconfig.ModelConfig(source_path=root, model_path=model_path, bind_to_mesh=True,
                                  capacity=cap, n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR,
                                  add_teeth=False, sh_degree=3, eval=True),
        pipeline=tconfig.PipelineConfig(tile_h=8, tile_w=16, tiers=((cap, 24),)),
        opt=tconfig.OptimizationConfig(iterations=6, position_lr_max_steps=6,
                                       densify_from_iter=100, densify_until_iter=200,
                                       opacity_reset_interval=10_000, lambda_scale=0.1, **opt),
    )


# ----------------------------------------------------- progressive resolution


def _dataset_at(src, dst, w, h):
    """A copy of a dataset's transforms and FLAME files whose frames claim
    w×h (cameras are built without decoding images)."""
    shutil.copytree(os.path.join(src, "flame_param"), os.path.join(dst, "flame_param"))
    for split in ("train", "val", "test"):
        name = f"transforms_{split}.json"
        meta = json.load(open(os.path.join(src, name)))
        for f in meta["frames"]:
            f["w"], f["h"] = w, h
        json.dump(meta, open(os.path.join(dst, name), "w"))
    return dst


@pytest.mark.parametrize("size", ["test", "802x550"])
def test_scene_scales_match_jax(models, tmp_path, size):
    _jm, tmodel, root = models
    if size != "test":
        root = _dataset_at(root, str(tmp_path), 802, 550)
    divisors = tuple(1.0 / s for s in sorted(SCALES, reverse=True))
    js = JScene(root, resolution_scales=divisors, num_verts_hint=tmodel.num_verts)
    ts = TScene(root, resolution_scales=divisors, num_verts_hint=tmodel.num_verts,
                device="cpu")
    sizes = set()
    for d in divisors:
        for split in ("train", "val", "test"):
            jc, tc = js.cameras(split, d), ts.cameras(split, d)
            assert len(jc) == len(tc) > 0
            for a, b in zip(jc, tc):
                assert (a.width, a.height) == (b.width, b.height), (split, d)
                np.testing.assert_allclose(b.full_proj.numpy(), np.asarray(a.full_proj),
                                           rtol=1e-6, atol=1e-7)
                sizes.add((d, b.width, b.height))
    assert len(sizes) == 3
    if size != "test":
        assert sorted((w, h) for _d, w, h in sizes) == [(401, 275), (601, 412), (802, 550)]


def test_progressive_schedule_eviction_and_resume(models, tmp_path):
    _jm, tmodel, root = models
    cfg = _config(root, str(tmp_path / "m"), use_progressive_resolution=True,
                  resolution_schedule=SCALES, resolution_milestones=(2, 4))
    h = tloop.build_harness(cfg, model=tmodel, device="cpu")
    logs = tloop.train(h, iterations=6, log_every=1, eval_every=0, checkpoint_iterations=[2],
                       prefetch_workers=2)
    want = [0.5, 0.75, 0.75, 1.0, 1.0, 1.0]
    assert [r["resolution_scale"] for r in logs] == want
    # Only the current scale's cache is held: the past ones were evicted.
    assert [r["cached_scales"] for r in logs] == [[s] for s in want]
    assert all(np.isfinite(r["loss"]) for r in logs)
    sizes = {s: (int(round(fa.H * s)), int(round(fa.W * s))) for s in SCALES}
    assert h.steps_by_size == {sizes[0.5]: 1, sizes[0.75]: 2, sizes[1.0]: 3}
    built = [(e["iteration"], e["scale"]) for e in h.events if e["kind"] == "gt_cache"]
    evicted = [(e["iteration"], e["scale"]) for e in h.events if e["kind"] == "evict_scale"]
    assert built == [(1, 0.5), (2, 0.75), (4, 1.0)]
    assert evicted == [(2, 0.5), (4, 0.75)]

    h2 = tloop.build_harness(cfg, model=tmodel, device="cpu",
                             start_checkpoint=str(tmp_path / "m" / "chkpnt2.npz"))
    assert h2.start_iteration == 2
    logs2 = tloop.train(h2, iterations=4, log_every=1, eval_every=0, prefetch_workers=2)
    assert [(r["iteration"], r["resolution_scale"]) for r in logs2] == [(3, 0.75), (4, 1.0)]
    assert [(e["iteration"], e["scale"]) for e in h2.events
            if e["kind"] == "gt_cache"] == [(3, 0.75), (4, 1.0)]


# ----------------------------------------------------- smart densification


def test_smart_densify_event_matches_jax(models, monkeypatch):
    jmodel, tmodel, root = models
    cap = 512
    jcfg = jconfig.Config(opt=jconfig.OptimizationConfig(
        use_smart_densification=True, densify_percentile_clone=70.0,
        densify_percentile_split=85.0, percent_dense=0.05))
    rng = np.random.RandomState(4)
    params, aux = fa.reference_avatar(jmodel, capacity=cap)
    n_alive = int(np.asarray(aux.alive).sum())
    # Local scales in two groups far from percent_dense · extent (extent 1):
    # world scales are these times the face scaling.
    small = rng.rand(cap) < 0.5
    log_scales = np.where(small[:, None], np.log(rng.uniform(1e-4, 2e-4, (cap, 3))),
                          np.log(rng.uniform(0.5, 1.0, (cap, 3)))).astype(np.float32)
    denom = rng.randint(0, 5, cap).astype(np.float32)
    accum = (rng.exponential(2e-4, cap) * denom).astype(np.float32)
    accum[rng.rand(cap) < 0.1] = 0.0
    params = dataclasses.replace(params, log_scales=jnp.asarray(log_scales),
                                 quats=jnp.asarray(rng.randn(cap, 4).astype(np.float32)))
    aux = dataclasses.replace(aux, grad_accum=jnp.asarray(accum), denom=jnp.asarray(denom))
    js = jtrainer.init_train_state(params, aux, jcfg, num_timesteps=2, n_expr=fa.N_EXPR,
                                   n_shape=fa.N_SHAPE, num_verts=jmodel.num_verts,
                                   key=jax.random.PRNGKey(11))
    ts = train_state_from_numpy(**state_numpy(js), device="cpu")
    # The world scales sit clear of the clone/split boundary.
    frames = jloop.face_frames(jmodel.forward(jloop.FlameParams(
        shape=js.flame_static.shape, expr=js.flame.expr[0][None],
        rotation=js.flame.rotation[0][None], neck=js.flame.neck[0][None],
        jaw=js.flame.jaw[0][None], eyes=js.flame.eyes[0][None],
        translation=js.flame.translation[0][None],
        static_offset=js.flame_static.static_offset))[0], jmodel.faces)
    wmax = np.asarray(jdensify.world_scale_of(params, aux, frames)).max(1)[:n_alive]
    assert np.min(np.abs(wmax / 0.05 - 1)) > 0.1
    # JAX's own draws: densify_event splits the state key, then
    # densify_and_prune splits its half in two.
    _key, sub = jax.random.split(js.key)
    noise = tuple(torch.as_tensor(np.array(jax.random.normal(k, (cap, 3))))
                  for k in jax.random.split(sub))
    monkeypatch.setattr(tloop, "densify_and_prune",
                        lambda *a, **k: tdensify.densify_and_prune(*a, **k, noise=noise))
    want_thr = jinn.smart_thresholds(js.aux.grad_accum, js.aux.denom, 0.0002, 70.0, 85.0)

    jh = jloop.TrainerHarness(cfg=jcfg, scene=None, model=jmodel, state=js,
                              spatial_lr_scale=1.0)
    th = tloop.TrainerHarness(cfg=tconfig.from_json(jconfig.to_json(jcfg)), scene=None,
                              model=tmodel, state=ts, spatial_lr_scale=1.0)
    jrep = jloop.densify_event(jh, 100)
    trep = tloop.densify_event(th, 100)
    assert trep.pop("clone_threshold") == float(want_thr[0]) > 0.0002 * 0.3
    assert trep.pop("split_threshold") == float(want_thr[1]) > float(want_thr[0])
    assert trep == jrep and jrep["cloned"] > 0 and jrep["split"] > 0
    for k in ("alive", "binding"):
        np.testing.assert_array_equal(getattr(th.state.aux, k).numpy(),
                                      np.asarray(getattr(jh.state.aux, k)), err_msg=k)
    for name, t_obj, j_obj in (("params", th.state.params, jh.state.params),
                               ("mu", th.state.adam.mu, jh.state.adam.mu),
                               ("nu", th.state.adam.nu, jh.state.adam.nu)):
        for k in PARAM_KEYS:
            np.testing.assert_allclose(getattr(t_obj, k).numpy(), np.asarray(getattr(j_obj, k)),
                                       atol=1e-6, rtol=0, err_msg=f"{name}.{k}")


# ----------------------------------------------------- checkpoints


def _jax_leaves(state):
    return {jckpt._path_str(kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}


INNOVATION_LEAVES = {
    **{f"color_net/weights/{i}": ((3, 16), (16, 16), (16, 3))[i] for i in range(3)},
    **{f"color_net/biases/{i}": ((16,), (16,), (3,))[i] for i in range(3)},
    **{f"color_adam/{m}/{kind}/{i}": None for m in ("mu", "nu")
       for kind in ("weights", "biases") for i in range(3)},
    "color_adam/step": (), "contrastive/images": (2, 8, 8, 3),
    "contrastive/count": (), "contrastive/head": (),
}


def test_checkpoints_with_innovations_cross_both_ways(models, tmp_path):
    jmodel, tmodel, _root = models
    opt = dict(use_color_calibration=True, use_contrastive_reg=True)
    jcfg = jconfig.Config(opt=jconfig.OptimizationConfig(**opt))
    params, aux = fa.reference_avatar(jmodel, capacity=512)
    kw = dict(num_timesteps=2, n_expr=fa.N_EXPR, n_shape=fa.N_SHAPE,
              num_verts=jmodel.num_verts, image_hw=(fa.H, fa.W))
    js = jtrainer.init_train_state(params, aux, jcfg, **kw)
    rng = np.random.RandomState(3)
    js = jax.tree_util.tree_map(
        lambda x: (x + jnp.asarray(rng.randn(*x.shape).astype(np.float32))
                   if x.dtype == jnp.float32 else x), js)
    js = dataclasses.replace(js, contrastive=js.contrastive._replace(
        count=jnp.int32(2), head=jnp.int32(1)), color_adam=js.color_adam._replace(
        step=jnp.int32(5)))
    ts0 = ttrainer.init_train_state(
        *tckpt_params(params, aux), tconfig.Config(opt=tconfig.OptimizationConfig(**opt)),
        **kw)
    jckpt.save_train_state(str(tmp_path / "j.npz"), js, 7)
    ts, it = tckpt.load_train_state(str(tmp_path / "j.npz"), ts0)
    assert it == 7
    jl = _jax_leaves(js)
    tl = {k: v.numpy() for k, v in tckpt.flatten_state(ts).items()}
    assert set(tl) == set(jl) - {"key"}
    assert set(INNOVATION_LEAVES) <= set(tl)
    for k, shape in INNOVATION_LEAVES.items():
        assert tl[k].dtype == jl[k].dtype, k
        if shape is not None:
            assert tl[k].shape == shape, k
    assert tl["color_adam/step"].dtype == tl["contrastive/count"].dtype == np.int32
    for k, v in tl.items():
        np.testing.assert_array_equal(v, jl[k].astype(v.dtype), err_msg=k)

    ts = dataclasses.replace(ts, contrastive=ts.contrastive._replace(
        images=ts.contrastive.images * 2.0, head=torch.zeros((), dtype=torch.int32)),
        color_net=ts.color_net._replace(weights=tuple(w + 1.0 for w in ts.color_net.weights)))
    tckpt.save_train_state(str(tmp_path / "t.npz"), ts, 9)
    js2, it2 = jckpt.load_train_state(str(tmp_path / "t.npz"), js)
    assert it2 == 9
    jl2 = _jax_leaves(js2)
    for k, v in tckpt.flatten_state(ts).items():
        assert jl2[k].dtype == jl[k].dtype, k
        np.testing.assert_array_equal(jl2[k], v.numpy().astype(jl2[k].dtype), err_msg=k)
    assert int(js2.contrastive.head) == 0 and int(js2.contrastive.count) == 2


def tckpt_params(params, aux):
    """The port's GaussianParams/GaussianAux of JAX ones (CPU)."""
    from gaussianavatars_torch.convert import gaussian_state_from_numpy

    def d(obj):
        return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}

    return gaussian_state_from_numpy(d(params), d(aux), device="cpu")


# ----------------------------------------------------- tools/train_synthetic


def _jax_script():
    """scripts/train_synthetic.py as a module (its import may point
    $GSAVATARS_FLAME_TEMPLATE at a local template: restored here)."""
    before = os.environ.get("GSAVATARS_FLAME_TEMPLATE")
    spec = importlib.util.spec_from_file_location("jax_train_synthetic",
                                                  REPO / "scripts" / "train_synthetic.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        if before is None:
            os.environ.pop("GSAVATARS_FLAME_TEMPLATE", None)
        else:
            os.environ["GSAVATARS_FLAME_TEMPLATE"] = before
    return mod


def _jax_script_config(js, a) -> jconfig.Config:
    """The Config `scripts/train_synthetic.py:main` builds (`:239-284`)."""
    innov = {}
    if a.all_innovations:
        innov = dict(
            use_region_adaptive_loss=True, use_smart_densification=True,
            use_progressive_resolution=True, resolution_schedule=(0.5, 0.75, 1.0),
            resolution_milestones=(a.iterations // 3, 2 * a.iterations // 3),
            use_color_calibration=True, use_contrastive_reg=True)
    return jconfig.Config(
        model=jconfig.ModelConfig(
            source_path=a.workdir, model_path=os.path.join(a.workdir, "model"),
            bind_to_mesh=True, capacity=a.capacity, n_shape=a.n_shape, n_expr=a.n_expr,
            add_teeth=True, eval=True, sh_degree=3),
        pipeline=jconfig.PipelineConfig(tile_h=32, tile_w=32, capacity_per_tile=512,
                                        max_tiles_per_gaussian=8,
                                        use_pallas=not a.no_pallas),
        opt=jconfig.OptimizationConfig(
            iterations=a.iterations, position_lr_max_steps=a.iterations,
            densify_from_iter=500, densify_until_iter=a.iterations,
            densification_interval=250,
            opacity_reset_interval=(a.opacity_reset_interval or 10 * a.iterations),
            densify_grad_threshold=a.densify_grad_threshold, lambda_scale=0.1,
            use_amp=a.use_amp, **innov))


@pytest.mark.parametrize("flag", ["--quality", "--all_innovations"])
def test_train_synthetic_profile_matches_jax(flag):
    """The profile's arguments and the resulting configuration, the paths
    aside (the port writes under its working directory)."""
    from gaussianavatars_torch.tools import train_synthetic as ts

    js = _jax_script()
    ja = js.parse_args([flag, "--iterations", "900"])
    ta = ts.parse_args([flag, "--iterations", "900"])
    if ja.quality:
        js.apply_quality_profile(ja, vars(js.parse_args([])))
        ts.apply_quality_profile(ta, vars(ts.parse_args([])))
    shared = (set(vars(ja)) & set(vars(ta))) - {"workdir"}
    assert {k: vars(ta)[k] for k in shared} == {k: vars(ja)[k] for k in shared}
    assert ta.all_innovations and ta.opacity_reset_interval == (90 if ja.quality else 0)
    ta.workdir = ja.workdir
    got = json.loads(tconfig.to_json(ts.make_config(ta)))
    want = json.loads(jconfig.to_json(_jax_script_config(js, ja)))
    for section in got:
        assert got[section] == {k: v for k, v in want[section].items() if k in got[section]}, \
            section
    assert got["opt"]["resolution_milestones"] == [300, 600]


def test_train_synthetic_all_innovations_runs_on_the_cpu(tmp_path, monkeypatch):
    """At the test size. The topology is the synthetic sphere's 5,023
    vertices (so the teeth and the region tables are in range) with every
    40th face: 415 faces with the teeth, where the full sphere's ~20k
    Gaussians cost the compositors' plain versions seconds a view."""
    from gaussianavatars_torch.models.flame.assets import NUM_VERTS, _uv_sphere
    from gaussianavatars_torch.tools import train_synthetic as ts

    verts, _uv, faces, _fuv = _uv_sphere(NUM_VERTS)
    obj = tmp_path / "sparse_sphere.obj"
    obj.write_text("".join(f"v {a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in verts)
                   + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces[::40]))
    monkeypatch.setenv("GSAVATARS_FLAME_TEMPLATE", str(obj))
    out = tmp_path / "result.json"
    h, result = ts.run(ts.parse_args([
        "--workdir", str(tmp_path / "syn"), "--device", "cpu", "--width", "64",
        "--height", "48", "--timesteps", "2", "--cameras", "2", "--iterations", "6",
        "--capacity", "1024", "--n_shape", "8", "--n_expr", "4", "--log_every", "1",
        "--eval_every", "0", "--all_innovations", "--json_out", str(out)]))
    assert h.model.num_verts == NUM_VERTS + 120 and h.state.color_net is not None
    assert int(h.state.contrastive.count) == 2
    logs = result["logs"]
    assert [r["resolution_scale"] for r in logs] == [0.5, 0.75, 0.75, 1.0, 1.0, 1.0]
    assert all(np.isfinite(r["loss"]) for r in logs)
    saved = json.loads(out.read_text())
    for split in ("val", "test"):
        m = saved[f"eval_{split}"]
        assert np.isfinite(m["psnr"]) and 0 < m["ssim"] <= 1 and m["n"] > 0
    from gaussianavatars_torch.tools import quality_report

    quality_report.main([str(out), str(tmp_path / "report.md")])
    text = (tmp_path / "report.md").read_text()
    assert "all 5" in text and f"PSNR **{saved['eval_val']['psnr']:.2f} dB**" in text
    assert text.count("\n| ") == len(logs) + 1     # the header and a row a log


def test_synthetic_lpips_weights_file(tmp_path):
    """`python -m gaussianavatars_torch.metrics.lpips OUT.npz` writes
    `synthetic_lpips_params` in the shared layout."""
    # The package exports the function `lpips` under the module's name.
    lpips = importlib.import_module("gaussianavatars_torch.metrics.lpips")
    path = lpips.main([str(tmp_path / "w" / "vgg.npz"), "--seed", "3"])
    got = lpips.load_lpips_weights(path, device="cpu")
    want = lpips.synthetic_lpips_params(torch.Generator().manual_seed(3), "vgg", device="cpu")
    assert got.net_type == "vgg"
    for a, b in zip(got.conv_w + got.lin_w, want.conv_w + want.lin_w):
        assert torch.equal(a, b)
