"""Chunks of training steps in the port (`trainer.make_train_chunk`,
`loop.chunk_boundary`, `train(steps_per_call=)`) against the JAX package's
(`make_train_scan`, `chunk_boundary`, `train(steps_per_call=)`), on the CPU.

* `chunk_boundary` on the cases of `tests/test_loop.py` and on a seeded
  grid of starts and schedules: equal to JAX's (pure Python).
* A chunk of K = 3 steps on the CPU is three `make_train_step` calls, bit
  for bit, and matches JAX `make_train_scan` (its Pallas kernels in
  interpret mode) at the tolerances of `tests/test_torch_train.py`: the
  loss per step at rtol 1e-4, the parameters' moves within 1e-2 of the
  leaf's largest move (elements whose first gradient is below 1e-7 of
  the leaf's largest left out, under 1 % of them).
* A step given its timestep as a 0-dim tensor equals one given an int, bit
  for bit; `stack_cameras` raises on mixed intrinsics and resolutions.
* The loop's dispatch schedule with the step and the chunk replaced by
  recording stubs (no numeric work): the JAX loop's GUI calls `[4, 8]`,
  then `[4, 5, 6, 7, 8]` once a client is connected, single steps from
  `debug_from` (a chunk ends the iteration before), single steps with a
  prefetcher and with mixed intrinsics.
* One real `train(steps_per_call=4)` on the tiny sphere's dataset (64×48,
  `tests/fixtures_avatar.py`'s avatar rendered by the port's
  `train_synthetic.write_dataset`) equals `steps_per_call=1` over 8
  iterations with a densify event at 4, every leaf bit for bit (the CPU
  chunk is the step in a loop).
* `--steps_per_call` reaches `train` from both CLIs (default 50, as the
  JAX scripts'), and a value below 1 is refused.

Everything runs on one intra-op thread (`torch_parity.torch_threads`).
"""
import dataclasses
import os
import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures_avatar as fa
from gaussianavatars_tpu import config as jconfig
from gaussianavatars_tpu.training import loop as jloop
from gaussianavatars_tpu.training import trainer as jtrainer
from gaussianavatars_torch import config as tconfig
from gaussianavatars_torch.data.pipeline import gt_to_float
from gaussianavatars_torch.training import checkpoint as tckpt
from gaussianavatars_torch.training import loop as tloop
from gaussianavatars_torch.training import trainer as ttrainer
from test_torch_loop import _jax_config
from test_torch_train import FLAME_KEYS, PARAM_KEYS, _both, _rel_close, avatar  # noqa: F401
from torch_parity import n, t, torch_threads


@pytest.fixture(autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


# ------------------------------------------------------------ chunk_boundary


def _boundaries(**opt):
    return (jconfig.OptimizationConfig(**opt), tconfig.OptimizationConfig(**opt))


def _both_boundaries(i, jo, to, **kw):
    want = jloop.chunk_boundary(i, opt=jo, **kw)
    got = tloop.chunk_boundary(i, opt=to, **kw)
    assert got == want, (i, kw)
    return got


def test_chunk_boundary_pre_vs_post_step_events():
    """`tests/test_loop.py::test_chunk_boundary_pre_vs_post_step_events`."""
    jo, to = _boundaries(densification_interval=100, opacity_reset_interval=3000,
                         use_progressive_resolution=True, resolution_milestones=(1500, 2500))
    kw = dict(iterations=10_000, steps_per_call=500, log_every=100, eval_every=None)
    assert _both_boundaries(901, jo, to, **kw) == 999
    assert _both_boundaries(1000, jo, to, **kw) == 1000
    assert _both_boundaries(1001, jo, to, **kw) == 1100
    assert _both_boundaries(1401, jo, to, **kw) == 1499
    assert _both_boundaries(1499, jo, to, **kw) == 1499
    assert _both_boundaries(1701, jo, to, **{**kw, "log_every": 0,
                                             "save_iterations": (1750,)}) == 1750
    assert _both_boundaries(201, jo, to, **{**kw, "steps_per_call": 10}) == 210


def test_chunk_boundary_eval_and_densify_from():
    """`tests/test_loop.py::test_chunk_boundary_eval_and_densify_from`."""
    jo, to = _boundaries(densification_interval=250, opacity_reset_interval=100_000,
                         densify_from_iter=630)
    kw = dict(iterations=10_000, steps_per_call=500, log_every=1000, eval_every=None)
    assert _both_boundaries(501, jo, to, **kw) == 630
    assert _both_boundaries(701, jo, to, **{**kw, "eval_iterations": (730, 5000)}) == 730


def test_chunk_boundary_matches_jax_on_a_seeded_grid():
    """Random schedules (intervals, milestones, event lists) and starts:
    the port's boundary is JAX's at every start."""
    rng = random.Random(14)
    for _ in range(40):
        iters = rng.randint(50, 5000)
        prog = rng.random() < 0.5
        opt = dict(
            densification_interval=rng.choice([0, 7, 100, 250]),
            opacity_reset_interval=rng.choice([0, 300, 3000]),
            densify_from_iter=rng.randint(0, iters),
            use_progressive_resolution=prog,
            resolution_milestones=tuple(sorted(rng.sample(range(1, iters), 2))) if prog
            else (100_000, 300_000))
        jo, to = _boundaries(**opt)
        kw = dict(iterations=iters, steps_per_call=rng.choice([1, 4, 50, 500]),
                  log_every=rng.choice([0, 1, 10, 100]), eval_every=rng.choice([None, 0, 33]),
                  save_iterations=tuple(rng.sample(range(1, iters + 1), 2)),
                  checkpoint_iterations=tuple(rng.sample(range(1, iters + 1), 1)),
                  eval_iterations=tuple(rng.sample(range(1, iters + 1), 2)))
        for i in sorted(rng.sample(range(1, iters + 1), min(iters, 25))):
            end = _both_boundaries(i, jo, to, **kw)
            assert i <= end <= max(i, iters)


# --------------------------------------------------------------- the chunk


def _cams(tcam, k):
    return ttrainer.stack_cameras([tcam] * k)


def test_chunk_equals_single_steps_and_jax_scan(avatar):
    """K = 3 over two views of one camera and both timesteps."""
    (jstep, js, jcam, jmodel), (tstep, ts, tcam, tmodel), gt = _both(avatar,
                                                                     lambda_laplacian=0.3)
    rng = np.random.RandomState(3)
    cache_np = np.stack([(gt * 255).astype(np.uint8),
                         rng.randint(0, 256, gt.shape).astype(np.uint8)])
    views, tsteps = [1, 0, 1], [0, 1, 1]
    cache = t(cache_np)
    tcfg = tconfig.Config(opt=tconfig.OptimizationConfig(lambda_laplacian=0.3))
    tile = ttrainer.TileConfig(tile_h=8, tile_w=16, tiers=((ts.params.capacity, 24),))
    chunk = ttrainer.make_train_chunk(tmodel, tcfg, tile)
    st_c, m_c = chunk(ts, cache, views, _cams(tcam, 3), tsteps, torch.zeros(3), 1)

    step = ttrainer.make_train_step(tmodel, tcfg, tile)
    st, losses = ts, []
    for v, ti in zip(views, tsteps):
        out = step(st, gt_to_float(cache[v]), tcam, ti, torch.zeros(3), 1)
        st = out.state
        losses.append(out.metrics["loss"])
        if len(losses) == 1:   # Adam's first moment after one step: 0.1·g
            first_g = {k: np.abs(n(getattr(st.adam.mu, k))) for k in PARAM_KEYS}
    got, want = tckpt.flatten_state(st_c), tckpt.flatten_state(st)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert set(m_c) == set(out.metrics) and all(v.shape == (3,) for v in m_c.values())
    assert torch.equal(m_c["loss"], torch.stack(losses))

    # JAX's scan from the same state, its Pallas kernels in interpret mode.
    jcfg = jconfig.Config(opt=jconfig.OptimizationConfig(lambda_laplacian=0.3))
    from gaussianavatars_tpu.ops.rasterize_tiled import TileConfig as JTileConfig

    scan = jtrainer.make_train_scan(jmodel, jcfg, JTileConfig(tile_h=8, tile_w=16,
                                                              tiers=tile.tiers))
    p0 = {k: n(getattr(ts.params, k)) for k in PARAM_KEYS}
    f0 = {k: n(getattr(ts.flame, k)) for k in FLAME_KEYS}
    js_new, jm = scan(js, jnp.asarray(cache_np), jnp.asarray(views, jnp.int32),
                      jtrainer.stack_cameras([jcam] * 3), jnp.asarray(tsteps, jnp.int32),
                      jnp.zeros(3), sh_degree=1)
    np.testing.assert_allclose(n(m_c["loss"]), np.asarray(jm["loss"]), rtol=1e-4)
    for k in PARAM_KEYS:
        g = first_g[k]
        small = (g > 0) & (g < 1e-7 * g.max())
        assert small.mean() < 0.01, f"{k}: {small.sum()} of {g.size} below the floor"
        move = np.asarray(getattr(js_new.params, k)) - p0[k]
        err = np.abs(n(getattr(st_c.params, k)) - p0[k] - move)[~small]
        assert err.max() <= 1e-2 * np.abs(move).max(), k
    for k in FLAME_KEYS:
        _rel_close(n(getattr(st_c.flame, k)) - f0[k],
                   np.asarray(getattr(js_new.flame, k)) - f0[k], 1e-2, k)


def test_tensor_timestep_equals_int(avatar):
    """Timestep 1 with per-timestep dynamic offsets (both regularisers):
    an int and a 0-dim tensor give the same state and metrics."""
    _j, (tstep, ts, tcam, _tm), gt = _both(avatar, dynamic_offset=True, lambda_laplacian=0.3,
                                           lambda_dynamic_offset=0.1,
                                           lambda_dynamic_offset_std=0.1)
    a = tstep(ts, t(gt), tcam, 1, torch.zeros(3), 1)
    b = tstep(ts, t(gt), tcam, torch.tensor(1, dtype=torch.int64), torch.zeros(3), 1)
    for k, v in tckpt.flatten_state(a.state).items():
        assert torch.equal(v, tckpt.flatten_state(b.state)[k]), k
    assert all(torch.equal(a.metrics[k], b.metrics[k]) for k in a.metrics)
    assert float(a.metrics["dy_off"]) > 0


def test_stack_cameras_raises_on_mixed_intrinsics(avatar):
    tcam = _both(avatar)[1][2]
    stacked = ttrainer.stack_cameras([tcam, tcam])
    assert stacked.world_view.shape == (2, 4, 4) and stacked.fovx == tcam.fovx
    row = ttrainer.camera_row(stacked, 1)
    assert torch.equal(row.full_proj, tcam.full_proj) and row.width == tcam.width
    with pytest.raises(ValueError, match="mixed per-camera intrinsics"):
        ttrainer.stack_cameras([tcam, dataclasses.replace(tcam, fovx=tcam.fovx * 1.1)])
    with pytest.raises(ValueError, match="mixed resolutions"):
        ttrainer.stack_cameras([tcam, dataclasses.replace(tcam, width=tcam.width + 8)])


# ------------------------------------------------------------------ the loop


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The tiny sphere avatar (`fixtures_avatar`, faces clamped as in
    `tests/test_torch_loop.py`) rendered by the port's
    `train_synthetic.write_dataset` at 64×48, 3 timesteps × 3 cameras:
    4 training views. Returns (model, root)."""
    from gaussianavatars_tpu.models.flame.assets import synthetic_assets
    from gaussianavatars_torch.convert import flame_assets_from_numpy
    from gaussianavatars_torch.models.flame import flame_model as tfm
    from gaussianavatars_torch.models.gaussians import init_bound
    from gaussianavatars_torch.tools.train_synthetic import write_dataset

    obj = tmp_path_factory.mktemp("sphere") / "sphere.obj"
    fa.tiny_sphere_obj(str(obj))
    assets = synthetic_assets(n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR, seed=0,
                              template_obj=str(obj))
    assets = assets._replace(faces=np.minimum(assets.faces, assets.num_verts - 1))
    model = tfm.FlameModel(flame_assets_from_numpy(assets._asdict()),
                           tfm.FlameConfig(fa.N_SHAPE, fa.N_EXPR, add_teeth=False), device="cpu")
    params, aux = init_bound(model.num_faces, capacity=512,
                             generator=torch.Generator().manual_seed(7), device="cpu")
    params = dataclasses.replace(params, logit_opacity=torch.full_like(params.logit_opacity, 2.0),
                                 log_scales=torch.full_like(params.log_scales, np.log(0.6)))
    root = str(tmp_path_factory.mktemp("dataset"))
    a = types.SimpleNamespace(workdir=root, width=fa.W, height=fa.H, timesteps=3, cameras=3,
                              n_shape=fa.N_SHAPE, n_expr=fa.N_EXPR, seed=0, no_pallas=False)
    with torch_threads(1):   # a module fixture starts before `_one_thread`
        write_dataset(a, model, params, aux)
    return model, root


def _port_harness(dataset, **opt):
    model, root = dataset
    cfg = tconfig.from_json(jconfig.to_json(_jax_config(root, "")))
    cfg = dataclasses.replace(cfg, opt=dataclasses.replace(cfg.opt, **opt))
    return tloop.build_harness(cfg, model=model, device="cpu")


class _Recorder:
    """Stands in for `make_train_step` and `make_train_chunk`: records each
    dispatch as (first iteration's view count, k) and returns the state
    unchanged with zero metrics."""

    def __init__(self):
        self.calls = []

    def _metrics(self, shape=()):
        z = torch.zeros(shape)
        return {"loss": z, "psnr": z, **{k: torch.zeros(shape, dtype=torch.int32)
                                         for k in tloop.BUDGET_METRICS}}

    def make_step(self, *a, **k):
        def step(state, gt, cam, ts, bg, sh):
            assert gt.shape[-1] == 3 and not isinstance(ts, torch.Tensor)
            self.calls.append(1)
            return ttrainer.StepOutput(state, self._metrics(), gt)
        return step

    def make_chunk(self, *a, **k):
        rec = self

        class Chunk:
            captures = 0

            def __call__(self, state, cache, views, cams, timesteps, bg, sh):
                assert len(views) == len(timesteps) == cams.world_view.shape[0]
                rec.calls.append(len(views))
                return state, rec._metrics((len(views),))

            def drop(self):
                pass
        return Chunk()


def _scheduled(monkeypatch, harness, **kw):
    rec = _Recorder()
    monkeypatch.setattr(tloop, "make_train_step", rec.make_step)
    monkeypatch.setattr(tloop, "make_train_chunk", rec.make_chunk)
    tloop.train(harness, iterations=8, log_every=8, eval_every=0, **kw)
    return rec.calls


def test_loop_chunk_schedule(dataset, monkeypatch):
    """`tests/test_loop.py::test_gui_service_every_dispatch_and_debug_from`
    with stubs: the dispatches and the GUI calls."""
    # densify_from_iter 0: no one-time boundary inside the 8 iterations.
    h = _port_harness(dataset, densify_from_iter=0)
    gui_calls, connected = [], {"v": False}

    def gui(it):
        gui_calls.append(it)
        return connected["v"]

    assert _scheduled(monkeypatch, h, steps_per_call=4, gui_service=gui) == [4, 4]
    assert gui_calls == [4, 8]
    gui_calls.clear()
    connected["v"] = True
    assert _scheduled(monkeypatch, h, steps_per_call=4, gui_service=gui) == [4, 1, 1, 1, 1]
    assert gui_calls == [4, 5, 6, 7, 8]
    assert _scheduled(monkeypatch, h, steps_per_call=4, debug_from=0) == [1] * 8
    assert _scheduled(monkeypatch, h, steps_per_call=4, debug_from=3) == [2] + [1] * 6
    assert sum(h.steps_by_size.values()) == 4 * 8
    # A prefetcher (no device cache) single-steps.
    assert _scheduled(monkeypatch, h, steps_per_call=4, device_cache_bytes=0,
                      prefetch_workers=1) == [1] * 8


def test_loop_single_steps_mixed_intrinsics(dataset, monkeypatch, capsys):
    h = _port_harness(dataset, densify_from_iter=0)
    cams = h.scene.cameras("train")
    cams[0] = dataclasses.replace(cams[0], fovx=cams[0].fovx * 1.05)
    monkeypatch.setattr(h.scene, "cameras", lambda split, scale=1.0: cams)
    assert _scheduled(monkeypatch, h, steps_per_call=4) == [1] * 8
    assert "per-camera intrinsics detected" in capsys.readouterr().out


def test_chunked_train_equals_single_steps(dataset):
    """8 iterations, a densify event at 4 (clone-only: no random draws),
    logs at 4 and 8: steps_per_call 4 against 1, every leaf bit for bit."""
    runs = []
    for spc in (4, 1):
        h = _port_harness(dataset, densify_from_iter=2, densification_interval=4,
                          percent_dense=100.0, densify_grad_threshold=1e-9)
        logs = tloop.train(h, iterations=8, log_every=4, eval_every=0, steps_per_call=spc)
        runs.append((h, logs))
    (hc, lc), (hs, ls) = runs
    assert [(e["kind"], e["iteration"]) for e in hc.events if e["kind"] != "gt_cache"] == [
        (e["kind"], e["iteration"]) for e in hs.events if e["kind"] != "gt_cache"]
    assert any(e["kind"] == "densify" and e["cloned"] > 0 for e in hc.events)
    assert [r["loss"] for r in lc] == [r["loss"] for r in ls]
    assert hc.steps_by_size == hs.steps_by_size == {(fa.H, fa.W): 8}
    got, want = tckpt.flatten_state(hc.state), tckpt.flatten_state(hs.state)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------------------ the CLIs


def test_steps_per_call_reaches_train_from_both_clis(monkeypatch, tmp_path):
    from gaussianavatars_torch.tools import train as ttrain
    from gaussianavatars_torch.tools import train_synthetic as tsyn

    seen = []

    def fake_train(harness, **kw):
        seen.append(kw["steps_per_call"])
        return []

    harness = types.SimpleNamespace(start_iteration=1, live_tile_config=None)
    monkeypatch.setattr(ttrain, "build_harness", lambda *a, **k: harness)
    monkeypatch.setattr(ttrain, "train", fake_train)
    base = ["-s", str(tmp_path), "-m", str(tmp_path / "out"), "--device", "cpu", "--port", "0"]
    ttrain.main(base)
    ttrain.main(base + ["--steps_per_call", "7"])
    with pytest.raises(ValueError, match="steps_per_call"):
        ttrain.main(base + ["--steps_per_call", "0"])

    for name, value in (("build_reference_avatar", lambda a, d: (None, None, None)),
                        ("write_dataset", lambda a, *r: os.makedirs(a.workdir, exist_ok=True)),
                        ("synthetic_assets", lambda **k: None),
                        ("FlameModel", lambda *a, **k: None),
                        ("build_harness", lambda *a, **k: harness), ("train", fake_train),
                        ("make_render_fn", lambda *a: None),
                        ("evaluate_split", lambda *a, **k: {})):
        monkeypatch.setattr(tsyn, name, value)
    syn = ["--workdir", str(tmp_path / "syn"), "--device", "cpu"]
    tsyn.run(tsyn.parse_args(syn))
    tsyn.run(tsyn.parse_args(syn + ["--steps_per_call", "3"]))
    assert seen == [50, 7, 50, 3]
