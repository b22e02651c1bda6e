"""LPIPS: the port's `metrics/lpips.py` against the JAX package's on the
same weights, carried across by `convert.lpips_params_from_numpy`, for
both backbones, at rtol 1e-4 on three seeded 64×96 image pairs; one
weights file read by both packages; the torch-checkpoint conversion of
both; and `evaluate_split`'s `lpips` key with `$GSAVATARS_LPIPS_WEIGHTS`
set, at rtol 1e-4.

The weights are drawn with numpy at the shapes and scales of the JAX
`synthetic_lpips_params` (its shapes checked by `jax.eval_shape`): JAX's
own draw of VGG16's 14.7M weights takes ~11 s on the CPU.
"""
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu import config as jconfig
from gaussianavatars_tpu.training import checkpoint as jckpt
from gaussianavatars_tpu.training import loop as jloop
from gaussianavatars_torch import config as tconfig
from gaussianavatars_torch.convert import flame_assets_from_numpy, lpips_params_from_numpy
from gaussianavatars_torch.models.flame import flame_model as tfm
from gaussianavatars_torch.training import checkpoint as tckpt
from gaussianavatars_torch.training import loop as tloop
from torch_parity import write_jax_model_dir

# The modules (each package's `metrics` re-exports the function `lpips`).
jl = importlib.import_module("gaussianavatars_tpu.metrics.lpips")
tl = importlib.import_module("gaussianavatars_torch.metrics.lpips")
RTOL = 1e-4


def jax_leaves(p) -> dict:
    return {"conv_w": [np.asarray(w) for w in p.conv_w],
            "conv_b": [np.asarray(b) for b in p.conv_b],
            "lin_w": [np.asarray(w) for w in p.lin_w], "net_type": p.net_type}


def image_pairs(n=3, h=64, w=96):
    rng = np.random.RandomState(11)
    out = []
    for _ in range(n):
        a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        # A blurred, shifted copy plus noise: near, not identical.
        b = np.clip(0.5 * (a + np.roll(a, 3, axis=1)) + rng.normal(0, 0.05, a.shape), 0, 1)
        out.append((a, b.astype(np.float32)))
    return out


def numpy_lpips_params(net_type: str, seed: int):
    """JAX LpipsParams with `synthetic_lpips_params`' shapes and scales
    (N(0, 1/fan_in) convolutions, zero biases, U(0, 0.1) heads), drawn
    with numpy."""
    shapes = jax.eval_shape(lambda: jl.synthetic_lpips_params(jax.random.PRNGKey(0),
                                                              net_type))
    rng = np.random.RandomState(seed)
    conv_w = []
    for w in shapes.conv_w:
        kh, kw, cin, _cout = w.shape
        conv_w.append((rng.randn(*w.shape) / np.sqrt(kh * kw * cin)).astype(np.float32))
    conv_b = [np.zeros(b.shape, np.float32) for b in shapes.conv_b]
    lin_w = [rng.uniform(0, 0.1, w.shape).astype(np.float32) for w in shapes.lin_w]
    return jl.LpipsParams(tuple(map(jnp.asarray, conv_w)), tuple(map(jnp.asarray, conv_b)),
                          tuple(map(jnp.asarray, lin_w)), net_type)


@pytest.fixture(scope="module", params=["vgg", "alex"])
def both_params(request):
    jp = numpy_lpips_params(request.param, seed=4)
    return jp, lpips_params_from_numpy(jax_leaves(jp), device="cpu")


def test_lpips_matches_jax(both_params):
    jp, tp = both_params
    assert tp.net_type == jp.net_type
    for w_t, w_j in zip(tp.conv_w, jp.conv_w):
        assert tuple(w_t.shape) == tuple(np.transpose(np.asarray(w_j), (3, 2, 0, 1)).shape)
    vals = []
    for a, b in image_pairs():
        want = float(jl.lpips(jp, jnp.asarray(a), jnp.asarray(b)))
        got = float(tl.lpips(tp, torch.from_numpy(a), torch.from_numpy(b)))
        np.testing.assert_allclose(got, want, rtol=RTOL)
        vals.append(got)
    assert min(vals) > 1e-4
    a = torch.from_numpy(image_pairs(1)[0][0])
    assert abs(float(tl.lpips(tp, a, a))) < 1e-6


def test_feature_stages_match_jax(both_params):
    """Every stage's activations (the padding and pooling rules), not only
    the final sum."""
    jp, tp = both_params
    a = image_pairs(1)[0][0]
    jf = jax.jit(jl.alexnet_features if jp.net_type == "alex" else jl.vgg16_features)(
        jp, jnp.asarray(a))
    tf = (tl.alexnet_features if tp.net_type == "alex" else tl.vgg16_features)(
        tp, torch.from_numpy(a))
    assert len(tf) == len(jf)
    for f_t, f_j in zip(tf, jf):
        f_j = np.asarray(f_j)
        assert tuple(f_t.shape) == f_j.shape
        np.testing.assert_allclose(f_t.numpy(), f_j, rtol=RTOL, atol=RTOL * np.abs(f_j).max())


def test_weights_file_read_by_both(both_params, tmp_path):
    """A file in the shared layout, written by each package in turn, read by
    both to the same metric; the port's synthetic weights have the JAX
    package's shapes and properties."""
    jp, tp = both_params
    ref = {"net_type": np.array(jp.net_type)}
    for i, (w, b) in enumerate(zip(jp.conv_w, jp.conv_b)):
        ref[f"conv_w_{i}"], ref[f"conv_b_{i}"] = np.asarray(w), np.asarray(b)
    for i, w in enumerate(jp.lin_w):
        ref[f"lin_w_{i}"] = np.asarray(w)
    np.savez(tmp_path / "jax.npz", **ref)
    tl.save_lpips_weights(tp, str(tmp_path / "port.npz"))
    port_file = np.load(tmp_path / "port.npz")
    assert sorted(port_file.files) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(port_file[k], ref[k], err_msg=k)
    a, b = image_pairs(1)[0]
    want = float(jl.lpips(jl.load_lpips_weights(str(tmp_path / "port.npz")),
                          jnp.asarray(a), jnp.asarray(b)))
    got = float(tl.lpips(tl.load_lpips_weights(str(tmp_path / "jax.npz"), device="cpu"),
                         torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=RTOL)

    syn = tl.synthetic_lpips_params(torch.Generator().manual_seed(0), jp.net_type, device="cpu")
    for w_t, w_j in zip(syn.conv_w, jp.conv_w):
        assert tuple(w_t.shape) == tuple(np.transpose(np.asarray(w_j), (3, 2, 0, 1)).shape)
    assert [tuple(w.shape) for w in syn.lin_w] == [np.asarray(w).shape for w in jp.lin_w]
    x = torch.from_numpy(a).requires_grad_(True)
    tl.lpips(syn, x, torch.from_numpy(b)).backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


def test_convert_torch_weights_matches_jax(tmp_path):
    """The one-time conversion of torch checkpoints (torchvision backbone
    keys, richzhang head keys) gives the same file in both packages."""
    g = torch.Generator().manual_seed(2)
    sd, lin = {}, {}
    cin = 3
    for i, (cout, k, _s, _p) in enumerate(tl.ALEX_CONVS):
        idx = (0, 3, 6, 8, 10)[i]
        sd[f"features.{idx}.weight"] = torch.randn((cout, cin, k, k), generator=g)
        sd[f"features.{idx}.bias"] = torch.randn((cout,), generator=g)
        lin[f"lin{i}.model.1.weight"] = torch.randn((1, cout, 1, 1), generator=g)
        cin = cout
    torch.save(sd, tmp_path / "alex.pth")
    torch.save(lin, tmp_path / "lin.pth")
    tl.convert_torch_weights(str(tmp_path / "alex.pth"), str(tmp_path / "lin.pth"),
                             str(tmp_path / "port.npz"), "alex")
    jl.convert_torch_weights(str(tmp_path / "alex.pth"), str(tmp_path / "lin.pth"),
                             str(tmp_path / "jax.npz"), "alex")
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["lin_w_0"] >= 0).all()


@pytest.fixture(scope="module")
def harnesses(tmp_path_factory):
    """Both packages' harnesses on one JAX-written model directory's
    dataset, the port's state loaded from the JAX state."""
    root = tmp_path_factory.mktemp("lp")
    _dir, jmodel, assets, _p, _a = write_jax_model_dir(root / "ds", root / "model")
    tmodel = tfm.FlameModel(flame_assets_from_numpy(assets._asdict()),
                            tfm.FlameConfig(jmodel.cfg.n_shape, jmodel.cfg.n_expr,
                                            add_teeth=False), device="cpu")
    jcfg = jconfig.from_json(open(os.path.join(_dir, "cfg_args.json")).read())
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, model_path=""))
    jh = jloop.build_harness(jcfg, model=jmodel)
    th = tloop.build_harness(tconfig.from_json(jconfig.to_json(jcfg)), model=tmodel,
                             device="cpu")
    path = str(root / "state.npz")
    jckpt.save_train_state(path, jh.state, 0)
    th.state, _ = tckpt.load_train_state(path, th.state)
    return jh, th, jmodel, tmodel


def test_evaluate_split_reports_lpips(harnesses, monkeypatch, tmp_path):
    jh, th, jmodel, tmodel = harnesses
    p = numpy_lpips_params("alex", seed=1)
    d = {"net_type": np.array("alex")}
    for i, (w, b) in enumerate(zip(p.conv_w, p.conv_b)):
        d[f"conv_w_{i}"], d[f"conv_b_{i}"] = np.asarray(w), np.asarray(b)
    for i, w in enumerate(p.lin_w):
        d[f"lin_w_{i}"] = np.asarray(w)
    np.savez(tmp_path / "w.npz", **d)
    monkeypatch.setenv("GSAVATARS_LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    jloop._eval_lpips_params.cache_clear()
    tloop._eval_lpips_params.cache_clear()
    try:
        jm = jloop.evaluate_split(jh, "val", jloop.make_render_fn(
            jmodel, jh.cfg, jloop.tile_config(jh.cfg)), sh_degree=3, max_views=1)
        tm = tloop.evaluate_split(th, "val", tloop.make_render_fn(
            tmodel, th.cfg, tloop.tile_config(th.cfg)), sh_degree=3, max_views=1)
    finally:
        jloop._eval_lpips_params.cache_clear()
        tloop._eval_lpips_params.cache_clear()
    assert "lpips" in jm and "lpips" in tm and tm["lpips"] > 0
    for k in ("psnr", "ssim", "lpips"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, err_msg=k)
    monkeypatch.delenv("GSAVATARS_LPIPS_WEIGHTS")
    assert "lpips" not in tloop.evaluate_split(th, "val", tloop.make_render_fn(
        tmodel, th.cfg, tloop.tile_config(th.cfg)), sh_degree=3, max_views=1)
