"""The port's densification events and the loop's tier-budget growth
against the JAX package.

`densify_and_prune` gets JAX's own split draws (the two
`jax.random.normal` of the key it is handed) as `noise`. Inputs are
numpy-seeded states whose decision values (mean gradient against the
threshold, largest world scale against percent_dense · extent) sit well
away from the thresholds, so no decision flips on a last-bit difference.
`alive`, `binding` and the report must be exact; parameters and Adam
moments within atol 1e-6 (the split's child means are a 3×3 rotation
times the draws, summed in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.models import densify as jd
from gaussianavatars_tpu.models import gaussians as jg
from gaussianavatars_tpu.ops.rasterize_tiled import TileConfig as JTileConfig
from gaussianavatars_tpu.training import loop as jloop
from gaussianavatars_torch.models import densify as td
from gaussianavatars_torch.models import gaussians as tg
from gaussianavatars_torch.ops.rasterize_tiled import TileConfig
from gaussianavatars_torch.training import loop as tloop

PARAM_KEYS = ("means", "log_scales", "quats", "sh_dc", "sh_rest", "logit_opacity")
AUX_KEYS = ("alive", "binding", "grad_accum", "denom", "max_radii2d")
EXTENT = 2.0


def _state(seed, cap, n_alive, n_faces, with_frames, prune_faces=0):
    """A random padded state as numpy dicts: params, aux, mu, nu, frames."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    thr = 0.0002
    # Local scales: half clearly small (clone candidates), half large.
    small = rng.rand(cap) < 0.5
    log_scales = np.where(small[:, None], np.log(rng.uniform(0.001, 0.004, (cap, 3))),
                          np.log(rng.uniform(0.05, 0.15, (cap, 3)))).astype(f32)
    params = {
        "means": rng.randn(cap, 3).astype(f32) * 0.1,
        "log_scales": log_scales,
        "quats": rng.randn(cap, 4).astype(f32),
        "sh_dc": rng.randn(cap, 1, 3).astype(f32),
        "sh_rest": rng.randn(cap, 15, 3).astype(f32) * 0.1,
        "logit_opacity": np.where(rng.rand(cap, 1) < 0.05, -8.0,
                                  rng.uniform(-2, 3, (cap, 1))).astype(f32),
    }
    denom = rng.randint(0, 6, cap).astype(f32)
    hot = rng.rand(cap) < 0.4
    mean_grad = np.where(hot, thr * rng.uniform(2.0, 5.0, cap), thr * rng.uniform(0.0, 0.5, cap))
    aux = {
        "alive": np.arange(cap) < n_alive,
        "binding": rng.randint(0, n_faces, cap).astype(np.int32),
        "grad_accum": (mean_grad * denom).astype(f32),
        "denom": denom,
        "max_radii2d": rng.uniform(0, 30, cap).astype(f32),
    }
    if prune_faces:
        # Every Gaussian of the first faces is transparent: the face-keeping
        # rule must keep their prunes.
        aux["binding"][:n_alive] = np.arange(n_alive) % n_faces
        low = np.isin(aux["binding"], np.arange(prune_faces))
        params["logit_opacity"][low] = -8.0
    mu = {k: rng.randn(*v.shape).astype(f32) * 1e-3 for k, v in params.items()}
    nu = {k: rng.uniform(0, 1e-5, v.shape).astype(f32) for k, v in params.items()}
    frames = None
    if with_frames:
        q = rng.randn(n_faces, 4).astype(f32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        frames = {
            "center": rng.randn(n_faces, 3).astype(f32),
            "orien_mat": np.tile(np.eye(3, dtype=f32), (n_faces, 1, 1)),
            "orien_quat": q,
            "scaling": rng.uniform(0.5, 1.5, (n_faces, 1)).astype(f32),
        }
    return params, aux, mu, nu, frames


CASES = {
    # name: (seed, cap, n_alive, n_faces, frames, max_screen_size, prune_faces)
    "clone_split_prune_bound": (0, 512, 200, 40, True, 20.0, 0),
    "unbound_no_screen_prune": (1, 512, 180, 1, False, 0.0, 0),
    "face_keeping": (2, 384, 160, 32, True, 20.0, 6),
    "capacity_exhausted": (3, 256, 236, 30, True, 20.0, 0),
}


def _jax_in(d, cls):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def _torch_in(d, cls):
    return cls(**{k: torch.as_tensor(np.array(v)) for k, v in d.items()})


@pytest.mark.parametrize("case", sorted(CASES))
def test_densify_and_prune_matches_jax(case):
    seed, cap, n_alive, n_faces, with_frames, max_screen, prune_faces = CASES[case]
    params, aux, mu, nu, frames = _state(seed, cap, n_alive, n_faces, with_frames, prune_faces)
    cfg_kw = dict(grad_threshold=0.0002, percent_dense=0.01, min_opacity=0.005,
                  max_screen_size=max_screen)
    key = jax.random.PRNGKey(seed + 100)
    jout = jd.densify_and_prune(
        _jax_in(params, jg.GaussianParams), _jax_in(aux, jg.GaussianAux),
        _jax_in(mu, jg.GaussianParams), _jax_in(nu, jg.GaussianParams), key,
        extent=EXTENT, cfg=jd.DensifyConfig(**cfg_kw),
        frames=None if frames is None else jg.FaceFrames(**{k: jnp.asarray(v)
                                                            for k, v in frames.items()}))
    k1, k2 = jax.random.split(key)
    noise = tuple(torch.as_tensor(np.array(jax.random.normal(k, (cap, 3)))) for k in (k1, k2))
    taux = dict(aux, binding=aux["binding"].astype(np.int64))
    tout = td.densify_and_prune(
        _torch_in(params, tg.GaussianParams), _torch_in(taux, tg.GaussianAux),
        _torch_in(mu, tg.GaussianParams), _torch_in(nu, tg.GaussianParams),
        extent=EXTENT, cfg=td.DensifyConfig(**cfg_kw),
        frames=None if frames is None else tg.FaceFrames(**{k: torch.as_tensor(v)
                                                            for k, v in frames.items()}),
        noise=noise)
    jp, ja, jmu, jnu, jrep = jout
    tp, ta, tmu, tnu, trep = tout
    report = {k: int(v) for k, v in trep._asdict().items()}
    assert report == {k: int(v) for k, v in jrep._asdict().items()}
    assert report["cloned"] > 0 and report["pruned"] > 0
    if case == "capacity_exhausted":
        # The clones take every free slot; the split requests are dropped.
        assert report["dropped"] > 0 and report["split"] == 0
    else:
        assert report["dropped"] == 0 and report["split"] > 0
    for k in ("alive", "binding"):
        np.testing.assert_array_equal(getattr(ta, k).numpy(), np.asarray(getattr(ja, k)),
                                      err_msg=k)
    for k in ("grad_accum", "denom", "max_radii2d"):
        assert not getattr(ta, k).any()
    for name, (t_obj, j_obj) in {"params": (tp, jp), "mu": (tmu, jmu), "nu": (tnu, jnu)}.items():
        for k in PARAM_KEYS:
            np.testing.assert_allclose(getattr(t_obj, k).numpy(), np.asarray(getattr(j_obj, k)),
                                       atol=1e-6, rtol=0, err_msg=f"{name}.{k}")
    if case == "face_keeping":
        # The transparent faces kept their Gaussians; JAX agrees (above).
        kept = np.isin(taux["binding"][:n_alive], np.arange(prune_faces))
        assert ta.alive.numpy()[:n_alive][kept].all()


def test_reset_opacity_and_grow_capacity_match_jax():
    params, aux, mu, nu, _ = _state(5, 256, 100, 10, False)
    jp, jmu, jnu = jd.reset_opacity(_jax_in(params, jg.GaussianParams),
                                    _jax_in(mu, jg.GaussianParams), _jax_in(nu, jg.GaussianParams))
    tp, tmu, tnu = td.reset_opacity(_torch_in(params, tg.GaussianParams),
                                    _torch_in(mu, tg.GaussianParams),
                                    _torch_in(nu, tg.GaussianParams))
    np.testing.assert_allclose(tp.logit_opacity.numpy(), np.asarray(jp.logit_opacity),
                               rtol=1e-6, atol=1e-6)
    assert not tmu.logit_opacity.any() and not tnu.logit_opacity.any()
    np.testing.assert_array_equal(tmu.means.numpy(), mu["means"])

    taux = dict(aux, binding=aux["binding"].astype(np.int64))
    jout = jd.grow_capacity(_jax_in(params, jg.GaussianParams), _jax_in(aux, jg.GaussianAux),
                            _jax_in(mu, jg.GaussianParams), _jax_in(nu, jg.GaussianParams), 384)
    tout = td.grow_capacity(_torch_in(params, tg.GaussianParams), _torch_in(taux, tg.GaussianAux),
                            _torch_in(mu, tg.GaussianParams), _torch_in(nu, tg.GaussianParams),
                            384)
    for t_obj, j_obj in zip(tout, jout):
        for f in dataclasses.fields(t_obj):
            np.testing.assert_array_equal(getattr(t_obj, f.name).numpy(),
                                          np.asarray(getattr(j_obj, f.name)), err_msg=f.name)
    assert tout[0].capacity == 384 and int(tg.num_alive(tout[1])) == 100
    same = td.grow_capacity(*tout, 128)
    assert same[0] is tout[0]


@pytest.mark.parametrize("budget_overflow,max_footprint,n_gauss,tiers", [
    (0, 0, 1024, ()),
    (5, 40, 1024, ()),
    (3, 90, 20000, ((2048, 8), (512, 24))),
    (1, 10, 300, ((128, 8),)),
])
def test_grow_tile_budgets_matches_jax(budget_overflow, max_footprint, n_gauss, tiers):
    j = jloop._grow_tile_budgets(JTileConfig(tile_h=32, tile_w=32, tiers=tiers), 0,
                                 budget_overflow, verbose=False, max_footprint=max_footprint,
                                 n_gauss=n_gauss, sorted_mode=True)
    t = tloop._grow_tile_budgets(TileConfig(tile_h=32, tile_w=32, tiers=tiers), 0,
                                 budget_overflow, verbose=False, max_footprint=max_footprint,
                                 n_gauss=n_gauss, sorted_mode=True)
    if j is None:
        assert t is None
    else:
        assert (t.base_budget, tuple(t.tiers)) == (j.base_budget, tuple(j.tiers))
