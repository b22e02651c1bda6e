"""PyTorch port vs JAX: FLAME assets, teeth, forward, binding frames and
world Gaussians.

Asset arrays are numpy on both sides and must be identical. Tensor outputs
are float32 at atol 1e-5: the same formulas in two frameworks may differ in
rounding (matmul order, fused multiply-adds), far below 1e-5 for vertex
coordinates of about 0.1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussianavatars_tpu.models import binding as jbind
from gaussianavatars_tpu.models import gaussians as jg
from gaussianavatars_tpu.models.flame import assets as jassets
from gaussianavatars_tpu.models.flame import flame_model as jfm
from gaussianavatars_torch.convert import (
    flame_assets_from_numpy, flame_params_from_numpy, gaussian_state_from_numpy,
)
from gaussianavatars_torch.models import binding as tbind
from gaussianavatars_torch.models import gaussians as tg
from gaussianavatars_torch.models.flame import assets as tassets
from gaussianavatars_torch.models.flame import flame_model as tfm

from torch_parity import dataclass_dict, n, t

ATOL = 1e-5
N_SHAPE, N_EXPR = 10, 6


def _assert_assets_equal(a, b):
    for name in a._fields:
        va, vb = getattr(a, name), getattr(b, name)
        if name == "vertex_masks":
            assert sorted(va) == sorted(vb)
            for k in va:
                np.testing.assert_array_equal(va[k], vb[k], err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=name)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_assets_identical(seed):
    a = tassets.synthetic_assets(N_SHAPE, N_EXPR, seed=seed)
    b = jassets.synthetic_assets(N_SHAPE, N_EXPR, seed=seed)
    _assert_assets_equal(a, b)
    assert a.num_verts == 5023


def test_teeth_build_identical():
    assets = tassets.synthetic_assets(N_SHAPE, N_EXPR, seed=1)
    a, masks_a = tfm._build_teeth(assets)
    b, masks_b = jfm._build_teeth(jassets.synthetic_assets(N_SHAPE, N_EXPR, seed=1))
    assert (a.num_verts, a.num_faces) == (b.num_verts, b.num_faces) == (5143, 10010)
    _assert_assets_equal(a, b)
    assert sorted(masks_a) == sorted(masks_b)


def _models(seed=2):
    assets = jassets.synthetic_assets(N_SHAPE, N_EXPR, seed=seed)
    cfg = jfm.FlameConfig(n_shape=N_SHAPE, n_expr=N_EXPR, add_teeth=True)
    jm = jfm.FlameModel(assets, cfg)
    tm = tfm.FlameModel(
        flame_assets_from_numpy(assets._asdict()),
        tfm.FlameConfig(n_shape=N_SHAPE, n_expr=N_EXPR, add_teeth=True), device="cpu")
    return jm, tm


def _np_flame_params(seed, batch=2, num_verts=0):
    rng = np.random.RandomState(seed)
    r = lambda *s, scale=0.2: (rng.randn(*s) * scale).astype(np.float32)  # noqa: E731
    return {
        "shape": r(N_SHAPE, scale=1.0), "expr": r(batch, N_EXPR, scale=1.0),
        "rotation": r(batch, 3), "neck": r(batch, 3), "jaw": r(batch, 3),
        "eyes": r(batch, 6), "translation": r(batch, 3, scale=0.05),
        "static_offset": r(num_verts, 3, scale=1e-3) if num_verts else None,
        "dynamic_offset": None,
    }


@pytest.mark.parametrize("seed,static", [(0, False), (1, True)])
def test_flame_forward(seed, static):
    jm, tm = _models()
    d = _np_flame_params(seed, num_verts=jm.num_verts if static else 0)
    ref = jm.forward(jfm.FlameParams(**{k: None if v is None else jnp.asarray(v)
                                        for k, v in d.items()}))
    out = tm(flame_params_from_numpy(d, device="cpu"))
    assert tuple(out.shape) == (2, 5143, 3)
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=ATOL)


def test_face_frames_and_world_gaussians():
    jm, tm = _models()
    d = _np_flame_params(4, batch=1)
    verts = np.asarray(jm.forward(jfm.FlameParams(**{
        k: None if v is None else jnp.asarray(v) for k, v in d.items()})))[0]
    fr_j = jbind.face_frames(jnp.asarray(verts), jm.faces)
    fr_t = tbind.face_frames(t(verts), tm.faces)
    for name in fr_j._fields:
        np.testing.assert_allclose(n(getattr(fr_t, name)), np.asarray(getattr(fr_j, name)),
                                   atol=ATOL, err_msg=name)

    # Bound Gaussians with non-trivial local state, carried across as numpy.
    pj, aj = jg.init_bound(jm.num_faces, 20224, jax.random.PRNGKey(0), per_face=2)
    rng = np.random.RandomState(5)
    pd = dataclass_dict(pj)
    pd["means"] = (rng.randn(*pd["means"].shape) * 0.1).astype(np.float32)
    pd["log_scales"] = np.log(rng.uniform(0.25, 0.7, pd["log_scales"].shape)).astype(np.float32)
    pd["quats"] = rng.randn(*pd["quats"].shape).astype(np.float32)
    pd["sh_rest"] = (rng.randn(*pd["sh_rest"].shape) * 0.1).astype(np.float32)
    pj = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in pd.items()})
    pt, at = gaussian_state_from_numpy(pd, dataclass_dict(aj), device="cpu")
    wj = jg.world_gaussians(pj, aj, fr_j)
    wt = tg.world_gaussians(pt, at, fr_t)
    for name in wj._fields:
        np.testing.assert_allclose(n(getattr(wt, name)), np.asarray(getattr(wj, name)),
                                   atol=ATOL, err_msg=name)


def test_init_bound_layout():
    import torch

    pt, at = tg.init_bound(100, 384, torch.Generator().manual_seed(0), per_face=3,
                           device="cpu")
    pj, aj = jg.init_bound(100, 384, jax.random.PRNGKey(0), per_face=3)
    # Colours come from different generators; everything else is identical.
    for name in ("means", "log_scales", "quats", "sh_rest", "logit_opacity"):
        np.testing.assert_allclose(n(getattr(pt, name)), np.asarray(getattr(pj, name)),
                                   atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(n(at.alive), np.asarray(aj.alive))
    np.testing.assert_array_equal(n(at.binding), np.asarray(aj.binding))
    rgb = n(pt.sh_dc)[:, 0] * 0.28209479177387814 + 0.5
    assert rgb.min() >= -1e-6 and rgb.max() <= 1 + 1e-6
    with pytest.raises(ValueError):
        tg.init_bound(100, 128, torch.Generator(), per_face=3, device="cpu")
