"""The real-FLAME import and the FLAME forward's flags: port vs JAX.

A FLAME-2023-shaped pickle is written with numpy from a seed on a mesh
with FLAME's vertex count (the UV sphere of `synthetic_assets`, so the
teeth can be built): 300 + 6 shape/expression columns, `posedirs`
[V, 3, 36], a `kintree_table`, a masks pickle with FLAME_masks.pkl's part
names and a landmark embedding. It comes in the dict form with a
scipy-sparse `J_regressor` and float64 arrays, and in the object form
with chumpy-style `.r` holders, float32 arrays and a dense regressor.

Both packages' `convert_flame_pickle` must write the same keys and
array-equal contents. The JAX model loads the port's npz and the port's
model JAX's: `forward` with every combination of its three return flags
agrees within 1e-5, with and without teeth.
"""
import functools
import itertools
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse

from gaussianavatars_tpu.models.flame import assets as jassets
from gaussianavatars_tpu.models.flame import flame_model as jfm
from gaussianavatars_torch.convert import flame_params_from_numpy
from gaussianavatars_torch.models.flame import assets as tassets
from gaussianavatars_torch.models.flame import flame_model as tfm
from gaussianavatars_torch.models.flame.topology import NUM_VERTS

from torch_parity import n

ATOL = 1e-5
N_SHAPE, N_EXPR = 10, 6
N_LMK = 68
FORMS = ("dict_sparse", "object_dense")
# FLAME_masks.pkl's part names.
PARTS = ("eye_region", "neck", "left_eyeball", "right_eyeball", "right_ear", "left_ear",
         "forehead", "lips", "nose", "scalp", "boundary", "face", "left_eye_region",
         "right_eye_region")
FLAGS = list(itertools.product((False, True), repeat=3))


class Chumpy:
    """Holds an array in `.r`, as the chumpy objects of a FLAME pickle do."""

    def __init__(self, r):
        self.r = r


class FlamePickle:
    """The object form: the model's arrays as attributes."""

    def __init__(self, **arrays):
        self.__dict__.update(arrays)


def write_obj(path: str, verts, uvs, faces, faces_uv) -> None:
    with open(path, "w") as f:
        f.writelines(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in verts)
        f.writelines(f"vt {u:.9g} {v:.9g}\n" for u, v in uvs)
        f.writelines(f"f {a + 1}/{ta + 1} {b + 1}/{tb + 1} {c + 1}/{tc + 1}\n"
                     for (a, b, c), (ta, tb, tc) in zip(faces, faces_uv))


@pytest.fixture(scope="module")
def flame_files(tmp_path_factory):
    """{form: (pickle, obj, masks, landmark embedding)} and the arrays written."""
    root = tmp_path_factory.mktemp("flame_import")
    verts, uvs, faces, faces_uv = tassets._uv_sphere(NUM_VERTS)
    obj = str(root / "head_template_mesh.obj")
    write_obj(obj, verts, uvs, faces, faces_uv)
    v = verts.shape[0]
    rng = np.random.default_rng(0)
    # A sparse regressor: 24 vertices a joint, rows summing to 1.
    jreg = np.zeros((5, v))
    for j in range(5):
        cols = rng.choice(v, 24, replace=False)
        jreg[j, cols] = rng.uniform(0.1, 1.0, 24)
    jreg /= jreg.sum(1, keepdims=True)
    weights = rng.uniform(0.0, 1.0, (v, 5))
    arrays = {
        "v_template": verts.astype(np.float64) + rng.normal(size=(v, 3)) * 1e-3,
        # 300 shape then 100 expression columns in the real file; the
        # converter reads [:n_shape] and [300:300 + n_expr].
        "shapedirs": rng.normal(size=(v, 3, 300 + N_EXPR)) * 1e-3,
        "posedirs": rng.normal(size=(v, 3, 36)) * 1e-4,
        "J_regressor": jreg,
        "kintree_table": np.array([[4294967295, 0, 1, 1, 1], [0, 1, 2, 3, 4]], np.int64),
        "weights": weights / weights.sum(1, keepdims=True),
        "f": faces.astype(np.uint32),
    }
    masks = {k: np.sort(rng.choice(v, 40 + 5 * i, replace=False))
             for i, k in enumerate(PARTS)}
    masks_pkl = str(root / "FLAME_masks.pkl")
    with open(masks_pkl, "wb") as f:
        pickle.dump(masks, f)
    emb = {"full_lmk_faces_idx": rng.integers(0, faces.shape[0], (1, N_LMK)),
           "full_lmk_bary_coords": rng.dirichlet(np.ones(3), (1, N_LMK))}
    lmk = str(root / "landmark_embedding.npy")
    np.save(lmk, emb, allow_pickle=True)

    files = {}
    for form in FORMS:
        pkl = str(root / f"flame2023_{form}.pkl")
        if form == "dict_sparse":
            model = dict(arrays, J_regressor=scipy.sparse.csc_matrix(arrays["J_regressor"]))
        else:
            model = FlamePickle(**{k: a if k in ("kintree_table", "f", "J_regressor")
                                   else Chumpy(a.astype(np.float32))
                                   for k, a in arrays.items()})
        with open(pkl, "wb") as f:
            pickle.dump(model, f, protocol=2)
        files[form] = (pkl, obj, masks_pkl, lmk)
    return files, arrays, masks, emb, (uvs, faces, faces_uv)


@functools.lru_cache(maxsize=None)
def _converted(files_key, form: str, out_dir: str) -> tuple:
    """(port npz, JAX npz) of one form, converted once a module."""
    pkl, obj, masks_pkl, lmk = files_key
    kw = dict(masks_pkl=masks_pkl, lmk_embedding_npy=lmk, n_shape=N_SHAPE, n_expr=N_EXPR)
    t_npz = tassets.convert_flame_pickle(pkl, obj, os.path.join(out_dir, f"port_{form}.npz"),
                                         **kw)
    j_npz = jassets.convert_flame_pickle(pkl, obj, os.path.join(out_dir, f"jax_{form}.npz"),
                                         **kw)
    return t_npz, j_npz


def _npz(flame_files, form):
    files = flame_files[0][form]
    return _converted(files, form, os.path.dirname(files[0]))


@pytest.mark.parametrize("form", FORMS)
def test_convert_flame_pickle_matches_jax(flame_files, form):
    t_npz, j_npz = _npz(flame_files, form)
    got, want = np.load(t_npz), np.load(j_npz)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # What was written comes back through the port's loader.
    _files, arrays, masks, emb, (uvs, faces, faces_uv) = flame_files
    a = tassets.load_assets(t_npz)
    f32 = np.float32
    np.testing.assert_array_equal(a.v_template, arrays["v_template"].astype(f32))
    sd = arrays["shapedirs"].astype(f32)
    np.testing.assert_array_equal(a.shapedirs, np.concatenate([sd[..., :N_SHAPE], sd[..., 300:]],
                                                              axis=2))
    np.testing.assert_array_equal(a.posedirs, arrays["posedirs"].astype(f32)
                                  .reshape(-1, 36).T)
    np.testing.assert_array_equal(a.j_regressor, arrays["J_regressor"].astype(f32))
    np.testing.assert_array_equal(a.parents, [-1, 0, 1, 1, 1])
    np.testing.assert_array_equal(a.lbs_weights, arrays["weights"].astype(f32))
    np.testing.assert_array_equal(a.faces, faces)
    np.testing.assert_array_equal(a.verts_uvs, uvs)
    np.testing.assert_array_equal(a.faces_uv, faces_uv)
    np.testing.assert_array_equal(a.lmk_faces_idx, emb["full_lmk_faces_idx"][0])
    np.testing.assert_array_equal(a.lmk_bary_coords,
                                  emb["full_lmk_bary_coords"][0].astype(f32))
    assert a.n_shape == N_SHAPE
    for k, m in masks.items():
        np.testing.assert_array_equal(a.vertex_masks[k], m, err_msg=k)
    # The regions built from the parts (`regions.combine_with_parts`).
    assert {"ears", "eyeballs", "left_eye", "right_eye", "hair", "sclerae",
            "skin"} <= set(a.vertex_masks)


@functools.lru_cache(maxsize=None)
def _models(t_npz: str, j_npz: str, teeth: bool) -> tuple:
    """The JAX model on the port's npz and the port's model on JAX's."""
    cfg = dict(n_shape=N_SHAPE, n_expr=N_EXPR, add_teeth=teeth)
    jm = jfm.FlameModel(jassets.load_assets(t_npz), jfm.FlameConfig(**cfg))
    tm = tfm.FlameModel(tassets.load_assets(j_npz), tfm.FlameConfig(**cfg), device="cpu")
    return jm, tm


def _params(batch: int = 3, seed: int = 4) -> dict:
    rng = np.random.RandomState(seed)
    r = lambda *s, scale=0.2: (rng.randn(*s) * scale).astype(np.float32)  # noqa: E731
    return {"shape": r(N_SHAPE, scale=1.0), "expr": r(batch, N_EXPR, scale=1.0),
            "rotation": r(batch, 3), "neck": r(batch, 3), "jaw": r(batch, 3),
            "eyes": r(batch, 6), "translation": r(batch, 3, scale=0.05),
            "static_offset": None, "dynamic_offset": None}


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "".join("01"[b] for b in f))
@pytest.mark.parametrize("teeth", (True, False), ids=("teeth", "no_teeth"))
def test_flame_forward_flags_match_jax(flame_files, teeth, flags):
    """flags: (return_verts_cano, return_landmarks, zero_centered_at_root_node).
    On the dict form's npz files (the object form's are array-equal to them,
    `test_convert_flame_pickle_matches_jax`)."""
    jm, tm = _models(*_npz(flame_files, "dict_sparse"), teeth)
    assert tm.num_verts == NUM_VERTS + (120 if teeth else 0)
    d = _params()
    kw = dict(zip(("return_verts_cano", "return_landmarks", "zero_centered_at_root_node"),
                  flags))
    want = jm.forward(jfm.FlameParams(**{k: None if v is None else jnp.asarray(v)
                                         for k, v in d.items()}), **kw)
    got = tm(flame_params_from_numpy(d, device="cpu"), **kw)
    n_out = 1 + flags[0] + flags[1]
    if n_out == 1:
        want, got = (want,), (got,)
    assert isinstance(got, tuple) and len(got) == len(want) == n_out
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(n(g), np.asarray(w), atol=ATOL, err_msg=f"output {i}")
    if flags[1]:
        assert tuple(got[-1].shape) == (3, N_LMK, 3)
    # The new flags leave the default path's vertices bit for bit alone.
    if not flags[2]:
        np.testing.assert_array_equal(n(got[0]), n(tm(flame_params_from_numpy(d, device="cpu"))))


def test_bootstrap_template_env(tmp_path, monkeypatch):
    """Sets $GSAVATARS_FLAME_TEMPLATE to the reference checkout's template
    when that exists and the variable is unset, and nothing else."""
    obj = tmp_path / "head_template_mesh.obj"
    # setenv first, so that the variable is restored (or removed) after the
    # test even though bootstrap_template_env sets it behind monkeypatch.
    monkeypatch.setenv("GSAVATARS_FLAME_TEMPLATE", "")
    monkeypatch.delenv("GSAVATARS_FLAME_TEMPLATE")
    monkeypatch.setattr(tassets, "REFERENCE_TEMPLATE", str(obj))
    tassets.bootstrap_template_env()
    assert "GSAVATARS_FLAME_TEMPLATE" not in os.environ
    obj.write_text("v 0 0 0\n")
    tassets.bootstrap_template_env()
    assert os.environ["GSAVATARS_FLAME_TEMPLATE"] == str(obj)
    assert tassets.default_template_path() == str(obj)
    monkeypatch.setenv("GSAVATARS_FLAME_TEMPLATE", "elsewhere.obj")
    tassets.bootstrap_template_env()
    assert os.environ["GSAVATARS_FLAME_TEMPLATE"] == "elsewhere.obj"
