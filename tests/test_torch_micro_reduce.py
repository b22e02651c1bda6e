"""The port's micro-reduce formulations against the JAX package's Pallas
kernels (`scripts/micro_reduce_bench.py`), which run here in interpret
mode at NT = 2 tiles.

Both packages get the same numpy input. Tolerance: relative 1e-5 per slot.
The four formulations sum 9 × 1024 float32 values in different orders
(JAX's run at <= 2.5e-6 relative to 46,080·x), so their roundings differ.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gaussianavatars_torch.tools import micro_reduce_bench as tmr

NT_TEST = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_bench():
    path = os.path.join(REPO, "scripts", "micro_reduce_bench.py")
    spec = importlib.util.spec_from_file_location("micro_reduce_bench_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def x_np():
    return np.random.RandomState(0).uniform(0.0, 1.0, (NT_TEST, tmr.C, 1)).astype(np.float32)


def _jax_kernel(mod, kern, x):
    call = pl.pallas_call(
        kern,
        grid=(x.shape[0],),
        in_specs=[pl.BlockSpec((1, mod.C, 1), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, mod.C, 1), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["a", "b", "c", "d"])
def test_plain_formulation_matches_jax_kernel(jax_bench, x_np, name):
    assert (tmr.NT, tmr.C, tmr.K, tmr.ROWS, tmr.LANES, tmr.NRED) == (
        jax_bench.NT, jax_bench.C, jax_bench.K, jax_bench.ROWS, jax_bench.LANES,
        jax_bench.NRED)
    want = _jax_kernel(jax_bench, getattr(jax_bench, f"kern_{name}"), x_np)
    x = torch.as_tensor(x_np)
    got = getattr(tmr, f"kern_{name}")(x).numpy()   # CPU tensor: the plain version
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, 46080.0 * x_np, rtol=1e-5, atol=0)
    assert tmr.LAUNCHES[f"micro_reduce_{name}"] == 0


def test_entry_point_on_cpu_and_without_a_card():
    out = tmr.main(["--device", "cpu", "--nt", "2", "--iters", "1"])
    assert out["device"] == "cpu"
    for name in "abcd":
        assert out[name]["max_rel_err_vs_46080x"] <= 1e-5 and out[name]["launches"] == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmr.main(["--nt", "2"])
    with pytest.raises(ValueError):
        tmr.reduce_slots("e", torch.zeros((2, tmr.C, 1)))
    with pytest.raises(ValueError):
        tmr.reduce_slots("a", torch.zeros((2, tmr.C)))
