"""The port's backward pair compositor and expansion reduction against the
JAX package's.

The plain PyTorch backward (what `bwd_call_pairs` runs on CPU tensors) and
the JAX `bwd_call_pairs` (its Pallas kernel in interpret mode) get the same
forward table, the same forward outputs and the same cotangents drawn from
a numpy seed, on the four tables of `test_torch_composite.py`.

Tolerances: rows 0..8 at atol/rtol 2e-4 (the Pallas kernel sums each
64-slot group's moments as one dot product, the port pixel by pixel, so
the float32 sums round differently). Rows 9..15, and every slot the walk
never reaches, are exact zeros in both. `reduce_expansion` adds the same
slices in the same order as the JAX function, so it is compared exactly.

The CUDA kernel itself is compared with this plain version on the card
(`tests/test_torch_gpu.py` and `chip_smoke.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.ops import sort_binning as jsb
from gaussianavatars_tpu.ops.pallas import composite_pairs as jcp
from gaussianavatars_torch.ops import composite_pairs as tcp
from gaussianavatars_torch.ops import sort_binning as tsb

from test_torch_composite import CASES, _table
from torch_parity import TILE_H, TILE_W, n, t

TOL = 2e-4


def _bwd_inputs(case, seed=5):
    dataT, starts, counts, ntx = _table(case)
    acc, tfin, stop = jcp.fwd_call_pairs(
        jnp.asarray(dataT), jnp.asarray(starts), jnp.asarray(counts), TILE_H, TILE_W, ntx)
    rng = np.random.RandomState(seed)
    nt, p = starts.shape[0], TILE_H * TILE_W
    g_acc_t = rng.randn(nt, p, 3).astype(np.float32)
    g_t = rng.randn(nt, p).astype(np.float32)
    arrays = (dataT, starts, counts, np.asarray(acc), np.asarray(tfin), np.asarray(stop),
              g_acc_t, g_t)
    return arrays, ntx


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_pallas(case):
    arrays, ntx = _bwd_inputs(case)
    dataT, starts, counts, _acc, _tfin, stop = arrays[:6]
    d_j = np.asarray(jcp.bwd_call_pairs(*(jnp.asarray(a) for a in arrays),
                                        TILE_H, TILE_W, ntx))
    d_t = n(tcp.bwd_call_pairs(*(t(a) for a in arrays), TILE_H, TILE_W, ntx))
    assert d_t.shape == dataT.shape and d_t.dtype == np.float32
    np.testing.assert_allclose(d_t[:9], d_j[:9], atol=TOL, rtol=TOL)
    assert not d_t[9:].any() and not d_j[9:].any()

    # Slots outside every walked window [start, start + needed) are exact
    # zeros in both.
    head = starts % 128
    needed = np.minimum(counts, stop.max(axis=1).astype(np.int64) - head + 1)
    walked = np.zeros(dataT.shape[1], bool)
    for s0, k in zip(starts, needed):
        walked[s0:s0 + max(int(k), 0)] = True
    assert not d_t[:, ~walked].any() and not d_j[:, ~walked].any()
    assert d_t[:9, walked].any()


def test_reduce_expansion_matches_jax_exactly():
    rng = np.random.RandomState(0)
    n_g = 512
    spec = tsb.TierSpec(base=2, tiers=((256, 5), (128, 9)))
    jspec = jsb.TierSpec(base=2, tiers=((256, 5), (128, 9)))
    m = spec.expansion_size(n_g)
    cols = rng.randn(9, m).astype(np.float32)
    got = n(tsb.reduce_expansion(t(cols), n_g, spec))
    want = np.stack([np.asarray(x) for x in
                     jsb.reduce_expansion([jnp.asarray(c) for c in cols], n_g, jspec)])
    assert got.shape == (9, n_g)
    np.testing.assert_array_equal(got, want)


def test_amp_raises_and_checks_inputs():
    """`amp=True` (the bf16 contraction) is ported: it holds against the JAX
    kernel's `amp` output within 1e-3 of each row's largest value (the bound
    of `test_torch_composite_variants.py`, which gives its reason). Bad
    inputs raise."""
    arrays, ntx = _bwd_inputs("unaligned_starts")
    ts = [t(a) for a in arrays]
    d_amp = n(tcp.bwd_call_pairs(*ts, TILE_H, TILE_W, ntx, amp=True))
    d_j = np.asarray(jcp.bwd_call_pairs(*(jnp.asarray(a) for a in arrays),
                                        TILE_H, TILE_W, ntx, amp=True))
    rel = np.abs(d_amp[:9] - d_j[:9]).max(axis=1) / np.abs(d_j[:9]).max(axis=1)
    assert (rel <= 1e-3).all(), rel
    bad = list(ts)
    bad[6] = ts[6].transpose(1, 2)          # g_acc in [NT, 3, P], not pixel-major
    with pytest.raises(ValueError):
        tcp.bwd_call_pairs(*bad, TILE_H, TILE_W, ntx)
    bad = list(ts)
    bad[5] = ts[5].long()
    with pytest.raises(ValueError):
        tcp.bwd_call_pairs(*bad, TILE_H, TILE_W, ntx)
    # The plain version runs for CPU tensors and launches nothing.
    before = dict(tcp.LAUNCHES)
    tcp.bwd_call_pairs(*ts, TILE_H, TILE_W, ntx)
    assert tcp.LAUNCHES == before
