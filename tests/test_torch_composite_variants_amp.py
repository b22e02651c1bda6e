"""The compositor's `amp` backward: the port's plain version against the
JAX package's v2, v3 and v4 Pallas kernels in `amp` mode (interpret mode),
and the guard that the float32 plain version misses them. Inputs, helpers
and tolerances are those of `test_torch_composite_variants.py`: per row
max |port − JAX| ≤ 1e-3 × max |JAX|. The guard reuses the `amp` runs
through `_jax_bwd`'s cache, so both stay in this file.
"""
import pytest

from gaussianavatars_torch.ops import composite_pairs as tcp

from test_torch_composite import CASES
from test_torch_composite_variants import AMP_REL, _inputs, _jax_bwd, _row_rel_err
from torch_parity import torch_threads, TILE_H, TILE_W, n, t


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (`torch_parity.torch_threads`)."""
    with torch_threads(1):
        yield


@pytest.mark.parametrize("impl", ["v2", "v3", "v4"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_amp_backward_matches_pallas_amp(case, impl, monkeypatch):
    arrays, ntx = _inputs(case)
    d_j = _jax_bwd(case, impl, True)
    monkeypatch.setattr(tcp, "_BWD_IMPL", impl)
    d_t = n(tcp.bwd_call_pairs(*(t(a) for a in arrays), TILE_H, TILE_W, ntx, amp=True))
    rel = _row_rel_err(d_t, d_j)
    assert (rel <= AMP_REL).all(), rel
    assert not d_t[9:].any() and not d_t[:, ~d_j.any(axis=0)].any()


def test_float32_plain_misses_pallas_amp():
    """The guard: without the bf16 rounding the plain version misses JAX's
    `amp` output by more than AMP_REL on some row of some table, so the
    bound of the test above tells the two modes apart."""
    worst = 0.0
    for case in sorted(CASES):
        arrays, ntx = _inputs(case)
        d_j = _jax_bwd(case, "v3", True)
        d_f32 = n(tcp.bwd_call_pairs_reference(*(t(a) for a in arrays), TILE_H, TILE_W, ntx))
        worst = max(worst, float(_row_rel_err(d_f32, d_j).max()))
    assert worst > AMP_REL, worst
