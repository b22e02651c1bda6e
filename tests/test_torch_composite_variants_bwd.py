"""The float32 backward of the compositor's other implementations: the
port's plain version against the JAX package's v2 and v4 Pallas backward
kernels (interpret mode). Inputs, helpers and tolerances are those of
`test_torch_composite_variants.py`: rows 0..8 at atol/rtol 2e-4.
"""
import numpy as np
import pytest

from gaussianavatars_torch.ops import composite_pairs as tcp

from test_torch_composite import CASES
from test_torch_composite_variants import TOL, _inputs, _jax_bwd
from torch_parity import torch_threads, TILE_H, TILE_W, n, t


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (`torch_parity.torch_threads`)."""
    with torch_threads(1):
        yield


@pytest.mark.parametrize("impl", ["v2", "v4"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_pallas_v2_v4(case, impl, monkeypatch):
    arrays, ntx = _inputs(case)
    d_j = _jax_bwd(case, impl, False)
    monkeypatch.setattr(tcp, "_BWD_IMPL", impl)
    d_t = n(tcp.bwd_call_pairs(*(t(a) for a in arrays), TILE_H, TILE_W, ntx))
    np.testing.assert_allclose(d_t[:9], d_j[:9], atol=TOL, rtol=TOL)
    assert not d_t[9:].any() and not d_j[9:].any()
    # What the plain version leaves zero, the JAX kernel leaves zero too.
    assert not d_j[:, ~d_t.any(axis=0)].any()
