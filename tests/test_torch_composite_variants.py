"""The compositor's other implementations and its `amp` mode: the port's
plain versions against the JAX package's v2, v3 and v4 Pallas kernels.

This file holds the forward, the implementation switch and the shared
helpers; the float32 backward is in `test_torch_composite_variants_bwd.py`
and the `amp` backward with its guard in
`test_torch_composite_variants_amp.py` (three files, so that the test
runner's workers share the interpreted kernels' cost).

The JAX kernels run in interpret mode. The JAX module's implementation
switch (`_FWD_IMPL`/`_BWD_IMPL`) is flipped by monkeypatching inside the
test, as `scripts/kernel_ab.py:101-102` flips it; nothing in the JAX
package changes. The port runs one plain version for every implementation
(they compute the same function), so each implementation's kernel is held
against that plain version here, and the CUDA kernels against it on the
card (`tests/test_torch_gpu.py`, `chip_smoke.py`).

Tolerances, with their reasons:
  * v2 forward: the v2 Pallas kernel equals the v3 Pallas kernel bit for
    bit on these tables, and the plain version holds against it as against
    v3 (`test_torch_composite.py`): `stop` exactly, acc and t_final at atol
    1e-5 (the Pallas kernels add each 64-slot group's colour as one dot
    product, the plain version slot by slot; they differ by a few ulp). The
    CUDA v2 kernel equals the plain version bit for bit on the card.
  * v2 and v4 backward, float32: rows 0..8 at atol/rtol 2e-4, as for v3
    (`test_torch_composite_bwd.py`): the Pallas kernels sum each group's
    moments as one dot product, the port pixel by pixel. v4's gc by
    broadcast products moves values by at most ~1e-4 on rows up to ~20.
  * `amp`: max |port − JAX| ≤ 1e-3 × max |JAX| per row. Both round the same
    contraction operands to bf16 and sum in float32; a float32 difference of
    one ulp in d_p or w can flip a bf16 rounding, which moves that pixel's
    term by up to 2⁻⁸ of it. The float32 plain version misses JAX's `amp`
    output by more than that bound on at least one table (the guard test),
    so the bound does see the rounding.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.ops.pallas import composite_pairs as jcp
from gaussianavatars_torch.ops import composite_pairs as tcp

from test_torch_composite import CASES, _table
from test_torch_composite_bwd import _bwd_inputs
from torch_parity import torch_threads, TILE_H, TILE_W, n, t


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (`torch_parity.torch_threads`)."""
    with torch_threads(1):
        yield


TOL = 2e-4
AMP_REL = 1e-3


@functools.cache
def _inputs(case):
    return _bwd_inputs(case)


@functools.cache
def _jax_bwd(case, impl, amp):
    """The JAX backward of implementation `impl` on `case`'s table, computed
    once per module (the guard test reuses the `amp` runs)."""
    arrays, ntx = _inputs(case)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcp, "_BWD_IMPL", getattr(jcp, f"_bwd_kernel_pairs_{impl}"))
        return np.asarray(jcp.bwd_call_pairs(*(jnp.asarray(a) for a in arrays),
                                             TILE_H, TILE_W, ntx, amp=amp))


def _row_rel_err(got, want):
    """Per row 0..8: max |got − want| / max |want|."""
    return np.abs(got[:9] - want[:9]).max(axis=1) / np.abs(want[:9]).max(axis=1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_matches_pallas_v2(case, monkeypatch):
    dataT, starts, counts, ntx = _table(case)
    args = (jnp.asarray(dataT), jnp.asarray(starts), jnp.asarray(counts), TILE_H, TILE_W, ntx)
    v3 = jcp.fwd_call_pairs(*args)
    monkeypatch.setattr(jcp, "_FWD_IMPL", jcp._fwd_kernel_pairs_v2)
    v2 = jcp.fwd_call_pairs(*args)
    for a, b in zip(v2, v3):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    monkeypatch.setattr(tcp, "_FWD_IMPL", "v2")
    acc, tfin, stop = tcp.fwd_call_pairs(t(dataT), t(starts), t(counts), TILE_H, TILE_W, ntx)
    np.testing.assert_allclose(n(acc), np.asarray(v2[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(tfin), np.asarray(v2[1]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(n(stop), np.asarray(v2[2]))


def test_switch_rejects_unknown_names(monkeypatch):
    arrays, ntx = _inputs("unaligned_starts")
    ts = [t(a) for a in arrays]
    monkeypatch.setattr(tcp, "_FWD_IMPL", "v5")
    with pytest.raises(ValueError, match="v5"):
        tcp.fwd_call_pairs(*ts[:3], TILE_H, TILE_W, ntx)
    monkeypatch.setattr(tcp, "_BWD_IMPL", "v1")
    with pytest.raises(ValueError, match="v1"):
        tcp.bwd_call_pairs(*ts, TILE_H, TILE_W, ntx)
    # Each known name maps to its own C entry point; v4's forward is v3's.
    assert tcp.fwd_entry("v4") == tcp.fwd_entry("v3") != tcp.fwd_entry("v2")
    entries = {tcp.bwd_entry(i, a)[1] for i in tcp.IMPLS for a in (False, True)}
    assert entries == {k for k in tcp.LAUNCHES if "_bwd" in k}
    assert {tcp.fwd_entry(i)[1] for i in tcp.IMPLS} == {k for k in tcp.LAUNCHES if "_fwd" in k}
    # On CPU tensors every implementation runs the plain version: no launch.
    monkeypatch.setattr(tcp, "_FWD_IMPL", "v2")
    monkeypatch.setattr(tcp, "_BWD_IMPL", "v4")
    before = dict(tcp.LAUNCHES)
    tcp.fwd_call_pairs(*ts[:3], TILE_H, TILE_W, ntx)
    tcp.bwd_call_pairs(*ts, TILE_H, TILE_W, ntx, amp=True)
    assert tcp.LAUNCHES == before


def test_kernel_ab_rejects_unknown_names_and_needs_a_card():
    """The A/B entry point checks its implementation names first, then needs
    a CUDA device: it has no CPU fallback."""
    from gaussianavatars_torch.tools import kernel_ab

    with pytest.raises(ValueError, match="v9"):
        kernel_ab.main(["--impls", "v2,v9"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_ab.main(["--impls", "v2,v3,v4", "--iters", "1"])
    assert (tcp._FWD_IMPL, tcp._BWD_IMPL) == ("v3", "v3")
