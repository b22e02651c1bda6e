"""The port's debug hooks (`utils/debug.py`) and the loop's `debug_from`
and `gui_service` against the JAX package's behaviour: `assert_finite`
names each poisoned leaf by its key path and raises `FloatingPointError`,
`checked` returns (err, out), and `train(..., debug_from=k)` raises at
the first step from k whose state is not finite. On the tiny Blender
scene of `tests/test_torch_unbound.py` (unbound, 64×48)."""
import dataclasses

import numpy as np
import pytest
import torch

from gaussianavatars_tpu import config as jconfig
from gaussianavatars_tpu.utils import debug as jdebug
from gaussianavatars_torch import config as tconfig
from gaussianavatars_torch.training import loop as tloop
from gaussianavatars_torch.utils import debug as tdebug
from test_torch_unbound import unbound_config, write_blender_scene


def test_assert_finite_names_the_poisoned_leaves():
    @dataclasses.dataclass
    class Inner:
        a: torch.Tensor
        b: torch.Tensor

    tree = {"params": Inner(torch.ones(3), torch.zeros(2, 2)), "step": torch.tensor(3),
            "none": None}
    tdebug.assert_finite(tree)
    tree["params"].b[1, 0] = float("inf")
    tree["params"].a[0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"in state: \['params/a', 'params/b'\]"):
        tdebug.assert_finite(tree, "state")
    # The JAX hook raises the same error type on the same leaves.
    with pytest.raises(FloatingPointError, match="a.*b"):
        jdebug.assert_finite({"params": {"a": np.asarray(tree["params"].a),
                                         "b": np.asarray(tree["params"].b)}}, "state")


def test_checked_returns_the_error_and_the_output():
    def f(x):
        return {"y": x * 2, "z": torch.log(x)}

    err, out = tdebug.checked(f)(torch.tensor([1.0, 2.0]))
    assert err is None and torch.equal(out["y"], torch.tensor([2.0, 4.0]))
    err, out = tdebug.checked(f)(torch.tensor([-1.0, 2.0]))
    assert err == "non-finite values in f: ['z']" and torch.isnan(out["z"][0])


def test_detect_anomaly_switch():
    before = torch.is_anomaly_enabled()
    try:
        tdebug.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        tdebug.enable_nan_debugging(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)


@pytest.mark.parametrize("poison_at,debug_from", [(3, 2), (2, 4)])
def test_debug_from_raises_on_a_nan(tmp_path, poison_at, debug_from):
    """`gui_service` runs after each step, before the finite checks: it
    poisons one mean at `poison_at`. From `debug_from` on, the loop raises
    at the first iteration that sees it."""
    root = write_blender_scene(str(tmp_path / "scene"), n_points=150)
    cfg = tconfig.from_json(jconfig.to_json(unbound_config(root, "", cap=256)))
    h = tloop.build_harness(cfg, device="cpu")
    served = []

    def service(it):
        served.append(it)
        if it == poison_at:
            p = h.state.params
            h.state = dataclasses.replace(h.state, params=dataclasses.replace(
                p, means=p.means.clone().index_fill_(0, torch.tensor([0]), float("nan"))))
        return False

    with pytest.raises(FloatingPointError, match=r"params@it\d+: \['means'") as e:
        tloop.train(h, iterations=6, log_every=100, gui_service=service,
                    debug_from=debug_from)
    first = max(poison_at, debug_from)
    assert f"params@it{first}" in str(e.value)
    assert served == list(range(1, first + 1))
