"""The guard against JAX: whole top-level module names, so the port
(`gaussianavatars_torch`) never trips it."""
import os
import subprocess
import sys
import types

import pytest

from avatar_bench import run as bench


@pytest.mark.parametrize("name,flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("gaussianavatars_tpu", True), ("gaussianavatars_tpu.ops.projection", True),
    ("gaussianavatars_torch", False), ("gaussianavatars_torch.render", False),
    ("jax_like_name", False), ("myjax", False),
])
def test_guard_by_whole_top_level_name(monkeypatch, name, flagged):
    before = bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (bench.forbidden_modules() - before != set()) == flagged


def test_a_run_loads_no_jax():
    """A tiny serving run in a fresh interpreter: the harness and the port
    leave no forbidden module behind."""
    code = ("from avatar_bench import run as bench; from avatar_bench.tests.tiny import tiny_run; "
            "r = tiny_run('base-serve'); bench.mode_of(r.traffic).run(r); "
            "print(r.correct, sorted(bench.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(bench.ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-2:] == ["True", "[]"]
