"""Each cell through the one command on the card, briefly: the line is
correct and carries the cell's metrics. Skips without a card."""
import json
import subprocess
import sys

import pytest
import torch

from avatar_bench import run as bench


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in bench.Spec().doc["workloads"]
                                  if w["chips"] == 1])
def test_cell_runs_correct(card, cell):
    out = subprocess.run([sys.executable, "-m", "avatar_bench.run", "--workload", cell,
                          "--seed", "4242424242", "--seconds", "2", "--trace", "0"],
                         cwd=bench.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert {m["name"] for m in bench.Spec().end_to_end(cell)} == set(line["metrics"])
