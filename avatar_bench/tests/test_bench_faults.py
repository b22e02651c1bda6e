"""The check fails what it must: the control (the reference in TF32 in the
program's place), and the program broken underneath a tiny run (a frame
altered where it is produced; a training step that returns its state
unchanged; a step whose loss is altered; the loss over half the image)."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from avatar_bench import run as bench
from avatar_bench.tests.tiny import SMALL, tiny_run
from gaussianavatars_torch import render
from gaussianavatars_torch.training import trainer


@pytest.mark.parametrize("cell,kind", [("base-serve", "tf32"), ("base-train", "tf32"),
                                       ("base-train", "half_image"), ("innov-train", "tf32"),
                                       ("innov-train", "half_image")])
def test_control_is_not_correct(cell, kind):
    r = tiny_run(cell, size=SMALL) if cell == "base-serve" else tiny_run(cell)
    r.finish_check(bench.mode_of(r.traffic).control(r, kind))
    assert not r.correct, r.checks


def test_altered_frame_is_not_correct(monkeypatch):
    original = render.AvatarRenderer.render

    def altered(self, fp):
        out = original(self, fp)
        return out._replace(color=out.color + 0.01)

    monkeypatch.setattr(render.AvatarRenderer, "render", altered)
    r = tiny_run("base-serve")
    bench.mode_of(r.traffic).run(r)
    assert not r.correct and r.failed > 0


def _broken_chunk(monkeypatch, fault):
    original = trainer.TrainChunk.__call__

    def broken(self, state, *args):
        new, metrics = original(self, state, *args)
        if fault == "unchanged":
            return state, metrics
        return new, dict(metrics, loss=metrics["loss"] * 1.01)

    monkeypatch.setattr(trainer.TrainChunk, "__call__", broken)


@pytest.mark.parametrize("cell", ["base-train", "innov-train"])
@pytest.mark.parametrize("fault", ["unchanged", "loss"])
def test_broken_step_is_not_correct(monkeypatch, fault, cell):
    _broken_chunk(monkeypatch, fault)
    r = tiny_run(cell)
    bench.mode_of(r.traffic).run(r)
    assert not r.correct, r.checks


@pytest.mark.parametrize("cell", ["base-train", "innov-train"])
def test_half_image_step_is_not_correct(monkeypatch, cell):
    """The program's image loss taken over the top half of the rows only."""
    def top(x):   # [H, W, C]
        return x[: x.shape[0] // 2]

    l1, wl1, ssim = trainer.l1_loss, trainer.weighted_l1_loss, trainer.ssim
    monkeypatch.setattr(trainer, "l1_loss", lambda p, t: l1(top(p), top(t)))
    monkeypatch.setattr(trainer, "weighted_l1_loss", lambda p, t, w: wl1(top(p), top(t), top(w)))
    monkeypatch.setattr(trainer, "ssim", lambda a, b, amp=False: ssim(a[:, : a.shape[1] // 2],
                                                                     b[:, : b.shape[1] // 2], amp=amp))
    r = tiny_run(cell)
    bench.mode_of(r.traffic).run(r)
    assert not r.correct, r.checks


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench.main(["--workload", "base-serve", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.HERE, tmp_path / "avatar_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "avatar_bench.run", "--workload", "base-serve",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""
