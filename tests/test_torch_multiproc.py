"""The port's multi-process runs on the CPU, in ranks launched as
`python -m` subprocesses over gloo (`parallel/distributed.launch`, a
`file://` rendezvous in a fresh temporary directory, a wall-clock limit on
every launch):

* `tools.multiproc_check --device cpu` (JAX `tests/test_multiproc.py`);
* `tools.train --mesh 1x2` FLAME-bound on the 415-face sparse sphere
  (2 timesteps × 2 cameras at 64×48; 4 iterations with a densify event,
  an opacity reset, an eval and a save) against the single-device CLI run
  of the same flags: the printed losses (5 decimals) within 2e-5, the
  live counts equal, the saved checkpoints' alive masks and bindings
  equal, and rank 1 printed nothing;
* a non-coordinator rank trains in step but writes and prints nothing
  (JAX `test_sharded_rank_safety`), in a one-rank world in this process;
* rank 0 held in the viewer longer than the collective timeout at the
  last iteration (a client asking to be kept alive): the other rank
  waits, and the final save and checkpoint are written;
* the launcher's echo gives rank 0's output while the ranks run;
* a rank that raises ends the launch with an error, and a launch that
  runs out of time is killed, both within their limits.
"""
import re
import sys
import textwrap

import numpy as np
import pytest
import torch.distributed as dist

from gaussianavatars_torch.parallel import distributed as pdist
from gaussianavatars_torch.parallel.mesh import make_rank_mesh
from gaussianavatars_torch.tools import multiproc_check
from gaussianavatars_torch.tools import train as ttrain
from gaussianavatars_torch.tools.render import load_flame_model
from gaussianavatars_torch.training import loop as tloop
from test_torch_train_cli import _flame_dataset
from torch_parity import torch_threads

LAUNCH_TIMEOUT_S = 240


def test_multiproc_check_on_the_cpu(capsys):
    assert multiproc_check.main(["--device", "cpu", "--timeout", str(LAUNCH_TIMEOUT_S)]) == 0
    out = capsys.readouterr().out
    assert "multiproc check OK: 2 ranks (gloo, cpu), 8 steps" in out
    assert out.count("[rank 0] done") == 1


FLAGS = ["--bind_to_mesh", "--eval", "--port", "0", "--device", "cpu", "--iterations", "4",
         "--interval", "4", "--capacity", "2048", "--densify_from_iter", "1",
         "--densification_interval", "3", "--densify_until_iter", "4",
         "--opacity_reset_interval", "2", "--log_every", "1"]
LOG_LINE = re.compile(r"^\[(\d+)/\d+\] loss=([0-9.]+) .* pts=(\d+)$", re.M)


def test_train_cli_on_a_1x2_mesh_matches_the_single_device_run(tmp_path, monkeypatch, capsys):
    root = _flame_dataset(tmp_path, monkeypatch)
    with torch_threads(1):
        harness, logs = ttrain.main(["-s", root, "-m", str(tmp_path / "one"), *FLAGS])
    capsys.readouterr()
    res, none = ttrain.main(["-s", root, "-m", str(tmp_path / "mesh"), *FLAGS, "--mesh", "1x2",
                             "--launch_timeout", str(LAUNCH_TIMEOUT_S)])
    assert none is None and res.ok and res.stdout[1] == ""
    assert capsys.readouterr().out == res.stdout[0]
    got = [(int(i), float(loss), int(pts)) for i, loss, pts in LOG_LINE.findall(res.stdout[0])]
    assert [g[0] for g in got] == [r["iteration"] for r in logs] == list(range(1, 5))
    np.testing.assert_allclose([g[1] for g in got], [r["loss"] for r in logs], atol=2e-5)
    assert [g[2] for g in got] == [r["num_points"] for r in logs]
    assert "[densify 3]" in res.stdout[0] and "[eval val]" in res.stdout[0]
    assert "[mesh 1x2] 2 ranks hold state" in res.stdout[0]
    one, mesh = (np.load(tmp_path / d / "chkpnt4.npz") for d in ("one", "mesh"))
    for k in ("aux/alive", "aux/binding"):
        np.testing.assert_array_equal(mesh[k], one[k], err_msg=k)
    assert int(one["aux/alive"].sum()) == int(harness.state.aux.alive.sum())
    for f in ("cfg_args.json", "cameras.json", "flame_assets.npz",
              "point_cloud/iteration_4/point_cloud.ply"):
        assert (tmp_path / "mesh" / f).exists(), f


def test_a_non_coordinator_rank_writes_and_prints_nothing(tmp_path, monkeypatch, capsys):
    root = _flame_dataset(tmp_path, monkeypatch)
    a = ttrain.parse_args(["-s", root, "-m", str(tmp_path / "rank1"), *FLAGS])
    cfg = ttrain.config_from_args(a)
    monkeypatch.setattr(pdist, "is_coordinator", lambda: False)
    capsys.readouterr()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        with torch_threads(1):
            model = load_flame_model(cfg, "", device="cpu", verbose=False)
            harness = tloop.build_harness(cfg, model=model, device="cpu", coordinator=False)
            logs = tloop.train_sharded(harness, make_rank_mesh(1, 1), iterations=4,
                                       log_every=4, eval_every=4, save_iterations=[4],
                                       checkpoint_iterations=[4])
    finally:
        dist.destroy_process_group()
    assert logs and np.isfinite(logs[-1]["loss"]) and logs[-1]["state_digest"]
    assert [e["kind"] for e in harness.events].count("densify") == 1   # at 3
    assert not (tmp_path / "rank1").exists()
    assert capsys.readouterr().out == ""


def _rank_module(tmp_path, body: str, timeout_s: float = pdist.DEFAULT_TIMEOUT_S,
                 before: str = "") -> dict:
    """A rank program `rank_prog` that runs `before`, waits until every
    rank has (a barrier on a file store of its own, with no deadline worth
    the name, so that a slow start under load costs the collectives
    nothing), joins the world with collectives timing out after
    `timeout_s`, then runs `body`."""
    (tmp_path / "rank_prog.py").write_text(textwrap.dedent("""\
        import argparse, datetime, os, time
        import torch.distributed as dist
        from gaussianavatars_torch.parallel import distributed as pdist
        p = argparse.ArgumentParser()
        for f in ("--coordinator_address", "--num_processes", "--process_id"):
            p.add_argument(f)
        a = p.parse_args()
    """) + textwrap.dedent(before) + textwrap.dedent(f"""\
        ready = dist.FileStore(a.coordinator_address[len("file://"):] + ".ready",
                               int(a.num_processes))
        ready.set_timeout(datetime.timedelta(seconds=600))
        ready.add("ready", 1)
        while ready.add("ready", 0) < int(a.num_processes):
            time.sleep(0.01)
        pdist.initialize(a.coordinator_address, a.num_processes, a.process_id, device="cpu",
                         timeout_s={timeout_s})
    """) + textwrap.dedent(body))
    return {"PYTHONPATH": str(tmp_path)}


HOLD_TIMEOUT_S = 4.0   # the ranks' collective timeout in the viewer-hold test


def test_rank_0_held_in_the_viewer_past_the_collective_timeout(tmp_path, monkeypatch):
    root = _flame_dataset(tmp_path, monkeypatch)
    out = tmp_path / "held"
    env = _rank_module(tmp_path, before=f"""\
        from gaussianavatars_torch.parallel.mesh import make_rank_mesh
        from gaussianavatars_torch.tools import train as ttrain
        from gaussianavatars_torch.tools.render import load_flame_model
        from gaussianavatars_torch.training import loop as tloop
        tloop._maybe_tensorboard({str(tmp_path / "tb")!r}).close()   # imported alike
        coord = a.process_id == "0"
        cfg = ttrain.config_from_args(ttrain.parse_args(
            ["-s", {root!r}, "-m", {str(out)!r}, "--bind_to_mesh", "--eval",
             "--capacity", "2048"]))
        model = load_flame_model(cfg, "", device="cpu", verbose=False)
        harness = tloop.build_harness(cfg, model=model, device="cpu", coordinator=coord)

        def viewer(it):   # a client keeps the last iteration alive
            time.sleep({2.5 * HOLD_TIMEOUT_S})
            return True
    """, timeout_s=HOLD_TIMEOUT_S, body="""\
        tloop.train_sharded(harness, make_rank_mesh(1, 2), iterations=1, log_every=1,
                            save_iterations=[1], checkpoint_iterations=[1],
                            gui_service=viewer if coord else None)
        pdist.shutdown()
    """)
    res = pdist.launch("rank_prog", [], 2, LAUNCH_TIMEOUT_S, device="cpu", env=env)
    assert res.ok, res.stderr
    assert res.seconds > 2.5 * HOLD_TIMEOUT_S
    assert (out / "chkpnt1.npz").exists()
    assert (out / "point_cloud" / "iteration_1" / "point_cloud.ply").exists()
    assert "[mesh 1x2] 2 ranks hold state" in res.stdout[0]


def test_the_launcher_echoes_rank_0_while_the_ranks_run(tmp_path, monkeypatch):
    go = tmp_path / "go"
    env = _rank_module(tmp_path, f"""\
        if dist.get_rank() == 0:
            print("rank 0 is waiting", flush=True)
            t0 = time.time()
            while not os.path.exists({str(go)!r}):   # made when the echo arrives
                if time.time() - t0 > 30:
                    raise SystemExit("no echo")
                time.sleep(0.05)
        else:
            print("rank 1")
        dist.barrier()
    """)

    class Spy:
        text = ""

        def write(self, s):
            self.text += s
            if "waiting" in s:
                go.write_text("")

        def flush(self):
            pass

    spy = Spy()
    monkeypatch.setattr(sys, "stdout", spy)
    res = pdist.launch("rank_prog", [], 2, 60, device="cpu", env=env, echo=True)
    monkeypatch.undo()
    assert res.ok, res.stderr
    assert spy.text == res.stdout[0] == "rank 0 is waiting\n"


def test_a_rank_that_raises_ends_the_launch(tmp_path):
    env = _rank_module(tmp_path, """\
        if dist.get_rank() == 1:
            raise SystemExit("rank 1 gives up")
        dist.barrier()   # rank 0 would wait here for the collective timeout
    """)
    res = pdist.launch("rank_prog", [], 2, 60, device="cpu", env=env)
    assert not res.ok and not res.timed_out and res.rcs[1] not in (0, None)
    assert res.seconds < 30
    with pytest.raises(RuntimeError, match=r"rank \d exited"):
        res.check()


def test_a_launch_out_of_time_is_killed(tmp_path):
    env = _rank_module(tmp_path, """\
        time.sleep(120)
    """)
    res = pdist.launch("rank_prog", [], 2, 3, device="cpu", env=env)
    assert res.timed_out and not res.ok and res.seconds < 30
    with pytest.raises(RuntimeError, match="timed out"):
        res.check()
    assert not dist.is_initialized()
