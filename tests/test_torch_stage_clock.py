"""The stage clock of `utils/profiling.py` on the CPU: its host side, the
reduction of its ring, the alignment with a profile, the graph keys that
hold its state, and the set-up spans. The stamp kernel itself runs only on
the card (`tests/test_torch_gpu.py`); here a subclass writes the same
stamps into a CPU ring from a virtual clock."""
import numpy as np
import pytest
import torch

from gaussianavatars_torch.utils import graphs, profiling


class SimClock(profiling._StageClock):
    """The clock with its stamp kernel done on a CPU ring: each stamp writes
    `now` (ns), which the test advances."""

    def __init__(self, rows: int):
        super().__init__(torch.device("cpu"), rows, generation=99)
        self.now = 1_000
        self.kinds = []

    def stamp(self, mark: int, kind: int) -> None:
        n = int(self.counter[0])
        self.ring[n % self.rows, mark] = self.now
        self.kinds.append(kind)
        if kind == profiling.ROW_END:
            self.counter[0] = n + 1
            self.ring[(n + 1) % self.rows].zero_()


@pytest.fixture
def sim(monkeypatch):
    clock = SimClock(rows=8)
    monkeypatch.setattr(profiling, "_CLOCK", clock)
    return clock


def _frame(clock, gap: int, c: int = 2):
    """One row: frame [1 | A 3 | B (1 | C c | 1) | 1], then `gap` ns."""
    with profiling.annotate("frame", row=True):
        clock.now += 1
        with profiling.annotate("A"):
            clock.now += 3
        with profiling.annotate("B"):
            clock.now += 1
            with profiling.annotate("C"):
                clock.now += c
            clock.now += 1
        clock.now += 1
    clock.now += gap


def test_annotate_off_records_and_allocates_nothing():
    assert profiling.current_clock() is None and profiling.clock_key() is None
    before = set(profiling._NAMES)
    span = profiling.annotate("off/span")
    assert span is profiling.annotate("off/other") is profiling._OFF
    with span:
        pass
    assert profiling._NAMES == before
    # A profiler makes it a range, so eager profiles keep their names.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("on/span"):
            torch.ones(2) + 1
    assert "on/span" in {e.name for e in prof.events()}


def test_enable_stage_clock_on_the_cpu_raises():
    with pytest.raises(RuntimeError, match="CUDA device"):
        profiling.enable_stage_clock("cpu", rows=16)
    assert profiling.current_clock() is None


def test_stage_report_means_self_times_and_gaps(sim):
    for i in range(3):
        _frame(sim, gap=10 + i, c=2 + i)
    with profiling.annotate("outside"):   # no row open: not stamped
        sim.now += 100
    rep = profiling.stage_report()
    assert rep["rows"] == 3 and not rep["wrapped"] and not rep["partial"]
    assert rep["resolution_ns"] == 1 and rep["repeats"] == {} and rep["dropped"] == {}
    frame = rep["kinds"]["frame"]
    assert frame["units"] == 3 and frame["gaps"] == 2
    assert frame["gap_ms"] == pytest.approx((10 + 11) / 2 / 1e6)
    spans = frame["spans"]
    assert set(spans) == {"frame", "A", "B", "C"}
    c_mean = (2 + 3 + 4) / 3
    want = {"frame": 7 + c_mean, "A": 3, "B": 2 + c_mean, "C": c_mean}
    self_ns = {"frame": 2, "A": 3, "B": 2, "C": c_mean}
    for name, s in spans.items():
        assert s["mean_ms"] == pytest.approx(want[name] / 1e6)
        assert s["self_ms"] == pytest.approx(self_ns[name] / 1e6)
    assert spans["C"]["parent"] == "B" and spans["A"]["parent"] == "frame"
    top = sum(s["mean_ms"] for s in spans.values() if s["parent"] == "frame")
    assert top + spans["frame"]["self_ms"] == pytest.approx(spans["frame"]["mean_ms"])
    # The read cleared the ring: the next stretch starts from row 0.
    assert int(sim.counter[0]) == 0 and int(sim.ring.abs().sum()) == 0
    # A name stamped twice in one row is counted, not summed.
    with profiling.annotate("frame", row=True):
        for _ in range(2):
            with profiling.annotate("A"):
                sim.now += 1
    assert profiling.stage_report()["repeats"] == {"A": 1}


def test_reduce_ring_wraps_and_leaves_out_a_partial_row():
    index = {"step": 0, "inner": 1}
    parents = {("step", "step"): None, ("step", "inner"): "step"}
    rows, marks = 4, 4
    ring = np.zeros((rows, marks), np.int64)
    t = 100
    for n in range(6):                       # six rows written, the ring keeps 4
        r = ring[n % rows]
        r[:] = 0
        r[0], r[2], r[3], r[1] = t, t + 2, t + 2 + n, t + 5 + n   # step, inner
        t += 5 + n + 7                       # a gap of 7
    ring[6 % rows] = [t, 0, t + 1, 0]        # row 6 begun, not ended
    rep = profiling.reduce_ring(ring, 6, index, parents, {"step"})
    assert rep["wrapped"] and rep["partial"] and rep["rows"] == 3
    k = rep["kinds"]["step"]
    assert k["units"] == 3 and k["gaps"] == 2 and k["gap_ms"] == pytest.approx(7e-6)
    assert k["spans"]["step"]["mean_ms"] == pytest.approx((8 + 9 + 10) / 3 / 1e6)
    assert k["spans"]["inner"]["mean_ms"] == pytest.approx((3 + 4 + 5) / 3 / 1e6)
    assert k["spans"]["step"]["self_ms"] == pytest.approx(5e-6)
    rep = profiling.reduce_ring(np.zeros((8, marks), np.int64), 0, index, parents, {"step"})
    assert rep["rows"] == 0 and rep["kinds"] == {} and rep["resolution_ns"] is None


def test_align_rows_offset_and_gap_labels(sim):
    for _ in range(4):
        _frame(sim, gap=20)
    assert sim.kinds[:8] == [1, 0, 0, 0, 0, 0, 0, 2]
    ring = sim.ring.numpy().copy()
    n = int(sim.counter[0])
    off = 5_000
    # The profile: each stamp kernel starts 1 ns after its stamp plus the
    # offset, but for one at 3; a copy runs 4 ns into each gap; the host is
    # in `frame/outputs` for the next 6, then in no program span.
    kernels = [(f"void {profiling.STAMP_KERNEL}<{k}>(long long*)", True,
                int(v) + off + (3 if i == 4 else 1), int(v) + off + 2)
               for i, (v, k) in enumerate(zip(
                   [v for r in range(n) for v in sorted(ring[r][ring[r] > 0])], sim.kinds))]
    events = list(kernels)
    for r in range(n - 1):
        end = int(ring[r][1]) + off
        events += [("Memcpy DtoD", True, end, end + 4),
                   ("frame/outputs", False, end - 1, end + 10),
                   ("aten::clone", False, end + 1, end + 3),
                   ("cudaStreamSynchronize", False, end + 10, end + 20)]
    spans = {"frame", "frame/outputs"}
    al = profiling.align_rows(ring, n, sim.index, sim.row_names, events, spans)
    assert al["stamps"] == 4 * 2 * 4 and al["rows_matched"] == al["rows"] == 4
    assert al["offset_ns"] == off + 1 and al["offset_iqr_ns"] == 0 and al["offset_drift_ns"] == 0
    gaps = al["gaps"]["frame"]
    assert gaps["gaps"] == 3
    # Each 20 ns gap, between the kernels that stamped its edges: the copy's
    # 3 ns left, 6 ns more in frame/outputs, the rest (11) in the caller.
    assert gaps["ms"] == pytest.approx({"device": 3e-6, "frame/outputs": 6e-6, "caller": 11e-6})
    # The profile lost an inner kernel and the kernel that ended row 1: the
    # rows still match, row 1's gap to row 2 is left out, the lossy rows
    # give their edges' offsets only.
    lost = [e for i, e in enumerate(events) if i not in (2, 15)]
    al = profiling.align_rows(ring, n, sim.index, sim.row_names, lost, spans)
    assert al["rows_matched"] == 3 and al["gaps"]["frame"]["gaps"] == 2
    assert al["stamps"] == 2 + 8 + 8 and al["offset_ns"] == off + 1
    assert "error" in profiling.align_rows(ring, n, sim.index, sim.row_names, [], spans)


def test_graph_keys_change_with_the_clock(monkeypatch):
    """FrameGraph re-captures when the clock switches, keeping its buffers;
    the set-up report counts the re-capture under `stage_clock`;
    TrainChunk's key holds the clock's state."""
    from gaussianavatars_torch.training.trainer import TrainChunk

    captured = []

    class FakeCaptured:
        def __init__(self, key, fn, kind="graph"):
            self.key, self.outputs = key, fn()
            captured.append(key)

        def replay(self, n=1):
            pass

    monkeypatch.setattr(graphs, "Captured", FakeCaptured)
    monkeypatch.setattr(graphs, "warm_up", lambda device, fn: fn())
    before = profiling.setup_report()["recaptures"].get("frame", {}).get("stage_clock", 0)
    frame = graphs.FrameGraph(lambda b: b["x"] * 2, "cpu")
    for _ in range(3):
        frame("k", {"x": torch.ones(2)})
    assert frame.captures == 1 and captured[0][-1] == ("stage_clock", None)
    monkeypatch.setattr(profiling, "_CLOCK", SimClock(rows=4))
    buffers = frame.buffers
    assert torch.equal(frame("k", {"x": torch.ones(2)}), torch.full((2,), 2.0))
    assert frame.captures == 2 and frame.buffers is buffers
    assert captured[1][-1] == ("stage_clock", 99) and captured[1][:-1] == captured[0][:-1]
    rep = profiling.setup_report()
    assert rep["recaptures"]["frame"]["stage_clock"] == before + 1

    from gaussianavatars_torch.render import build_scene
    from gaussianavatars_torch.config import Config
    from gaussianavatars_torch.training.trainer import init_train_state, stack_cameras

    model, params, aux, fl, cam, _n = build_scene(per_face=1, width=32, height=16, n_shape=4,
                                                  n_expr=2, device="cpu")
    state = init_train_state(params, aux, Config(), num_timesteps=1, n_expr=2, n_shape=4,
                             num_verts=model.num_verts)
    gt = torch.zeros((1, 16, 32, 3), dtype=torch.uint8)
    on = TrainChunk.key(state, gt, stack_cameras([cam]), 3)
    monkeypatch.setattr(profiling, "_CLOCK", None)
    off = TrainChunk.key(state, gt, stack_cameras([cam]), 3)
    assert on != off and graphs.changed_fields(off, on) == ["stage_clock"]


def test_setup_report_nests_and_counts_captures():
    start = len(profiling.setup_report()["spans"])
    with profiling.setup_span("outer/test") as outer:
        with profiling.setup_span("inner/test", source="x") as inner:
            inner["compiled"] = 2
        outer["n"] = 1
    spans = profiling.setup_report()["spans"][start:]
    assert [s["name"] for s in spans] == ["outer/test", "inner/test"]
    assert spans[0]["depth"] == 0 and spans[0]["parent"] is None and spans[0]["n"] == 1
    assert spans[1]["depth"] == 1 and spans[1]["parent"] == "outer/test"
    assert spans[1]["source"] == "x" and spans[1]["compiled"] == 2
    assert 0 <= spans[1]["seconds"] <= spans[0]["seconds"]
    assert spans[1]["start_s"] >= spans[0]["start_s"]
    rep = profiling.setup_report()
    n0 = rep["captures"].get("test_kind", 0)
    profiling.count_capture("test_kind", None)
    profiling.count_capture("test_kind", ["size", "stage_clock"])
    rep = profiling.setup_report()
    assert rep["captures"]["test_kind"] == n0 + 2
    assert rep["recaptures"]["test_kind"] == {"size": 1, "stage_clock": 1}
    old = graphs.graph_key(size=(1, 2), fov=0.5)
    new = graphs.graph_key(size=(1, 3), fov=0.5)
    assert graphs.changed_fields(None, new) is None
    assert graphs.changed_fields(old, new) == ["size"]
