"""Tracing: the stage clock, set-up spans and Chrome traces.

The port of the JAX package's `utils/profiling.py`. The port replays its
hot frames and training steps as captured CUDA graphs (`utils/graphs.py`),
and a host range never runs inside a replay, so its spans are stamped on
the device:

  * `annotate(name)` — a span. It opens a `record_function` range when a
    profiler is active, so profiles keep its name. With the stage clock
    on (`enable_stage_clock`) it also launches a one-thread kernel
    (`csrc/stage_clock.cu`) at its begin and its end on the current
    stream, which writes the device's `%globaltimer` into a ring on the
    card. Inside a capture those stamps become nodes of the graph, so
    every replay writes them. A span with `row=True` is a frame or a step:
    its end advances the ring's row counter on the device, so that every
    replay writes a row of its own. Spans stamp only inside such a row. With the clock off and no
    profiler, a span is a no-op context that captures and launches
    nothing. `stamp=False` keeps a span on the host (the phases of an
    entry call around a replay): a range in a profile, nothing else.
  * `enable_stage_clock(device, rows)`, `disable_stage_clock()`,
    `stage_report()` — the clock's switch and its reading. The clock's
    state is part of every captured graph's key (`clock_key`), so a graph
    captured with the clock off never replays with it on, and the reverse.
    `stage_report(trace_events=...)` also aligns the stamps to a profile's
    clock and labels the device's idle time between rows with the host
    span that was open.
  * `setup_span(name)`, `count_capture(kind, changed)`, `setup_report()` —
    set-up, always on and off the hot path: host-clock spans of the
    kernel build and load, the FLAME model's set-up, the tier probe,
    warm-ups and captures, and counts of captures by graph kind and of
    re-captures by the key field that changed.
  * `counter(name, keys)`, `count(counts, key)`, `probe(name, read)` —
    engagement counts, always on: a module's counts by key (kernel
    launches, index builds), which every replay of a captured graph grows
    by what its capture counted (`utils/graphs.Captured`), and readings
    that `setup_report()` takes on demand, off the hot path; it reports
    both.
  * `trace(log_dir)` — `torch.profiler` around a region, writing a Chrome
    trace (`trace.json`) into `log_dir`; CUDA activity is recorded when a
    card is present. `trace_events(prof)` lists a profile's events.
"""
from __future__ import annotations

import bisect
import contextlib
import ctypes
import functools
import os
import re
import statistics
import threading
import time
from collections import Counter, defaultdict
from typing import Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# The stamp kernel's name, as a profile shows it, and its kinds (a template
# parameter, in the name): a row's first stamp, its last, the others.
STAMP_KERNEL = "stage_clock_stamp_kernel"
INNER, ROW_BEGIN, ROW_END = 0, 1, 2
_KIND = re.compile(STAMP_KERNEL + r"<(\d)>")
# Spans a row holds (each takes a begin and an end mark).
MAX_SPANS = 64
# The label of device idle time with no program span open on the host.
CALLER = "caller"
MAX_SETUP_SPANS = 10_000


@functools.cache
def _stamp_fn():
    from .. import cuda_build

    fn = cuda_build.load("stage_clock").stage_clock_stamp
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    return fn


class _StageClock:
    """The ring [rows, 2 · MAX_SPANS] of int64 stamps and its row counter on
    the card, and the host's table of spans: a span's index i owns marks 2i
    (begin) and 2i + 1 (end) of every row."""

    def __init__(self, device: torch.device, rows: int, generation: int):
        self.device, self.rows, self.generation = device, rows, generation
        self.marks = 2 * MAX_SPANS
        self.ring = torch.zeros((rows, self.marks), dtype=torch.int64, device=device)
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)
        self.index: dict[str, int] = {}
        # (row span, span) → the span open around it when it first began.
        self.parents: dict[tuple, Optional[str]] = {}
        self.row_names: set = set()
        self.stack: list = []
        self.seen: set = set()        # spans stamped in the host's current row
        self.repeats: Counter = Counter()
        self.dropped: Counter = Counter()
        self.lock = threading.Lock()

    def stamp(self, mark: int, kind: int) -> None:
        """Launch the stamp kernel of `kind` on the current stream: mark `mark`
        of the current row, then, for ROW_END, on to the next row."""
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = _stamp_fn()(self.ring.data_ptr(), self.counter.data_ptr(), self.rows,
                              self.marks, mark, kind, stream)
        if err:
            raise RuntimeError(f"stage clock stamp: CUDA error {err}")

    def begin(self, name: str, row: bool) -> Optional[int]:
        """Stamp a span's begin; its index, or None when it is not stamped
        (outside a row, or past MAX_SPANS)."""
        with self.lock:
            if not self.stack and not row:
                return None
            i = self.index.get(name)
            if i is None:
                if len(self.index) >= MAX_SPANS:
                    self.dropped[name] += 1
                    return None
                i = self.index[name] = len(self.index)
            outer = self.stack[0] if self.stack else name
            self.parents.setdefault((outer, name), self.stack[-1] if self.stack else None)
            if not self.stack:
                self.row_names.add(name)
            if name in self.seen:
                self.repeats[name] += 1
            self.seen.add(name)
            self.stamp(2 * i, INNER if self.stack else ROW_BEGIN)
            self.stack.append(name)
            return i

    def end(self, name: str, i: int) -> None:
        with self.lock:
            if name in self.stack:
                del self.stack[len(self.stack) - 1 - self.stack[::-1].index(name)]
            advance = not self.stack and name in self.row_names
            if advance:
                self.seen.clear()
            self.stamp(2 * i + 1, ROW_END if advance else INNER)


_CLOCK: Optional[_StageClock] = None
_GENERATION = 0
_NAMES: set = set()   # every span name annotate has opened


_OFF = contextlib.nullcontext()   # a span with the clock off and no profiler


class _Span:
    """A range in an active profile, stamped on the card when `clock` is
    given."""

    __slots__ = ("name", "clock", "row", "range", "index")

    def __init__(self, name: str, clock: Optional[_StageClock], row: bool):
        self.name, self.clock, self.row = name, clock, row
        self.range = self.index = None

    def __enter__(self):
        _NAMES.add(self.name)
        if _autograd_profiler._is_profiler_enabled:
            self.range = record_function(self.name)
            self.range.__enter__()
        if self.clock is not None:
            self.index = self.clock.begin(self.name, self.row)
        return self

    def __exit__(self, *exc):
        if self.index is not None:
            self.clock.end(self.name, self.index)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def annotate(name: str, stamp: bool = True, row: bool = False):
    """A span named `name` (see the module's docstring): a no-op unless the
    stage clock is on (for a stamped span) or a profiler is active."""
    clock = _CLOCK if stamp else None
    if clock is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, clock, row)


def clock_key() -> Optional[int]:
    """The stage clock's state as a captured graph's key holds it: None when
    off, else the generation of the enabled clock (a new ring a generation)."""
    return None if _CLOCK is None else _CLOCK.generation


def current_clock() -> Optional[_StageClock]:
    """The enabled clock (a captured graph keeps it, and so its ring, alive)."""
    return _CLOCK


def enable_stage_clock(device, rows: int = 4096) -> None:
    """Turn the stage clock on with a fresh ring of `rows` rows on `device`
    (a CUDA device). Graphs captured before re-capture at their next call.
    The stamp kernel is built, loaded and launched once here, outside any
    capture."""
    global _CLOCK, _GENERATION
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the stage clock needs a CUDA device (got {dev}): its stamps are "
                           "the card's %globaltimer, written by a kernel")
    if rows < 2:
        raise ValueError(f"the stage clock needs at least 2 rows, got {rows}")
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the stage clock cannot be switched during a capture")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _GENERATION += 1
    clock = _StageClock(dev, rows, _GENERATION)
    clock.stamp(0, INNER)
    clock.ring.zero_()
    _CLOCK = clock


def disable_stage_clock() -> None:
    """Turn the stage clock off; graphs captured with it re-capture at their
    next call."""
    global _CLOCK
    _CLOCK = None


def stage_report(trace_events: Optional[list] = None, reset: bool = True) -> dict:
    """Read the ring after a stretch (synchronising its device) and reduce
    it (`reduce_ring`); with `reset`, clear it for the next stretch. With
    `trace_events` (`trace_events(prof)` of a profile of this stretch),
    align the stamps to the profile's clock and label the idle time
    between rows (`align_rows`)."""
    clock = _CLOCK
    if clock is None:
        raise RuntimeError("the stage clock is off")
    if clock.device.type == "cuda":
        torch.cuda.synchronize(clock.device)
    ring = clock.ring.to("cpu", copy=True).numpy()
    n = int(clock.counter.item())
    if reset:
        clock.ring.zero_()
        clock.counter.zero_()
    out = reduce_ring(ring, n, clock.index, clock.parents, clock.row_names)
    out["repeats"], out["dropped"] = dict(clock.repeats), dict(clock.dropped)
    if trace_events is not None:
        out["align"] = align_rows(ring, n, clock.index, clock.row_names, trace_events, _NAMES)
    return out


def _complete_rows(ring: np.ndarray, n: int) -> list:
    """The complete rows of a ring whose counter reads n, oldest first: every
    row begun before the current one that the ring still holds."""
    rows = ring.shape[0]
    return [ring[k % rows] for k in range(max(0, n - rows + 1), n)]


def _row_kind(row: np.ndarray, index: dict, row_names: set) -> Optional[str]:
    for name in row_names:
        i = index[name]
        if row[2 * i] > 0 and row[2 * i + 1] > 0:
            return name
    return None


def reduce_ring(ring: np.ndarray, n: int, index: dict, parents: dict, row_names: set) -> dict:
    """Per kind of row (the row span: `frame`, `train/step`), over its
    complete rows: the units (rows); each span's mean device ms a unit
    (`mean_ms`), its self time (`self_ms`: less its direct children's), the
    rows holding it and its parent; the gap, from one row's end to the
    next row's begin where both are of the kind (`gap_ms`, `gaps`).
    `resolution_ns` is the least nonzero step between a row's stamps."""
    rows = _complete_rows(ring, n)
    kinds: dict = {}
    steps = []
    prev = None   # (kind, end ns) of the row before
    for row in rows:
        kind = _row_kind(row, index, row_names)
        if kind is None:
            prev = None
            continue
        k = kinds.setdefault(kind, dict(units=0, spans={}, gap_ns=0, gaps=0))
        k["units"] += 1
        dur = {name: int(row[2 * i + 1] - row[2 * i]) for name, i in index.items()
               if row[2 * i] > 0 and row[2 * i + 1] > 0}
        children = defaultdict(int)
        for name, d in dur.items():
            p = parents.get((kind, name))
            if p is not None and name != kind:
                children[p] += d
        for name, d in dur.items():
            s = k["spans"].setdefault(name, dict(parent=parents.get((kind, name)), count=0,
                                                 total_ns=0, self_ns=0))
            s["count"] += 1
            s["total_ns"] += d
            s["self_ns"] += d - children[name]
        i = index[kind]
        if prev is not None and prev[0] == kind:
            k["gap_ns"] += int(row[2 * i]) - prev[1]
            k["gaps"] += 1
        prev = (kind, int(row[2 * i + 1]))
        stamps = np.sort(row[row > 0])
        diffs = np.diff(stamps)
        if (diffs > 0).any():
            steps.append(int(diffs[diffs > 0].min()))
    out = {}
    for kind, k in kinds.items():
        out[kind] = dict(
            units=k["units"], gaps=k["gaps"],
            gap_ms=k["gap_ns"] / k["gaps"] / 1e6 if k["gaps"] else None,
            spans={name: dict(parent=s["parent"], count=s["count"],
                              mean_ms=s["total_ns"] / k["units"] / 1e6,
                              self_ms=s["self_ns"] / k["units"] / 1e6)
                   for name, s in k["spans"].items()})
    return dict(rows=len(rows), wrapped=n >= ring.shape[0], partial=bool(
        n > 0 and (ring[n % ring.shape[0]] > 0).any()), kinds=out,
        resolution_ns=min(steps) if steps else None)


def _quartiles(x: list) -> tuple:
    if len(x) < 2:
        return x[0], x[0], x[0]
    q = statistics.quantiles(x, n=4)
    return q[0], statistics.median(x), q[2]


def _match(values: list, kernels: list) -> dict:
    """Match sorted kernel starts with the sorted ring stamps they wrote: each
    kernel starts at its stamp plus an offset that drifts slowly, and the
    profile may have lost some kernels. Returns {index of a stamp: its
    kernel's start}. The tolerance is a quarter of the stamps' median
    spacing; the first offset is the pairing of the first kernel that most
    of the next ones agree with."""
    if not values or not kernels:
        return {}
    tol = statistics.median(np.diff(values)) / 4 if len(values) > 1 else float("inf")

    def nearest(x, lo):
        i = bisect.bisect_left(values, x, lo)
        cands = [j for j in (i - 1, i) if lo <= j < len(values)]
        return min(cands, key=lambda j: abs(values[j] - x)) if cands else None

    def agree(off):
        return sum(1 for k in kernels[:16]
                   if (j := nearest(k - off, 0)) is not None and abs(values[j] - k + off) <= tol)
    off = max((kernels[0] - values[a] for a in range(len(values) - len(kernels) + 1)),
              key=agree)
    out, lo = {}, 0
    for k in kernels:
        j = nearest(k - off, lo)
        if j is not None and abs(values[j] - (k - off)) <= tol:
            out[j], off, lo = k, k - values[j], j + 1
    return out


def align_rows(ring: np.ndarray, n: int, index: dict, row_names: set, events: list,
               program_spans: set) -> dict:
    """Align the ring's stamps with a profile of the same stretch and split
    the gaps between its rows.

    `events`: (name, on_device, start_ns, end_ns) of every event of the
    profile. The stamp kernels that began and ended rows (their kind is in
    their name) are matched with the rows' first and last stamps
    (`_match`); in a row whose every stamp kernel the profile kept, the
    others are matched in order. The offset of each matched stamp is its
    kernel's start in the profile less the `%globaltimer` it wrote. Each
    gap from a row's end to the next row's begin (both of one kind) is
    taken between the two matched kernels, on the profile's own clock,
    and split into the time some device operation ran (`device`) and the
    idle time, each idle stretch cut where a program span (a name in
    `program_spans`) opens or closes on the host and each piece labelled
    with the innermost one open at its start, or `caller` when none is.
    Returns the offset's median, interquartile range and drift (its change
    from the first matched row to the last) in ns, the counts, and per
    kind the mean ms a gap of each label."""
    rows = _complete_rows(ring, n)
    kinds = [_row_kind(row, index, row_names) for row in rows]
    live = [r for r, k in enumerate(kinds) if k is not None]
    by_kind: dict = {INNER: [], ROW_BEGIN: [], ROW_END: []}
    for name, dev, s, _e in events:
        m = _KIND.search(name) if dev else None
        if m:
            by_kind[int(m.group(1))].append(s)
    starts_all = sorted(by_kind[INNER] + by_kind[ROW_BEGIN] + by_kind[ROW_END])
    edges = {}
    for kind, mark in ((ROW_BEGIN, 0), (ROW_END, 1)):
        vals = [int(rows[r][2 * index[kinds[r]] + mark]) for r in live]
        edges[kind] = {live[j]: k for j, k in _match(vals, sorted(by_kind[kind])).items()}
    both = [r for r in live if r in edges[ROW_BEGIN] and r in edges[ROW_END]]
    if not both:
        return dict(error=f"no row matched: {len(starts_all)} stamp kernels in the profile, "
                          f"{sum(int((row > 0).sum()) for row in rows)} stamps in the ring")
    offsets, row_off = [], {}
    for r in both:
        b, e = edges[ROW_BEGIN][r], edges[ROW_END][r]
        row = rows[r]
        vals = np.sort(row[row > 0])
        inside = starts_all[bisect.bisect_left(starts_all, b):bisect.bisect_right(starts_all, e)]
        i = index[kinds[r]]
        row_off[r] = b - int(row[2 * i])
        if len(inside) == len(vals):
            offsets += [k - int(v) for k, v in zip(inside, vals)]
        else:
            offsets += [row_off[r], e - int(row[2 * i + 1])]
    q1, off, q3 = _quartiles(offsets)
    merged: list = []
    for s, e in sorted((s, e) for _n, dev, s, e in events if dev and e > s):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [m[0] for m in merged]
    host = sorted((s, e, name) for name, dev, s, e in events
                  if not dev and name in program_spans and e > s)
    bounds = sorted({t for s, e, _n in host for t in (s, e)})
    split: dict = {}
    for r in live[:-1]:
        kind = kinds[r]
        if kinds[r + 1] == kind and r in edges[ROW_END] and r + 1 in edges[ROW_BEGIN]:
            lab = split.setdefault(kind, dict(gaps=0, ms=Counter()))
            lab["gaps"] += 1
            _split_gap(edges[ROW_END][r], edges[ROW_BEGIN][r + 1], merged, starts, host,
                       bounds, lab["ms"])
    return dict(offset_ns=off, offset_iqr_ns=q3 - q1,
                offset_drift_ns=row_off[both[-1]] - row_off[both[0]], stamps=len(offsets),
                kernels=len(starts_all), rows=len(live), rows_matched=len(both),
                gaps={kind: dict(gaps=v["gaps"],
                                 ms={k: t / v["gaps"] / 1e6 for k, t in v["ms"].most_common()})
                      for kind, v in split.items()})


def _split_gap(t0: int, t1: int, merged: list, starts: list, host: list, bounds: list,
               acc: Counter) -> None:
    """Add [t0, t1) to `acc`: the part some device operation covers (`merged`:
    the union of the operations' intervals, sorted) under `device`; the
    idle rest cut at the host spans' edges (`bounds`, sorted), each piece
    under the span open at its start."""
    j = max(0, bisect.bisect_right(starts, t0) - 1)
    t = t0
    while t < t1:
        if j < len(merged) and merged[j][1] <= t:
            j += 1
        elif j < len(merged) and merged[j][0] <= t:
            e = min(merged[j][1], t1)
            acc["device"] += e - t
            t = e
        else:
            nxt = min(t1, merged[j][0]) if j < len(merged) else t1
            cuts = bounds[bisect.bisect_right(bounds, t):bisect.bisect_left(bounds, nxt)]
            for a, b in zip([t, *cuts], [*cuts, nxt]):
                acc[_open_span(host, a)] += b - a
            t = nxt


def _open_span(host: list, t: float) -> str:
    """The innermost (latest begun) program span open at t, or `caller`."""
    best = None
    for s, e, name in host[:bisect.bisect_right(host, (t, float("inf"), ""))]:
        if s <= t < e and (best is None or s >= best[0]):
            best = (s, name)
    return CALLER if best is None else best[1]


class _Setup:
    """Set-up spans and capture counts of this process."""

    def __init__(self):
        self.spans: list = []
        self.local = threading.local()
        self.captures: Counter = Counter()
        self.recaptures: dict = defaultdict(Counter)
        self.dropped = 0


_SETUP = _Setup()


@contextlib.contextmanager
def setup_span(name: str, **attrs):
    """A set-up span on the host clock (always on): yields a dict of its
    attributes, which the body may add to. Spans nest within a thread."""
    stack = _SETUP.local.__dict__.setdefault("stack", [])
    span = dict(name=name, start_s=time.perf_counter(), end_s=None, depth=len(stack),
                parent=stack[-1]["name"] if stack else None, **attrs)
    if len(_SETUP.spans) < MAX_SETUP_SPANS:
        _SETUP.spans.append(span)
    else:
        _SETUP.dropped += 1
    stack.append(span)
    try:
        yield span
    finally:
        stack.pop()
        span["end_s"] = time.perf_counter()


def count_capture(kind: str, changed: Optional[list]) -> None:
    """Count a capture of a graph of `kind`; `changed`: the key fields that
    differ from the graph it replaces (None for a first capture)."""
    _SETUP.captures[kind] += 1
    for field in changed or ():
        _SETUP.recaptures[kind][field] += 1


_COUNTERS: dict = {}        # name → a module's counts by key
_PROBES: dict = {}          # name → a reading taken by setup_report
_COUNT_LOCK = threading.Lock()


def counter(name: str, keys) -> dict:
    """The counts `name`: a dict of ints by key, zero at first, that its
    module keeps and adds to with `count`. `setup_report` reports every
    such dict, and a replay of a captured graph adds to each what its
    capture counted (`utils/graphs.Captured`), so the counts count the
    replayed work as they count eager calls."""
    return _COUNTERS.setdefault(name, dict.fromkeys(keys, 0))


def counters() -> dict:
    """Every dict of `counter`, by name."""
    return _COUNTERS


def count(counts: dict, key: str, n: int = 1) -> None:
    """Add `n` to `counts[key]` (a dict of `counter`)."""
    with _COUNT_LOCK:
        counts[key] += n


def probe(name: str, read) -> None:
    """Register `read()`, a reading that `setup_report` takes when it is
    called and reports under `name` (None: nothing to read). A reading
    may read the device, which synchronises it."""
    _PROBES[name] = read


def setup_report() -> dict:
    """The set-up spans (name, start_s on the `time.perf_counter` clock,
    seconds, depth, parent and attributes; open ones have seconds None),
    captures by kind and re-captures by kind and changed key field; the
    engagement counts by name (`counter`) and the readings by name
    (`probe`), taken now."""
    spans = [dict({k: v for k, v in s.items() if k != "end_s"},
                  seconds=None if s["end_s"] is None else s["end_s"] - s["start_s"])
             for s in list(_SETUP.spans)]
    return dict(spans=spans, captures=dict(_SETUP.captures),
                recaptures={k: dict(v) for k, v in _SETUP.recaptures.items()},
                dropped=_SETUP.dropped,
                counts={k: dict(v) for k, v in list(_COUNTERS.items())},
                probes={k: read() for k, read in list(_PROBES.items())})


def trace_events(prof) -> list:
    """(name, on_device, start_ns, end_ns) of each event of a finished
    `torch.profiler.profile`: device operations (not the device's copies
    of host ranges) and host events."""
    cuda = torch.autograd.DeviceType.CUDA
    try:
        evs = prof.profiler.kineto_results.events()
        rows = [(e.name(), e.device_type() == cuda, e.start_ns(), e.end_ns(),
                 e.is_user_annotation()) for e in evs]
    except AttributeError:
        rows = [(e.name, e.device_type == cuda, int(e.time_range.start * 1e3),
                 int(e.time_range.end * 1e3), e.is_user_annotation) for e in prof.events()]
    return [(n, dev, s, e) for n, dev, s, e, ann in rows if not (dev and ann)]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body into `log_dir/trace.json` (Chrome trace format);
    yields the `torch.profiler.profile` (None when it could not start).

    A profiler that fails to start is a no-op, as in the JAX package; an
    exception from the body propagates (the JAX version's `except` around
    its `yield` would yield a second time there)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
    except Exception:   # noqa: BLE001 — a backend without profiling: run unprofiled
        prof = None
    ok = False
    try:
        yield prof
        ok = True
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            if ok:
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
