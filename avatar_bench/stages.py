"""The program's stage clock (`gaussianavatars_torch.utils.profiling`) as
the benchmark reads it: a stamped stretch over a cell's own frames or
chunks, read back as each stage's device ms a unit, the gap between units
on the device's clock and that gap split by the host span that was open;
and the set-up spans the program closed before the window.

`stretch(run, unit, ...)` takes the mode's live program: `unit(i)` renders
frame i and waits for it, or runs chunk i and reads its losses back, as
the window does. The clock goes on (the next unit re-captures and is left
out), `n` units run, then `profiled` more under the profiler for the
alignment, and the clock goes off; the report is kept on `run.stages` and
printed on standard error. Make it before any profiler session of the
process: a `torch.profiler` session slows every later frame's host part
for good, and with it the gap between frames. The stage readers read
`run.stages`, and None without it; `setup_s` reads the program's set-up
report, and None with a program that has none.
"""
from __future__ import annotations

import time

# /proc's process start and uptime count in ticks of 10 ms.
AGE_RESOLUTION_S = 0.02


def span_ms(run, kind: str, *names) -> float | None:
    """The summed mean device ms a unit of the named spans in rows of `kind`,
    over those present; None when none is."""
    rep = getattr(run, "stages", None)
    spans = None if rep is None else rep["stretch"]["kinds"].get(kind, {}).get("spans", {})
    got = [spans[n]["mean_ms"] for n in names if spans and n in spans]
    return sum(got) if got else None


def gap_ms(run, kind: str) -> float | None:
    """The mean device ms from one unit's end to the next one's begin."""
    rep = getattr(run, "stages", None)
    k = None if rep is None else rep["stretch"]["kinds"].get(kind)
    return None if k is None else k["gap_ms"]


def setup_spans(run) -> list | None:
    """The program's set-up spans closed before the window began (begun
    before it, to the process-age clock's resolution); None with a program
    that keeps no set-up report."""
    from gaussianavatars_torch.utils import profiling
    if not hasattr(profiling, "setup_report") or run.setup_s is None:
        return None
    from .run import _process_age_s

    # The window's start on the spans' clock (`time.perf_counter`), from the
    # process age at which the window began.
    window = time.perf_counter() - (_process_age_s() - run.setup_s) + AGE_RESOLUTION_S
    return [s for s in profiling.setup_report()["spans"]
            if s["seconds"] is not None and s["start_s"] <= window]


def setup_s(run) -> float | None:
    """Seconds of the program's top-level set-up spans closed before the
    window."""
    spans = setup_spans(run)
    return None if spans is None else sum(s["seconds"] for s in spans if s["depth"] == 0)


def stretch(run, unit, n: int, profiled: int, per_unit: int) -> None:
    """Make the stamped stretch over `unit` (see the module's docstring) and
    keep its report on `run.stages`; off the card, or with a program that
    has no stage clock, leave none."""
    from gaussianavatars_torch.utils import profiling
    if run.device.type != "cuda" or not hasattr(profiling, "enable_stage_clock"):
        return
    from torch.profiler import ProfilerActivity, profile

    profiling.enable_stage_clock(run.device, rows=(n + profiled + 2) * per_unit + 64)
    try:
        unit(0)                 # re-captures with the clock on
        profiling.stage_report()
        t0 = time.perf_counter()
        for i in range(1, n + 1):
            unit(i)
        host_s = time.perf_counter() - t0
        stamped = profiling.stage_report()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n + 1, n + 1 + profiled):
                unit(i)
            run.sync()
        aligned = profiling.stage_report(trace_events=profiling.trace_events(prof))
    finally:
        profiling.disable_stage_clock()
    report = profiling.setup_report()
    run.stages = dict(stretch=stamped, host_ms=host_s / (n * per_unit) * 1e3,
                      units=n * per_unit, profiled=aligned, setup=setup_spans(run) or [],
                      captures=(report["captures"], report["recaptures"]))
    _print(run, run.stages)


def _print(run, rep: dict) -> None:
    note = run.note
    st = rep["stretch"]
    note(f"stages: {rep['units']} units stamped, host ms a unit {rep['host_ms']:.6f}, rows "
         f"{st['rows']}, stamp resolution {st['resolution_ns']} ns, repeats {st['repeats']}, "
         f"dropped {st['dropped']}")
    for kind, k in st["kinds"].items():
        outer = k["spans"][kind]["mean_ms"]
        total = outer + (k["gap_ms"] or 0.0)
        note(f"stages {kind}: units {k['units']}, device ms a unit {outer:.6f} + gap "
             f"{k['gap_ms']} = {total:.6f} against the host's {rep['host_ms']:.6f} "
             f"({100 * (total / rep['host_ms'] - 1):+.3f} %)")
        for name, s in sorted(k["spans"].items(), key=lambda x: -x[1]["mean_ms"]):
            note(f"stages   {name}: mean {s['mean_ms']:.6f} ms, self {s['self_ms']:.6f} ms, "
                 f"in {s['parent']}, rows {s['count']}")
    al = rep["profiled"].get("align", {})
    if "error" in al:
        note(f"stages align: {al['error']}")
    else:
        note(f"stages align: offset {al['offset_ns']} ns, interquartile range "
             f"{al['offset_iqr_ns']} ns, drift {al['offset_drift_ns']} ns over {al['stamps']} "
             f"stamps; rows matched {al['rows_matched']} of {al['rows']}, stamp kernels "
             f"{al['kernels']} in the profile")
        for kind, g in al["gaps"].items():
            pk = rep["profiled"]["kinds"].get(kind, {})
            note(f"stages {kind} gap under the profiler ({g['gaps']} gaps, mean "
                 f"{pk.get('gap_ms')} ms): "
                 + ", ".join(f"{lab} {ms:.6f}" for lab, ms in g["ms"].items()))
    spans: dict = {}
    for s in rep["setup"]:
        key = (s["depth"], s["parent"], s["name"])
        count, total, extra = spans.get(key, (0, 0.0, {}))
        extra = dict(extra, **{k: v for k, v in s.items()
                               if k not in ("name", "start_s", "seconds", "depth", "parent")})
        spans[key] = (count + 1, total + s["seconds"], extra)
    for (depth, parent, name), (count, total, extra) in spans.items():
        note(f"stages setup {'  ' * depth}{name} (in {parent}): {count} x, {total:.6f} s; "
             f"last {extra}")
    top = sum(s["seconds"] for s in rep["setup"] if s["depth"] == 0)
    note(f"stages setup: top-level spans {top:.6f} s before the window; captures "
         f"{rep['captures'][0]}, re-captures by changed key field {rep['captures'][1]}")
