"""Per cent of a served frame's time in which no operation runs on the card:
1 − (device busy a frame: the union of the device operations' intervals
in the traced stretch over its frames) / (the untraced window's time a
frame). The traced stretch's own length is not the base: the profiler
slows the host's part of each frame."""


def read(run):
    t = run.trace
    if t is None or not t.ops or t.units <= 0 or run.attempted <= 0:
        return None
    return 100.0 * (1.0 - (t.busy_s() / t.units) / (run.window_s / run.attempted))
