"""Per cent of the traced chunk of training steps in which no operation ran
on the card: 1 − (the union of the device operations' intervals) / (the
stretch's length on the host clock). A chunk replays captured steps, so
the profiler adds nothing to the host's part of it (unlike a served
frame's, `device_idle.serve`)."""


def read(run):
    t = run.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
