"""Median host milliseconds of one chunk call of training steps, from the
call to its return (its steps enqueued; the wait for them is not in it),
over the window's chunks."""
import statistics


def read(run):
    return statistics.median(run.host_ms) if run.host_ms else None
