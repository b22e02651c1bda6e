"""Median host milliseconds of a served frame's call, from the call to its
return: the pose copied into the captured frame's buffers and the replay
enqueued (the wait for the image is not in it), over the window's frames."""
import statistics


def read(run):
    return statistics.median(run.host_ms) if run.host_ms else None
