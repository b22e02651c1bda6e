"""Tracing and step timing.

The port of the JAX package's `utils/profiling.py` (the reference times
iterations with paired CUDA events, `train.py:108-109,174,245`):

  * `StepTimer` — the EMA of host milliseconds a step, synchronising the
    device only on sample steps (a sync every iteration would serialise the
    host's issue of kernels with the device's work);
  * `trace(log_dir)` — `torch.profiler` around a region, writing a Chrome
    trace (`trace.json`) into `log_dir`; CUDA activity is recorded when a
    card is present;
  * `annotate(name)` — a named range (`record_function`) in such a trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


class StepTimer:
    """EMA host ms a step; synchronises the device every `sync_every` steps."""

    def __init__(self, sync_every: int = 50, ema: float = 0.9):
        self.sync_every = sync_every
        self.ema_factor = ema
        self.ema_ms: Optional[float] = None
        self._t0 = time.perf_counter()
        self._steps_since = 0

    def step(self, sync_on: Optional[torch.Tensor] = None) -> Optional[float]:
        """Call once an iteration; returns the EMA ms a step on sample steps
        (None between them). `sync_on`: a tensor of this step's outputs (any
        leaf of the train state), whose CUDA device is synchronised when
        sampling."""
        self._steps_since += 1
        if self._steps_since < self.sync_every:
            return None
        if sync_on is not None and sync_on.is_cuda:
            torch.cuda.synchronize(sync_on.device)
        dt_ms = (time.perf_counter() - self._t0) * 1000 / self._steps_since
        self.ema_ms = dt_ms if self.ema_ms is None else (
            self.ema_factor * self.ema_ms + (1 - self.ema_factor) * dt_ms
        )
        self._t0 = time.perf_counter()
        self._steps_since = 0
        return self.ema_ms


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


def annotate(name: str):
    return record_function(name)
