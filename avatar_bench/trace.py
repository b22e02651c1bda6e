"""A profiled stretch of a run, reduced to what the per-layer readers need:
each device operation's name and interval, the device's busy time (the
union of the intervals), the host clock's length of the stretch, and the
idle gaps between device operations labelled by what the host was doing.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable

import torch


@dataclasses.dataclass
class Trace:
    ops: list             # (name, start_ns, end_ns) of each device operation
    host: list            # (name, start_ns, end_ns) of each host event
    window_s: float       # host clock from the first issue to the last synchronise
    units: int            # frames or steps in the stretch

    def busy_s(self) -> float:
        busy, end = 0, None
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def kernel_s(self, name: str) -> float:
        """Seconds of the device operations whose name holds `name`."""
        return sum(e - s for n, s, e in self.ops if name in n) / 1e9

    def top_ops(self, k: int = 10) -> list:
        tot = defaultdict(int)
        for n, s, e in self.ops:
            tot[n] += e - s
        return [[n[:120], v / 1e9] for n, v in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The longest idle stretches between device operations, summed by
        the innermost host event under each gap's start."""
        ops = sorted(self.ops, key=lambda o: o[1])
        host = sorted(self.host, key=lambda h: h[1])
        tot = defaultdict(int)
        end = None
        j = 0
        active: list = []
        for _, s, e in ops:
            if end is not None and s > end:
                while j < len(host) and host[j][1] <= end:
                    active.append(host[j])
                    j += 1
                active = [h for h in active if h[2] > end]
                label = max(active, key=lambda h: h[1])[0] if active else "no host event"
                tot[label[:120]] += s - end
            end = e if end is None else max(end, e)
        return [[n, v / 1e9] for n, v in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def _events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    try:
        evs = prof.profiler.kineto_results.events()
        rows = [(e.name(), e.device_type(), e.start_ns(), e.end_ns(), e.is_user_annotation())
                for e in evs]
    except AttributeError:
        rows = [(e.name, e.device_type, int(e.time_range.start * 1e3),
                 int(e.time_range.end * 1e3), e.is_user_annotation) for e in prof.events()]
    ops = [(n, s, e) for n, d, s, e, ann in rows if d == cuda and not ann and e > s]
    host = [(n, s, e) for n, d, s, e, ann in rows if d != cuda and e > s]
    return ops, host


def profile(fn: Callable[[], int], device) -> Trace:
    """Run fn() (it returns the frames or steps it ran) under the profiler,
    between two synchronisations of `device`."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units = fn()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    ops, host = _events(prof)
    return Trace(ops=ops, host=host, window_s=window, units=units)
