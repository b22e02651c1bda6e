"""CUDA graphs: one captured graph over static buffers, replayed once a
frame or a step.

The JAX package dispatches a frame as one jitted XLA program and a chunk of
training steps as one `lax.scan`. The port's counterparts capture the
same work in one CUDA graph and replay it, so that the host issues one
replay where it would issue hundreds of kernels:

  * `training/trainer.TrainChunk`, a step replayed K times a chunk;
  * `parallel/sharded.ShardedStep`, a rank's sharded step, its NCCL
    collectives inside, replayed once a step;
  * `FrameGraph`, a frame replayed once a call: `training/loop.make_render_fn`
    (eval, `tools/render`, the viewer server) and `render.AvatarRenderer`;
  * `tools/fps_benchmark_demo.run_chain`, the FPS benchmarks' frame chain.

The pieces they share:

  * `warm_up`: eager work on a side stream before a capture, so that lazy
    initialisation (kernel libraries, cached grids, autograd's streams)
    happens outside it;
  * `Captured`: `torch.cuda.graph` with its own memory pool, its static
    outputs, and the engagement counts (`utils/profiling.counter`: the
    kernels' launches, the binding index's builds) grown by a replay's
    counts at every replay, so that they count frames and steps as eager
    calls do;
  * `copy_in`: static input buffers filled in place before a replay;
  * `GraphSlot`: one graph for one key, dropped on a key change, so that
    one private memory pool is alive a user at a time;
  * `graph_key`: a key's named fields and the stage clock's state
    (`utils/profiling.clock_key`), so that switching the clock re-captures.

Warm-ups and captures are set-up spans, and captures are counted by kind
and by the key field that changed (`utils/profiling.setup_report`).

A capture runs the table pipeline in its host-read-free form (its fixed
walk: `ops/rasterize_tiled.host_read_free` sees the capture); the eager
warm-up takes the planned walk, which computes the same bits. A capture that fails raises: nothing
falls back to eager calls on the card. The captured work must make no host
read and no host-to-device copy of a pageable tensor.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..training.optim import tree_map
from . import profiling


def warm_up(device, fn: Callable):
    """fn() on a side stream of `device` (the current stream waits for it);
    returns its result."""
    with profiling.setup_span("graphs/warm_up"):
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn()
        main.wait_stream(side)
        return out


def graph_key(**fields) -> tuple:
    """A captured graph's key: its fields by name, and the stage clock's
    state last (`stage_clock`)."""
    return (*fields.items(), ("stage_clock", profiling.clock_key()))


def changed_fields(old: Optional[tuple], new: tuple) -> Optional[list]:
    """The names of the fields of `graph_key` key `new` that differ from
    `old`'s; None without an old key."""
    if old is None:
        return None
    before = dict(old)
    return [k for k, v in new if k not in before or before[k] != v]


def copy_in(buffers: dict, values: dict) -> None:
    """Each value into its static buffer, in place and without a host
    synchronisation: a device tensor by a device copy (nothing when it is
    the buffer itself), a host tensor through pinned memory, a Python
    number by `fill_`."""
    for name, x in values.items():
        buf = buffers[name]
        if x is buf:
            continue
        if not isinstance(x, torch.Tensor):
            buf.fill_(x)
        elif x.device.type == "cpu" and buf.device.type == "cuda":
            buf.copy_(x.pin_memory(), non_blocking=True)
        else:
            buf.copy_(x)


class Captured:
    """fn() captured once in a CUDA graph with a private memory pool.

    `outputs` is what fn returned during the capture: static tensors that
    every `replay` rewrites. The capture itself launches nothing, so the
    engagement counts it recorded (`utils/profiling.counters`) are taken
    back and added once a replay instead. The capture refuses an unsafe
    CUDA call (a host read, a synchronisation) made by this thread only
    ("thread_local"): other threads of the process make CUDA calls while
    it runs (NCCL's watchdog querying its collectives' events, the loop's
    prefetch workers copying ground truth to the card), which the default
    global mode would turn into a failed capture."""

    def __init__(self, key, fn: Callable, kind: str = "graph"):
        counts = profiling.counters()
        before = {name: dict(c) for name, c in list(counts.items())}
        self.key = key
        # The stage clock's ring, which the graph's stamps write, lives as
        # long as the graph.
        self.clock = profiling.current_clock()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with profiling.setup_span("graphs/capture", kind=kind), \
                    torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.outputs = fn()
            self.per_replay = {
                name: {k: v - before.get(name, {}).get(k, 0) for k, v in c.items()}
                for name, c in list(counts.items())}
        finally:
            for name, c in list(counts.items()):
                c.update({k: before.get(name, {}).get(k, 0) for k in c})

    def replay(self, n: int = 1) -> None:
        for _ in range(n):
            self.graph.replay()
        counts = profiling.counters()
        for name, delta in self.per_replay.items():
            for k, v in delta.items():
                if v:
                    profiling.count(counts[name], k, v * n)


class GraphSlot:
    """At most one captured graph of `kind`, for one key (`graph_key`);
    `captures` counts them, and each is counted in the set-up report with
    the key fields that changed since the graph before."""

    def __init__(self, kind: str):
        self.kind = kind
        self.captured: Optional[Captured] = None
        self.captures = 0
        self.last_key = None

    def get(self, key) -> Optional[Captured]:
        """The graph of `key`, or None (a graph of another key is dropped)."""
        if self.captured is not None and self.captured.key != key:
            self.drop()
        return self.captured

    def capture(self, key, fn: Callable) -> Captured:
        self.drop()
        profiling.count_capture(self.kind, changed_fields(self.last_key, key))
        self.captured = Captured(key, fn, self.kind)
        self.last_key = key
        self.captures += 1
        return self.captured

    def drop(self) -> None:
        """Release the graph and its memory pool."""
        self.captured = None


class FrameGraph:
    """A frame function replayed from one captured CUDA graph a key.

    Call: frame(key, inputs: {name: tensor or number}) → fn(buffers), where
    `buffers` holds a static device tensor a name, filled from `inputs`
    (`copy_in`). The first call with a key makes the buffers and runs fn
    eagerly on a side stream (`warm_up`): its result is that call's frame.
    The second call captures fn over the same buffers; it and every later
    call replay the graph and return a copy of its outputs, fresh tensors
    as a jitted call returns. Another key drops the graph and the buffers,
    and starts again; switching the stage clock keeps the buffers and
    re-captures at the next call. fn runs in the `frame` span, a row of
    the stage clock; the call's host phases are the spans
    `frame/copy_in`, `frame/replay` and `frame/outputs`."""

    def __init__(self, fn: Callable, device):
        self.fn = fn
        self.device = torch.device(device)
        self.slot = GraphSlot("frame")
        self.key = None
        self.buffers: Optional[dict] = None

    @property
    def captures(self) -> int:
        return self.slot.captures

    def _frame(self):
        with profiling.annotate("frame", row=True):
            return self.fn(self.buffers)

    def __call__(self, key, inputs: dict):
        if self.buffers is None or key != self.key:
            self.slot.drop()
            self.key = key
            self.buffers = {k: torch.empty_like(torch.as_tensor(x), device=self.device)
                            for k, x in inputs.items()}
            copy_in(self.buffers, inputs)
            return warm_up(self.device, self._frame)
        with profiling.annotate("frame/copy_in", stamp=False):
            copy_in(self.buffers, inputs)
        gkey = graph_key(inputs=key)
        g = self.slot.get(gkey) or self.slot.capture(gkey, self._frame)
        with profiling.annotate("frame/replay", stamp=False):
            g.replay()
        with profiling.annotate("frame/outputs", stamp=False):
            return tree_map(lambda x: x.clone(), g.outputs)
