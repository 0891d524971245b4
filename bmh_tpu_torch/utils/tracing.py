"""Profiling and tracing hooks on torch.profiler (bmh_tpu/utils/tracing.py's
counterparts), and the port's one span recorder.

`annotate(name, layer)` is the span entry point.  Off (no `recording()`
open and no profiler recording) it returns one shared null context, so the
hot path pays a flag check and the profiler check and allocates nothing.
While torch.profiler records, a span is a record_function range, and on a
card an NVTX range too.  Inside `recording()` it is also kept by the
`Recorder` that `recording()` yields: (id, parent id, request id, layer,
name, start ns, end ns) on `time.perf_counter_ns()`.  A span opened with
no span open on its thread starts a new request; the spans opened inside
it, on that thread, share its request id.  The port's spans are per
request, per stage and per batch, never per block; their layers are
"api", "pipeline" and "programs".

`device_trace(out_dir)` records the enclosed block with torch.profiler,
the CUDA activity included on a card, and writes a Chrome trace under
`out_dir` or BMH_TRACE_DIR; without a directory it does nothing.
`device_activity` lists the card's work in a finished profile, `busy_ms`
the time the card had any of it running, and `device_profile` gives both
for one call with its wall time and idle share.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch


@contextmanager
def device_trace(out_dir: str | None = None):
    """Record the enclosed block into a Chrome trace under `out_dir` (or
    BMH_TRACE_DIR); a no-op without a directory.  Yields the trace file's
    path, or None."""
    d = out_dir or os.environ.get("BMH_TRACE_DIR")
    if not d:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(d) / f"bmh_trace_{os.getpid()}_{time.time_ns()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(str(path))


class Recorder:
    """The spans kept while `recording()` is open: `spans` lists (id,
    parent id, request id, layer, name, start ns, end ns) in the order
    they closed; parent id 0 marks a request's root.  Each thread keeps
    its own stack of open spans."""

    def __init__(self):
        self.spans: list[tuple] = []
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def self_ns(self, by: str = "name") -> dict:
        """Self time (ns) of the spans, summed by "name" or "layer": a
        span's duration less the part its child spans cover (children are
        opened on the span's own thread, one after another)."""
        inner: dict = defaultdict(int)
        for _, parent, _, _, _, t0, t1 in self.spans:
            inner[parent] += t1 - t0
        col = 4 if by == "name" else 3
        out: dict = defaultdict(int)
        for s in self.spans:
            out[s[col]] += s[6] - s[5] - inner.get(s[0], 0)
        return dict(out)

    def counts(self, by: str = "name") -> dict:
        """Spans closed, by "name" or "layer"."""
        col = 4 if by == "name" else 3
        out: dict = defaultdict(int)
        for s in self.spans:
            out[s[col]] += 1
        return dict(out)

    def report(self) -> str:
        """One line per span name, the most self time first: its count and
        self time in ms."""
        counts = self.counts()
        return "\n".join(f"{name}: {counts[name]} spans, self {ns / 1e6:.3f} ms"
                         for name, ns in sorted(self.self_ns().items(),
                                                key=lambda kv: -kv[1]))


# the recorder of the open `recording()`, or None: the one flag the off
# path checks
_recorder: Recorder | None = None
_OFF = nullcontext()


@contextmanager
def recording():
    """Keep every span of this process while the block runs; yields the
    Recorder.  A nested `recording()` keeps the spans of its block to
    itself and hands the outer one back at its end."""
    global _recorder
    outer, rec = _recorder, Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = outer


class _Span:
    """One span while the recorder or a profiler records."""

    __slots__ = ("name", "layer", "region", "nvtx", "rec", "sid", "parent",
                 "request", "t0")

    def __init__(self, name: str, layer: str):
        self.name, self.layer = name, layer

    def __enter__(self):
        # the recorder's clock runs outside the profiler's range, so that
        # the range's own cost is the span's, not its parent's
        rec = self.rec = _recorder
        if rec is not None:
            stack = rec._stack()
            if stack:
                self.parent, self.request = stack[-1]
            else:
                self.parent, self.request = 0, next(rec._requests)
            self.sid = next(rec._ids)
            stack.append((self.sid, self.request))
            self.t0 = time.perf_counter_ns()
        self.region = None
        if torch._C._autograd._profiler_enabled():
            self.nvtx = torch.cuda.is_available()
            if self.nvtx:
                torch.cuda.nvtx.range_push(self.name)
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        return self

    def __exit__(self, *exc):
        if self.region is not None:
            try:
                self.region.__exit__(*exc)
            finally:
                if self.nvtx:
                    torch.cuda.nvtx.range_pop()
        rec = self.rec
        if rec is not None:
            t1 = time.perf_counter_ns()
            rec._stack().pop()
            rec.spans.append((self.sid, self.parent, self.request, self.layer,
                              self.name, self.t0, t1))
        return False


def annotate(name: str, layer: str = "pipeline"):
    """A span named `name` of `layer`: the shared null context while
    nothing records (see the module docstring)."""
    if _recorder is None and not torch._C._autograd._profiler_enabled():
        return _OFF
    return _Span(name, layer)


def device_activity(prof) -> list[tuple[str, float, float]]:
    """The card's kernels, copies and fills in a finished torch.profiler
    run, as (name, start us, end us).  An annotated range also shows on the
    card, spanning the kernels it encloses; the profiler marks it a user
    annotation, and it is left out."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def busy_ms(spans) -> float:
    """The time covered by the union of (name, start us, end us) spans:
    work on several streams may overlap."""
    busy, end = 0.0, float("-inf")
    for _, a, b in sorted(spans, key=lambda x: x[1]):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def device_profile(fn) -> dict:
    """fn() on a card under torch.profiler: prof_wall_ms (the host clock
    around the call and a synchronize, which the profiler lengthens),
    device_ms (the card's kernels, copies and fills summed over every
    stream), busy_ms (the union of their intervals), idle_share (1 - busy /
    wall) and spans (device_activity's list)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    spans = device_activity(prof)
    busy = busy_ms(spans)
    return {"prof_wall_ms": wall, "device_ms": sum(b - a for _, a, b in spans) / 1e3,
            "busy_ms": busy, "idle_share": 1 - busy / wall, "spans": spans}
