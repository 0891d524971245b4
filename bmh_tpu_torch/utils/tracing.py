"""Profiling and tracing hooks on torch.profiler (bmh_tpu/utils/tracing.py's
counterparts).

`annotate(name)` names a region in a profiler trace (record_function) and,
where a card is present, as an NVTX range; it does nothing while no
profiler records, so the hot path pays one check for it.  `device_trace(out_dir)` records
the enclosed block with torch.profiler, the CUDA activity included on a
card, and writes a Chrome trace under `out_dir` or BMH_TRACE_DIR; without
a directory it does nothing.  `device_activity` lists the card's work in a
finished profile, and `busy_ms` the time the card had any of it running.
`StageTimer` sums wall-clock time per named stage.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
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


@contextmanager
def annotate(name: str):
    """Named region visible in profiler traces, and in NVTX on a card,
    while a profiler records."""
    if not torch._C._autograd._profiler_enabled():
        yield
        return
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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


class StageTimer:
    """Accumulates wall-clock per named stage; cheap enough to leave on."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{k}: {v:.3f}s over {self.counts[k]} calls"
                 for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines)
