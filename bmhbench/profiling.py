"""What the benchmark reads from torch.profiler and from the host's waits.

Frozen copies of the program's arithmetic (bmh_tpu_torch/utils/tracing.py:
device_activity, busy_ms; bmh_tpu_torch/tools/ab_trees.py: count_syncs),
kept here so that a change to the program cannot change how it is
measured, and the reduction of one profiled window to the numbers that
the per-layer readers take: device time summed and as a union, the
window's length, time by device operation, idle gaps by the host span
they fall in."""

from __future__ import annotations

import warnings
from collections import defaultdict
from contextlib import contextmanager

WINDOW_SPAN = "bench.window"


@contextmanager
def count_syncs(counts: dict):
    """Counts the host's waits for the card while the block runs, into
    `counts`: `event_waits` (torch.cuda.Event.synchronize, which the
    program's copies and loop flags wait on) and `torch_syncs` (operations
    that read a card tensor on the host: sync debug mode "warn" reports
    each)."""
    import torch

    counts.setdefault("event_waits", 0)
    counts.setdefault("torch_syncs", 0)
    event_sync = torch.cuda.Event.synchronize

    def counted(self):
        counts["event_waits"] += 1
        return event_sync(self)

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.Event.synchronize = counted
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            yield counts
    finally:
        torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.Event.synchronize = event_sync
        counts["torch_syncs"] += sum("synchronizing CUDA operation" in str(w.message)
                                     for w in seen)


def device_activity(events) -> list[tuple[str, float, float]]:
    """The card's kernels, copies and fills, as (name, start us, end us);
    an annotated range shown on the card is left out."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def union(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    """The merged intervals that (name, start, end) spans cover in [lo, hi]."""
    out: list[list[float]] = []
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def host_spans(events) -> list[tuple[str, float, float]]:
    """The host's annotated ranges (record_function): the benchmark's own
    around each request and each call into the program's backend, and the
    program's own."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU and e.is_user_annotation]


def reduce(prof) -> dict:
    """One profiled window (the span WINDOW_SPAN) reduced: window_s,
    busy_s (union of device work), device_s (summed), device_by_name
    {name: s}, idle_by_span {host span: s of idle device time in it}."""
    events = prof.events()
    hosts = host_spans(events)
    lo, hi = next((a, b) for n, a, b in hosts if n == WINDOW_SPAN)
    dev = [(n, max(a, lo), min(b, hi)) for n, a, b in device_activity(events)
           if b > lo and a < hi]
    busy = union(dev, lo, hi)
    by_name: dict = defaultdict(float)
    for n, a, b in dev:
        by_name[n] += (b - a) / 1e6
    idle: dict = defaultdict(float)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    inner = [(n, a, b) for n, a, b in hosts if n != WINDOW_SPAN]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        around = [(y - x, n) for n, x, y in inner if x <= mid <= y]
        idle[min(around)[1] if around else "between requests"] += (b - a) / 1e6
    return {"window_s": (hi - lo) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_s": sum(b - a for _, a, b in dev) / 1e6,
            "device_by_name": dict(by_name), "idle_by_span": dict(idle)}


def top(d: dict, k: int = 10) -> list[list]:
    return [[n, s] for n, s in sorted(d.items(), key=lambda x: -x[1])[:k]]
