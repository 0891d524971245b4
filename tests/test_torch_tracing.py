"""The port's span recorder (utils/tracing.py) on the CPU: nothing kept or
allocated while off; under `recording()` a compress_many and a
decompress_many give every span of the request path, one request id a
call, nested parents and self times that add up to each request's root;
under torch.profiler the same spans are record_function events on one
clock with the recorder's."""

import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

import bmh_tpu_torch as bt
from bmh_tpu_torch.utils import tracing

BS = 4096
API = {"api.compress", "api.split", "api.pack",
       "api.decompress", "api.parse", "api.validate", "api.restore", "api.join"}
PIPELINE = {"pipeline.group", "pipeline.rle1", "pipeline.stage", "compress_assemble",
            "pipeline.drain"}
PROGRAMS = {"programs.run", "programs.flag", "programs.wait"}
STAGES = {"stage.rle1", "stage.bwt", "stage.mtf", "stage.entropy"}  # run eagerly: spans only
DISPATCH = ("compress_dispatch_b", "decompress_dispatch_b", "decompress_single_b")


def _inputs():
    """Text over several blocks, a random block and a single-symbol one
    (both kinds of decode dispatch span)."""
    rng = np.random.default_rng(18)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta\n"]
    text = b"".join(words[i] for i in rng.integers(0, 4, 2500))
    return [text, bytes(rng.integers(0, 256, 3000, dtype=np.uint8)), b"\x00" * 3]


def _round_trip():
    datas = _inputs()
    blobs = bt.compress_many(datas, block_size=BS, device="cpu")
    assert bt.decompress_many(blobs, device="cpu") == datas


@pytest.fixture(scope="module")
def spans():
    with tracing.recording() as rec:
        _round_trip()
    return rec


def _by_id(rec):
    return {s[0]: s for s in rec.spans}


def test_off_keeps_nothing_and_allocates_nothing():
    assert tracing._recorder is None
    assert tracing.annotate("api.parse", "api") is tracing.annotate("x")
    _round_trip()  # nothing records: no recorder holds its spans
    with tracing.recording() as rec:
        pass
    assert rec.spans == []
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with tracing.annotate("pipeline.stage"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    where = [tracemalloc.Filter(True, tracing.__file__)]
    grown = after.filter_traces(where).compare_to(before.filter_traces(where), "filename")
    assert sum(d.size_diff for d in grown) == 0


def test_every_span_of_the_request_path(spans):
    names = set(spans.counts())
    assert API | PIPELINE | PROGRAMS | STAGES <= names
    for prefix in DISPATCH:
        assert any(n.startswith(prefix) for n in names), prefix
    # nothing is captured on the CPU: programs.capture shows on a card only
    assert "programs.capture" not in names
    assert names <= (API | PIPELINE | PROGRAMS | STAGES
                     | {n for n in names if n.startswith(DISPATCH)})
    layers = {s[4]: s[3] for s in spans.spans}
    assert {layers[n] for n in API} == {"api"}
    assert {layers[n] for n in PROGRAMS} == {"programs"}
    assert {layers[n] for n in STAGES} == {"device programs"}
    assert {layers[n] for n in names - API - PROGRAMS - STAGES} == {"pipeline"}


def test_one_request_per_api_call(spans):
    roots = [s for s in spans.spans if s[1] == 0]
    assert [s[4] for s in roots] == ["api.compress", "api.decompress"]
    assert len({s[2] for s in roots}) == 2
    assert {s[2] for s in spans.spans} == {s[2] for s in roots}


def test_parents_nest(spans):
    by_id = _by_id(spans)
    assert len(by_id) == len(spans.spans)
    for sid, parent, request, _, _, t0, t1 in spans.spans:
        assert t0 <= t1
        if parent:
            p = by_id[parent]
            assert p[2] == request and p[5] <= t0 and t1 <= p[6], (sid, parent)
            assert p[0] > 0
    # a dispatch's stage and program run sit inside the dispatch span
    for s in spans.spans:
        if s[4] in ("pipeline.stage", "programs.run"):
            assert by_id[s[1]][4].startswith(DISPATCH)


def test_self_times_add_up_to_each_request(spans):
    by_name = spans.self_ns()
    assert sum(by_name.values()) == sum(spans.self_ns("layer").values())
    assert all(v >= 0 for v in by_name.values())
    for root in (s for s in spans.spans if s[1] == 0):
        one = tracing.Recorder()
        one.spans = [s for s in spans.spans if s[2] == root[2]]
        assert sum(one.self_ns().values()) == root[6] - root[5]
    assert sum(spans.counts("layer").values()) == len(spans.spans)


def test_self_time_is_duration_less_children():
    with tracing.recording() as rec:
        with tracing.annotate("outer", "api"):
            time.sleep(0.002)
            with tracing.annotate("inner"):
                time.sleep(0.003)
            with tracing.annotate("inner"):
                pass
    inner = [s for s in rec.spans if s[4] == "inner"]
    (outer,) = [s for s in rec.spans if s[4] == "outer"]
    dur = {s[0]: s[6] - s[5] for s in rec.spans}
    assert rec.self_ns() == {"inner": sum(dur[s[0]] for s in inner),
                             "outer": dur[outer[0]] - sum(dur[s[0]] for s in inner)}
    assert rec.self_ns("layer")["api"] >= 2_000_000
    assert rec.counts() == {"inner": 2, "outer": 1}
    assert rec.counts("layer") == {"pipeline": 2, "api": 1}
    lines = rec.report().splitlines()
    assert sorted(lines) == sorted([f"inner: 2 spans, self {rec.self_ns()['inner'] / 1e6:.3f} ms",
                                    f"outer: 1 spans, self {rec.self_ns()['outer'] / 1e6:.3f} ms"])
    assert lines[0].startswith("inner" if rec.self_ns()["inner"] > rec.self_ns()["outer"]
                               else "outer")


def test_a_thread_and_a_nested_recording_start_their_own():
    seen = {}

    def other():
        with tracing.annotate("other"):
            pass

    with tracing.recording() as outer:
        with tracing.annotate("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with tracing.recording() as inner:
                with tracing.annotate("nested"):
                    pass
            seen["back"] = tracing._recorder
    assert seen["back"] is outer and tracing._recorder is None
    assert [s[4] for s in inner.spans] == ["nested"] and inner.spans[0][1] == 0
    main, other_span = (next(s for s in outer.spans if s[4] == n) for n in ("main", "other"))
    assert other_span[1] == 0 and other_span[2] != main[2]


def test_spans_are_profiler_events_on_one_clock():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        # a profile's first range sets its thread's state up inside
        # record_function's enter (0.1-0.7 ms on a CPU), before or after the
        # profiler's stamp: not a clock's offset
        with torch.profiler.record_function("first range"):
            pass
        with tracing.recording() as rec:
            _round_trip()
    events: dict = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.is_user_annotation:
            events.setdefault(e.name, []).append(e.time_range.start)
    offsets = []
    for name, n in rec.counts().items():
        starts = sorted(s[5] for s in rec.spans if s[4] == name)
        assert len(events.get(name, [])) == n, name
        offsets += [t / 1e3 - us for t, us in zip(starts, events[name])]
    assert len(offsets) == len(rec.spans)
    # one offset between the clocks, each span's within 200 µs of it
    common = float(np.median(offsets))
    assert max(abs(o - common) for o in offsets) < 200.0
