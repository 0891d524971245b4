"""Compiled batch programs: bmh_tpu's lru_cached jax.jit programs on torch.

bmh_tpu runs each batch through a `jax.jit` program cached by
`functools.lru_cache(maxsize=128)` on its shapes and the knobs it reads
(bmh_tpu/models/pipeline.py), and each of its sharded steps through a
`jax.jit(shard_map(...))` (bmh_tpu/parallel/dataparallel.py).  Here a
program is a function of device tensors (models/pipeline.py: the two
compress programs, `inflate_program`, the three decode programs;
parallel/dataparallel.py: the sharded stages and the round-trip step), and
`run` / `run_device` keep, per device, up to MAX_ENTRIES of them keyed by
`key()`: the program's name, its static shapes and every knob any program
reads (KNOBS; BMH_LF2 included, which bmh_tpu's `_decode_flat` leaves out
of its key).  An input may be another program's output (`Feed`): the
feeding program runs first in the same turn of the device, and its output
is copied into the fed program's static input on the card.

On a card, the first call of a key copies the inputs into static buffers,
runs the function once as it is on a side stream (the warm-up: kernel
builds, K1's shared-memory opt-in, the allocator's first blocks), then
captures it with torch.cuda.CUDAGraph under
torch.cuda.set_sync_debug_mode("error") and replays it on the current
stream.  Every later call copies its inputs into the same buffers, in
stream order, and replays.  A `control.while_loop` inside the function
splits the capture: the code before the loop, the loop's body and the code
after it are graphs of their own, and the replay runs the body graph while
its predicate, copied to pinned memory, says to go on (one small read a
round; the `flag_reads` count).  A `control.stage(label)` mark inside the
function closes the graph open and opens the next one, and every step
captured from then on carries `label`; the program's first mark names the
graph that the capture opened with.  A replay records a timing event on
its stream wherever the label changes and once at the end, and the
output copy's `HostCopy.wait` adds each stage's milliseconds to
`STATS["stage_ms.<label>"]` (see STAGES).  A capture that fails raises:
there is no eager path on a card.  A collective of torch.distributed inside a program
(the sharded steps, NCCL on a card) is captured like any other work: the
warm-up has run it once, so its communicator exists before the capture.

All of a device's graphs share one memory pool, and every run of a
device's programs (input copies, replays, the output's copy to pinned host
memory, or to new device tensors for `run_device`) takes the device's lock
and waits, in stream order, for the run before it: a graph's temporaries,
state and outputs then hold their values only within one run, and may share
memory with any other graph.  The output copy is enqueued in the same run,
so the next replay cannot overwrite it first.

On the CPU (the tests) the same function runs as it is, through the same
key and counts: the CPU has no graphs, so this is no fallback.

LAUNCHES (ops/_build.py) stays true: a capture records the launches of
each graph instead of counting them, and each replay adds them.

Spans (utils/tracing.annotate, layer "programs"): `programs.run` around a
run (input load, replay launch, the output copy's start), with a child
`programs.capture` where its key is new (warm-up and capture);
`programs.flag` around each loop-flag read; `programs.wait` around
HostCopy.wait.  The last two are the host's waits for the card.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..ops import _build, control
from ..utils import config as config_mod
from ..utils.tracing import annotate

MAX_ENTRIES = 128
# every knob a program reads, in its key (bmh_tpu's keys: shapes plus
# _tier_key and the decode's place_mode, which the port does not read; and
# lf2, which bmh_tpu forgets).  A knob that only the host reads (min_bucket,
# through the nmax in the key) or that nothing reads (utils/config.py)
# stays out: flipping it would capture the same graphs again
KNOBS = ("mtf_chunk", "imtf_chunk", "full_rounds", "sparse_cap_div",
         "tier1_rounds", "tier2_div", "pallas_sort", "lf2")

# the stages that the compress programs mark (models/pipeline.py)
STAGES = ("rle1", "bwt", "mtf", "entropy")
# counts since the process started (or reset_stats): programs run, cache
# hits, warm-ups, captures and their seconds, graphs captured, graph
# replays (a loop body's every round counted), flag reads, and each
# stage's milliseconds on the card over the replays whose output copy was
# waited for.  A stage's time runs from the event recorded where it starts
# to the next one on the stream, so it includes the card's idle gaps
# inside the stage, such as a loop's flag-read round trips
STATS = {"runs": 0, "hits": 0, "warmups": 0, "captures": 0, "capture_s": 0.0,
         "graphs": 0, "replays": 0, "flag_reads": 0,
         **{f"stage_ms.{s}": 0.0 for s in STAGES}}
_stats_lock = threading.Lock()
_caches: dict = {}  # device -> _DeviceCache
_cpu_keys: OrderedDict = OrderedDict()  # the CPU's keys: counts only


def key(name: str, *, b_pad: int, nmax: int, nc: int = 0, chunk_bits: int = 0,
        maxl: int = 0, stride: int = 0, s: int = 0, mesh: tuple = ()) -> tuple:
    """The cache key of one program: its name and static shapes (s: the
    compact upload stream's length; mesh: a sharded program's identity, its
    maker's token, the group's size and this process's rank), then the
    value of every knob in KNOBS, read now."""
    cfg = config_mod.DEFAULT
    return (name, b_pad, nmax, nc, chunk_bits, maxl, stride, s, mesh) + tuple(
        getattr(cfg, k) for k in KNOBS)


def _count(**kw) -> None:
    with _stats_lock:
        for k, v in kw.items():
            STATS[k] += v


def reset_stats() -> None:
    with _stats_lock:
        for k, v in STATS.items():
            STATS[k] = 0.0 if isinstance(v, float) else 0


class Feed:
    """A program's input that another program computes: `fn` under key `k`
    on host arrays `inputs` (which may hold Feeds in turn).  The program it
    feeds runs it first, in the same turn of the device, and takes its
    output as that input: on a card by a device-to-device copy into the
    static input buffer, in stream order; the output never comes to the
    host."""

    def __init__(self, k: tuple, fn, inputs):
        self.k, self.fn, self.inputs = k, fn, inputs


class HostCopy:
    """A device tensor's copy to the host: on a card, into pinned memory
    with an event recorded after it (started, not waited for); on the CPU,
    the tensor itself.  `marks` are the stage marks of the replay that
    made the tensor (_Program.replay), counted once the copy is waited
    for."""

    def __init__(self, t: torch.Tensor, marks: list = ()):
        self.event = None
        self.marks = marks
        if t.device.type != "cuda":
            self.host = t
            return
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self) -> np.ndarray:
        with annotate("programs.wait", "programs"):
            if self.event is not None:
                self.event.synchronize()
            # the marks were recorded before the copy on its stream: all done
            marks, self.marks = self.marks, ()
            for (label, a), (_, b) in zip(marks, marks[1:]):
                _count(**{f"stage_ms.{label}": a.elapsed_time(b)})
            return self.host.numpy()


class _Capture:
    """The while_loop and stage runner of one capture: cuts the program
    into graphs at its loops and stage marks (see the module docstring).
    `steps` lists them in replay order: ("graph", label, g, launches) or
    ("loop", label, g, launches, flag); label is None before any mark."""

    def __init__(self, pool):
        self.pool = pool
        self.steps: list = []
        self.label = None
        self._graph = None
        self._tally = None

    def begin(self) -> None:
        self._graph = torch.cuda.CUDAGraph()
        self._rec = _build.recording()
        self._tally = self._rec.__enter__()
        self._graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def end(self):
        try:
            self._graph.capture_end()
        finally:
            self._rec.__exit__(None, None, None)
        g, tally, self._graph = self._graph, dict(self._tally), None
        return self.label, g, tally

    def while_loop(self, cond, body, state: tuple, max_trips: int) -> tuple:
        # private copies: the body graph writes its new state back into them
        state = tuple(s.clone() for s in state)
        flag = cond(*state).reshape(1).to(torch.int32)
        self.steps.append(("graph", *self.end()))
        self.begin()
        new = body(*state)
        for old, nxt in zip(state, new):
            old.copy_(nxt)
        flag.copy_(cond(*state).reshape(1))
        self.steps.append(("loop", *self.end(), flag))
        self.begin()
        return state

    def stage(self, label: str) -> None:
        if label not in STAGES:
            raise ValueError(f"unknown stage {label!r}: not in programs.STAGES")
        if self.steps or self.label is not None:
            self.steps.append(("graph", *self.end()))
            self.begin()
        self.label = label


def _timing_event() -> torch.cuda.Event:
    """A timing event recorded now on the current stream."""
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class _Program:
    """One cache entry on a card: static inputs, the captured steps and the
    output tensor their last graph writes."""

    def __init__(self, cache, fn, inputs):
        self.cache, self.fn = cache, fn
        self.inputs = [torch.empty(x.shape, dtype=x.dtype if torch.is_tensor(x)
                                   else torch.from_numpy(x[:0]).dtype,
                                   device=cache.device) for x in inputs]
        self.steps = None
        self.out = None
        self.marks: list = []  # the last replay's stage marks

    def load(self, inputs) -> None:
        """Copy the inputs into the static ones, in stream order: host
        arrays through pinned memory, device tensors (a Feed's output) on
        the card."""
        for buf, x in zip(self.inputs, inputs):
            if not torch.is_tensor(x):
                x = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
            buf.copy_(x, non_blocking=True)

    def warm_up(self) -> None:
        """One run as it is, on the cache's side stream.  Its memory, cached
        for that stream, goes back to the card before the capture takes the
        pool's (at 32 x 2 MiB each holds about 17 GB)."""
        side = self.cache.side
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.empty_cache()
        _count(warmups=1)

    def capture(self) -> None:
        """Capture the program into graphs; raises where it fails."""
        side = self.cache.side
        t = time.perf_counter()
        # the warm-up's work done (an event: a stream synchronize would
        # trip the sync debug mode of a caller that set it)
        done = torch.cuda.Event()
        done.record(side)
        done.synchronize()
        cap = _Capture(self.cache.pool)
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                control.set_runner(cap)
                try:
                    cap.begin()
                    try:
                        out = self.fn(*self.inputs)
                    finally:
                        g = cap.end()
                finally:
                    control.set_runner(None)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        cap.steps.append(("graph", *g))
        torch.cuda.current_stream().wait_stream(side)
        self.steps, self.out = cap.steps, out
        _count(captures=1, graphs=len(cap.steps),
               capture_s=time.perf_counter() - t)

    def replay(self, trips: list | None = None) -> list:
        """Replay the steps on the current stream; a loop step reads its
        flag (written by the step before and by its body) once a round.
        Returns the rounds each loop ran.  Given `trips` (what an earlier
        replay of the same inputs returned), the loops run that many rounds
        without reading a flag: what a loop on the card (a conditional
        WHILE node) would save; it is right only for those inputs.  A program with stage marks records
        a timing event before the first step of each stage and one after
        the last step, into `marks` as (label, event)."""
        host = torch.empty(1, dtype=torch.int32, pin_memory=True)
        ev = torch.cuda.Event()
        replays = reads = 0
        ran = []
        marks, label = [], None
        for step in self.steps:
            if step[1] != label:
                label = step[1]
                marks.append((label, _timing_event()))
            if step[0] == "graph":
                step[2].replay()
                _build.add_launches(step[3])
                replays += 1
                continue
            _, _, g, tally, flag = step
            rounds = 0
            while True:
                if trips is not None:
                    if rounds == trips[len(ran)]:
                        break
                else:
                    with annotate("programs.flag", "programs"):
                        host.copy_(flag, non_blocking=True)
                        ev.record()
                        ev.synchronize()
                    reads += 1
                    if not host[0]:
                        break
                g.replay()
                _build.add_launches(tally)
                replays += 1
                rounds += 1
            ran.append(rounds)
        if marks:
            marks.append((None, _timing_event()))
        self.marks = marks
        _count(replays=replays, flag_reads=reads)
        return ran


class _DeviceCache:
    """A card's programs (least recently used first), its graph pool, its
    side stream and the lock and event that order its runs."""

    def __init__(self, device: torch.device):
        self.device = device
        self.entries: OrderedDict = OrderedDict()
        self.lock = threading.Lock()
        with torch.cuda.device(device):
            self.pool = torch.cuda.graph_pool_handle()
            self.side = torch.cuda.Stream(device)
        self.done = None  # event after the last run's output copy


def _cache_for(device: torch.device) -> _DeviceCache:
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _stats_lock:
        c = _caches.get(device)
        if c is None:
            c = _caches[device] = _DeviceCache(device)
        return c


def clear() -> None:
    """Drop every cached program (the next call of each key captures
    again)."""
    with _stats_lock:
        caches = list(_caches.values())
        _cpu_keys.clear()
    for c in caches:
        with c.lock:
            c.entries.clear()
            # the pool went with its last graph: the next capture needs a new one
            with torch.cuda.device(c.device):
                c.pool = torch.cuda.graph_pool_handle()
    torch.cuda.empty_cache()


def _cpu_call(k: tuple, fn, inputs):
    """Program `fn` run as it is on the CPU, through key `k`'s counts (its
    Feeds first, as on a card)."""
    args = [_cpu_call(x.k, x.fn, x.inputs) if isinstance(x, Feed)
            else x if torch.is_tensor(x)
            else torch.from_numpy(np.ascontiguousarray(x)) for x in inputs]
    _count(runs=1)
    with _stats_lock:
        hit = k in _cpu_keys
        _cpu_keys[k] = True
        _cpu_keys.move_to_end(k)
        while len(_cpu_keys) > MAX_ENTRIES:
            _cpu_keys.popitem(last=False)
    _count(hits=int(hit))
    return fn(*args)


def _replayed(c: _DeviceCache, k: tuple, fn, inputs) -> _Program:
    """Program `fn` under key `k` on card cache `c` (its lock held): its
    Feeds run first, then the inputs are loaded, the program captured if
    its key is new, and replayed.  Returns the entry, whose `out` holds the
    result until the device's next run."""
    inputs = [_replayed(c, x.k, x.fn, x.inputs).out if isinstance(x, Feed) else x
              for x in inputs]
    _count(runs=1)
    prog = c.entries.get(k)
    if prog is not None:
        c.entries.move_to_end(k)
        _count(hits=1)
        prog.load(inputs)
    else:
        with annotate("programs.capture", "programs"):
            prog = _Program(c, fn, inputs)
            prog.load(inputs)
            prog.warm_up()
            prog.capture()
        c.entries[k] = prog
        while len(c.entries) > MAX_ENTRIES:
            c.entries.popitem(last=False)
    prog.replay()
    return prog


def run(device, k: tuple, fn, inputs, out_len: int | None = None) -> HostCopy:
    """Run program `fn` (one output tensor) on `inputs` (numpy arrays, or
    Feeds) on `device` through the cache entry `k`, and start the copy of
    the first `out_len` elements of its output (all with None) to the
    host."""
    device = torch.device(device)
    with annotate("programs.run", "programs"):
        if device.type != "cuda":
            out = _cpu_call(k, fn, inputs)
            return HostCopy(out if out_len is None else out[:out_len])
        c = _cache_for(device)
        with torch.cuda.device(c.device), c.lock:
            if c.done is not None:
                torch.cuda.current_stream().wait_event(c.done)
            prog = _replayed(c, k, fn, inputs)
            copy = HostCopy(prog.out if out_len is None else prog.out[:out_len],
                            prog.marks)
            c.done = copy.event
            return copy


def run_device(device, k: tuple, fn, inputs) -> tuple:
    """Run program `fn`, which returns a tuple of tensors, on `inputs`
    (numpy arrays or tensors) on `device` through the cache entry `k`, and
    return its outputs as tensors of their own on that device (on a card,
    copies made in the same turn, which no later replay overwrites)."""
    device = torch.device(device)
    with annotate("programs.run", "programs"):
        if device.type != "cuda":
            return tuple(_cpu_call(k, fn, inputs))
        c = _cache_for(device)
        with torch.cuda.device(c.device), c.lock:
            if c.done is not None:
                torch.cuda.current_stream().wait_event(c.done)
            outs = tuple(o.clone() for o in _replayed(c, k, fn, inputs).out)
            c.done = torch.cuda.Event()
            c.done.record()
            return outs
