"""Runs one cell of BENCHMARK.json once and prints its result line.

    python3 -m bmhbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in setup_s, from the start of this module): the program
imported with the configuration's knobs, the cell's pool of requests made
from the seed, and every request of the pool run once, which builds the
kernels on a checkout's first run and captures every program the window
replays; a decompress cell's set-up also makes its containers with the
program.  The window: one closed-loop client sends the pool's requests in
turn until `--seconds` have passed, and the window ends with the last
call.  With `--trace 1` the window runs with the benchmark's spans and the
program's counters read, and then `trace_requests` more requests run
under torch.profiler.  Once the window has closed: the check that no JAX
module is loaded, the device's memory peak, the comparison with the
reference (check.py), the metrics by their readers (metrics/<name>.py),
and the result as the last line of standard output, with each number
compared beside its limit also on the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from . import check, profiling, spec, traffic, work  # noqa: E402

# top-level module names that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "bmh_tpu")


def loaded_forbidden() -> list[str]:
    """FORBIDDEN names among sys.modules' top-level names, compared whole
    (bmh_tpu_torch is not bmh_tpu)."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _loop(call, inputs: list, seconds: float):
    """The closed loop: (pool index, the call's outputs, or None where it
    raised) per call, each call's seconds, the window's seconds, and the
    calls that raised.  Every output is kept for the comparison after the
    window."""
    produced, lat, failed = [], [], 0
    k = 0
    t0 = end = time.perf_counter()
    while end - t0 < seconds:
        p = k % len(inputs)
        t = time.perf_counter()
        try:
            out = call(inputs[p])
        except Exception as e:  # a failed request counts against the run
            out = None
            failed += 1
            if failed == 1:
                print(f"request {k} raised {type(e).__name__}: {e}", file=sys.stderr)
        end = time.perf_counter()
        produced.append((p, out))
        lat.append(end - t)
        k += 1
    return produced, lat, end - t0, failed


def _profiled(sut, call, inputs: list, n: int) -> dict:
    """`n` requests under torch.profiler, reduced (profiling.reduce)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    sut.sync()
    with sut.instrument(syncs=False):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(profiling.WINDOW_SPAN):
                for k in range(n):
                    with record_function("bench.request"):
                        call(inputs[k % len(inputs)])
                torch.cuda.synchronize()
    out = profiling.reduce(prof)
    out["requests"] = [k % len(inputs) for k in range(n)]
    return out


def _item_bytes(items) -> int:
    return sum(len(x) for x in items)


def run_cell(name: str, config: dict, mix: dict, sut, seed: int, seconds: float,
             trace: bool, metrics: list[dict], t_start: float, card: str | None) -> dict:
    """One run of a cell; returns the result line's object.  `card` is the
    device's name, or None off a card (the tests' runs)."""
    direction = mix["direction"]
    stages = {"start": time.perf_counter() - t_start}
    pool = traffic.pool(config, mix, seed)
    stages["inputs"] = time.perf_counter() - t_start
    if direction == "compress":
        inputs, made, call = pool, None, sut.compress
    elif direction == "decompress":
        made = [sut.compress(req) for req in pool]
        inputs, call = made, sut.decompress
        stages["containers"] = time.perf_counter() - t_start
    else:
        raise ValueError(f"unknown direction {direction!r}")
    if sut.warm_up:
        for req in inputs:  # every shape the window uses, built and captured
            call(req)
    sut.sync()
    setup_s = time.perf_counter() - t_start
    print(f"{name}: set-up reached " + ", ".join(f"{k} at {v:.3f} s" for k, v in stages.items()),
          file=sys.stderr)

    before = sut.counters()
    spans = None
    if trace:
        with sut.instrument() as spans:
            produced, lat, window_s, failed = _loop(call, inputs, seconds)
    else:
        produced, lat, window_s, failed = _loop(call, inputs, seconds)
    after = sut.counters()
    prof = None
    if trace and card is not None:
        prof = _profiled(sut, call, inputs, int(mix["trace_requests"]))
        prof["raw_bytes"] = sum(_item_bytes(pool[p]) for p in prof["requests"])
        if direction == "decompress":
            prof["decode_work"] = work.decode_work(
                [b for p in prof["requests"] for b in inputs[p]])
    memory = 0
    if card is not None:
        import torch

        memory = torch.cuda.max_memory_reserved()

    # the uncompressed bytes of the calls that returned: a compress call's
    # input, a decompress call's output
    raw = sum(_item_bytes(pool[p]) for p, o in produced if o is not None)
    if direction == "compress":
        checks = check.containers(pool, produced, config, int(mix["check_blocks"]), seed)
    else:
        checks = {"outputs_wrong": sum(check.items_wrong(pool[p], outs)
                                       for p, outs in produced)}
        checks.update(check.containers(pool, list(enumerate(made)), config,
                                       int(mix["check_blocks"]), seed))
    compares = {k: {"value": int(v), "limit": check.LIMITS[k]} for k, v in checks.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in compares.values())

    window = SimpleNamespace(
        direction=direction, setup_s=setup_s, window_s=window_s, latencies_s=lat,
        raw_bytes=raw, spans=spans, profile=prof, card=card)
    values = {}
    for m in metrics:
        v = spec.reader(m["name"])(window)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    delta = {k: after[k] - before[k] for k in after}
    print(f"{name}: set-up {setup_s:.3f} s, {len(produced)} requests in "
          f"{window_s:.3f} s, {failed} failed; graph captures in the window "
          f"{delta.get('programs.captures', 0)}, warm-ups "
          f"{delta.get('programs.warmups', 0)}", file=sys.stderr)
    device = {"platform": "gpu" if card is not None else "cpu", "kind": card or "cpu",
              "count": 1, "memory_peak_bytes": int(memory)}
    result = {"correct": correct, "attempted": len(produced), "failed": failed,
              "metrics": values, "device": device}
    if prof is not None:
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": profiling.top(prof["device_by_name"]),
                               "idle_gaps": profiling.top(prof["idle_by_span"])}
    result["checks"] = compares
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sut", choices=("port", "control"), default="port",
                    help="the system under test: the program, or the control "
                         "codec (control.py) that the comparison must fail")
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")

    bench = spec.load()
    cell = spec.workload(bench, args.workload)
    config = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    metrics = spec.metrics(bench, cell["name"], bool(args.trace))

    # one process with one intra-op thread: the host side is the bottleneck
    # of every cell, and a thread pool's spinning made runs slower and
    # spread them wider (PERF.md, PR 17)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    from . import sut as sut_mod

    sut = sut_mod.make(args.sut, config)
    result = run_cell(cell["name"], config, mix, sut, args.seed, args.seconds,
                      bool(args.trace), metrics, T_START, torch.cuda.get_device_name(0))
    bad = loaded_forbidden()
    if bad:
        print(f"modules loaded that the benchmark must not load: {bad}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
