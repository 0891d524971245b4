"""The archive cells (configuration archive-1m) and the stage readers.

On the CPU at the tiny size both cells run correct and the control does
not; the configuration is stream-128k's but for its name, block size and
sourcing; the three `stage_ms_per_MB.*` readers give the program's stage
counter over the window's MB, and nothing where the program keeps no such
counter (a checkout from before the counters) or counted nothing."""

import time
from types import SimpleNamespace

import pytest

from bmhbench import run, spec
from bmhbench import sut as sut_mod
from bmhbench.tests.cells import tiny

CELLS = ("archive1m-compress", "archive1m-decompress")
STAGES = ("bwt", "mtf", "entropy")


def _run(bench, cell, sut_name="port"):
    config, mix = tiny(bench, cell)
    sut = sut_mod.make(sut_name, config, "cpu")
    return run.run_cell(cell, config, mix, sut, 2**32 + 20, 0.3, False,
                        spec.metrics(bench, cell, False), time.perf_counter(), None)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_archive_run_is_correct(bench, cell):
    r = _run(bench, cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {m["name"] for m in spec.metrics(bench, cell, False)}
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_archive_control_is_not_correct(bench, cell):
    r = _run(bench, cell, "control")
    assert not r["correct"] and r["checks"]["sampled_blocks_wrong"]["value"] > 0


def test_archive_is_the_stream_at_the_clis_block(bench):
    archive, stream = spec.config(bench, "archive-1m"), spec.config(bench, "stream-128k")
    changed = {k for k in archive.keys() | stream.keys() if archive.get(k) != stream.get(k)}
    assert changed == {"name", "source", "deployment", "block_size", "assumed"}
    assert archive["block_size"] == 1 << 20 and archive["reduced"] == []
    entry = next(c for c in bench["configs"] if c["name"] == "archive-1m")
    assert entry["source"] == archive["source"] and entry["reduced"] == []


def _window(delta, direction="compress", raw_bytes=4_000_000):
    return SimpleNamespace(direction=direction, raw_bytes=raw_bytes,
                           spans={"delta": delta})


@pytest.mark.parametrize("stage", STAGES)
def test_stage_reader(bench, stage):
    read = spec.reader(f"stage_ms_per_MB.{stage}")
    key = f"programs.stage_ms.{stage}"
    assert read(_window({key: 10.0})) == pytest.approx(2.5)
    assert read(_window({"programs.runs": 3})) is None  # a program without the counter
    assert read(_window({key: 0.0})) is None
    assert read(_window({key: 10.0}, direction="decompress")) is None
    assert read(SimpleNamespace(direction="compress", raw_bytes=1, spans=None)) is None
    m = next(m for m in bench["per_layer"] if m["name"] == f"stage_ms_per_MB.{stage}")
    assert m["workloads"] == ["stream128k-compress", "objects-put", "archive1m-compress"]
