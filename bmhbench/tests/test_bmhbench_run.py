"""Runs of the harness: on the CPU at a tiny size with the program's plain
versions (the look for a card skipped), with the control in the
program's place, and with the timed path broken underneath, where
`correct` has to come out false; on a card, the command itself."""

import json
import shutil
import subprocess
import sys
import time

import pytest

from bmhbench import run, spec
from bmhbench import sut as sut_mod
from bmhbench.tests.cells import tiny

CELLS = ("stream128k-compress", "stream128k-decompress", "objects-put", "objects-get")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(bench, cell, sut=None, trace=False, seconds=0.3, seed=2**32 + 17):
    config, mix = tiny(bench, cell)
    sut = sut or sut_mod.make("port", config, "cpu")
    return run.run_cell(cell, config, mix, sut, seed, seconds, trace,
                        spec.metrics(bench, cell, trace), time.perf_counter(), None)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(bench, cell):
    r = _run(bench, cell)
    assert list(r) == RESULT_KEYS  # `checks` comes last
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    e2e = {m["name"] for m in spec.metrics(bench, cell, False)}
    assert set(r["metrics"]) == e2e
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c["value"] == 0 == c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", ("stream128k-compress", "objects-get"))
def test_tiny_traced_run_reads_the_host_side_layers(bench, cell):
    r = _run(bench, cell, trace=True)
    assert r["correct"]
    direction = spec.traffic(spec.workload(bench, cell)["traffic"])["direction"]
    assert f"api_host_share.{direction}" in r["metrics"]
    # the device readers find nothing off a card and are left out
    assert not any(k.startswith(("idle_share", "device_ms")) for k in r["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench, cell):
    config, _ = tiny(bench, cell)
    r = _run(bench, cell, sut=sut_mod.make("control", config))
    assert not r["correct"]
    assert r["checks"]["sampled_blocks_wrong"]["value"] > 0


class _Broken:
    """The program with a fault planted under the harness."""

    def __init__(self, config, fault):
        self.port = sut_mod.make("port", config, "cpu")
        self.fault = fault

    def __getattr__(self, name):
        return getattr(self.port, name)

    def compress(self, items):
        return self.fault("compress", items, self.port.compress)

    def decompress(self, items):
        return self.fault("decompress", items, self.port.decompress)


def _unchanged(direction, items, call):
    """A step that returns its input as it came."""
    return list(items)


def _half_left_out(direction, items, call):
    """Half of the batch left out: the first half's answers stand in for
    the rest."""
    half = max(len(items) // 2, 1)
    out = call(items[:half])
    return (out * 2)[:len(items)]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_left_out])
def test_broken_timed_path_is_not_correct(bench, cell, fault):
    config, mix = tiny(bench, cell)
    if fault is _half_left_out and mix["items_per_request"] < 2:
        pytest.skip("a request of one item has no half to leave out")
    wrapped = _Broken(config, lambda d, items, call: (
        fault(d, items, call) if d == mix["direction"] else call(items)))
    assert not _run(bench, cell, sut=wrapped)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced_is_not_correct(bench, cell, monkeypatch):
    """A byte of every block's payload (compress) or of every restored
    block (decompress) altered inside the program."""
    from bmh_tpu_torch import api

    config, mix = tiny(bench, cell)
    sut = sut_mod.make("port", config, "cpu")
    if mix["direction"] == "compress":
        pack = api._pack_block

        def altered(r, raw_len):
            if r["payload"]:
                r = dict(r, payload=bytes([r["payload"][0] ^ 1]) + r["payload"][1:])
            return pack(r, raw_len)

        monkeypatch.setattr(api, "_pack_block", altered)
    else:
        restore = api._rle1_restore

        def altered(part, raw_len):
            out = restore(part, raw_len).copy()
            out[0] ^= 1
            return out

        # the set-up's containers are made before the fault is planted
        real = sut_mod.Port.decompress

        def decompress(self, items):
            monkeypatch.setattr(api, "_rle1_restore", altered)
            try:
                return real(self, items)
            finally:
                monkeypatch.setattr(api, "_rle1_restore", restore)

        monkeypatch.setattr(sut_mod.Port, "decompress", decompress)
        sut = sut_mod.make("port", config, "cpu")
    r = _run(bench, cell, sut=sut)
    assert not r["correct"]


@pytest.mark.parametrize("cell", ("stream128k-compress", "objects-put"))
def test_a_fault_in_some_calls_is_not_correct(bench, cell, monkeypatch):
    """A byte of every block's payload altered inside the program in every
    third call only (one in-flight slot gone wrong): the containers made
    again from one input disagree, whatever blocks the sample draws."""
    from bmh_tpu_torch import api

    config, _ = tiny(bench, cell)
    port = sut_mod.make("port", config, "cpu")
    pack, calls = api._pack_block, []

    def altered(r, raw_len):
        if len(calls) % 3 == 0 and r["payload"]:
            r = dict(r, payload=bytes([r["payload"][0] ^ 1]) + r["payload"][1:])
        return pack(r, raw_len)

    def compress(items):
        calls.append(1)
        return sut_mod.Port.compress(port, items)

    monkeypatch.setattr(api, "_pack_block", altered)
    port.compress = compress
    r = _run(bench, cell, sut=port, seconds=1.5)
    assert r["attempted"] >= 3
    assert r["checks"]["repeats_differ"]["value"] > 0 and not r["correct"]


def test_no_card_no_result(capsys):
    """Off a card the command exits non-zero and prints no result."""
    assert run.main(["--workload", "objects-get", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_only_the_benchmark_files_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the files under paths,
    the command exits non-zero and prints no result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    for p in spec.load()["paths"]:
        shutil.copytree(spec.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "bmhbench.run", "--workload", "objects-get",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.gpu
def test_command_on_the_card(card, bench):
    """A short run of the cheapest cell through the command on the card."""
    out = subprocess.run([sys.executable, "-m", "bmhbench.run", "--workload", "objects-get",
                          "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "1"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["kind"] == card
    assert r["device"]["busy_s"] > 0 and "breakdown" in r
    assert set(r["metrics"]) == {m["name"] for m in spec.metrics(bench, "objects-get", True)}
