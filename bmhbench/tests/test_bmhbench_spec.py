"""BENCHMARK.json against the benchmark contract's shape, and the harness
finding a configuration, a mix and a metric by name alone."""

import json
import re
import shutil

import pytest

from bmhbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape(bench):
    assert set(bench) == KEYS["top"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert all(p.startswith("bmhbench") for p in bench["paths"])
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[part]]
        assert len(set(names)) == len(names)
        for e in bench[part]:
            extra = {"workloads"} if part in ("end_to_end", "per_layer") else set()
            assert KEYS[part] <= set(e) <= KEYS[part] | extra, e["name"]
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    cells = {w["name"]: w for w in bench["workloads"]}
    for w in cells.values():
        assert w["chips"] == 1 and _line(w["why"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in cells.values())
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for cell in cells:  # setup_s, another end-to-end metric, a per-layer one
        names = {m["name"] for m in spec.metrics(bench, cell, False)}
        assert "setup_s" in names and len(names) >= 2
        assert spec.metrics(bench, cell, True)
    for m in bench["per_layer"]:
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:  # each cell reports the metric it moves
            assert m["moves"] in {x["name"] for x in spec.metrics(bench, cell, False)}
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_name_has_its_file(bench):
    for w in bench["workloads"]:
        config = spec.config(bench, w["config"])
        assert config["name"] == w["config"]
        mix = spec.traffic(w["traffic"])
        assert mix["direction"] in ("compress", "decompress")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_unknown_names_raise(bench):
    with pytest.raises(KeyError):
        spec.workload(bench, "no-such-cell")
    with pytest.raises(KeyError):
        spec.reader("no_such_metric")


def test_a_new_metric_is_a_new_file(tmp_path, bench):
    """A later change adds a metric, a mix and a configuration by files and
    entries alone: the harness finds them by name."""
    here = tmp_path / "bmhbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    (here / "metrics" / "requests_in_window.py").write_text(
        "def read(w):\n    return len(w.latencies_s)\n")
    (here / "traffic" / "stream-compress-long.json").write_text(
        json.dumps({**spec.traffic("stream-compress"), "pool_requests": 8}))
    (here / "configs" / "stream-256k.json").write_text(
        json.dumps({**spec.config(bench, "stream-128k"), "name": "stream-256k",
                    "block_size": 262144}))
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({**bench["configs"][0], "name": "stream-256k",
                             "file": "bmhbench/configs/stream-256k.json"})
    bench["workloads"].append({"name": "stream256k-compress", "config": "stream-256k",
                               "traffic": "stream-compress-long", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "requests_in_window", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "api", "moves": "compress_MBps"})
    assert spec.config(bench, "stream-256k", root=tmp_path)["block_size"] == 262144
    assert spec.traffic("stream-compress-long", here=here)["pool_requests"] == 8
    read = spec.reader("requests_in_window", here=here)

    class W:
        latencies_s = [0.1, 0.2]

    assert read(W) == 2
    assert "requests_in_window" in {m["name"] for m in
                                    spec.metrics(bench, "stream256k-compress", True)}
