"""Finds what BENCHMARK.json names: a cell, its configuration and traffic
mix, and the readers of its metrics.  Nothing here knows a particular
configuration, mix or metric: each lives in a file of its own."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's file, as it is run."""
    with open(root / _named(bench["configs"], name, "configuration")["file"]) as f:
        return json.load(f)


def traffic(name: str, here: Path = HERE) -> dict:
    with open(here / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics, or with
    tracing its per-layer ones; a metric with a `workloads` key only in the
    cells it lists."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str, here: Path = HERE):
    """The `read(window) -> number | None` of metrics/<name>.py."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bmhbench.metrics.{name}", path)
    if spec is None or not path.is_file():
        raise KeyError(f"no reader for metric {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
