"""Seeded input generators, one module per kind, found by name.

Each module has `make(seed, count, **params) -> list[bytes]`: `count`
items, the same for the same seed.  They live here and not in the
program, so that a change to the program never changes the benchmark's
inputs; zipf_text is a frozen copy of the program's own smoke_input
(bmh_tpu_torch/utils/synth.py)."""

from __future__ import annotations

import importlib

import numpy as np


def find(kind: str):
    """The generator module of `kind` (generators/<kind>.py)."""
    if not kind.replace("_", "").isalnum():
        raise ValueError(f"bad generator name {kind!r}")
    return importlib.import_module(f"{__name__}.{kind}")


def item_seed(seed: int, i: int) -> int:
    """A seed of its own for item i of a run's seed (any non-negative int)."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0])
