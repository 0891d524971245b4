"""Shared fixtures of the benchmark's own tests.

Run on the CPU: `python -m pytest bmhbench/tests -q`; on the card:
`python -m pytest bmhbench/tests -q -m gpu`.  Whether a card is there is
decided inside the `card` fixture, never at import."""

from __future__ import annotations

import pytest

from bmhbench import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.fixture
def bench():
    return spec.load()

