"""The control: the reference codec with one guarantee broken, put in the
program's place to show that the comparison fails it.

The configurations state that a container is the format's own, with
optimal (minimum-redundancy) code lengths.  The control takes the cheaper
Shannon lengths, ceil(log2(total / count)), which a later change might be
tempted by (a code-length step without the merge); they form a valid
prefix code, so its containers still decode to the input, and only their
bytes differ.  `python3 -m bmhbench.run ... --sut control` runs a cell
with it."""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np

from . import reference


def shannon_lengths(freqs: np.ndarray) -> np.ndarray:
    lens = np.zeros(freqs.size, dtype=np.int64)
    present = freqs > 0
    if int(present.sum()) <= 1:
        return lens
    p = freqs[present] / freqs.sum()
    lens[present] = np.minimum(np.ceil(-np.log2(p)).astype(np.int64), reference.MAX_CODE_LEN)
    return np.maximum(lens, present.astype(np.int64))


class Control:
    """The system under test's interface, computed by the control codec
    on the host."""

    name = "control"
    warm_up = False  # nothing to build or capture

    def __init__(self, config: dict):
        self.block_size = int(config["block_size"])
        self.stride = int(config["cursor_stride"])

    def compress(self, items: list[bytes]) -> list[bytes]:
        return [reference.compress(d, self.block_size, self.stride, shannon_lengths)
                for d in items]

    def decompress(self, items: list[bytes]) -> list[bytes]:
        return [reference.decompress(b) for b in items]

    def sync(self) -> None:
        pass

    def on_card(self) -> bool:
        return False

    def counters(self) -> dict:
        return {}

    @contextmanager
    def instrument(self, syncs: bool = True):
        yield {"delta": {}}
