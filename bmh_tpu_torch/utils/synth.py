"""Seeded synthetic input streams for the GPU smoke run and the profiler."""

from __future__ import annotations

import numpy as np

TEXT_BYTES = 8 << 20
RANDOM_BYTES = 1 << 20


def smoke_input(seed: int) -> bytes:
    """Seeded text-like stream (Zipf-weighted words over a generated
    vocabulary, spaces and newlines) followed by seeded random bytes.
    Uses only Generator.integers / .random, whose streams numpy keeps
    stable."""
    rng = np.random.default_rng(seed)
    vocab_n = 6000
    lens = rng.integers(1, 11, vocab_n)
    letters = rng.integers(97, 123, int(lens.sum())).astype(np.uint8).tobytes()
    offs = np.concatenate([[0], np.cumsum(lens)])
    vocab = [letters[offs[i]:offs[i + 1]] for i in range(vocab_n)]
    cdf = np.cumsum(1.0 / np.arange(1, vocab_n + 1) ** 1.1)
    cdf /= cdf[-1]
    n_words = TEXT_BYTES // 5
    picks = np.searchsorted(cdf, rng.random(n_words), side="right")
    seps = np.where(rng.random(n_words) < 1 / 12, b"\n", b" ")
    text = b"".join(vocab[min(p, vocab_n - 1)] + s for p, s in zip(picks, seps))
    assert len(text) >= TEXT_BYTES, "vocabulary too short for the text size"
    rnd = rng.integers(0, 256, RANDOM_BYTES, dtype=np.uint8).tobytes()
    return text[:TEXT_BYTES] + rnd
