"""Text-like streams: Zipf-1.1 words over a 6000-word generated vocabulary,
spaces and newlines, then seeded random bytes (a frozen copy of
bmh_tpu_torch/utils/synth.py's smoke_input: the same draws, the same
stream).  Every item has the same size; each has a seed of its own."""

from __future__ import annotations

import numpy as np

from . import item_seed

WIDTH = 11  # the longest word (10 letters) and its separator


def _search(cdf: np.ndarray, u: np.ndarray, bits: int = 16) -> np.ndarray:
    """np.searchsorted(cdf, u, side="right"), by a table over 2**bits equal
    slices of [0, 1) where a slice holds no step of the cdf, and by the
    search elsewhere: the same answer, several times sooner."""
    edges = np.arange((1 << bits) + 1) / (1 << bits)
    at = np.searchsorted(cdf, edges, side="right")
    k = (u * (1 << bits)).astype(np.int64)
    out = at[k]
    open_ = at[k + 1] != out
    out[open_] = np.searchsorted(cdf, u[open_], side="right")
    return out


def stream(seed: int, text_bytes: int, random_bytes: int) -> bytes:
    """`text_bytes` of Zipf-weighted words, then `random_bytes` random bytes."""
    rng = np.random.default_rng(seed)
    vocab_n = 6000
    lens = rng.integers(1, 11, vocab_n)
    letters = rng.integers(97, 123, int(lens.sum())).astype(np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens)])
    cdf = np.cumsum(1.0 / np.arange(1, vocab_n + 1) ** 1.1)
    cdf /= cdf[-1]
    picks = np.zeros(0, dtype=np.int64)
    seps = np.zeros(0, dtype=np.uint8)
    # the program's copy draws text_bytes // 5 words once and fails where
    # the frequent words are short; more words are drawn here until they
    # fill the text (the same stream wherever one draw suffices)
    while int(lens[picks].sum()) + picks.size < text_bytes:
        more = max(text_bytes // 5, 1)
        picks = np.concatenate([picks, np.minimum(_search(cdf, rng.random(more)),
                                                  vocab_n - 1)])
        seps = np.concatenate([seps, np.where(rng.random(more) < 1 / 12, ord("\n"),
                                              ord(" ")).astype(np.uint8)])
    # every word in a row of WIDTH bytes, its separator after its letters;
    # the rows' used bytes back to back are the text
    col = np.arange(WIDTH)
    table = np.zeros((vocab_n, WIDTH), np.uint8)
    inside = col < lens[:, None]
    table[inside] = letters[(offs[:-1, None] + col)[inside]]
    used = col <= lens[:, None]
    seg = (lens + 1).astype(np.int8)
    n_words = int(np.searchsorted(np.cumsum(seg[picks], dtype=np.int64), text_bytes)) + 1
    picks = picks[:n_words]
    rows = table[picks]
    rows[np.arange(n_words), lens[picks]] = seps[:n_words]
    text = rows[used[picks]][:text_bytes]
    rnd = rng.integers(0, 256, random_bytes, dtype=np.uint8).tobytes()
    return text.tobytes() + rnd


def make(seed: int, count: int, text_bytes: int, random_bytes: int = 0) -> list[bytes]:
    return [stream(item_seed(seed, i), text_bytes, random_bytes) for i in range(count)]
