"""Seeded synthetic inputs: the stream of the GPU smoke run and the
profiler, and kernel inputs made to hurt the designs of K1, K2 and K3."""

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


def phase_a_hostile_cases(seed: int, nc: int) -> list[tuple]:
    """Inputs made to hurt kernel K1's merge of a chunk's 32 decodes, as
    (name, wext (wpc+1, nc) int32, count_t (32, nc) int32, chunk_bits, maxl):
    a table of zeros under which no two decodes meet (each resets every 32
    bits); a table with maxl = 8 whose short codes leave most 8-bit patterns
    to the overflow reset, with counts above maxl that must be ignored; and
    a plausible table at the two shortest chunks, where every decode ends
    inside the lookahead word.  Words are random, in words_ext layout."""
    rng = np.random.default_rng(seed)
    plausible = np.zeros(32, np.int32)
    plausible[[2, 3, 4, 6, 9]] = (1, 2, 3, 10, 20)
    short = np.zeros(32, np.int32)
    short[[5, 8, 12]] = (1, 3, 5)
    cases = []
    for name, counts, chunk_bits, maxl in (
            ("no_merge", np.zeros(32, np.int32), 512, 31),
            ("overflow_maxl8", short, 512, 8),
            ("chunk_bits_32", plausible, 32, 16),
            ("chunk_bits_64", plausible, 64, 16)):
        count_t = np.repeat(counts[:, None], nc, axis=1)
        cases.append((name, _random_wext(rng, nc, chunk_bits), count_t,
                      chunk_bits, maxl))
    return cases


def _random_wext(rng, nc: int, chunk_bits: int, ones: int = 0) -> np.ndarray:
    """Random payload words of nc chunks in words_ext layout ((wpc+1, nc)
    int32: each chunk's words, then the next chunk's first word).  With
    ones > 0 each word is the OR of ones + 1 random words: runs of 1 bits,
    the long codewords of a canonical code."""
    words = rng.integers(0, 1 << 32, (nc, chunk_bits // 32), dtype=np.uint64)
    for _ in range(ones):
        words |= rng.integers(0, 1 << 32, words.shape, dtype=np.uint64)
    words = words.astype(np.uint32)
    nxt = np.concatenate([words[1:, :1], np.zeros((1, 1), np.uint32)])
    return np.ascontiguousarray(np.concatenate([words, nxt], axis=1).T).view(np.int32)


def phase_b_hostile_cases(seed: int, nc: int) -> list[tuple]:
    """Inputs made to hurt kernel K2's codeword-a-turn decode and its output
    windows, as (name, wext (wpc+1, nc) int32, count_t (32, nc) int32,
    entry (nc,) int32, chunk_bits, maxl): an over-subscribed table whose
    indices pass 256 (the clip fires); the all-zero table (only overflow
    resets); maxl = 8 with counts above it that must be ignored; a complete
    code with lengths 1..31 over words rich in 1 bits (the longest codes,
    offsets near 2^31); a random table per chunk; a plausible table at 32-
    and 64-bit chunks and at 544 bits.  Entries are random in 0..31, the
    first chunk's 31.  Words are random, in words_ext layout."""
    rng = np.random.default_rng(seed)
    oversub = np.zeros(32, np.int32)
    oversub[[3, 8, 9]] = (1, 100, 400)
    short = np.zeros(32, np.int32)
    short[[5, 8, 12]] = (1, 3, 5)
    long_codes = np.ones(32, np.int32)
    long_codes[0], long_codes[31] = 0, 2
    plausible = np.zeros(32, np.int32)
    plausible[[2, 3, 4, 6, 9]] = (1, 2, 3, 10, 20)
    cases = []
    for name, counts, chunk_bits, maxl, ones in (
            ("oversubscribed_clip", oversub, 512, 16, 0),
            ("all_zero", np.zeros(32, np.int32), 512, 31, 0),
            ("maxl8_ignores_longer", short, 512, 8, 0),
            ("long_codes", long_codes, 512, 31, 3),
            ("random_tables", None, 512, 16, 0),
            ("chunk_bits_32", plausible, 32, 16, 0),
            ("chunk_bits_64", plausible, 64, 16, 0),
            ("chunk_bits_544", plausible, 544, 16, 0)):
        if counts is None:  # per chunk: lengths 1..12, under- or over-subscribed
            count_t = np.zeros((32, nc), np.int32)
            count_t[1:13] = rng.integers(0, 6, (12, nc)) * (rng.random((12, nc)) < 0.5)
        else:
            count_t = np.repeat(counts[:, None], nc, axis=1)
        entry = rng.integers(0, 32, nc).astype(np.int32)
        entry[0] = 31
        cases.append((name, _random_wext(rng, nc, chunk_bits, ones), count_t,
                       entry, chunk_bits, maxl))
    return cases


def imtf_hostile_cases(seed: int, m: int, k: int) -> list[tuple]:
    """Codes made to hurt kernel K3's batches, as (name, codes (m, k)
    int32): all zero (no step in any batch), all 255 (every step moves the
    whole list) and uniformly random (every step, every distance)."""
    rng = np.random.default_rng(seed)
    return [("zeros", np.zeros((m, k), np.int32)),
            ("all_255", np.full((m, k), 255, np.int32)),
            ("random", rng.integers(0, 256, (m, k)).astype(np.int32))]
