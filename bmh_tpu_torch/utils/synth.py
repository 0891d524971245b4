"""Seeded synthetic inputs: the stream of the GPU smoke run and the
profiler, the workloads of its upload and route phases (many small files,
zero-heavy pages, a stream of repeated records), kernel inputs made to
hurt the designs of K1, K2 and K3, and the histograms that hold K6 and its
plain version to the two-queue method's ties and edges."""

from __future__ import annotations

import numpy as np

TEXT_BYTES = 8 << 20
RANDOM_BYTES = 1 << 20


def smoke_input(seed: int, text_bytes: int = TEXT_BYTES,
                random_bytes: int = RANDOM_BYTES) -> bytes:
    """Seeded text-like stream of `text_bytes` (Zipf-weighted words over a
    generated vocabulary, spaces and newlines) followed by `random_bytes`
    seeded random bytes.  The defaults give the 9 MiB stream whose
    containers tests/data/torch_golden.json records.  Uses only
    Generator.integers / .random, whose streams numpy keeps stable."""
    rng = np.random.default_rng(seed)
    vocab_n = 6000
    lens = rng.integers(1, 11, vocab_n)
    letters = rng.integers(97, 123, int(lens.sum())).astype(np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens)])
    cdf = np.cumsum(1.0 / np.arange(1, vocab_n + 1) ** 1.1)
    cdf /= cdf[-1]
    n_words = text_bytes // 5
    picks = np.minimum(np.searchsorted(cdf, rng.random(n_words), side="right"),
                       vocab_n - 1)
    seps = np.where(rng.random(n_words) < 1 / 12, ord("\n"), ord(" ")).astype(np.uint8)
    # the words and their separators back to back, built by index arithmetic
    seg = lens[picks] + 1
    assert int(seg.sum()) >= text_bytes, "vocabulary too short for the text size"
    word = np.repeat(np.arange(n_words), seg)[:text_bytes]
    within = np.arange(word.size) - (np.cumsum(seg) - seg)[word]
    # (at a separator the index may run one past the letters: clamp it)
    src = np.minimum(offs[picks][word] + within, letters.size - 1)
    text = np.where(within == seg[word] - 1, seps[word], letters[src])
    rnd = rng.integers(0, 256, random_bytes, dtype=np.uint8).tobytes()
    return text.tobytes() + rnd


def small_files(seed: int, count: int = 2048, lo: int = 512,
                hi: int = 16 << 10) -> list[bytes]:
    """`count` small objects of lo..hi bytes (uniform), the way a log
    shipper or a document store sees them: slices of smoke_input's
    text-like stream, about one in 16 seeded random bytes instead.  The
    default 2048 files hold about 17 MiB."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi + 1, count)
    is_random = rng.random(count) < 1 / 16
    text = smoke_input(seed, text_bytes=int(sizes.sum()), random_bytes=0)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() if r
            else text[a:a + n] for n, r, a in zip(sizes, is_random, offs)]


def zero_pages(seed: int, total: int = 32 << 20, page: int = 4096,
               zero_share: float = 0.75) -> bytes:
    """`total` bytes of `page`-byte pages, each all-zero with probability
    `zero_share` and otherwise seeded random bytes (compressed or encrypted
    contents): a sparse VM image or database file."""
    rng = np.random.default_rng(seed)
    n = total // page
    pages = np.zeros((n, page), np.uint8)
    full = rng.random(n) >= zero_share
    pages[full] = rng.integers(0, 256, (int(full.sum()), page), dtype=np.uint8)
    return pages.tobytes()


def record_stream(seed: int, total: int = 8 << 20, record: int = 1024) -> bytes:
    """One seeded random `record`-byte record repeated to `total` bytes (a
    preallocated file of template records).  RLE1 leaves it whole, and a
    block whose length the record divides is a power of it: every such
    block takes the periodic route."""
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 256, record, dtype=np.uint8).tobytes()
    return (rec * -(-total // record))[:total]


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


def fibonacci_stream(k: int, seed: int) -> np.ndarray:
    """A shuffled stream of k RLE0 symbols with Fibonacci counts 1, 1, 2,
    3, 5, ...: the histogram whose Huffman code is deepest for its total
    (k - 1 bits).  k = 26 gives 317,810 symbols and a 25-bit code, k = 29
    1,346,268 symbols and a 28-bit code.  The symbols are k distinct
    values of 0..256 in seeded order.  Returns (F(k+2) - 1,) int64."""
    rng = np.random.default_rng(seed)
    counts = [1, 1]
    while len(counts) < k:
        counts.append(counts[-1] + counts[-2])
    syms = rng.choice(257, k, replace=False)
    return rng.permutation(np.repeat(syms, counts[:k])).astype(np.int64)


def code_length_cases() -> dict[str, np.ndarray]:
    """Named (rows, 257) int64 histogram sets for the code lengths (K6 and
    its plain version):
      edges     frequency ties, all-equal present symbols, a sparse row,
                powers of two (deep), a single symbol, two equal symbols
      one, two  one present symbol; two of counts 1 and 500
      all_257   every symbol present
      fibonacci 26 symbols with Fibonacci counts: a 25-bit code
      random    256 seeded rows, by fours: counts 0..3 (many ties), one
                count at a random share of the symbols (all equal), a
                sparse row of counts below 1000, a row of counts below 2^20
      empty     an all-zero row, a single-symbol row"""
    rng = np.random.default_rng(3)
    edges = [rng.integers(0, 4, 257),
             np.where(np.arange(257) % 7 == 0, 5, 0),
             rng.integers(0, 1000, 257) * (rng.random(257) < 0.3),
             (2 ** np.minimum(np.arange(257), 20)) * (np.arange(257) < 22),
             np.eye(1, 257, 42)[0].astype(np.int64) * 9,
             np.array([3, 3] + [0] * 255)]
    cases = {"edges": np.stack(edges)}
    for name in ("one", "two", "all_257"):  # each from the seed anew
        rng = np.random.default_rng(11)
        f = np.zeros(257, np.int64)
        if name == "one":
            f[rng.integers(257)] = 1000
        elif name == "two":
            f[rng.choice(257, 2, replace=False)] = (1, 500)
        else:
            f[:] = rng.integers(1, 5000, 257)
        cases[name] = f
    f = np.zeros(257, np.int64)
    np.add.at(f, fibonacci_stream(26, 5), 1)
    cases["fibonacci"] = f
    rng = np.random.default_rng(19)
    rows = []
    for r in range(256):
        kind = r % 4
        if kind == 0:
            rows.append(rng.integers(0, 4, 257))
        elif kind == 1:
            rows.append(np.where(rng.random(257) < rng.random(), 1 + rng.integers(100), 0))
        elif kind == 2:
            rows.append(rng.integers(0, 1000, 257) * (rng.random(257) < 0.3))
        else:
            rows.append(rng.integers(0, 1 << 20, 257))
    cases["random"] = np.stack(rows)
    single = np.zeros(257, np.int64)
    single[rng.integers(257)] = 1 + rng.integers(1 << 20)
    cases["empty"] = np.stack([np.zeros(257, np.int64), single])
    return {k: np.atleast_2d(v).astype(np.int64) for k, v in cases.items()}
