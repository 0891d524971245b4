"""Sequential NumPy oracle for the BWT->MTF->Huffman codec (bmh_tpu's copy).

The correctness judge of the port: plain, one block at a time, on no hot
path.  It keeps bmh_tpu/models/oracle.py's functions and their semantics:

* ``bwt``            sort of all N cyclic rotations, stable by rotation
                     start for fully-equal (periodic) rotations; the last
                     column and the sorted position of rotation 0.
* ``bwt_inverse``    stable value sort of the last column gives the LF
                     map, then an N-step walk.
* ``mtf``/``mtf_inverse``  the 256-entry move-to-front list from the
                     identity.
* Huffman            canonical codes from optimal (heap-built) code
                     lengths, packed MSB first.

One difference: bmh_tpu's ``bwt_with_checkpoints`` reads the cursor stride
frozen at its import; here the stride is an argument, the one the caller
encodes the whole stream with.
"""

from __future__ import annotations

import heapq

import numpy as np

ALPHABET = 256
MAX_CODE_LEN = 31  # code lengths are stored in 5 bits in the container


# ---------------------------------------------------------------------------
# BWT
# ---------------------------------------------------------------------------

def bwt_brute(data: np.ndarray) -> tuple[int, np.ndarray]:
    """O(n^2 log n) rotation sort for tiny inputs; the oracle's oracle."""
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    if n == 0:
        return 0, data
    doubled = np.concatenate([data, data])
    keys = [bytes(doubled[i:i + n]) for i in range(n)]
    order = sorted(range(n), key=lambda i: keys[i])  # stable: equal rotations keep index order
    last = data[[(i + n - 1) % n for i in order]].astype(np.uint8)
    shift = order.index(0)
    return shift, last


def bwt(data: np.ndarray) -> tuple[int, np.ndarray]:
    """Cyclic-rotation BWT via prefix doubling (NumPy lexsort).

    Stable by rotation start for periodic inputs.
    """
    shift, last, _ = bwt_with_checkpoints(data, 4096)
    return shift, last


def bwt_with_checkpoints(data: np.ndarray, stride: int) -> tuple[int, np.ndarray,
                                                                 np.ndarray | None]:
    """BWT that also samples inverse-BWT cursor checkpoints (ops/bwt.py
    semantics).

    Returns (shift, last, cps) with cps = rank[(j*stride) % n] for
    j = 1..ceil(n/stride)-1, or None when the input is periodic (rotations
    not all distinct: the rank identity does not hold there).
    """
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    if n == 0:
        return 0, data, np.zeros(0, dtype=np.int32)
    idx = np.arange(n)
    rank = data.astype(np.int64)
    h = 1
    while h < n:
        rank2 = rank[(idx + h) % n]
        order = np.lexsort((idx, rank2, rank))
        r1, r2 = rank[order], rank2[order]
        changed = np.empty(n, dtype=np.int64)
        changed[0] = 0
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank = np.cumsum(changed)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank
        if new_rank[-1] == n - 1:
            break
        h *= 2
    order = np.lexsort((idx, rank))
    shift = int(np.nonzero(order == 0)[0][0])
    last = data[(order + n - 1) % n]
    aperiodic = np.unique(rank).size == n
    if aperiodic:
        k = max(-(-n // stride) - 1, 0)
        j = (np.arange(k) + 1) * stride
        cps = rank[j % n].astype(np.int32)
    else:
        cps = None
    return shift, last.astype(np.uint8), cps


def bwt_inverse(last: np.ndarray, shift: int) -> np.ndarray:
    """Inverse BWT: stable sort -> LF map -> sequential walk (main.cpp:61-75)."""
    last = np.asarray(last, dtype=np.uint8)
    n = last.size
    if n == 0:
        return last
    l_shift = np.argsort(last, kind="stable")
    out = np.empty(n, dtype=np.uint8)
    row = int(shift)
    for i in range(n):
        row = int(l_shift[row])
        out[i] = last[row]
    return out


# ---------------------------------------------------------------------------
# MTF
# ---------------------------------------------------------------------------

def mtf(data: np.ndarray) -> np.ndarray:
    """Sequential move-to-front (reference: main.cpp:93-112)."""
    data = np.asarray(data, dtype=np.uint8)
    alphabet = list(range(ALPHABET))
    out = np.empty(data.size, dtype=np.uint8)
    for i, byte in enumerate(data.tolist()):
        pos = alphabet.index(byte)
        out[i] = pos
        if pos:
            alphabet.pop(pos)
            alphabet.insert(0, byte)
    return out


def mtf_inverse(codes: np.ndarray) -> np.ndarray:
    """Sequential inverse move-to-front (reference: main.cpp:114-130)."""
    codes = np.asarray(codes, dtype=np.uint8)
    alphabet = list(range(ALPHABET))
    out = np.empty(codes.size, dtype=np.uint8)
    for i, pos in enumerate(codes.tolist()):
        sym = alphabet[pos]
        out[i] = sym
        if pos:
            alphabet.pop(pos)
            alphabet.insert(0, sym)
    return out


# ---------------------------------------------------------------------------
# Huffman (canonical)
# ---------------------------------------------------------------------------

def histogram(data: np.ndarray, alphabet: int = ALPHABET) -> np.ndarray:
    return np.bincount(np.asarray(data).astype(np.int64),
                       minlength=alphabet).astype(np.int64)


def huffman_code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Optimal prefix-code lengths for a 256-bin histogram.

    Single-present-symbol inputs get code length 0 (empty codeword), which
    mirrors the reference's single-leaf-tree behaviour (main.cpp:268-275)
    where the empty codeword immediately matches.
    Returns a (256,) uint8 array; absent symbols have length 0.
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    alphabet = freqs.size
    present = [s for s in range(alphabet) if freqs[s] > 0]
    lens = np.zeros(alphabet, dtype=np.uint8)
    if len(present) <= 1:
        return lens  # zero or one symbol: empty codeword
    depth = np.zeros(alphabet, dtype=np.int64)
    # heap of (freq, tiebreak, [symbols]) — tiebreak keeps determinism
    heap = [(int(freqs[s]), s, [s]) for s in present]
    heapq.heapify(heap)
    tiebreak = alphabet
    while len(heap) > 1:
        f1, _, s1 = heapq.heappop(heap)
        f2, _, s2 = heapq.heappop(heap)
        for s in s1:
            depth[s] += 1
        for s in s2:
            depth[s] += 1
        heapq.heappush(heap, (f1 + f2, tiebreak, s1 + s2))
        tiebreak += 1
    if depth.max() > MAX_CODE_LEN:
        raise ValueError(f"Huffman depth {depth.max()} exceeds {MAX_CODE_LEN}; use smaller blocks")
    lens[present] = depth[present]
    return lens


def canonical_codes(lens: np.ndarray) -> np.ndarray:
    """Canonical code values from code lengths: symbols ordered by (len, symbol)."""
    lens = np.asarray(lens, dtype=np.int64)
    alphabet = lens.size
    order = sorted((s for s in range(alphabet) if lens[s] > 0), key=lambda s: (lens[s], s))
    codes = np.zeros(alphabet, dtype=np.uint32)
    code = 0
    prev_len = 0
    for s in order:
        code <<= int(lens[s]) - prev_len
        prev_len = int(lens[s])
        codes[s] = code
        code += 1
    return codes


def huffman_encode(data: np.ndarray, lens: np.ndarray, codes: np.ndarray) -> tuple[bytes, int]:
    """MSB-first bit-pack of per-symbol canonical codes.

    Returns (payload bytes, total payload bits).  Bit order matches the
    reference cursor (io_utilities.h:87-94): first bit = MSB of byte 0.
    """
    data = np.asarray(data).astype(np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    sym_lens = lens[data]
    total_bits = int(sym_lens.sum())
    out = bytearray((total_bits + 7) // 8)
    bitpos = 0
    lens_list = sym_lens.tolist()
    codes_list = codes[data].tolist()
    for code, ln in zip(codes_list, lens_list):
        for k in range(ln - 1, -1, -1):
            if (code >> k) & 1:
                out[bitpos >> 3] |= 0x80 >> (bitpos & 7)
            bitpos += 1
    return bytes(out), total_bits


def huffman_decode(payload: bytes, lens: np.ndarray, n_symbols: int) -> np.ndarray:
    """Canonical-code FSM decode, bit at a time (oracle for the gap decoder)."""
    lens = np.asarray(lens, dtype=np.int64)
    present = [s for s in range(lens.size) if lens[s] > 0]
    if not present:
        # zero-length codeword: a single distinct symbol, repeated
        bitmap = np.nonzero(lens == 0)[0]
        raise ValueError("huffman_decode needs explicit symbol for empty code; handle upstream")
    order = sorted(present, key=lambda s: (lens[s], s))
    # canonical first_code/count tables per length
    count = np.zeros(MAX_CODE_LEN + 1, dtype=np.int64)
    for s in present:
        count[lens[s]] += 1
    first_code = np.zeros(MAX_CODE_LEN + 2, dtype=np.int64)
    c = 0
    for l in range(1, MAX_CODE_LEN + 1):
        first_code[l] = c
        c = (c + count[l]) << 1
    offset = np.zeros(MAX_CODE_LEN + 1, dtype=np.int64)
    acc = 0
    for l in range(1, MAX_CODE_LEN + 1):
        offset[l] = acc
        acc += count[l]
    sym_table = np.array(order, dtype=np.int64)

    out = np.empty(n_symbols, dtype=np.int64)
    val = 0
    ln = 0
    pos = 0
    emitted = 0
    data = np.frombuffer(payload, dtype=np.uint8)
    while emitted < n_symbols:
        bit = (int(data[pos >> 3]) >> (7 - (pos & 7))) & 1
        pos += 1
        val = (val << 1) | bit
        ln += 1
        if count[ln] > 0 and first_code[ln] <= val < first_code[ln] + count[ln]:
            out[emitted] = sym_table[offset[ln] + (val - first_code[ln])]
            emitted += 1
            val = 0
            ln = 0
        elif ln > MAX_CODE_LEN:
            raise ValueError("corrupt Huffman stream")
    return out


# ---------------------------------------------------------------------------
# RLE0 (zero-run coding of the MTF stream, bzip2-style RUNA/RUNB)
# ---------------------------------------------------------------------------
# Maximal runs of MTF code 0 are rewritten in bijective base 2 over two run
# symbols RUNA=0 / RUNB=1 (run length r = sum over digits of (1+b_i)*2^i,
# digits least-significant first); every non-zero MTF code c becomes symbol
# c+1.  Alphabet grows to 257; the zero-dominated post-BWT/MTF stream
# shrinks by the run lengths' log, which plain Huffman cannot achieve (its
# floor is 1 bit per zero).  This is a capability the reference lacks —
# compressed sizes strictly beat the reference table (README.md:19-36).

RLE_ALPHABET = 257
RUNA = 0
RUNB = 1


def rle0(codes: np.ndarray) -> np.ndarray:
    """MTF codes (uint8) -> RLE0 symbol stream (int64, values 0..256)."""
    codes = np.asarray(codes, dtype=np.uint8)
    out: list[int] = []
    i = 0
    n = codes.size
    while i < n:
        c = int(codes[i])
        if c != 0:
            out.append(c + 1)
            i += 1
            continue
        r = 0
        while i < n and codes[i] == 0:
            r += 1
            i += 1
        while r > 0:
            if r & 1:
                out.append(RUNA)
                r = (r - 1) // 2
            else:
                out.append(RUNB)
                r = (r - 2) // 2
    return np.asarray(out, dtype=np.int64)


def rle0_inverse(syms: np.ndarray, orig_len: int) -> np.ndarray:
    """RLE0 symbol stream -> MTF codes (uint8, length orig_len)."""
    syms = np.asarray(syms).astype(np.int64)
    out = np.zeros(orig_len, dtype=np.uint8)
    pos = 0
    i = 0
    m = syms.size
    while i < m:
        s = int(syms[i])
        if s >= 2:
            out[pos] = s - 1
            pos += 1
            i += 1
            continue
        r = 0
        w = 1
        while i < m and syms[i] <= 1:
            r += (1 + int(syms[i])) * w
            w *= 2
            i += 1
        pos += r  # zeros are the fill value
    if pos != orig_len:
        raise ValueError(f"RLE0 expansion mismatch: {pos} != {orig_len}")
    return out


# ---------------------------------------------------------------------------
# Whole-block oracle pipeline
# ---------------------------------------------------------------------------

def compress_block(data: np.ndarray, stride: int):
    """Full oracle pipeline for one block: BWT -> MTF -> RLE0 -> Huffman,
    with cursor checkpoints every `stride` positions.

    Returns dict with shift, lens (257,), rle_len, payload bytes, total_bits.
    """
    data = np.asarray(data, dtype=np.uint8)
    shift, last, cps = bwt_with_checkpoints(data, stride)
    codes_mtf = mtf(last)
    syms = rle0(codes_mtf)
    freqs = histogram(syms, alphabet=RLE_ALPHABET)
    lens = huffman_code_lengths(freqs)
    codes = canonical_codes(lens)
    payload, total_bits = huffman_encode(syms, lens, codes)
    return {
        "shift": shift,
        "lens": lens,
        "freqs": freqs,
        "payload": payload,
        "total_bits": total_bits,
        "orig_len": data.size,
        "rle_len": int(syms.size),
        "cps": cps,
    }


def decompress_block(payload: bytes, lens: np.ndarray, shift: int, orig_len: int,
                     rle_len: int,
                     single_symbol: int | None = None) -> np.ndarray:
    lens = np.asarray(lens, dtype=np.int64)
    if orig_len == 0:
        return np.zeros(0, dtype=np.uint8)
    if (lens > 0).sum() == 0:
        # single distinct RLE0 symbol; must be provided by the caller
        if single_symbol is None:
            raise ValueError("single-symbol block requires the symbol")
        syms = np.full(rle_len, single_symbol, dtype=np.int64)
    else:
        syms = huffman_decode(payload, lens, rle_len)
    codes_mtf = rle0_inverse(syms, orig_len)
    last = mtf_inverse(codes_mtf)
    return bwt_inverse(last, shift)
