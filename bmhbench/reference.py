"""The plain reference codec: the `.bzt` container written and read by
NumPy and the standard library alone, one block at a time.

It states what the program has to produce and imports nothing of the
program: per block, RLE1 where it strictly shrinks the block, the BWT of
all cyclic rotations (stable by rotation start) with cursor checkpoints
every `stride` positions, move-to-front from the identity list, RLE0
(zero runs in bijective base 2 over RUNA = 0 and RUNB = 1, a non-zero code
c as c + 1), optimal canonical Huffman codes over the 257 symbols, packed
MSB first; then the container with its block table and CRC32.  The
functions follow the program's sequential oracle (bmh_tpu_torch/models/
oracle.py) and its format module (utils/container.py), copied here so that
a change to the program cannot change the yardstick; RLE1, RLE0 and the
bit packing are written with NumPy array operations in place of the
oracle's loops, and decoding walks a table of every bit position's
codeword in place of a bit-at-a-time loop.

`code_lengths` is the one place the control (control.py) departs from.
"""

from __future__ import annotations

import heapq
import struct
import zlib

import numpy as np

ALPHABET = 257
MAX_CODE_LEN = 31
MAGIC = b"BZT1"
VERSION = 3
FLAG_STREAMING = 0x01
FLAG_CRC32 = 0x02
FILE_HEADER = struct.Struct("<4sBBHIIQ")
BLOCK_HEADER = struct.Struct("<IIHI")
PERIODIC = 0xFFFF
RLE1_FLAG = 0x80000000
BITMAP_BYTES = (ALPHABET + 7) // 8


# ---------------------------------------------------------------------------
# RLE1: runs of 4 to 255 equal bytes as the byte four times and a count
# ---------------------------------------------------------------------------

def rle1_encode(a: np.ndarray) -> np.ndarray:
    """Each run of L equal bytes v: L // 255 chunks (v v v v 251), then the
    rest r = L % 255 as a chunk (v v v v r-4) if r >= 4, else r bytes v."""
    a = np.asarray(a, dtype=np.uint8)
    if a.size == 0:
        return a
    starts = np.flatnonzero(np.concatenate([[True], a[1:] != a[:-1]]))
    lens = np.diff(np.append(starts, a.size))
    vals = a[starts]
    full, rest = lens // 255, lens % 255
    tail = rest >= 4
    out_len = 5 * full + np.where(tail, 5, rest)
    out = np.repeat(vals, out_len)
    off = np.cumsum(out_len) - out_len
    # the count byte of every full chunk, then of every tail chunk
    run_of_chunk = np.repeat(np.arange(lens.size), full)
    k = np.arange(run_of_chunk.size) - (np.cumsum(full) - full)[run_of_chunk]
    out[off[run_of_chunk] + 5 * k + 4] = 251
    out[(off + 5 * full + 4)[tail]] = (rest[tail] - 4).astype(np.uint8)
    return out


def rle1_decode(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint8).tolist()
    out = bytearray()
    i, n = 0, len(a)
    while i < n:
        v = a[i]
        if i + 3 < n and a[i + 1] == v and a[i + 2] == v and a[i + 3] == v:
            if i + 4 >= n:
                raise ValueError("truncated RLE1 chunk")
            out.extend([v] * (4 + a[i + 4]))
            i += 5
        else:
            out.append(v)
            i += 1
    return np.frombuffer(bytes(out), dtype=np.uint8)


# ---------------------------------------------------------------------------
# BWT with cursor checkpoints, and its inverse
# ---------------------------------------------------------------------------

def bwt(data: np.ndarray, stride: int):
    """(shift, last column, checkpoints): prefix doubling of the rotations'
    ranks, ties kept in rotation order; cps = rank[(j * stride) % n] for
    j = 1 .. ceil(n / stride) - 1, or None when rotations repeat (a
    periodic block)."""
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
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
    shift = int(np.flatnonzero(order == 0)[0])
    last = data[(order + n - 1) % n]
    cps = None
    if np.unique(rank).size == n:
        j = (np.arange(max(-(-n // stride) - 1, 0)) + 1) * stride
        cps = rank[j % n].astype(np.int64)
    return shift, last, cps


def bwt_inverse(last: np.ndarray, shift: int) -> np.ndarray:
    lf = np.argsort(last, kind="stable").tolist()
    col = last.tolist()
    out = bytearray(len(col))
    row = int(shift)
    for i in range(len(col)):
        row = lf[row]
        out[i] = col[row]
    return np.frombuffer(bytes(out), dtype=np.uint8)


# ---------------------------------------------------------------------------
# MTF and RLE0
# ---------------------------------------------------------------------------

def mtf(data: np.ndarray) -> np.ndarray:
    alphabet = list(range(256))
    out = bytearray(data.size)
    for i, byte in enumerate(np.asarray(data, dtype=np.uint8).tolist()):
        pos = alphabet.index(byte)
        out[i] = pos
        if pos:
            del alphabet[pos]
            alphabet.insert(0, byte)
    return np.frombuffer(bytes(out), dtype=np.uint8)


def mtf_inverse(codes: np.ndarray) -> np.ndarray:
    alphabet = list(range(256))
    out = bytearray(codes.size)
    for i, pos in enumerate(np.asarray(codes, dtype=np.uint8).tolist()):
        sym = alphabet[pos]
        out[i] = sym
        if pos:
            del alphabet[pos]
            alphabet.insert(0, sym)
    return np.frombuffer(bytes(out), dtype=np.uint8)


def rle0(codes: np.ndarray) -> np.ndarray:
    """MTF codes -> RLE0 symbols (int64, 0..256): a run of r zeros as the
    bits of r + 1 below its leading one, least significant first."""
    codes = np.asarray(codes, dtype=np.uint8)
    if codes.size == 0:
        return np.zeros(0, dtype=np.int64)
    zero = codes == 0
    run_start = zero & np.concatenate([[True], ~zero[:-1]])
    heads = np.flatnonzero(~zero | run_start)  # one element each
    is_run = zero[heads]
    # a run's length: up to the next element that is not in it
    nxt = np.append(heads[1:], codes.size)
    ends = np.where(is_run, nxt, heads + 1)
    # a run ends where a non-zero code starts; heads inside a run are only
    # its start, so the next head is the end of the run
    r = ends - heads
    r1 = np.where(is_run, r + 1, 2)
    count = np.where(is_run, np.frexp(r1.astype(np.float64))[1] - 1, 1)
    el = np.repeat(np.arange(heads.size), count)
    within = np.arange(el.size) - (np.cumsum(count) - count)[el]
    val = codes[heads].astype(np.int64) + 1
    return np.where(is_run[el], (r1[el] >> within) & 1, val[el])


def rle0_inverse(syms: np.ndarray, n: int) -> np.ndarray:
    syms = np.asarray(syms, dtype=np.int64)
    out = np.zeros(n, dtype=np.uint8)
    pos, i, m = 0, 0, syms.size
    s = syms.tolist()
    while i < m:
        if s[i] >= 2:
            out[pos] = s[i] - 1
            pos += 1
            i += 1
            continue
        r, w = 0, 1
        while i < m and s[i] <= 1:
            r += (1 + s[i]) * w
            w *= 2
            i += 1
        pos += r
    if pos != n:
        raise ValueError(f"RLE0 expands to {pos}, expected {n}")
    return out


# ---------------------------------------------------------------------------
# Huffman: optimal lengths, canonical codes, MSB-first packing
# ---------------------------------------------------------------------------

def code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Optimal (minimum-redundancy) code lengths by the heap merge, ties by
    symbol then merge order; 0 for absent symbols and for a lone one."""
    present = [s for s in range(freqs.size) if freqs[s] > 0]
    lens = np.zeros(freqs.size, dtype=np.int64)
    if len(present) <= 1:
        return lens
    heap = [(int(freqs[s]), s, [s]) for s in present]
    heapq.heapify(heap)
    tiebreak = freqs.size
    while len(heap) > 1:
        f1, _, s1 = heapq.heappop(heap)
        f2, _, s2 = heapq.heappop(heap)
        lens[s1] += 1
        lens[s2] += 1
        heapq.heappush(heap, (f1 + f2, tiebreak, s1 + s2))
        tiebreak += 1
    if lens.max() > MAX_CODE_LEN:
        raise ValueError(f"code length {lens.max()} above {MAX_CODE_LEN}")
    return lens


def canonical_codes(lens: np.ndarray) -> np.ndarray:
    order = sorted((s for s in range(lens.size) if lens[s] > 0),
                   key=lambda s: (lens[s], s))
    codes = np.zeros(lens.size, dtype=np.int64)
    code, prev = 0, 0
    for s in order:
        code <<= int(lens[s]) - prev
        prev = int(lens[s])
        codes[s] = code
        code += 1
    return codes


def huffman_encode(syms: np.ndarray, lens: np.ndarray, codes: np.ndarray) -> bytes:
    sl = lens[syms]
    el = np.repeat(np.arange(syms.size), sl)
    within = np.arange(el.size) - (np.cumsum(sl) - sl)[el]
    bits = (codes[syms][el] >> (sl[el] - 1 - within)) & 1
    return np.packbits(bits.astype(np.uint8)).tobytes()


def huffman_decode(payload: bytes, lens: np.ndarray, count: int) -> np.ndarray:
    """`count` symbols of a canonical code: the symbol and length that
    start at every bit position, then a walk from position 0."""
    lens = np.asarray(lens, dtype=np.int64)
    maxl = int(lens.max())
    bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8)).astype(np.int64)
    nb = bits.size
    padded = np.concatenate([bits, np.zeros(maxl, np.int64)])
    window = np.zeros(nb, dtype=np.int64)
    for k in range(maxl):
        window = (window << 1) | padded[k:k + nb]
    order = sorted((s for s in range(lens.size) if lens[s] > 0),
                   key=lambda s: (lens[s], s))
    codes = canonical_codes(lens)
    sym_at = np.full(nb, -1, dtype=np.int64)
    len_at = np.zeros(nb, dtype=np.int64)
    for ln in range(1, maxl + 1):
        group = [s for s in order if lens[s] == ln]
        if not group:
            continue
        first = int(codes[group[0]])
        v = window >> (maxl - ln)
        hit = (sym_at < 0) & (v >= first) & (v < first + len(group))
        sym_at[hit] = np.asarray(group)[v[hit] - first]
        len_at[hit] = ln
    sym_l, len_l = sym_at.tolist(), len_at.tolist()
    out = np.empty(count, dtype=np.int64)
    pos = 0
    for i in range(count):
        if pos >= nb or sym_l[pos] < 0:
            raise ValueError("corrupt Huffman stream")
        out[i] = sym_l[pos]
        pos += len_l[pos]
    return out


# ---------------------------------------------------------------------------
# Blocks and the container
# ---------------------------------------------------------------------------

def pack_lens(lens: np.ndarray, present: np.ndarray) -> bytes:
    bitmap = np.packbits(np.pad(present, (0, 8 * BITMAP_BYTES - ALPHABET)),
                         bitorder="little")
    v = lens[present]
    bits = ((v[:, None] >> np.arange(4, -1, -1)) & 1).astype(np.uint8)
    return bitmap.tobytes() + np.packbits(bits.reshape(-1)).tobytes()


def encode_block(raw: np.ndarray, stride: int, lengths=code_lengths) -> bytes:
    """One block of the container, from its raw bytes."""
    raw = np.asarray(raw, dtype=np.uint8)
    enc = rle1_encode(raw)
    data = enc if enc.size < raw.size else raw
    shift, last, cps = bwt(data, stride)
    syms = rle0(mtf(last))
    freqs = np.bincount(syms, minlength=ALPHABET)
    lens = lengths(freqs)
    payload = huffman_encode(syms, lens, canonical_codes(lens))
    present = freqs > 0
    len_field = raw.size | (RLE1_FLAG if data is enc else 0)
    if cps is None:
        head = BLOCK_HEADER.pack(len_field, shift, PERIODIC, syms.size)
        cp_bytes = b""
    else:
        head = BLOCK_HEADER.pack(len_field, shift, cps.size, syms.size)
        cp_bytes = cps.astype("<u4").tobytes()
    pre = struct.pack("<I", data.size) if data is enc else b""
    return head + pre + cp_bytes + pack_lens(lens, present) + payload


def split(data: bytes, block_size: int) -> list[np.ndarray]:
    a = np.frombuffer(data, dtype=np.uint8)
    return [a[i:i + block_size] for i in range(0, a.size, block_size)]


def pack_file(blocks: list[bytes], block_size: int, total: int, stride: int) -> bytes:
    header = FILE_HEADER.pack(MAGIC, VERSION, FLAG_CRC32, stride.bit_length() - 1,
                              block_size, len(blocks), total)
    body = b"".join(blocks)
    return (header + struct.pack(f"<{len(blocks)}I", *map(len, blocks))
            + struct.pack("<I", zlib.crc32(body)) + body)


def compress(data: bytes, block_size: int, stride: int, lengths=code_lengths) -> bytes:
    return pack_file([encode_block(b, stride, lengths) for b in split(data, block_size)],
                     block_size, len(data), stride)


def unpack_file(buf: bytes) -> tuple[dict, list[bytes]]:
    """(header fields, block byte strings) of a container with a block
    table and a CRC; raises ValueError on anything else."""
    if len(buf) < FILE_HEADER.size:
        raise ValueError("truncated header")
    magic, version, flags, res, block_size, n, total = FILE_HEADER.unpack_from(buf, 0)
    if magic != MAGIC or flags != FLAG_CRC32:
        raise ValueError("not a CRC-checked, tabled .bzt container")
    off = FILE_HEADER.size
    if len(buf) < off + 4 * n + 4:
        raise ValueError("truncated block table")
    sizes = struct.unpack_from(f"<{n}I", buf, off)
    off += 4 * n
    (crc,) = struct.unpack_from("<I", buf, off)
    off += 4
    if len(buf) != off + sum(sizes):
        raise ValueError("container length disagrees with its block table")
    head = {"version": version, "stride": 1 << res if res else 4096,
            "block_size": block_size, "n_blocks": n, "total": total,
            "crc_ok": zlib.crc32(buf[off:]) == crc}
    blocks = []
    for sz in sizes:
        blocks.append(buf[off:off + sz])
        off += sz
    return head, blocks


def decode_block(blk: bytes) -> np.ndarray:
    len_field, shift, n_cps, rle_len = BLOCK_HEADER.unpack_from(blk, 0)
    raw_len = len_field & ~RLE1_FLAG
    off = BLOCK_HEADER.size
    pre_len = raw_len
    if len_field & RLE1_FLAG:
        (pre_len,) = struct.unpack_from("<I", blk, off)
        off += 4
    if n_cps != PERIODIC:
        off += 4 * n_cps
    bitmap = np.frombuffer(blk, np.uint8, BITMAP_BYTES, off)
    off += BITMAP_BYTES
    present = np.unpackbits(bitmap, bitorder="little")[:ALPHABET].astype(bool)
    npres = int(present.sum())
    nbytes = (5 * npres + 7) // 8
    packed = np.unpackbits(np.frombuffer(blk, np.uint8, nbytes, off))[:5 * npres]
    off += nbytes
    lens = np.zeros(ALPHABET, dtype=np.int64)
    lens[present] = packed.reshape(npres, 5).astype(np.int64) @ (1 << np.arange(4, -1, -1))
    if raw_len == 0:
        return np.zeros(0, dtype=np.uint8)
    if npres == 1:
        syms = np.full(rle_len, int(np.flatnonzero(present)[0]), dtype=np.int64)
    else:
        syms = huffman_decode(blk[off:], lens, rle_len)
    data = bwt_inverse(mtf_inverse(rle0_inverse(syms, pre_len)), shift)
    return rle1_decode(data) if len_field & RLE1_FLAG else data


def decompress(buf: bytes) -> bytes:
    head, blocks = unpack_file(buf)
    if not head["crc_ok"]:
        raise ValueError("CRC mismatch")
    out = b"".join(decode_block(b).tobytes() for b in blocks)
    if len(out) != head["total"]:
        raise ValueError("decoded length disagrees with the header")
    return out


def block_sizes(blk: bytes) -> dict:
    """The sizes a block's decode works on, read from its header: its
    payload bytes, RLE0 symbols, BWT length (after RLE1), present symbols
    and whether it is periodic."""
    len_field, _, n_cps, rle_len = BLOCK_HEADER.unpack_from(blk, 0)
    off = BLOCK_HEADER.size
    pre_len = len_field & ~RLE1_FLAG
    if len_field & RLE1_FLAG:
        (pre_len,) = struct.unpack_from("<I", blk, off)
        off += 4
    if n_cps != PERIODIC:
        off += 4 * n_cps
    present = np.unpackbits(np.frombuffer(blk, np.uint8, BITMAP_BYTES, off),
                            bitorder="little")[:ALPHABET]
    npres = int(present.sum())
    off += BITMAP_BYTES + (5 * npres + 7) // 8
    return {"payload": len(blk) - off, "rle_len": rle_len, "n": pre_len,
            "present": npres, "periodic": n_cps == PERIODIC}
