"""RocksDB data blocks as a memtable flush writes them, with db_bench's
defaults: the data that a key-value store hands its block compressor.

The entries are db_bench's (tools/db_bench_tool.cc): `num` keys drawn at
random without repeats, each `key_size` bytes (the number as 8 big-endian
bytes, padded with "0"), and a `value_size`-byte value from db_bench's
RandomGenerator, whose values are `compression_ratio` random printable
bytes repeated to fill the value.  A flush sorts them; every key becomes
an internal key with the write's sequence number and type (8 bytes,
little-endian).  The blocks are BlockBasedTable data blocks
(table/block_based/block_builder.cc): key prefixes shared with the
previous key except at a restart point, every `block_restart_interval`
entries; the restart offsets and their count as a 4-byte little-endian
trailer.  A block is cut as FlushBlockBySizePolicy cuts it: once it
reaches `block_size`, or earlier where the next entry would take it past
`block_size` and it is already over (100 - `block_size_deviation`)% of it.
The sequence numbers, the random keys and the values' bytes come from the
seed; db_bench's own generator has a fixed seed."""

from __future__ import annotations

import struct

import numpy as np

TYPE_VALUE = 1  # kTypeValue


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _values(rng, count: int, value_size: int, compression_ratio: float) -> list[bytes]:
    """RandomGenerator's values: 1 MiB of 100-byte pieces, each
    int(100 * compression_ratio) printable bytes repeated, read in turn
    value_size bytes at a time, from the start again at the end."""
    raw = int(100 * compression_ratio)
    n_pieces = -(-max(1 << 20, value_size) // 100)
    chars = rng.integers(ord(" "), ord(" ") + 95, (n_pieces, raw), dtype=np.uint8)
    pieces = np.tile(chars, -(-100 // raw))[:, :100]
    data = pieces.tobytes()
    out, pos = [], 0
    for _ in range(count):
        if pos + value_size > len(data):
            pos = 0
        out.append(data[pos:pos + value_size])
        pos += value_size
    return out


class _Block:
    """block_builder.cc's BlockBuilder, without value delta encoding."""

    def __init__(self, restart_interval: int):
        self.interval = restart_interval
        self.buf = bytearray()
        self.restarts = [0]
        self.counter = 0
        self.last = b""

    def size(self) -> int:  # CurrentSizeEstimate
        return len(self.buf) + 4 * len(self.restarts) + 4

    def size_after(self, key: bytes, value: bytes) -> int:  # EstimateSizeAfterKV
        restart = self.counter >= self.interval
        return (self.size() + len(key) + len(value) + (4 if restart else 0) + 4
                + len(_varint(len(key))) + len(_varint(len(value))))

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.counter >= self.interval:
            self.restarts.append(len(self.buf))
            self.counter = 0
        elif self.buf:
            while (shared < min(len(key), len(self.last))
                   and key[shared] == self.last[shared]):
                shared += 1
        self.buf += (_varint(shared) + _varint(len(key) - shared) + _varint(len(value))
                     + key[shared:] + value)
        self.last = key
        self.counter += 1

    def finish(self) -> bytes:
        return (bytes(self.buf) + struct.pack(f"<{len(self.restarts)}I", *self.restarts)
                + struct.pack("<I", len(self.restarts)))


def make(seed: int, count: int, block_size: int = 4096, block_size_deviation: int = 10,
         block_restart_interval: int = 16, key_size: int = 16, value_size: int = 100,
         compression_ratio: float = 0.5, num: int = 1000000) -> list[bytes]:
    """The first `count` data blocks of a flush of enough entries to fill
    them."""
    rng = np.random.default_rng(seed)
    entry = key_size + 8 + value_size
    n = min(num, count * (block_size // entry + 2) + 1)
    keys = np.sort(rng.choice(num, n, replace=False)).astype(">u8").tobytes()
    seqs = rng.permutation(n).astype(np.uint64) + 1
    values = _values(rng, n, value_size, compression_ratio)
    pad = b"0" * max(key_size - 8, 0)
    limit = (block_size * (100 - block_size_deviation) + 99) // 100
    out: list[bytes] = []
    blk = _Block(block_restart_interval)
    for i in range(n):
        ikey = (keys[8 * i:8 * i + 8] + pad)[:key_size] + struct.pack(
            "<Q", int(seqs[i]) << 8 | TYPE_VALUE)
        if blk.buf and (blk.size() >= block_size or (
                blk.size_after(ikey, values[i]) > block_size and blk.size() > limit)):
            out.append(blk.finish())
            if len(out) == count:
                return out
            blk = _Block(block_restart_interval)
        blk.add(ikey, values[i])
    raise ValueError(f"{num} keys fill fewer than {count} blocks")
