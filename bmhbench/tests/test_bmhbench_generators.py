"""The seeded generators: the same seed gives the same inputs; zipf_text
is the program's own stream, and rocksdb_blocks writes RocksDB's block
format and cuts blocks as its flush policy does."""

import struct

import numpy as np
import pytest

from bmhbench import generators, traffic
from bmhbench.generators import rocksdb_blocks, zipf_text

KINDS = {"zipf_text": {"text_bytes": 5000, "random_bytes": 1000},
         "rocksdb_blocks": {"block_size": 1024}}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_deterministic_by_seed(kind):
    gen = generators.find(kind)
    a = gen.make(2**33 + 7, 3, **KINDS[kind])
    assert a == gen.make(2**33 + 7, 3, **KINDS[kind])
    assert a != gen.make(2**33 + 8, 3, **KINDS[kind])
    assert len(a) == 3 and all(isinstance(x, bytes) for x in a)


def test_zipf_text_is_the_programs_stream():
    from bmh_tpu_torch.utils import synth

    assert zipf_text.stream(11, 20000, 3000) == synth.smoke_input(11, 20000, 3000)


def test_zipf_text_where_the_programs_stream_fails():
    """Seed 3100000001's frequent words are short: the program's generator
    draws too few of them for 200000 bytes; the frozen copy draws more."""
    from bmh_tpu_torch.utils import synth

    with pytest.raises(AssertionError):
        synth.smoke_input(3100000001, 200000, 0)
    assert len(zipf_text.stream(3100000001, 200000, 100)) == 200100


def _entries(block: bytes) -> tuple[list[tuple[bytes, bytes]], int]:
    """A RocksDB data block's (internal key, value) entries, read back
    through its prefix compression, and its number of restarts."""
    n_restarts = struct.unpack("<I", block[-4:])[0]
    end = len(block) - 4 * (n_restarts + 1)
    restarts = struct.unpack(f"<{n_restarts}I", block[end:-4])
    out, pos, key = [], 0, b""

    def varint():
        nonlocal pos
        v = shift = 0
        while True:
            b = block[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return v

    while pos < end:
        if pos in restarts:
            assert len(out) % 16 == 0
        shared, non_shared, vlen = varint(), varint(), varint()
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        out.append((key, block[pos:pos + vlen]))
        pos += vlen
    assert pos == end and restarts[0] == 0
    return out, n_restarts


def test_rocksdb_blocks_are_rocksdb_blocks():
    blocks = rocksdb_blocks.make(2**31 + 5, 24)
    users = []
    for blk in blocks:
        entries, n_restarts = _entries(blk)
        assert n_restarts == -(-len(entries) // 16)
        for key, value in entries:
            assert len(key) == 24 and key[8:16] == b"0" * 8
            assert struct.unpack("<Q", key[16:])[0] & 0xFF == rocksdb_blocks.TYPE_VALUE
            assert len(value) == 100 and value[:50] == value[50:]
            assert all(32 <= c < 127 for c in value)
            users.append(key[:8])
        # cut once past 90% of block_size, before the next entry would
        # take it past block_size
        assert (4096 * 90 + 99) // 100 < len(blk) <= 4096
        assert len(blk) + 24 + 100 + 6 > 4096
    assert users == sorted(set(users))


def test_rocksdb_blocks_same_work_every_seed():
    a = rocksdb_blocks.make(1, 64)
    b = rocksdb_blocks.make(2**33 + 9, 64)
    assert abs(sum(map(len, a)) - sum(map(len, b))) <= 64 * 8


def test_pool_shape(bench):
    from bmhbench.tests.cells import tiny

    config, mix = tiny(bench, "objects-put")
    pool = traffic.pool(config, mix, 5)
    assert len(pool) == mix["pool_requests"]
    assert all(len(r) == mix["items_per_request"] for r in pool)
    assert traffic.pool(config, mix, 5) == pool


def test_bad_generator_name():
    with pytest.raises(ValueError):
        generators.find("../x")
    assert np.isscalar(generators.item_seed(2**40, 3))
