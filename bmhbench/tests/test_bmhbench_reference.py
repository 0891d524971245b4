"""The plain reference codec: it round-trips its inputs, and at a tiny
size its containers are the program's, byte for byte."""

import numpy as np
import pytest

from bmhbench import control, reference
from bmhbench.generators import rocksdb_blocks, zipf_text


def _cases():
    rng = np.random.default_rng(3)
    text = zipf_text.stream(5, 12000, 2000)
    return {
        "text_and_random": text,
        "runs_rle1": b"a" * 700 + b"q" * 4 + b"z" * 259 + text[:3000] + b"\0" * 5000,
        "periodic": b"wxyz" * 3000,
        "single_symbol": b"\x07" * 9000,
        "one_byte": b"!",
        "random": rng.integers(0, 256, 9000, dtype=np.uint8).tobytes(),
        "empty": b"",
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_trip(name):
    buf = reference.compress(CASES[name], 4096, 4096)
    assert reference.decompress(buf) == CASES[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_containers_equal_the_programs(name):
    from bmh_tpu_torch import api

    data = CASES[name]
    assert reference.compress(data, 4096, 4096) == api.compress_bytes(data, 4096, device="cpu")


def test_uniform_many_equal_the_programs():
    from bmh_tpu_torch import api

    objs = rocksdb_blocks.make(9, 4, block_size=1024) + [zipf_text.stream(9, n, 0)
                                                          for n in (300, 3000)]
    got = api.compress_many(objs, 8192, uniform=True, device="cpu")
    assert got == [reference.compress(o, 8192, 4096) for o in objs]


def test_rle1_is_the_programs_spec():
    from bmh_tpu_torch.utils import nativeio

    for name, data in CASES.items():
        a = np.frombuffer(data, np.uint8)
        assert np.array_equal(reference.rle1_encode(a), nativeio._rle1_encode_py(a)), name


def test_block_sizes_read_the_header():
    buf = reference.compress(CASES["text_and_random"], 4096, 4096)
    head, blocks = reference.unpack_file(buf)
    s = reference.block_sizes(blocks[0])
    assert s["n"] == 4096 and s["present"] > 1 and not s["periodic"]
    assert s["payload"] > 0 and s["rle_len"] > 0
    assert reference.block_sizes(reference.unpack_file(
        reference.compress(CASES["periodic"], 4096, 4096))[1][0])["periodic"]


def test_control_differs_and_still_decodes():
    data = CASES["text_and_random"]
    ctl = reference.compress(data, 4096, 4096, control.shannon_lengths)
    assert ctl != reference.compress(data, 4096, 4096)
    assert reference.decompress(ctl) == data
