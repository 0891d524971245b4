"""The port's slice end to end on the CPU: bmh_tpu_torch.compress_bytes
writes the same bytes as bmh_tpu.compress_bytes, the two packages decode
each other's containers, and the routes outside this slice raise."""

import numpy as np
import pytest
import torch

import bmh_tpu
import bmh_tpu_torch as bt
from bmh_tpu_torch.utils import container as tcont


def _text(rng, n):
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over ",
             b"lazy ", b"dog", b".\n", b", "]
    w = rng.integers(0, len(words), n // 3)
    return b"".join(words[i] for i in w)[:n]


def _inputs():
    rng = np.random.default_rng(2024)
    text = _text(rng, 40000)
    rnd = bytes(rng.integers(0, 256, 20000, dtype=np.uint8))
    runs = bytes(np.repeat(rng.integers(0, 256, 300, dtype=np.uint8),
                           rng.integers(1, 40, 300)))
    return {
        "text": (text, 8192),
        "random": (rnd, 4096),
        "mixed": (text[:9000] + rnd[:7000] + runs + text[9000:20000], 16384),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_compress_byte_identical_and_cross_decodes(name):
    data, bs = INPUTS[name]
    ref = bmh_tpu.compress_bytes(data, block_size=bs)
    got = bt.compress_bytes(data, block_size=bs, device="cpu")
    assert len(tcont.unpack_file(got)[2]) > 1  # several blocks
    assert got == ref
    assert bt.decompress_bytes(ref, device="cpu") == data
    assert bmh_tpu.decompress_bytes(got) == data


def test_many_uniform_and_files(tmp_path):
    data, _ = INPUTS["text"]
    parts = [data[:5000], data[5000:17000], b""]
    blobs = bt.compress_many(parts, block_size=4096, uniform=True, device="cpu")
    assert blobs == bt.compress_many(parts, block_size=4096, device="cpu")
    assert blobs[1] == bmh_tpu.compress_bytes(parts[1], block_size=4096)
    assert bt.decompress_many(blobs, uniform=True, device="cpu") == parts
    src = tmp_path / "in.bin"
    src.write_bytes(data[:10000])
    assert bt.full_pipeline(str(src), str(tmp_path / "x.bzt"),
                            str(tmp_path / "x.out"), block_size=4096, device="cpu")
    info = bt.compress_file(str(src), str(tmp_path / "y.bzt"), device="cpu")
    assert info["encoded_file_size"] == (tmp_path / "y.bzt").stat().st_size
    assert 0 < info["header_size"] < info["encoded_file_size"]


def test_out_of_slice_routes_raise():
    single = bt.compress_bytes(b"\x00" * 3, block_size=2048, device="cpu")
    assert single == bmh_tpu.compress_bytes(b"\x00" * 3, block_size=2048)
    with pytest.raises(NotImplementedError, match="single-symbol.*ROADMAP"):
        bt.decompress_bytes(single, device="cpu")
    periodic = bt.compress_bytes(b"xyz" * 2000, block_size=8192, device="cpu")
    assert periodic == bmh_tpu.compress_bytes(b"xyz" * 2000, block_size=8192)
    assert tcont.unpack_block(tcont.unpack_file(periodic)[2][0])[4] is None
    with pytest.raises(NotImplementedError, match="periodic.*ROADMAP"):
        bt.decompress_bytes(periodic, device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        bt.compress_bytes(b"abc")
    with pytest.raises(RuntimeError, match="CUDA"):
        bt.decompress_bytes(bmh_tpu.compress_bytes(b"abc"))
    with pytest.raises(ValueError, match="backend"):
        bt.compress_bytes(b"abc", backend="jax", device="cpu")


def test_empty_and_tiny_roundtrip():
    for data in (b"", b"abcabd", b"hello, world", bytes(range(256))):
        blob = bt.compress_bytes(data, device="cpu")
        assert blob == bmh_tpu.compress_bytes(data)
        assert bt.decompress_bytes(blob, device="cpu") == data
