"""The port end to end on the CPU: bmh_tpu_torch.compress_bytes writes the
same bytes as bmh_tpu.compress_bytes under both sort routes and both
compress programs, and the two packages decode each other's containers on
every decompress route (flat, periodic, single-symbol)."""

import numpy as np
import pytest
import torch

import bmh_tpu
import bmh_tpu_torch as bt
from bmh_tpu_torch.models import pipeline as tpipe
from bmh_tpu_torch.utils import config as tconfig
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
    """The single-symbol and periodic routes (once outside the port, now
    ported): bmh_tpu's containers decode through them, and the port writes
    the same containers."""
    refs = {}
    for data, bs in ((b"\x00" * 3, 2048), (b"\x05", 2048), (b"xyz" * 2000, 8192),
                     (b"xyz" * 700, 2100)):
        refs[data] = ref = bmh_tpu.compress_bytes(data, block_size=bs)
        assert bt.compress_bytes(data, block_size=bs, device="cpu") == ref
        assert bt.decompress_bytes(ref, device="cpu") == data
    for data in (b"\x00" * 3, b"\x05"):  # one present symbol, no payload
        fields = tcont.unpack_block(tcont.unpack_file(refs[data])[2][0])
        assert int(fields[3].sum()) == 1 and fields[6] == b""
    fields = tcont.unpack_block(tcont.unpack_file(refs[b"xyz" * 2000])[2][0])
    assert fields[4] is None and fields[7] > 4096  # the periodic route


def _streams():
    rng = np.random.default_rng(11)
    text = INPUTS["text"][0]
    motif = bytes(rng.integers(0, 256, 1024, dtype=np.uint8))
    return {
        "text": (text[:30000], 8192),
        "random": INPUTS["random"],
        # exactly periodic blocks, longer than one checkpoint stride and
        # shorter than the pathological test's 8192-byte floor: the sparse
        # program's resume branch, the periodic decode route
        "periodic": (b"abcdef" * 4000, 6000),
        # run-dominated blocks (the full-rounds batch) beside text ones
        "pathological": (motif * 16 + text[:9000], 8192),
    }


STREAMS = _streams()
_REFS: dict = {}


@pytest.mark.parametrize("sort3", [False, True], ids=["torch_sort", "sort3"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_compress_matches_bmh_tpu_both_sort_routes(monkeypatch, name, sort3):
    """BMH_PALLAS_SORT routes every BWT sort of both programs through K5's
    plain version here; the containers stay bmh_tpu's byte for byte."""
    data, bs = STREAMS[name]
    if name not in _REFS:
        _REFS[name] = bmh_tpu.compress_bytes(data, block_size=bs)
    monkeypatch.setattr(tconfig.DEFAULT, "pallas_sort", sort3)
    arrs = [np.frombuffer(data[i:i + bs], np.uint8) for i in range(0, len(data), bs)]
    hard = [tpipe._looks_pathological(a) for a in arrs]
    assert any(hard) == (name == "pathological") and not all(hard)
    got = bt.compress_bytes(data, block_size=bs, device="cpu")
    assert got == _REFS[name]
    if name == "periodic":
        assert all(tcont.unpack_block(r)[4] is None for r in tcont.unpack_file(got)[2])
    assert bt.decompress_bytes(got, device="cpu") == data


@pytest.mark.parametrize("lf2", [True, False], ids=["lf2", "lf1"])
def test_64k_blocks_roundtrip_both_walks(monkeypatch, lf2):
    """64 KiB blocks, where BMH_LF2 sends bmh_tpu's inverse BWT over its
    LF² table and the port's over 16-step row links: the container is bmh_tpu's byte for byte, and each package
    decodes the other's, with the knob on and off."""
    bs = 1 << 16
    if "64k" not in _REFS:
        rng = np.random.default_rng(64)
        data = _text(rng, 100000) + bytes(rng.integers(0, 256, 20000, dtype=np.uint8))
        _REFS["64k"] = (data, bmh_tpu.compress_bytes(data, block_size=bs))
    data, ref = _REFS["64k"]
    monkeypatch.setattr(tconfig.DEFAULT, "lf2", lf2)
    got = bt.compress_bytes(data, block_size=bs, device="cpu")
    assert got == ref and len(tcont.unpack_file(got)[2]) == 2
    assert bt.decompress_bytes(ref, device="cpu") == data
    assert bmh_tpu.decompress_bytes(got) == data


def test_full_rounds_program_writes_the_same_blocks():
    """Forcing the full-rounds program on every batch changes no byte."""
    data, bs = STREAMS["text"]
    blocks = [np.frombuffer(data[i:i + bs], np.uint8) for i in range(0, len(data), bs)]
    be = tpipe.TorchBackend(torch.device("cpu"))
    sparse = be.compress_blocks(blocks, 4096)
    full = be.compress_blocks(blocks, 4096, full_rounds=True)
    for a, b in zip(sparse, full):
        assert a["payload"] == b["payload"] and a["shift"] == b["shift"]
        np.testing.assert_array_equal(a["cps"], b["cps"])


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


def test_decode_chunk_bits_65536_matches_bmh_tpu(monkeypatch):
    """decode_chunk_bits is a decoder knob, not a container field: at
    65536-bit chunks (each block's payload in one chunk, the lookahead
    crossing into the next block's) the port decodes bmh_tpu's container
    to bmh_tpu's bytes.  bmh_tpu decodes at its default chunk size: its
    flat decode pads the chunk axis to 1024 chunks, which at 65536 bits
    asks for more memory than a test may take."""
    data = _text(np.random.default_rng(65), 12000) + INPUTS["random"][0][:3000]
    ref = bmh_tpu.compress_bytes(data, block_size=8192)
    want = bmh_tpu.decompress_bytes(ref)
    monkeypatch.setattr(tconfig.DEFAULT, "decode_chunk_bits", 65536)
    assert bt.decompress_bytes(ref, device="cpu") == want == data
