"""The port's NumPy oracle and its backend, held against bmh_tpu's oracle:
the same stage outputs, byte-identical containers, and containers that
cross-decode with the port's torch backend."""

import numpy as np
import pytest

import bmh_tpu
from bmh_tpu.models import oracle as joracle

import bmh_tpu_torch as bt
from bmh_tpu_torch.models import oracle as toracle

BS = 8192


def _inputs():
    rng = np.random.default_rng(31337)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9))) for _ in range(200)]
    text = b" ".join(words[i] for i in rng.integers(0, 200, 6000))
    motif = bytes(rng.integers(0, 256, 300, dtype=np.uint8))
    return {
        "empty": b"",
        "one_byte": b"\x07",
        "single_symbol": b"z" * 5000,
        "periodic": motif * 40,
        "mixed": text[:14000] + bytes(rng.integers(0, 256, 3000, dtype=np.uint8)),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("stride", [4096, 1024])
@pytest.mark.parametrize("name", ["one_byte", "single_symbol", "periodic", "mixed"])
def test_stages_equal_bmh_tpus(name, stride, monkeypatch):
    import bmh_tpu.ops.bwt

    data = np.frombuffer(INPUTS[name][:BS], np.uint8)
    monkeypatch.setattr(bmh_tpu.ops.bwt, "CURSOR_STRIDE", stride)
    jshift, jlast, jcps = joracle.bwt_with_checkpoints(data)
    tshift, tlast, tcps = toracle.bwt_with_checkpoints(data, stride)
    assert jshift == tshift and np.array_equal(jlast, tlast)
    assert (jcps is None and tcps is None) or np.array_equal(jcps, tcps)
    assert toracle.bwt(data)[0] == joracle.bwt(data)[0]
    codes = toracle.mtf(tlast)
    assert np.array_equal(codes, joracle.mtf(jlast))
    assert np.array_equal(toracle.mtf_inverse(codes), tlast)
    syms = toracle.rle0(codes)
    assert np.array_equal(syms, joracle.rle0(codes))
    freqs = toracle.histogram(syms, toracle.RLE_ALPHABET)
    lens = toracle.huffman_code_lengths(freqs)
    assert np.array_equal(lens, joracle.huffman_code_lengths(freqs))
    canon = toracle.canonical_codes(lens)
    assert np.array_equal(canon, joracle.canonical_codes(lens))
    payload, bits = toracle.huffman_encode(syms, lens, canon)
    assert (payload, bits) == joracle.huffman_encode(syms, lens, canon)
    single = int(syms[0]) if (lens > 0).sum() == 0 else None
    back = toracle.decompress_block(payload, lens, tshift, data.size, syms.size,
                                    single_symbol=single)
    assert np.array_equal(back, data)
    jb = joracle.compress_block(data)
    tb = toracle.compress_block(data, stride)
    for key in ("shift", "payload", "total_bits", "orig_len", "rle_len"):
        assert jb[key] == tb[key]
    assert np.array_equal(jb["lens"], tb["lens"]) and np.array_equal(jb["freqs"], tb["freqs"])


def test_bwt_brute_agrees():
    data = np.frombuffer(b"banana\x00abracadabra", np.uint8)
    s, last = toracle.bwt_brute(data)
    assert (s, last.tobytes()) == (joracle.bwt_brute(data)[0], joracle.bwt_brute(data)[1].tobytes())
    assert toracle.bwt(data)[0] == s and np.array_equal(toracle.bwt(data)[1], last)
    assert np.array_equal(toracle.bwt_inverse(last, s), data)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_oracle_containers_equal_bmh_tpus_and_cross_decode(name):
    data = INPUTS[name]
    blob = bt.compress_bytes(data, block_size=BS, backend="oracle")
    assert blob == bmh_tpu.compress_bytes(data, block_size=BS, backend="oracle")
    assert bt.decompress_bytes(blob, backend="oracle") == data
    assert bt.decompress_bytes(blob, device="cpu") == data
    torch_blob = bt.compress_bytes(data, block_size=BS, device="cpu")
    assert bt.decompress_bytes(torch_blob, backend="oracle") == data


def test_oracle_backend_many_and_knobs(monkeypatch):
    from bmh_tpu_torch.utils import config

    datas = [INPUTS["mixed"], INPUTS["periodic"]]
    blobs = bt.compress_many(datas, block_size=BS, backend="oracle", uniform=True)
    assert bt.decompress_many(blobs, backend="oracle", uniform=True) == datas
    # the stride compress_many passes reaches the oracle's checkpoints
    monkeypatch.setattr(config.DEFAULT, "cursor_stride", 1024)
    blob = bt.compress_bytes(INPUTS["mixed"], block_size=BS, backend="oracle")
    assert blob == bt.compress_bytes(INPUTS["mixed"], block_size=BS, device="cpu")
    assert bt.decompress_bytes(blob, device="cpu") == INPUTS["mixed"]
    with pytest.raises(ValueError, match="unknown backend"):
        bt.get_backend("jax")
    assert bt.get_backend("oracle").name == "oracle"
