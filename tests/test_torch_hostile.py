"""Hostile containers through the port: CRC-valid .bzt files with
internally inconsistent fields fail closed with ValueError.

The cases of tests/test_hostile.py on the flat, periodic and single-symbol
routes, run through bmh_tpu_torch on the CPU.  Two defence layers:
host-side cross-field validation (api._validate_block_info) and the
decoded totals the device returns with the decoded bytes
(models/pipeline.decode_flat and decode_flat_periodic)."""

import numpy as np
import pytest

import bmh_tpu_torch as bt
from bmh_tpu_torch.utils import container


def _mutate_block(blob: bytes, idx: int = 0, **overrides) -> bytes:
    """Re-pack `blob` with block `idx`'s fields overridden and a FRESH CRC
    (the attacker model: a writer that lies consistently)."""
    bs, total, raws = container.unpack_file(blob)
    stride = container.file_stride(blob)
    blocks = []
    for i, raw in enumerate(raws):
        (orig_len, shift, lens, present, cps, rle_len, payload,
         pre_len) = container.unpack_block(raw)
        if i == idx:
            f = dict(orig_len=orig_len, bwt_shift=shift, lens=lens,
                     present=present, payload=payload, cps=cps,
                     rle_len=rle_len, pre_len=pre_len)
            f.update(overrides)
            raw = container.pack_block(
                f["orig_len"], f["bwt_shift"], f["lens"], f["present"],
                f["payload"], cps=f["cps"], rle_len=f["rle_len"],
                pre_len=f["pre_len"])
        blocks.append(raw)
    return container.pack_file(blocks, bs, total, stride=stride)


def _decode(blob):
    return bt.decompress_bytes(blob, device="cpu")


@pytest.fixture(scope="module")
def text_blob():
    rng = np.random.default_rng(7)
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"lazy ", b"dog ",
             b"jumps ", b"over "]
    data = b"".join(words[i] for i in rng.integers(0, 8, 2800))[:12000]
    blob = bt.compress_bytes(data, block_size=16384, device="cpu")
    assert _decode(blob) == data  # sanity: the base is valid
    return data, blob


def _fields(blob, idx=0):
    _, _, raws = container.unpack_file(blob)
    return container.unpack_block(raws[idx])


def test_rle_len_too_large_host_check(text_blob):
    _, blob = text_blob
    pre_len = _fields(blob)[7]
    with pytest.raises(ValueError, match="rle_len"):
        _decode(_mutate_block(blob, rle_len=pre_len + 5))


def test_rle_len_lying_small_device_totals(text_blob):
    _, blob = text_blob
    rle_len = _fields(blob)[5]
    assert rle_len > 4
    with pytest.raises(ValueError, match="corrupt"):
        _decode(_mutate_block(blob, rle_len=rle_len - 3))


def test_rle_len_one_device_totals(text_blob):
    _, blob = text_blob
    with pytest.raises(ValueError, match="corrupt"):
        _decode(_mutate_block(blob, rle_len=1))


def test_truncated_cps(text_blob):
    _, blob = text_blob
    cps = _fields(blob)[4]
    assert cps is not None and len(cps) > 0
    with pytest.raises(ValueError, match="checkpoint"):
        _decode(_mutate_block(blob, cps=cps[:-1]))


def test_oversized_cps(text_blob):
    _, blob = text_blob
    extra = np.concatenate([np.asarray(_fields(blob)[4], dtype=np.int32),
                            np.arange(40, dtype=np.int32)])
    with pytest.raises(ValueError, match="checkpoint"):
        _decode(_mutate_block(blob, cps=extra))


def test_cps_value_out_of_range(text_blob):
    _, blob = text_blob
    cps, pre_len = _fields(blob)[4], _fields(blob)[7]
    cc = np.asarray(cps, dtype=np.int32).copy()
    cc[0] = pre_len + 10
    with pytest.raises(ValueError, match="checkpoint"):
        _decode(_mutate_block(blob, cps=cc))


def test_kraft_violation(text_blob):
    _, blob = text_blob
    lens, present = _fields(blob)[2], _fields(blob)[3]
    lens2 = np.asarray(lens, dtype=np.uint8).copy()
    lens2[int(np.nonzero(present)[0][0])] += 1
    with pytest.raises(ValueError, match="Kraft|corrupt"):
        _decode(_mutate_block(blob, lens=lens2))


def test_zero_length_present_symbol(text_blob):
    _, blob = text_blob
    lens, present = _fields(blob)[2], _fields(blob)[3]
    lens2 = np.asarray(lens, dtype=np.uint8).copy()
    lens2[int(np.nonzero(present)[0][0])] = 0
    with pytest.raises(ValueError, match="length 0|Kraft|corrupt"):
        _decode(_mutate_block(blob, lens=lens2))


def test_truncated_payload(text_blob):
    _, blob = text_blob
    payload = _fields(blob)[6]
    with pytest.raises(ValueError, match="corrupt"):
        _decode(_mutate_block(blob, payload=payload[: len(payload) // 2]))


def test_orig_len_exceeds_block_size(text_blob):
    _, blob = text_blob
    with pytest.raises(ValueError, match="corrupt|orig_len"):
        _decode(_mutate_block(blob, orig_len=1 << 20, pre_len=1 << 20))


def test_shift_out_of_range(text_blob):
    _, blob = text_blob
    pre_len = _fields(blob)[7]
    with pytest.raises(ValueError, match="shift"):
        _decode(_mutate_block(blob, bwt_shift=pre_len + 3))


def test_garbage_payload_bits(text_blob):
    _, blob = text_blob
    garbage = bytes((b ^ 0x5A) for b in _fields(blob)[6])
    with pytest.raises(ValueError, match="corrupt"):
        _decode(_mutate_block(blob, payload=garbage))


def test_hostile_block_size_header():
    blob = bt.compress_bytes(b"hello world " * 100, block_size=2048, device="cpu")
    _, total, raws = container.unpack_file(blob)
    bad = container.pack_file(raws, 1 << 30, total, stride=4096)
    with pytest.raises(ValueError, match="block_size"):
        _decode(bad)
    with pytest.raises(ValueError, match="block_size"):
        bt.decompress_many([bad], device="cpu")


def test_fused_decode_totals_wrap_aliasing_container():
    """A CRC-valid container whose RLE0 digit stream's contribution sum is
    exactly pre_len + 2^32 (so a 32-bit total would alias pre_len) must
    fail closed: the port's int64 totals cannot wrap."""
    n = 3000
    target = n + (1 << 32)
    m = 535
    base = ((1 << 22) - 1) + (m - 22) * (1 << 22)
    extra = target - base
    hi_flips = min(extra // (1 << 22), m - 22)
    rem = extra - hi_flips * (1 << 22)
    assert 0 <= rem < (1 << 22)
    bits = [((rem >> j) & 1) if j < 22 else int((j - 22) < hi_flips)
            for j in range(m)]
    total = sum((1 + b) << min(j, 22) for j, b in enumerate(bits))
    assert total == target and total % (1 << 32) == n
    payload = bytearray((m + 7) // 8)
    for j, b in enumerate(bits):
        if b:
            payload[j >> 3] |= 0x80 >> (j & 7)
    lens = np.zeros(container.ALPHABET, np.uint8)
    present = np.zeros(container.ALPHABET, bool)
    lens[0] = lens[1] = 1
    present[0] = present[1] = True
    raw = container.pack_block(n, 7, lens, present, bytes(payload),
                               cps=(), rle_len=m, pre_len=n)
    blob = container.pack_file([raw], 4096, n, stride=4096)
    with pytest.raises(ValueError, match="corrupt"):
        _decode(blob)


@pytest.mark.parametrize("data,bs", [(b"xyz" * 700, 2100), (b"xyz" * 2000, 8192)],
                         ids=["one_stride", "periodic_route"])
def test_periodic_block_lying_rle_len(data, bs):
    """A block without checkpoints: within one stride it takes the flat
    route, longer the periodic route, whose decoded totals come back the
    same way."""
    blob = bt.compress_bytes(data, block_size=bs, device="cpu")
    assert _decode(blob) == data
    f = _fields(blob)
    assert f[4] is None and (f[7] > 4096) == (bs > 4096)
    assert f[5] > 3
    with pytest.raises(ValueError, match="corrupt"):
        _decode(_mutate_block(blob, rle_len=f[5] - 2))


def test_single_symbol_lying_rle_len():
    """Single-symbol blocks carry no payload; the host-side closed-form
    check catches a lying rle_len."""
    blob = bt.compress_bytes(b"\x00" * 3, block_size=2048, device="cpu")
    assert _decode(blob) == b"\x00" * 3
    with pytest.raises(ValueError, match="single-symbol|corrupt"):
        _decode(_mutate_block(blob, rle_len=_fields(blob)[5] + 1))
