"""Seeded fuzz twin of tests/test_fuzz.py: the port against bmh_tpu over
every input class that has bitten the codec (0xFF runs against the 4-byte
init sentinel, periodic blocks, single-symbol streams, two-symbol runs,
ragged lengths 1-4097) at block sizes 256, 1024 and 8192.

For each input the port's container (device="cpu", the kernels' plain
versions) equals bmh_tpu.compress_bytes's byte for byte, the port decodes
bmh_tpu's container, and the port's oracle backend writes the same
container.  bmh_tpu's own decompress is left out: byte-equal containers
make it redundant, and tests/test_fuzz.py runs it.

Then one long-code case at the ops level: 26 symbols with Fibonacci counts
reach a 25-bit code, which no stream above comes near."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fuzz import _cases

import bmh_tpu
from bmh_tpu.models import pipeline as jpipe
from bmh_tpu.ops import huffman as jhuf
import bmh_tpu_torch as bt
from bmh_tpu_torch.models import pipeline as tpipe
from bmh_tpu_torch.ops import huffman as thuf
from bmh_tpu_torch.utils import synth

# _cases emits, for each length, one input of each class in this order
CLASSES = ("random", "single_symbol", "periodic", "ff_runs", "two_symbol")


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("block_size", [256, 1024, 8192])
def test_fuzz_containers_match_bmh_tpu(block_size, cls):
    cases = _cases(np.random.default_rng(1234))[CLASSES.index(cls)::len(CLASSES)]
    assert len(cases) == 10
    for case in cases:
        data = case.tobytes()
        want = bmh_tpu.compress_bytes(data, block_size=block_size)
        got = bt.compress_bytes(data, block_size=block_size, device="cpu")
        assert got == want, (cls, len(data), block_size)
        assert bt.decompress_bytes(want, device="cpu") == data, (cls, len(data))
        assert bt.compress_bytes(data, block_size=block_size,
                                 backend="oracle") == want, (cls, len(data))


def _block(words, bits, lens, m):
    """One container block's fields from a bitpacked stream (no RLE0:
    the decoded length is the symbol count)."""
    nw = (int(bits) + 31) // 32
    payload = np.asarray(words[:nw], np.uint32).astype(">u4").tobytes()
    return {"payload": payload[: (int(bits) + 7) // 8],
            "lens": np.asarray(lens).astype(np.uint8), "orig_len": m,
            "rle_len": m, "shift": 0}


def test_long_codes_match_bmh_tpu():
    """26 symbols with Fibonacci counts (317,810 symbols, a 25-bit code),
    shuffled: histogram, code lengths, canonical codes, bitpack and the
    flat gap decode (K1 and K2's plain versions) equal bmh_tpu's stage by
    stage, and the decode gives the stream back."""
    stream = synth.fibonacci_stream(26, 0)
    m = stream.size
    nmax = 1 << (m - 1).bit_length()
    padded = np.zeros(nmax, np.int64)
    padded[:m] = stream

    freqs = thuf.histogram(torch.from_numpy(padded)[None], torch.tensor([m]), 257)
    lens = thuf.code_lengths_device(freqs)
    codes = thuf.canonical_codes_device(lens)
    words, bits = thuf.encode_bitpack(torch.from_numpy(padded)[None],
                                      torch.tensor([m]), lens, codes)
    assert int(lens.max()) == 25

    js = jnp.asarray(padded, jnp.int32)
    jf = jhuf.histogram(js, jnp.int32(m), bins=257)
    jl = jhuf.code_lengths_device(jf)
    jc = jhuf.canonical_codes_device(jl)
    jw, jb = jax.jit(jhuf.encode_bitpack)(js, jnp.int32(m), jl, jc)
    np.testing.assert_array_equal(freqs[0].numpy(), np.asarray(jf))
    np.testing.assert_array_equal(lens[0].numpy(), np.asarray(jl))
    np.testing.assert_array_equal(codes[0].numpy(), np.asarray(jc))
    assert int(bits[0]) == int(jb)
    np.testing.assert_array_equal(words[0].numpy(), np.asarray(jw).astype(np.int64))

    blocks = [_block(np.asarray(jw), jb, jl, m)]
    chunk_bits = 512
    (jwords, jlens, jss, jssi, jsid, jms, _, _, _, jmaxl, _) = \
        jpipe._stage_flat_np(blocks, [0])
    count_b, sym_b = jax.vmap(jhuf.decode_tables_device)(jnp.asarray(jlens))
    want = jax.jit(jhuf.gap_decode_flat, static_argnums=(7, 8, 9))(
        jnp.asarray(jwords), count_b[jnp.asarray(jsid)].T, jnp.asarray(jss),
        jnp.asarray(jssi), jnp.asarray(jsid), sym_b, jnp.asarray(jms), nmax,
        chunk_bits, jmaxl)

    (tw, tl, tss, tssi, tsid, tms, _, _, tmaxl) = (
        torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        for x in tpipe._stage_flat_np(blocks, [0], chunk_bits, pad=False))
    assert tmaxl == jmaxl == 31
    wext, count_t, tsym = tpipe._tables(tw.view(torch.int32), tl, tsid, chunk_bits)
    got = thuf.gap_decode_flat(wext, count_t, tss, tssi, tsid, tsym, tms, nmax,
                               chunk_bits, tmaxl)
    np.testing.assert_array_equal(got[:1].numpy(), np.asarray(want)[:1])
    np.testing.assert_array_equal(got[0, :m].numpy(), stream)
