"""bmh_tpu_torch modules against their bmh_tpu functions on the same numpy
inputs: BWT forward, MTF both ways, RLE0, the Huffman tables, bitpack, the
fused gap decode, and the container format.  Integers compare exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmh_tpu import api as japi
from bmh_tpu.models import pipeline as jpipe
from bmh_tpu.ops import bwt as jbwt
from bmh_tpu.ops import huffman as jhuf
from bmh_tpu.ops import mtf as jmtf
from bmh_tpu.ops import rle as jrle
from bmh_tpu.utils import container as jcont
from bmh_tpu_torch.models import pipeline as tpipe
from bmh_tpu_torch.ops import _build
from bmh_tpu_torch.ops import bwt as tbwt
from bmh_tpu_torch.ops import huffman as thuf
from bmh_tpu_torch.ops import mtf as tmtf
from bmh_tpu_torch.ops import rle as trle
from bmh_tpu_torch.utils import container as tcont
from bmh_tpu_torch.utils import synth

NMAX = 2048


def _rows(rng):
    """Blocks of varied lengths and statistics, zero-padded to NMAX."""
    text = np.frombuffer(b"the cat sat on the mat; the dog sat on the log. " * 50,
                         dtype=np.uint8)
    blocks = [
        np.array([7], np.uint8),
        np.array([5, 5], np.uint8),
        np.frombuffer(b"banana_bandana", np.uint8),
        np.tile(np.frombuffer(b"xyz", np.uint8), 600),      # periodic
        np.full(NMAX, 0xFF, np.uint8),                       # 0xFFFFFFFF 4-grams
        rng.integers(0, 256, 1999).astype(np.uint8),
        rng.integers(0, 3, NMAX).astype(np.uint8),
        text[:1500].copy(),
    ]
    batch = np.zeros((len(blocks), NMAX), np.uint8)
    for i, b in enumerate(blocks):
        batch[i, : b.size] = b
    return batch, np.array([b.size for b in blocks], np.int64)


@pytest.fixture(scope="module")
def rows():
    return _rows(np.random.default_rng(5))


def test_bwt_forward_cp_matches_jax(rows):
    batch, ns = rows
    last, shift, cps, aper = tbwt.bwt_forward_cp(
        torch.from_numpy(batch), torch.from_numpy(ns), jbwt.CURSOR_STRIDE)
    f = jax.jit(jbwt.bwt_forward_cp)
    assert not bool(aper[3])  # the periodic row is flagged
    for i in range(len(ns)):
        jl, js, jc, ja = f(jnp.asarray(batch[i]), jnp.int32(ns[i]))
        np.testing.assert_array_equal(last[i].numpy(), np.asarray(jl))
        assert int(shift[i]) == int(js)
        assert bool(aper[i]) == bool(ja)
        if ns[i] > 1:
            np.testing.assert_array_equal(cps[i].numpy(), np.asarray(jc))


def _bwt_forward_inputs(kind):
    """tests/test_bwt.py's inputs by kind: the oracle cases (one byte, two
    equal bytes, banana_bandana, periodic rows), random bytes at its lengths
    (full and 4-symbol alphabets), and 0xFF runs against the 4-byte init
    sentinel."""
    rng = np.random.default_rng(1234)
    if kind == "oracle_cases":
        return [np.array([1], np.uint8), np.array([5, 5], np.uint8),
                np.frombuffer(b"banana_bandana", np.uint8),
                np.tile(np.arange(3, dtype=np.uint8), 11),
                np.zeros(33, np.uint8), np.full(64, 7, np.uint8)]
    if kind == "one_byte":
        return [np.array([v], np.uint8) for v in (0, 0x7F, 0xFF)]
    if kind == "ff_runs":
        out = []
        for n in (4, 5, 100, 1000):
            x = rng.integers(0, 256, n).astype(np.uint8)
            x[: min(8, n)] = 0xFF
            x[-min(5, n):] = 0xFF
            out += [x, np.full(n, 0xFF, np.uint8)]
        return out
    return [rng.integers(0, 4 if kind == "random_4sym" else 256, n).astype(np.uint8)
            for n in (1, 2, 5, 100, 1000, 4096)]


@pytest.mark.parametrize("kind", ["oracle_cases", "random", "random_4sym",
                                  "ff_runs", "one_byte"])
def test_bwt_forward_matches_jax(kind):
    """bwt_forward (no checkpoints) against bmh_tpu's jitted bwt_forward,
    every position of the last column and the shift, each row at its own
    power-of-two bucket and all rows in one batch at the largest."""
    cases = _bwt_forward_inputs(kind)
    f = jax.jit(jbwt.bwt_forward)
    want = []
    for x in cases:
        nmax = max(8, 1 << max(x.size - 1, 1).bit_length())
        row = np.zeros(nmax, np.uint8)
        row[: x.size] = x
        jl, js = f(jnp.asarray(row), jnp.int32(x.size))
        want.append((np.asarray(jl), int(js)))
        last, shift = tbwt.bwt_forward(torch.from_numpy(row)[None],
                                       torch.tensor([x.size]))
        np.testing.assert_array_equal(last[0].numpy(), want[-1][0])
        assert int(shift[0]) == want[-1][1]
    nmax = max(w[0].size for w in want)
    batch = np.zeros((len(cases), nmax), np.uint8)
    for i, x in enumerate(cases):
        batch[i, : x.size] = x
    last, shift = tbwt.bwt_forward(torch.from_numpy(batch),
                                   torch.tensor([x.size for x in cases]))
    for i, (jl, js) in enumerate(want):
        np.testing.assert_array_equal(last[i, : jl.size].numpy(), jl)
        assert not last[i, jl.size:].any() and int(shift[i]) == js


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_mtf_forward_and_rle0_match_jax(rows, chunk):
    """On CPU tensors mtf_forward runs the plain version at the given MTF
    chunk (no K7 launch), equal to bmh_tpu's codes."""
    batch, ns = rows
    before = _build.LAUNCHES["mtf_forward"]
    codes = tmtf.mtf_forward(torch.from_numpy(batch), torch.from_numpy(ns), chunk)
    assert _build.LAUNCHES["mtf_forward"] == before
    assert torch.equal(codes, tmtf.mtf_forward_plain(torch.from_numpy(batch),
                                                     torch.from_numpy(ns), chunk))
    syms, m = trle.rle0_encode(codes, torch.from_numpy(ns))
    fm = jax.jit(jmtf.mtf_forward, static_argnums=2)
    fr = jax.jit(jrle.rle0_encode)
    for i in range(len(ns)):
        jc = fm(jnp.asarray(batch[i]), jnp.int32(ns[i]), chunk)
        np.testing.assert_array_equal(codes[i].numpy(), np.asarray(jc))
        js, jm = fr(jc, jnp.int32(ns[i]))
        assert int(m[i]) == int(jm)
        np.testing.assert_array_equal(syms[i].numpy(), np.asarray(js))


def test_mtf_forward_refuses_other_devices():
    """Neither a CUDA nor a CPU tensor: the wrapper raises before any route
    runs."""
    data = torch.zeros((2, 256), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="mtf_forward: unsupported device meta"):
        tmtf.mtf_forward(data, torch.ones(2, dtype=torch.int64, device="meta"), 128)


def test_mtf_inverse_matches_jax(rows):
    batch, ns = rows
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 40, batch.shape).astype(np.uint8)
    codes[:, ::3] = 0
    got = tmtf.mtf_inverse(torch.from_numpy(codes), torch.from_numpy(ns), 1024)
    f = jax.jit(jmtf.mtf_inverse, static_argnums=2)
    for i in range(len(ns)):
        want = f(jnp.asarray(codes[i]), jnp.int32(ns[i]), 128)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_code_lengths_and_tables_match_jax():
    freqs = synth.code_length_cases()["edges"]
    lens = thuf.code_lengths_device(torch.from_numpy(freqs))
    codes = thuf.canonical_codes_device(lens)
    count, sym = thuf.decode_tables_device(lens)
    for i in range(freqs.shape[0]):
        jl = jhuf.code_lengths_device(jnp.asarray(freqs[i], jnp.int32))
        np.testing.assert_array_equal(lens[i].numpy(), np.asarray(jl))
        jc = jhuf.canonical_codes_device(jl)
        np.testing.assert_array_equal(codes[i].numpy(), np.asarray(jc))
        jcount, jsym = jhuf.decode_tables_device(jl)
        np.testing.assert_array_equal(count[i].numpy(), np.asarray(jcount))
        np.testing.assert_array_equal(sym[i].numpy(), np.asarray(jsym))


def test_histogram_and_bitpack_match_jax():
    rng = np.random.default_rng(4)
    nsym = 1024
    syms = rng.integers(0, 257, (3, nsym)) * (rng.random((3, nsym)) < 0.5)
    syms[1] %= 4
    m = np.array([nsym, 700, 1], np.int64)
    st, mt = torch.from_numpy(syms), torch.from_numpy(m)
    freqs = thuf.histogram(st, mt, 257)
    lens = thuf.code_lengths_device(freqs)
    words, bits = thuf.encode_bitpack(st, mt, lens, thuf.canonical_codes_device(lens))
    for i in range(3):
        js = jnp.asarray(syms[i], jnp.int32)
        jf = jhuf.histogram(js, jnp.int32(m[i]), bins=257)
        np.testing.assert_array_equal(freqs[i].numpy(), np.asarray(jf))
        jl = jhuf.code_lengths_device(jf)
        jw, jb = jax.jit(jhuf.encode_bitpack)(js, jnp.int32(m[i]), jl,
                                              jhuf.canonical_codes_device(jl))
        assert int(bits[i]) == int(jb)
        np.testing.assert_array_equal(words[i].numpy(), np.asarray(jw).astype(np.int64))


def _jax_blocks(rng):
    """Compressed block dicts from bmh_tpu's backend, several per batch."""
    text = b"".join(rng.choice([b"alpha ", b"beta ", b"gamma\n", b"delta "], 1500))
    raw = [np.frombuffer(text[:3000], np.uint8),
           rng.integers(0, 256, 2500).astype(np.uint8),
           np.frombuffer(text[3000:7000], np.uint8),
           rng.integers(0, 9, 900).astype(np.uint8)]
    res = japi.get_backend("jax").compress_blocks(raw)
    for r in res:
        r["stride"] = jbwt.CURSOR_STRIDE
    return raw, res


def test_gap_decode_rle0_flat_matches_jax():
    raw, blocks = _jax_blocks(np.random.default_rng(6))
    idxs = list(range(len(blocks)))
    nmax = 4096
    chunk_bits = 512
    (words, lens_all, seg_start, seg_start_idx, seg_id, ms, ns, _shifts, nc,
     maxl, b_pad) = jpipe._stage_flat_np(blocks, idxs)
    count_b, sym_b = jax.vmap(jhuf.decode_tables_device)(jnp.asarray(lens_all))
    jcodes, jtot = jax.jit(jhuf.gap_decode_rle0_flat, static_argnums=(8, 9, 10))(
        jnp.asarray(words), count_b[jnp.asarray(seg_id)].T, jnp.asarray(seg_start),
        jnp.asarray(seg_start_idx), jnp.asarray(seg_id), sym_b, jnp.asarray(ms),
        jnp.asarray(ns), nmax, chunk_bits, maxl)

    (tw, tl, tss, tssi, tsid, tms, tns, _, tmaxl) = tpipe._stage_flat_np(
        blocks, idxs, chunk_bits, pad=False)
    tcount, tsym = thuf.decode_tables_device(torch.from_numpy(tl))
    count_t = tcount[torch.from_numpy(tsid)].T.to(torch.int32).contiguous()
    wext = thuf.words_ext(torch.from_numpy(tw.view(np.int32)), chunk_bits)
    codes, tot = thuf.gap_decode_rle0_flat(
        wext, count_t, torch.from_numpy(tss), torch.from_numpy(tssi),
        torch.from_numpy(tsid), tsym, torch.from_numpy(tms), torch.from_numpy(tns),
        nmax, chunk_bits, tmaxl)
    b = len(idxs)  # the port's rows: the blocks, then the pad chunks' row
    np.testing.assert_array_equal(codes[:b].numpy(), np.asarray(jcodes)[:b])
    np.testing.assert_array_equal(tot[:b].numpy(), np.asarray(jtot)[:b])
    np.testing.assert_array_equal(tot[:b].numpy(), [r.size for r in raw])


def test_rle0_decode_and_decoded_len_match_jax(rows):
    """The periodic and single-symbol routes' RLE0 inverse: codes and exact
    totals equal bmh_tpu's; a lying symbol count, and a run stream far
    longer than the block, give a total != n in both packages."""
    batch, ns = rows
    n = torch.from_numpy(ns)
    codes = tmtf.mtf_forward(torch.from_numpy(batch), n, 128)
    syms, m = trle.rle0_encode(codes, n)
    hostile = torch.ones((1, NMAX), dtype=torch.int64)  # 60 x RUNB
    syms = torch.cat([syms, hostile])
    m = torch.cat([m, torch.tensor([60])])
    n = torch.cat([n, torch.tensor([3000])])
    got = trle.rle0_decode(syms, m, n)
    tot = trle.rle0_decoded_len(syms, m)
    lying = trle.rle0_decoded_len(syms, m - 1)
    np.testing.assert_array_equal(got[:-1].numpy(), codes.numpy())
    np.testing.assert_array_equal(tot[:-1].numpy(), ns)
    fd, fl = jax.jit(jrle.rle0_decode), jax.jit(jrle.rle0_decoded_len)
    for i in range(n.numel()):
        js, jm, jn = jnp.asarray(syms[i].numpy(), jnp.int32), jnp.int32(m[i]), jnp.int32(n[i])
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(fd(js, jm, jn)))
        if i < len(ns):
            assert int(tot[i]) == int(fl(js, jm, jn))
            failing = (lying[i], fl(js, jm - 1, jn))
        else:
            failing = (tot[i], fl(js, jm, jn))
        assert all(int(x) != int(n[i]) for x in failing)


def test_gap_decode_flat_matches_jax():
    """The periodic route's gap decode to RLE0 symbols, and their RLE0
    inverse against the fused main-path decode."""
    _, blocks = _jax_blocks(np.random.default_rng(6))
    idxs = list(range(len(blocks)))
    nmax = 4096
    chunk_bits = 512
    (words, lens_all, seg_start, seg_start_idx, seg_id, ms, ns, _shifts, nc,
     maxl, b_pad) = jpipe._stage_flat_np(blocks, idxs)
    count_b, sym_b = jax.vmap(jhuf.decode_tables_device)(jnp.asarray(lens_all))
    want = jax.jit(jhuf.gap_decode_flat, static_argnums=(7, 8, 9))(
        jnp.asarray(words), count_b[jnp.asarray(seg_id)].T, jnp.asarray(seg_start),
        jnp.asarray(seg_start_idx), jnp.asarray(seg_id), sym_b, jnp.asarray(ms),
        nmax, chunk_bits, maxl)

    (tw, tl, tss, tssi, tsid, tms, tns, _, tmaxl) = (
        torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        for x in tpipe._stage_flat_np(blocks, idxs, chunk_bits, pad=False))
    wext, count_t, tsym = tpipe._tables(tw.view(torch.int32), tl, tsid, chunk_bits)
    got = thuf.gap_decode_flat(wext, count_t, tss, tssi, tsid, tsym, tms, nmax,
                               chunk_bits, tmaxl)
    b = len(idxs)
    np.testing.assert_array_equal(got[:b].numpy(), np.asarray(want)[:b])
    fused, _ = thuf.gap_decode_rle0_flat(wext, count_t, tss, tssi, tsid, tsym,
                                         tms, tns, nmax, chunk_bits, tmaxl)
    assert torch.equal(trle.rle0_decode(got, tms, tns), fused)


def test_bwt_inverse_matches_jax(rows):
    """The doubling inverse of the periodic and single-symbol routes, on
    aperiodic and periodic rows."""
    batch, ns = rows
    n = torch.from_numpy(ns)
    last, shift, _, aper = tbwt.bwt_forward_cp(torch.from_numpy(batch), n,
                                               jbwt.CURSOR_STRIDE)
    assert not bool(aper[3]) and not bool(aper[4])
    got = tbwt.bwt_inverse(last, shift, n)
    f = jax.jit(jbwt.bwt_inverse)
    for i in range(len(ns)):
        want = f(jnp.asarray(last[i].numpy()), jnp.int32(shift[i]), jnp.int32(ns[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        np.testing.assert_array_equal(got[i, : ns[i]].numpy(), batch[i, : ns[i]])


def test_container_pack_matches_jax():
    rng = np.random.default_rng(8)
    lens = rng.integers(0, 32, 257).astype(np.uint8)
    present = rng.random(257) < 0.4
    lens[~present] = 0
    for args in [dict(cps=np.arange(5, dtype=np.int32), rle_len=77, pre_len=100),
                 dict(cps=None, rle_len=3, pre_len=None), dict(cps=(), rle_len=9)]:
        a = jcont.pack_block(123, 45, lens, present, b"\x01\x02payload", **args)
        b = tcont.pack_block(123, 45, lens, present, b"\x01\x02payload", **args)
        assert a == b
        ja, tb = jcont.unpack_block(a), tcont.unpack_block(b)
        for x, y in zip(ja, tb):
            if x is None or isinstance(x, (int, bytes)):
                assert x == y
            else:
                np.testing.assert_array_equal(x, y)
    blocks = [b"abc", b"", b"defgh"]
    fa = jcont.pack_file(blocks, 4096, 99, stride=4096)
    assert fa == tcont.pack_file(blocks, 4096, 99, stride=4096)
    assert tcont.unpack_file(fa) == jcont.unpack_file(fa)
    with pytest.raises(ValueError, match="CRC"):
        tcont.unpack_file(fa[:-1] + b"\x00")
    with pytest.raises(ValueError, match="truncated code-length"):
        tcont.unpack_lens(b"\xff" * 40, 0)
