"""bmh_tpu_torch kernels K1-K4: each plain PyTorch version against its
Pallas function in interpret mode and against bmh_tpu's scan formulation
(K1, K2 and K3 also on inputs made to hurt their kernels' designs),
on the same numpy inputs; K4's composed walk against its one-row-a-step
walk, and its composed links against bmh_tpu's _compose_packed.  K6's
wrapper on the CPU: its plain version against bmh_tpu's code lengths on
synth.code_length_cases, and what it refuses.  The kernel sources the
build knows.  Integer outputs are compared exactly (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmh_tpu.models import oracle
from bmh_tpu.ops import bwt as jbwt
from bmh_tpu.ops import huffman as jhuf
from bmh_tpu.ops import pallas_decode as PD
from bmh_tpu.ops import pallas_ibwt as PI
from bmh_tpu.ops import pallas_mtf as PM
from bmh_tpu_torch.ops import _build
from bmh_tpu_torch.ops import bwt as tbwt
from bmh_tpu_torch.ops import decode_kernels as tdk
from bmh_tpu_torch.ops import huffman as thuf
from bmh_tpu_torch.ops import ibwt_kernel, imtf_kernel
from bmh_tpu_torch.utils import config as tconfig
from bmh_tpu_torch.utils import synth

CHUNK_BITS = 512


def _payload_words(rng, n_syms, alphabet, nc_align=8):
    """Huffman payload of random symbols (oracle encoder), padded to whole
    chunks: returns (words (W,) uint32, count table (32,), maxl)."""
    data = rng.integers(0, alphabet, n_syms).astype(np.uint8)
    lens = jhuf.code_lengths_from_hist(oracle.histogram(data))
    payload, _ = oracle.huffman_encode(data, lens, jhuf.canonical_code_table(lens))
    wbytes = CHUNK_BITS // 8
    nchunks = -(-max(1, -(-len(payload) // wbytes)) // nc_align) * nc_align
    buf = payload + b"\x00" * (nchunks * wbytes - len(payload))
    words = np.frombuffer(buf, dtype=">u4").astype(np.uint32)
    count = jhuf.decode_tables(lens)["count"]
    maxl = min(max(8, -(-int(lens.max()) // 8) * 8), 31)
    return words, count, maxl


def _true_entries(exit_map):
    nc = exit_map.shape[1]
    entry = np.zeros(nc, np.int32)
    g = 0
    for c in range(nc):
        entry[c] = g
        g = exit_map[g, c]
    return entry


@pytest.mark.parametrize("alphabet,n_syms", [(64, 4000), (200, 3000), (3, 5000)])
def test_phase_a_b_plain_match_pallas_and_scan(alphabet, n_syms):
    rng = np.random.default_rng(alphabet)
    words, count, maxl = _payload_words(rng, n_syms, alphabet)
    nc = words.size * 32 // CHUNK_BITS
    count_t = np.broadcast_to(count[:, None], (32, nc)).astype(np.int32).copy()
    wext_j = PD.words_ext(jnp.asarray(words), CHUNK_BITS)
    tiles = jhuf.unpack_bit_tiles_flat(jnp.asarray(words), CHUNK_BITS)

    wext_t = torch.from_numpy(np.asarray(wext_j).view(np.int32).copy())
    assert torch.equal(wext_t, thuf.words_ext(torch.from_numpy(words.view(np.int32)),
                                              CHUNK_BITS))
    ct = torch.from_numpy(count_t)
    cnt_t, ex_t = tdk.phase_a_plain(wext_t, ct, CHUNK_BITS, maxl)
    cnt_p, ex_p = PD.phase_a(wext_j, jnp.asarray(count_t), chunk_bits=CHUNK_BITS,
                             maxl=maxl, interpret=True)
    cnt_s, ex_s = PD.phase_a_scan(tiles, jnp.asarray(count_t),
                                  chunk_bits=CHUNK_BITS, maxl=maxl)
    for ref in ((cnt_p, ex_p), (cnt_s, ex_s)):
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(ex_t.numpy(), np.asarray(ref[1]))

    entry = _true_entries(np.asarray(ex_s))
    idx_t = tdk.phase_b_plain(wext_t, ct, torch.from_numpy(entry), CHUNK_BITS, maxl)
    idx_p = PD.phase_b(wext_j, jnp.asarray(count_t), jnp.asarray(entry),
                       chunk_bits=CHUNK_BITS, maxl=maxl, interpret=True)
    idx_s = PD.phase_b_scan(tiles, jnp.asarray(count_t), jnp.asarray(entry),
                            chunk_bits=CHUNK_BITS, maxl=maxl)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_p))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_s))


@pytest.mark.parametrize("m,alphabet", [(64, 256), (96, 5)])
def test_imtf_plain_matches_pallas(m, alphabet):
    rng = np.random.default_rng(m)
    codes = rng.integers(0, alphabet, (m, PM.TILE)).astype(np.int32)
    codes[:, :8] = 0  # lanes of all-zero codes (runs)
    ys_p, q_p = PM.imtf_chunks(jnp.asarray(codes), interpret=True)
    ys_t, q_t = imtf_kernel.imtf_chunks_plain(torch.from_numpy(codes))
    np.testing.assert_array_equal(ys_t.numpy(), np.asarray(ys_p))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_p))


@pytest.mark.parametrize("case", range(4), ids=["no_merge", "overflow_maxl8",
                                               "chunk_bits_32", "chunk_bits_64"])
def test_phase_a_plain_matches_pallas_on_hostile_tables(case):
    """The inputs made to hurt K1's merge of a chunk's decodes (no two
    decodes meet; overflow resets at maxl = 8; the shortest chunks)."""
    name, wext, count_t, chunk_bits, maxl = synth.phase_a_hostile_cases(5, 24)[case]
    cnt_t, ex_t = tdk.phase_a(torch.from_numpy(wext), torch.from_numpy(count_t),
                              chunk_bits, maxl)  # CPU: plain
    cnt_p, ex_p = PD.phase_a(jnp.asarray(wext.view(np.uint32)), jnp.asarray(count_t),
                             chunk_bits=chunk_bits, maxl=maxl, interpret=True)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_p))
    np.testing.assert_array_equal(ex_t.numpy(), np.asarray(ex_p))
    if name == "no_merge":  # nothing completes, nothing exits
        assert int(cnt_t.max()) == 0 and int(ex_t.max()) == 0
    if name == "overflow_maxl8":  # the counts above maxl were ignored
        wide, _ = tdk.phase_a_plain(torch.from_numpy(wext), torch.from_numpy(count_t),
                                    chunk_bits, 16)
        assert not torch.equal(wide, cnt_t)


PHASE_B_CASES = ["oversubscribed_clip", "all_zero", "maxl8_ignores_longer",
                 "long_codes", "random_tables", "chunk_bits_32", "chunk_bits_64",
                 "chunk_bits_544"]


@pytest.mark.parametrize("case", range(len(PHASE_B_CASES)), ids=PHASE_B_CASES)
def test_phase_b_plain_matches_pallas_on_hostile_cases(case):
    """The inputs made to hurt K2's codeword-a-turn decode and its output
    windows, against bmh_tpu's Pallas kernel (interpret mode) and its scan,
    exactly.  13 chunks: the Pallas side alone is padded to 16 (its chunk
    axis is cut in rows of 8), with zero words, tables and entries."""
    name, wext, count_t, entry, chunk_bits, maxl = synth.phase_b_hostile_cases(7, 13)[case]
    assert name == PHASE_B_CASES[case]
    got = tdk.phase_b(torch.from_numpy(wext), torch.from_numpy(count_t),
                      torch.from_numpy(entry), chunk_bits, maxl).numpy()  # CPU: plain
    nc = wext.shape[1]
    pad = ((0, 0), (0, 16 - nc))
    wext_p, count_p = np.pad(wext, pad), np.pad(count_t, pad)
    entry_p = np.pad(entry, (0, 16 - nc))
    idx_p = PD.phase_b(jnp.asarray(wext_p.view(np.uint32)), jnp.asarray(count_p),
                       jnp.asarray(entry_p), chunk_bits=chunk_bits, maxl=maxl,
                       interpret=True)
    words = np.ascontiguousarray(wext_p[:-1].T).reshape(-1).view(np.uint32)
    tiles = jhuf.unpack_bit_tiles_flat(jnp.asarray(words), chunk_bits)
    idx_s = PD.phase_b_scan(tiles, jnp.asarray(count_p), jnp.asarray(entry_p),
                            chunk_bits=chunk_bits, maxl=maxl)
    assert got.shape == (chunk_bits + 32, nc)
    np.testing.assert_array_equal(got, np.asarray(idx_p)[:, :nc])
    np.testing.assert_array_equal(got, np.asarray(idx_s)[:, :nc])
    assert (got[:entry[0], 0] == -1).all()  # nothing before the entry gap
    if name == "oversubscribed_clip":
        assert (got == 256).any() and (got > 200).sum() > (got == 256).sum()
    if name == "all_zero":  # only overflow resets: nothing completes
        assert (got == -1).all()
    if name == "maxl8_ignores_longer":
        wide = tdk.phase_b_plain(torch.from_numpy(wext), torch.from_numpy(count_t),
                                 torch.from_numpy(entry), chunk_bits, 16).numpy()
        assert not np.array_equal(wide, got)
    if name == "long_codes":  # codewords of 20 bits and more completed
        assert got.max() >= 20


@pytest.mark.parametrize("case", range(3), ids=["zeros", "all_255", "random"])
def test_imtf_plain_matches_pallas_on_hostile_codes(case):
    """The codes made to hurt K3's batches, at a lane count no multiple of
    a block's lanes and a length no multiple of a batch; the Pallas side
    alone is padded to its tile."""
    m, k = 70, 13
    _, codes = synth.imtf_hostile_cases(6, m, k)[case]
    padded = np.zeros((m, PM.TILE), np.int32)
    padded[:, :k] = codes
    ys_p, q_p = PM.imtf_chunks(jnp.asarray(padded), interpret=True)
    ys_t, q_t = imtf_kernel.imtf_chunks(torch.from_numpy(codes))  # CPU: plain
    np.testing.assert_array_equal(ys_t.numpy(), np.asarray(ys_p)[:, :k])
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_p)[:, :k])


@pytest.mark.parametrize("chunk_bits,rows,maxl", [
    (0, 1, 8), (-32, 0, 8), (48, 2, 8), (64, 2, 8), (64, 4, 8),
    (64, 3, 0), (64, 3, 32),
], ids=["zero_bits", "negative_bits", "bits_not_32n", "rows_short", "rows_long",
        "maxl_0", "maxl_32"])
def test_gap_decode_wrappers_reject_bad_chunks_on_cpu(chunk_bits, rows, maxl):
    """chunk_bits and maxl index the kernels' shared memory and wext's rows:
    the wrappers refuse what does not fit before either route runs."""
    wext = torch.zeros((rows, 4), dtype=torch.int32)
    count_t = torch.zeros((32, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="chunk_bits|maxl"):
        tdk.phase_a(wext, count_t, chunk_bits, maxl)
    with pytest.raises(ValueError, match="chunk_bits|maxl"):
        tdk.phase_b(wext, count_t, torch.zeros(4, dtype=torch.int32), chunk_bits, maxl)


def _lf_tables(rng, nmax, b):
    lfs, starts, ns, lasts, shifts, cpss = [], [], [], [], [], []
    for i in range(b):
        data = rng.integers(0, 5, nmax - 7 * i - 3).astype(np.uint8)
        pad = np.zeros(nmax, np.uint8)
        pad[: data.size] = data
        last, shift, cps, aper = jax.jit(jbwt.bwt_forward_cp)(
            jnp.asarray(pad), jnp.int32(data.size))
        assert bool(aper)
        lfs.append(jbwt._lf_map_packed(last, jnp.int32(data.size)))
        k = max(nmax // jbwt.CURSOR_STRIDE, 1)
        st = jnp.concatenate([shift[None].astype(jnp.int32), cps[: k - 1]])
        starts.append(jnp.clip(st, 0, nmax - 1))
        ns.append(data.size)
        lasts.append(np.asarray(last))
        shifts.append(int(shift))
        cpss.append(np.asarray(cps))
    return lfs, starts, ns, lasts, shifts, cpss


def test_ibwt_plain_matches_pallas(rng):
    nmax, b = 1024, 8
    lfs, starts, ns, _, _, _ = _lf_tables(rng, nmax, b)
    k = max(nmax // jbwt.CURSOR_STRIDE, 1)
    want = np.asarray(PI.ibwt_walk(jnp.stack(lfs), jnp.stack(starts),
                                   steps=nmax // k, interpret=True))
    table = torch.from_numpy(np.asarray(jnp.stack(lfs)).view(np.int32).copy())
    got = ibwt_kernel.ibwt_walk_plain(
        table, torch.from_numpy(np.array(jnp.stack(starts))), nmax // k)
    # real cursors never reach pad rows: every emitted value is a byte
    assert want.max() < 256
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))


def _bwt_rows(rng, nmax, b):
    """Aperiodic blocks a little shorter than nmax (so pad rows exist) and
    their BWT by the port's forward: (data, last, shift, cps, n) tensors."""
    data = torch.zeros((b, nmax), dtype=torch.uint8)
    ns = []
    for i in range(b):
        n = nmax - 7 * i - 3
        data[i, :n] = torch.from_numpy(rng.integers(0, 5, n).astype(np.uint8))
        ns.append(n)
    n = torch.tensor(ns)
    last, shift, cps, aper = tbwt.bwt_forward_cp(data, n, jbwt.CURSOR_STRIDE)
    assert bool(aper.all())
    return data, last, shift, cps, n


@pytest.mark.parametrize("lf2", [True, False], ids=["lf2", "lf1"])
@pytest.mark.parametrize("log_nmax,b", [(14, 3), (16, 2), (17, 1)])
def test_ibwt_cursors_match_jax(monkeypatch, log_nmax, b, lf2):
    """bwt_inverse_cursors against bmh_tpu's, un-jitted so that it reads the
    knob this test sets: with lf2 on the port walks 16-step row links,
    bmh_tpu LF² at 2^14 and 2^16 and its LF¹ scan at 2^17."""
    nmax = 1 << log_nmax
    monkeypatch.setattr(tconfig.DEFAULT, "lf2", lf2)
    monkeypatch.setattr(jbwt._config_mod.DEFAULT, "lf2", lf2)
    steps = min(nmax, jbwt.CURSOR_STRIDE)
    assert tbwt._walk_hop(steps) == (ibwt_kernel.HOP if lf2 else 1)
    data, last, shift, cps, n = _bwt_rows(np.random.default_rng(log_nmax), nmax, b)
    got = tbwt.bwt_inverse_cursors(last, shift, cps, n, jbwt.CURSOR_STRIDE)
    assert torch.equal(got, data)
    for i in range(b):
        want = np.asarray(jbwt.bwt_inverse_cursors(
            jnp.asarray(last[i].numpy()), jnp.int32(int(shift[i])),
            jnp.asarray(cps[i].numpy().astype(np.int32)), jnp.int32(int(n[i]))))
        np.testing.assert_array_equal(got[i].numpy(), want)


def _random_table(rng, b, nmax, n):
    """(B, Nmax) packed LF tables in int32 storage: a random permutation of
    n real rows with random bytes, then pad rows (byte field 256, linking
    to themselves)."""
    tabs = []
    for _ in range(b):
        real = (rng.integers(0, 256, n) << 23) | rng.permutation(n)
        tabs.append(np.concatenate([real, (256 << 23) | np.arange(n, nmax)]))
    return torch.from_numpy(np.stack(tabs).astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("nmax,n,k,steps", [
    (1024, 1000, 1, 1024),       # one cursor, pad rows
    (4096, 4096, 4, 1024),       # no pad row
    (1 << 16, (1 << 16) - 9, 16, 64),
    (1 << 17, (1 << 17) - 50, 32, 64),
    (512, 300, 3, 16),           # a single composed step
    (256, 200, 2, 48),
])
def test_ibwt_plain_composed_equals_hop1(nmax, n, k, steps):
    """The composed walk emits the bytes of the one-row-a-step walk, also
    from a start clamped onto a pad row."""
    rng = np.random.default_rng(nmax)
    table = _random_table(rng, 2, nmax, n)
    starts = torch.from_numpy(rng.integers(0, n, (2, k)).astype(np.int32))
    starts[0, 0] = nmax - 1  # a pad row unless n == nmax
    want = ibwt_kernel.ibwt_walk_plain(table, starts, steps, 1)
    if n < nmax:
        assert int(want[0, 0].max()) == 0  # the pad row emits zeros forever
    got = ibwt_kernel.ibwt_walk(table, starts, steps, ibwt_kernel.HOP)  # CPU: plain
    assert got.dtype == torch.uint8 and torch.equal(got, want)


@pytest.mark.parametrize("steps,hop", [(6, 16), (24, 16), (1, 16), (64, 2),
                                       (64, 4), (64, 32), (64, 0)])
def test_ibwt_walk_refuses_other_hops(steps, hop):
    """Only hop 1 and the composed hop exist, and the hop must divide steps."""
    table = _random_table(np.random.default_rng(steps), 1, 256, 200)
    starts = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="divide steps"):
        ibwt_kernel.ibwt_walk(table, starts, steps, hop)
    with pytest.raises(ValueError, match="divide steps"):
        ibwt_kernel.ibwt_walk_plain(table, starts, steps, hop)


@pytest.mark.parametrize("steps,lf2,want", [
    (4096, True, 16), (1024, True, 16), (64, True, 16), (16, True, 16),
    (4096, False, 1), (1024, False, 1),
    (6, True, 1), (24, True, 1), (7, True, 1),
])
def test_walk_hop_follows_knob_and_steps(monkeypatch, steps, lf2, want):
    monkeypatch.setattr(tconfig.DEFAULT, "lf2", lf2)
    assert tbwt._walk_hop(steps) == want


@pytest.mark.parametrize("nmax", [1024, 1 << 14, 1 << 16])
def test_compose_plain_matches_jax_compose(nmax):
    """The composed row links against bmh_tpu's _compose_packed (two sorts
    there, gathers here) applied as often: its low bits are the row two
    steps on, so four applications give the row 16 steps on."""
    _, last, _, _, n = _bwt_rows(np.random.default_rng(nmax), nmax, 2)
    packed = tbwt._lf_map_packed(last, n)
    table = (packed - ((packed >> 31) << 32)).to(torch.int32)
    got = ibwt_kernel.compose_plain(table)
    for i in range(2):
        jp = jbwt._lf_map_packed(jnp.asarray(last[i].numpy()), jnp.int32(int(n[i])))
        np.testing.assert_array_equal(packed[i].numpy(), np.asarray(jp).astype(np.int64))
        links = jp
        for _ in range(4):
            links = jbwt._compose_packed(links)
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(links & jnp.uint32((1 << 23) - 1)).astype(np.int64))


KERNEL_SOURCES = {"gap_decode_phase_a": "gap_decode.cu", "gap_decode_phase_b": "gap_decode.cu",
                  "imtf_chunks": "imtf.cu", "ibwt_walk": "ibwt_walk.cu",
                  "sort3": "sort3.cu", "code_lengths": "code_lengths.cu",
                  "mtf_forward": "mtf_forward.cu"}


@pytest.mark.parametrize("name", sorted(KERNEL_SOURCES))
def test_kernel_sources_exist(name):
    """Each kernel's launch count and source under csrc/, which the card
    builds (K6: code_lengths.cu, K7: mtf_forward.cu)."""
    assert set(_build.SOURCES) == set(KERNEL_SOURCES) == set(_build.LAUNCHES)
    assert _build.SOURCES[name] == KERNEL_SOURCES[name]
    assert (_build.CSRC / KERNEL_SOURCES[name]).is_file()


@pytest.mark.parametrize("case", ["edges", "one", "two", "all_257", "fibonacci",
                                  "random", "empty"])
def test_code_lengths_plain_on_cpu_matches_bmh_tpu(case):
    """A CPU tensor takes the plain version (no launch counted), which
    equals bmh_tpu's code lengths row by row: ties, all-equal rows, rows
    of 0 and 1 present symbols (all lengths 0), the 25-bit code."""
    freqs = synth.code_length_cases()[case]
    before = _build.LAUNCHES["code_lengths"]
    got = thuf.code_lengths_device(torch.from_numpy(freqs))
    assert _build.LAUNCHES["code_lengths"] == before
    assert torch.equal(got, thuf.code_lengths_plain(torch.from_numpy(freqs)))
    want = jax.jit(jax.vmap(jhuf.code_lengths_device))(jnp.asarray(freqs, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "empty":
        assert not got.any()
    if case == "fibonacci":
        assert int(got.max()) == 25


@pytest.mark.parametrize("bad", ["alphabet_256", "one_dim", "not_contiguous", "int32"])
def test_code_lengths_wrapper_rejects_bad_inputs_on_cpu(bad):
    """The kernel reads each row's 257 int64 counts side by side: the
    wrapper refuses anything else before either route runs."""
    f = {"alphabet_256": torch.ones((4, 256), dtype=torch.int64),
         "one_dim": torch.ones(257, dtype=torch.int64),
         "not_contiguous": torch.ones((257, 4), dtype=torch.int64).T,
         "int32": torch.ones((4, 257), dtype=torch.int32)}[bad]
    with pytest.raises(ValueError, match="int64 .B, 257. histograms with contiguous rows"):
        thuf.code_lengths_device(f)
