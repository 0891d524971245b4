"""bmh_tpu_torch on a CUDA card: each kernel (K1-K7) against its plain
PyTorch version, and the codec round trip against its CPU run.

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(--noconftest: tests/conftest.py imports jax, which the machine with the
card does not need.)  Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

import bmh_tpu_torch as bt
from bmh_tpu_torch.ops import _build
from bmh_tpu_torch.ops import decode_kernels as dk
from bmh_tpu_torch.ops import huffman as thuf
from bmh_tpu_torch.ops import ibwt_kernel, imtf_kernel, sort_kernel
from bmh_tpu_torch.ops import mtf as tmtf
from bmh_tpu_torch.utils import config, synth

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _text(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta\n", b"epsilon "]
    return b"".join(words[i] for i in rng.integers(0, 5, n // 4))[:n]


def test_roundtrip_matches_cpu(cuda):
    rng = np.random.default_rng(1)
    data = _text(300000) + bytes(rng.integers(0, 256, 50000, dtype=np.uint8))
    _build.reset_launches()
    blob = bt.compress_bytes(data, block_size=65536, device=cuda)
    assert blob == bt.compress_bytes(data, block_size=65536, device="cpu")
    assert bt.decompress_bytes(blob, device=cuda) == data
    assert bt.decompress_bytes(blob) == data  # the default device is the card
    # with BMH_PALLAS_SORT off (the default) K5 stays idle
    assert _build.LAUNCHES["sort3"] == 0
    assert all(v > 0 for k, v in _build.LAUNCHES.items() if k != "sort3")


def test_gap_decode_kernels_match_plain(cuda):
    blob = bt.compress_bytes(_text(200000, 2), block_size=65536, device=cuda)
    infos = [dict(i) for i in bt.api._parse(blob)[0]]
    from bmh_tpu_torch.models import pipeline

    (words, lens_all, seg_start, _, seg_id, _, _, _, maxl) = \
        pipeline._stage_flat_np(infos, list(range(len(infos))), 512)
    count, _ = thuf.decode_tables_device(torch.from_numpy(lens_all).to(cuda))
    count_t = count[torch.from_numpy(seg_id).to(cuda)].T.to(torch.int32).contiguous()
    wext = thuf.words_ext(torch.from_numpy(words.view(np.int32)).to(cuda), 512)
    cnt, ex = dk.phase_a(wext, count_t, 512, maxl)
    cnt_p, ex_p = dk.phase_a_plain(wext, count_t, 512, maxl)
    assert torch.equal(cnt, cnt_p) and torch.equal(ex, ex_p)
    entry = torch.randint(0, 32, (wext.shape[1],), device=cuda, dtype=torch.int32)
    assert torch.equal(dk.phase_b(wext, count_t, entry, 512, maxl),
                       dk.phase_b_plain(wext, count_t, entry, 512, maxl))


def test_imtf_kernel_matches_plain(cuda):
    g = torch.Generator(device="cpu").manual_seed(3)
    codes = torch.randint(0, 256, (512, 1000), generator=g, dtype=torch.int32)
    codes[:, ::2] %= 4
    ys, q = imtf_kernel.imtf_chunks(codes.to(cuda))
    ys_p, q_p = imtf_kernel.imtf_chunks_plain(codes.to(cuda))
    assert torch.equal(ys, ys_p) and torch.equal(q, q_p)


@pytest.mark.parametrize("case", range(4), ids=["no_merge", "overflow_maxl8",
                                               "chunk_bits_32", "chunk_bits_64"])
def test_phase_a_kernel_matches_plain_on_hostile_tables(cuda, case):
    """K1 where its merge of a chunk's decodes finds nothing to merge, where
    overflow resets make the boundaries, and at the shortest chunks; the
    chunk count is no multiple of a block's."""
    _, wext, count_t, chunk_bits, maxl = synth.phase_a_hostile_cases(5, 1003)[case]
    wext, count_t = torch.from_numpy(wext).to(cuda), torch.from_numpy(count_t).to(cuda)
    _build.reset_launches()
    cnt, ex = dk.phase_a(wext, count_t, chunk_bits, maxl)
    assert _build.LAUNCHES["gap_decode_phase_a"] == 1
    cnt_p, ex_p = dk.phase_a_plain(wext, count_t, chunk_bits, maxl)
    assert torch.equal(cnt, cnt_p) and torch.equal(ex, ex_p)


@pytest.mark.parametrize("chunk_bits", [2016, 2048, 4096])
def test_phase_a_kernel_long_chunks(cuda, chunk_bits):
    """Both widths of K1's memo entry (16 bits up to 2016-bit chunks, 32
    above) and blocks of fewer chunks than a warp."""
    g = torch.Generator(device="cpu").manual_seed(chunk_bits)
    nc = 77
    wext = torch.randint(-2**31, 2**31, (chunk_bits // 32 + 1, nc), generator=g,
                         dtype=torch.int64).to(torch.int32).to(cuda)
    counts = torch.zeros(32, dtype=torch.int32)
    counts[[1, 3, 4, 7]] = torch.tensor([1, 1, 2, 9], dtype=torch.int32)
    count_t = counts[:, None].repeat(1, nc).to(cuda)
    cnt, ex = dk.phase_a(wext, count_t, chunk_bits, 8)
    cnt_p, ex_p = dk.phase_a_plain(wext, count_t, chunk_bits, 8)
    assert torch.equal(cnt, cnt_p) and torch.equal(ex, ex_p)


PHASE_B_CASES = ["oversubscribed_clip", "all_zero", "maxl8_ignores_longer",
                 "long_codes", "random_tables", "chunk_bits_32", "chunk_bits_64",
                 "chunk_bits_544"]


@pytest.mark.parametrize("case", range(len(PHASE_B_CASES)), ids=PHASE_B_CASES)
def test_phase_b_kernel_matches_plain_on_hostile_inputs(cuda, case):
    """K2 where the clip fires, where only overflow resets happen, where
    counts above maxl must be ignored, on codes of up to 31 bits, under a
    table per chunk, at the shortest chunks and at one whose steps are no
    multiple of the output window; 1003 chunks, no multiple of a block's."""
    name, *args = synth.phase_b_hostile_cases(5, 1003)[case]
    assert name == PHASE_B_CASES[case]
    wext, count_t, entry = (torch.from_numpy(a).to(cuda) for a in args[:3])
    _build.reset_launches()
    got = dk.phase_b(wext, count_t, entry, *args[3:])
    assert _build.LAUNCHES["gap_decode_phase_b"] == 1
    assert torch.equal(got, dk.phase_b_plain(wext, count_t, entry, *args[3:]))


@pytest.mark.parametrize("chunk_bits", [32800, 65536])
def test_gap_decode_kernels_past_32768_bits(cuda, chunk_bits):
    """K1 and K2 at chunk sizes the config accepts beyond what K1's memo
    once held in shared memory: 32800 bits (one chunk a block in shared
    memory) and 65536 (the global scratch)."""
    g = torch.Generator(device="cpu").manual_seed(chunk_bits)
    nc = 5
    wext = torch.randint(-2**31, 2**31, (chunk_bits // 32 + 1, nc), generator=g,
                         dtype=torch.int64).to(torch.int32).to(cuda)
    counts = torch.zeros(32, dtype=torch.int32)
    counts[[2, 3, 4, 6, 9]] = torch.tensor([1, 2, 3, 10, 20], dtype=torch.int32)
    count_t = counts[:, None].repeat(1, nc).to(cuda)
    cnt, ex = dk.phase_a(wext, count_t, chunk_bits, 16)
    cnt_p, ex_p = dk.phase_a_plain(wext, count_t, chunk_bits, 16)
    assert torch.equal(cnt, cnt_p) and torch.equal(ex, ex_p)
    entry = torch.randint(0, 32, (nc,), generator=g, dtype=torch.int32).to(cuda)
    assert torch.equal(dk.phase_b(wext, count_t, entry, chunk_bits, 16),
                       dk.phase_b_plain(wext, count_t, entry, chunk_bits, 16))


def test_roundtrip_decode_chunk_bits_65536(cuda, monkeypatch):
    """decode_chunk_bits is the decoder's knob: a container decodes on the
    card at 65536-bit chunks through both kernels."""
    data = _text(300000, 8)
    blob = bt.compress_bytes(data, device=cuda)
    monkeypatch.setattr(config.DEFAULT, "decode_chunk_bits", 65536)
    _build.reset_launches()
    assert bt.decompress_bytes(blob, device=cuda) == data
    assert _build.LAUNCHES["gap_decode_phase_a"] > 0
    assert _build.LAUNCHES["gap_decode_phase_b"] > 0


@pytest.mark.parametrize("case", range(3), ids=["zeros", "all_255", "random"])
def test_imtf_kernel_matches_plain_on_hostile_codes(cuda, case):
    """K3 on batches with no step, with every step moving the whole list and
    with every step at every distance; the lane count is no multiple of a
    block's lanes, the length no multiple of a batch."""
    _, codes = synth.imtf_hostile_cases(6, 300, 1003)[case]
    codes = torch.from_numpy(codes).to(cuda)
    ys, q = imtf_kernel.imtf_chunks(codes)
    ys_p, q_p = imtf_kernel.imtf_chunks_plain(codes)
    assert torch.equal(ys, ys_p) and torch.equal(q, q_p)


def _walk_table(g, b, nmax, n, cuda):
    """Random packed LF tables: n real rows (a permutation, random bytes),
    then pad rows with byte field 256 that link to themselves."""
    rows = torch.stack([torch.cat([torch.randperm(n, generator=g),
                                   torch.arange(n, nmax)]) for _ in range(b)])
    byte = torch.randint(0, 256, (b, nmax), generator=g)
    byte[:, n:] = 256
    packed = (byte << 23) | rows
    return (packed - ((packed >> 31) << 32)).to(torch.int32).to(cuda)


@pytest.mark.parametrize("hop", [1, ibwt_kernel.HOP])
@pytest.mark.parametrize("b,nmax,n,k", [(5, 8192, 8000, 2), (3, 1 << 16, 1 << 16, 16),
                                        (4, 1 << 17, (1 << 17) - 9, 32),
                                        (40, 1 << 16, (1 << 16) - 1, 64)])
def test_ibwt_kernel_matches_plain(cuda, hop, b, nmax, n, k):
    """K4 in both modes (one row a step; 16-step row links) against the
    plain one-row-a-step walk, with one start clamped onto a pad row; the
    last case has more cursors than one to a block."""
    g = torch.Generator(device="cpu").manual_seed(4 + nmax)
    table = _walk_table(g, b, nmax, n, cuda)
    starts = torch.randint(0, n, (b, k), generator=g, dtype=torch.int32)
    starts[0, -1] = nmax - 1  # what a hostile container's clamped start gives
    starts = starts.to(cuda)
    steps = nmax // k
    want = ibwt_kernel.ibwt_walk_plain(table, starts, steps, 1)
    _build.reset_launches()
    assert torch.equal(ibwt_kernel.ibwt_walk(table, starts, steps, hop), want)
    assert _build.LAUNCHES["ibwt_walk"] == 1
    assert torch.equal(ibwt_kernel.ibwt_walk_plain(table, starts, steps, hop), want)


@pytest.mark.parametrize("lf2", [True, False], ids=["lf2", "lf1"])
@pytest.mark.parametrize("bs", [1 << 16, 1 << 17])
def test_roundtrip_both_walks(cuda, monkeypatch, bs, lf2):
    """BMH_LF2 on and off, at 64 and 128 KiB blocks: same container as the
    CPU run, bit-exact round trip."""
    monkeypatch.setattr(config.DEFAULT, "lf2", lf2)
    data = _text(3 * bs + 1000, 7)
    blob = bt.compress_bytes(data, block_size=bs, device=cuda)
    assert blob == bt.compress_bytes(data, block_size=bs, device="cpu")
    _build.reset_launches()
    assert bt.decompress_bytes(blob, device=cuda) == data
    assert _build.LAUNCHES["ibwt_walk"] > 0


@pytest.mark.parametrize("b,n", [(3, 1024), (2, 2048), (7, 4096), (5, 1 << 15),
                                 (32, 1 << 17), (1, 1 << 16), (1, 1 << 18)])
def test_sort3_kernel_matches_plain(cuda, b, n):
    """K5 at its envelope's floor, on rows sorted as one tile, at B no
    power of two, the 32-block doubling-round shape and the sparse sets'
    one-row shapes; many ties, keys at both int32 extremes (-2^31, the
    biased init ranks; INT32_BIG, the pads)."""
    g = torch.Generator(device="cpu").manual_seed(n)
    k1 = torch.randint(0, max(4, n // 64), (b, n), generator=g, dtype=torch.int32)
    k2 = torch.randint(0, 8, (b, n), generator=g, dtype=torch.int32)
    k1[:, ::7] = -(2**31)
    k1[:, 2::9] = 2**31 - 1
    k2[:, 3::11] = 2**31 - 1
    k2[:, 1::13] = -(2**31)
    idx = torch.stack([torch.randperm(n, generator=g) for _ in range(b)]).to(torch.int32)
    args = [x.to(cuda) for x in (k1, k2, idx)]
    got, want = sort_kernel.sort3(*args), sort_kernel.sort3_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    key = (got[0].long() << 32) + (got[1].long() + 2**31)
    assert bool((key[:, 1:] >= key[:, :-1]).all())


def test_roundtrip_with_sort_kernel(cuda, monkeypatch):
    """BMH_PALLAS_SORT on: every BWT sort inside K5's envelope launches it,
    and the container equals the CPU run's."""
    monkeypatch.setattr(config.DEFAULT, "pallas_sort", True)
    data = _text(200000, 5)
    _build.reset_launches()
    blob = bt.compress_bytes(data, block_size=65536, device=cuda)
    assert _build.LAUNCHES["sort3"] > 0
    assert blob == bt.compress_bytes(data, block_size=65536, device="cpu")
    assert bt.decompress_bytes(blob, device=cuda) == data


def test_periodic_and_single_symbol_roundtrip(cuda):
    rng = np.random.default_rng(6)
    motif = bytes(rng.integers(0, 256, 1024, dtype=np.uint8))
    for data, bs in ((motif * 96, 1 << 17), (b"abcdef" * 4000, 6000),
                     (b"\x00" * 3, 2048)):
        blob = bt.compress_bytes(data, block_size=bs, device=cuda)
        assert blob == bt.compress_bytes(data, block_size=bs, device="cpu")
        assert bt.decompress_bytes(blob, device=cuda) == data


def test_wrappers_reject_bad_inputs(cuda):
    with pytest.raises(ValueError):
        imtf_kernel.imtf_chunks(torch.zeros((4, 4), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        ibwt_kernel.ibwt_walk(torch.zeros((2, 8), dtype=torch.int32, device=cuda),
                              torch.zeros((3, 1), dtype=torch.int32, device=cuda), 8)
    tab = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    st = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    for hop in (2, 16):  # an unknown hop; one that does not divide steps
        with pytest.raises(ValueError):
            ibwt_kernel.ibwt_walk(tab, st, 8, hop)
    with pytest.raises(ValueError):
        ibwt_kernel.ibwt_walk(tab.long(), st, 8)
    wext = torch.zeros((3, 4), dtype=torch.int32, device=cuda)
    count_t = torch.zeros((32, 4), dtype=torch.int32, device=cuda)
    entry = torch.zeros(4, dtype=torch.int32, device=cuda)
    for chunk_bits, maxl in ((0, 8), (48, 8), (32, 8), (128, 8), (64, 0), (64, 32)):
        with pytest.raises(ValueError):
            dk.phase_a(wext, count_t, chunk_bits, maxl)
        with pytest.raises(ValueError):
            dk.phase_b(wext, count_t, entry, chunk_bits, maxl)
    bad = torch.zeros((1, 4096), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        sort_kernel.sort3(bad, bad, bad[:, ::2].contiguous())
    with pytest.raises(ValueError):
        sort_kernel.sort3(*(torch.zeros((2, 2048), dtype=torch.int32, device=cuda)[:, ::2]
                            for _ in range(3)))
    with pytest.raises(ValueError, match="aligned"):  # 4 bytes off a 16-byte line
        sort_kernel.sort3(*(torch.zeros(1025, dtype=torch.int32, device=cuda)[1:][None]
                            for _ in range(3)))
    for bad in (torch.ones((4, 256), dtype=torch.int64, device=cuda),
                torch.ones((257, 4), dtype=torch.int64, device=cuda).T,
                torch.ones((4, 257), dtype=torch.int32, device=cuda)):
        with pytest.raises(ValueError):
            thuf.code_lengths_device(bad)
    data = torch.zeros((2, 4096), dtype=torch.uint8, device=cuda)
    n = torch.full((2,), 4096, dtype=torch.int64, device=cuda)
    for bad_data, bad_n in ((data.to(torch.int32), n),        # dtype
                            (data[0], n[:1]),                 # one dimension
                            (data[:, ::2], n),                # not contiguous
                            (data, n[:1]),                    # n's shape
                            (data, n.float()),                # n's dtype
                            (data, n.repeat(2)[::2]),         # n not contiguous
                            (data, n.cpu())):                 # n off the card
        with pytest.raises(ValueError, match="mtf_forward"):
            tmtf.mtf_forward(bad_data, bad_n, 128)


CODE_LENGTH_CASES = ["edges", "one", "two", "all_257", "fibonacci", "random", "empty",
                     "b1", "b8", "b32"]


@pytest.mark.parametrize("case", CODE_LENGTH_CASES)
def test_code_lengths_kernel_matches_plain(cuda, case):
    """K6 against its plain version, bit for bit, in one launch: the CPU
    tests' sets (ties, all-equal rows, 0 and 1 present symbols, the 25-bit
    code), 256 seeded rows, and batches of 1, 8 and 32 rows drawn from
    them (the Fibonacci row first)."""
    cases = synth.code_length_cases()
    if case.startswith("b"):
        mix = np.concatenate([cases[k] for k in ("fibonacci", "edges", "empty", "random")])
        freqs = mix[: int(case[1:])]
    else:
        freqs = cases[case]
    f = torch.from_numpy(freqs).to(cuda)
    _build.reset_launches()
    got = thuf.code_lengths_device(f)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["code_lengths"] == 1
    assert got.dtype == torch.int64 and got.shape == f.shape
    assert torch.equal(got, thuf.code_lengths_plain(f))


def test_code_lengths_kernel_in_a_captured_program(cuda):
    """K6 captured as the compress program captures it (sync debug mode
    "error"): every replay equals the eager run and counts one launch."""
    from bmh_tpu_torch.models import programs

    freqs = synth.code_length_cases()["random"][:32]
    prog = programs._Program(programs._cache_for(cuda), thuf.code_lengths_device, (freqs,))
    prog.load((freqs,))
    prog.warm_up()
    prog.capture()
    eager = thuf.code_lengths_device(torch.from_numpy(freqs).to(cuda))
    assert torch.equal(eager, thuf.code_lengths_plain(torch.from_numpy(freqs).to(cuda)))
    _build.reset_launches()
    for k in range(3):
        prog.out.zero_()
        prog.replay()
        torch.cuda.synchronize()
        assert torch.equal(prog.out, eager)
        assert _build.LAUNCHES["code_lengths"] == k + 1


MTF_CASES = ["random", "one_symbol", "runs", "bwt_text", "all_256", "n_edges", "n_odd",
             "rows_2p20", "puts"]


def _mtf_case(case: str):
    """(data (B, Nmax) uint8, n (B,)) on the host for one K7 case."""
    from bmh_tpu_torch.ops import bwt

    rng = np.random.default_rng(7)
    if case == "random":
        data = rng.integers(0, 256, (8, 1 << 16))
    elif case == "one_symbol":
        data = np.full((4, 1 << 16), 0x41)
    elif case == "runs":  # runs of 1 to 3000 bytes, a few long enough to span lanes
        sym = rng.integers(0, 256, 2000)
        data = np.repeat(sym, rng.integers(1, 3000, 2000))[: 4 << 17].reshape(4, 1 << 17)
    elif case == "bwt_text":  # BWT last columns of the benchmark's stream
        text = synth.smoke_input(0, text_bytes=8 << 17, random_bytes=0)
        rows = torch.from_numpy(np.frombuffer(text[: 8 << 17], np.uint8).reshape(8, 1 << 17))
        n = torch.full((8,), 1 << 17, dtype=torch.int64)
        data = bwt.bwt_forward_cp(rows.cuda(), n.cuda(), 4096)[0].cpu().numpy()
    elif case == "all_256":  # every symbol in every 128 bytes, lanes of any length
        data = np.concatenate([rng.permutation(256) for _ in range(4 * 512)])
        data = data.reshape(4, 1 << 17)
    elif case == "rows_2p20":
        data = np.frombuffer(synth.smoke_input(1, text_bytes=32 << 20, random_bytes=0)
                             [: 32 << 20], np.uint8).reshape(32, 1 << 20)
    else:  # rows with garbage past n, which the codes must not see
        data = rng.integers(0, 256, (32 if case == "puts" else 6, 1 << 17))
        data[:, ::3] %= 5
    b, nmax = data.shape
    n = {"n_edges": [0, 1, nmax, 1, 0, nmax],
         "n_odd": [1023, 1025, 77777, nmax - 1, 3, 65537],
         "puts": rng.integers(3997, 4001, b)}.get(case, [nmax] * b)
    return np.ascontiguousarray(data, dtype=np.uint8), np.asarray(n, dtype=np.int64)


@pytest.mark.parametrize("case", MTF_CASES)
def test_mtf_forward_kernel_matches_plain(cuda, case):
    """K7 against the plain version, byte for byte, in one call: random
    bytes, one symbol, long runs, BWT last columns of text, every symbol in
    every chunk, rows of n = 0, 1 and Nmax, n on no lane boundary with
    garbage past it, a 32 x 2^20 batch, and a puts batch (32 rows of
    131,072 with n near 4000)."""
    data, n = _mtf_case(case)
    d, nt = torch.from_numpy(data).to(cuda), torch.from_numpy(n).to(cuda)
    _build.reset_launches()
    got = tmtf.mtf_forward(d, nt, 128)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mtf_forward"] == 1
    assert got.dtype == torch.uint8 and got.shape == d.shape
    want = tmtf.mtf_forward_plain(d, nt, 128)
    assert torch.equal(got, want)
    if case == "one_symbol":
        assert int(got[:, 1:].max()) == 0 and int(got[0, 0]) == 0x41
    if case == "n_edges":
        assert not got[0].any() and not got[4].any()


@pytest.mark.parametrize("hard", [False, True], ids=["sparse", "full_rounds"])
def test_mtf_forward_kernel_in_a_captured_compress_program(cuda, monkeypatch, hard):
    """Both compress programs captured with K7 inside: every replay equals
    the eager run, adds one mtf_forward launch, and the eager run equals the
    same program with the plain MTF forward."""
    import functools

    from bmh_tpu_torch.models import programs

    _, (batch, ns), _, pipeline = _program_inputs(4)
    fn = functools.partial(pipeline.compress_program, stride=4096, hard=hard, b_pad=8)
    # device inputs: no pinned staging buffer in flight at the capture
    inputs = (torch.from_numpy(batch).to(cuda), torch.from_numpy(ns).to(cuda))
    torch.cuda.synchronize()
    prog = programs._Program(programs._cache_for(cuda), fn, inputs)
    prog.load(inputs)
    prog.warm_up()
    prog.capture()
    eager = fn(*inputs)
    _build.reset_launches()
    for k in range(3):
        prog.out.zero_()
        prog.replay()
        torch.cuda.synchronize()
        assert torch.equal(prog.out, eager)
        assert _build.LAUNCHES["mtf_forward"] == k + 1
    monkeypatch.setattr(tmtf, "mtf_forward", tmtf.mtf_forward_plain)
    assert torch.equal(fn(*inputs), eager)


def test_decode_on_side_streams_while_another_batch_runs(cuda):
    """Two batches dispatched on two side streams at once, the second from
    a worker thread, each equal to its default-stream decode."""
    import threading

    from bmh_tpu_torch.models import pipeline

    blobs = [bt.compress_bytes(_text(400000, seed), block_size=65536, device=cuda)
             for seed in (7, 8)]
    infos = [bt.api._parse(b)[0] for b in blobs]

    def decode(inf, results):
        part = pipeline._decompress_dispatch(inf, list(range(len(inf))), 65536,
                                             config.DEFAULT.cursor_stride, cuda)
        pipeline._decompress_drain(part, list(range(len(inf))), results)

    want = []
    for inf in infos:
        want.append([None] * len(inf))
        decode(inf, want[-1])
    got = [[None] * len(inf) for inf in infos]

    def other():
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            decode(infos[1], got[1])

    with torch.cuda.stream(torch.cuda.Stream(cuda)):
        t = threading.Thread(target=other)
        t.start()
        decode(infos[0], got[0])
        t.join(timeout=120)
    assert not t.is_alive()
    for g, w in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(g, w))


@pytest.mark.parametrize("max_dispatch", [1, 3])
def test_inflight_4_equals_inflight_1(cuda, monkeypatch, max_dispatch):
    """Four batches in flight (BMH_INFLIGHT=4), also fanned out over two
    slots on the card, write and decode the same bytes as one batch at a
    time, K5 on and off."""
    rng = np.random.default_rng(9)
    motif = bytes(rng.integers(0, 256, 512, dtype=np.uint8))
    data = _text(600000, 9) + motif * 128 + b"\x00" * 3
    monkeypatch.setattr(config.DEFAULT, "max_dispatch", max_dispatch)
    for sort3 in (False, True):
        monkeypatch.setattr(config.DEFAULT, "pallas_sort", sort3)
        blobs = {}
        for inflight, dev in ((1, cuda), (4, cuda), (4, ("cuda:0", "cuda:0"))):
            monkeypatch.setattr(config.DEFAULT, "inflight", inflight)
            blobs[inflight, str(dev)] = blob = bt.compress_bytes(
                data, block_size=65536, device=dev)
            assert bt.decompress_bytes(blob, device=dev) == data
        assert len(set(blobs.values())) == 1
    assert blob == bt.compress_bytes(data, block_size=65536, device="cpu")


def test_second_card(cuda, monkeypatch):
    """"cuda:1" pins the second card, and "cuda" fans the batches out over
    every card; both write the CPU's bytes (K1's shared-memory opt-in is
    per card)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from bmh_tpu_torch.models import pipeline

    data = _text(500000, 10)
    monkeypatch.setattr(config.DEFAULT, "max_dispatch", 2)
    want = bt.compress_bytes(data, block_size=65536, device="cpu")
    for dev in ("cuda:1", "cuda"):
        blob = bt.compress_bytes(data, block_size=65536, device=dev)
        assert blob == want
        assert bt.decompress_bytes(blob, device=dev) == data
    assert pipeline.LAST_DISPATCH["compress_ndev"] > 1
    assert pipeline.LAST_DISPATCH["decompress_ndev"] > 1


def test_cli_and_resumable_roundtrip_on_the_card(cuda, tmp_path, capsys):
    """The command line on the card (its default device): compress, the
    resumable compress, decompress and verify; both containers equal the
    CPU's."""
    from bmh_tpu_torch import cli
    from bmh_tpu_torch.utils import container

    data = _text(300000, 11)
    src = tmp_path / "in.txt"
    src.write_bytes(data)
    bs = ["--block-size", "65536"]
    assert cli.main(["compress", str(src), str(tmp_path / "a.bzt"), *bs]) == 0
    assert cli.main(["compress", str(src), str(tmp_path / "s.bzt"), *bs, "--resumable"]) == 0
    assert cli.main(["decompress", str(tmp_path / "s.bzt"), str(tmp_path / "out")]) == 0
    assert cli.main(["verify", str(src), str(tmp_path / "out")]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "success"
    one_shot = (tmp_path / "a.bzt").read_bytes()
    assert one_shot == bt.compress_bytes(data, block_size=65536, device="cpu")
    assert (container.unpack_file((tmp_path / "s.bzt").read_bytes())[2]
            == container.unpack_file(one_shot)[2])


def test_oracle_containers_equal_the_cards(cuda):
    rng = np.random.default_rng(12)
    data = _text(50000, 12) + bytes(rng.integers(0, 256, 15000, dtype=np.uint8))
    blob = bt.compress_bytes(data, block_size=32768, backend="oracle")
    assert blob == bt.compress_bytes(data, block_size=32768, device=cuda)
    assert bt.decompress_bytes(blob, device=cuda) == data
    assert bt.decompress_bytes(blob, backend="oracle") == data


def test_roundtrip_step_on_one_nccl_process(cuda, tmp_path):
    """make_roundtrip_step on a one-process NCCL group: every row decodes,
    the bits are the tables' lengths over the histograms, and K1-K4 launch
    (256-bit chunks, MTF chunk 128); a second call replays the captured
    step, collectives included, and gives the same outputs."""
    import torch.distributed as dist

    from bmh_tpu_torch.models import programs
    from bmh_tpu_torch.parallel import dataparallel as tdp
    from bmh_tpu_torch.parallel import mesh as tmesh

    nmax, b = 16384, 4
    buf = _text(b * nmax, 13)
    batch = np.frombuffer(buf, np.uint8).reshape(b, nmax).copy()
    ns = np.full(b, nmax, np.int64)
    ns[-1] = nmax - 999
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            world_size=1, rank=0)
    try:
        mesh = tmesh.make_mesh(device="cuda")
        freqs = tdp.make_sharded_stage1(mesh, nmax)(batch, ns)[2].cpu().numpy()
        tbl = tdp.host_tables(freqs)
        _build.reset_launches()
        step = tdp.make_roundtrip_step(mesh, nmax)
        args = (batch, ns, *(tbl[k] for k in ("enc_len", "enc_code", "count", "sym")))
        out, total_ok, bits = step(*args)
        torch.cuda.synchronize()
        programs.reset_stats()
        again = step(*args)
        assert programs.STATS["captures"] == 0 and programs.STATS["hits"] == 1
        assert all(torch.equal(a, b) for a, b in zip(again, (out, total_ok, bits)))
    finally:
        programs.clear()  # the captured collectives go before their group
        dist.destroy_process_group()
    assert all(_build.LAUNCHES[k] > 0 for k in ("gap_decode_phase_a", "gap_decode_phase_b",
                                                "imtf_chunks", "ibwt_walk"))
    assert int(total_ok) == int(ns.sum())
    assert np.array_equal(bits.cpu().numpy(), (freqs * tbl["enc_len"]).sum(1))
    out = out.cpu().numpy()
    for row in range(b):
        assert (out[row, : ns[row]] == batch[row, : ns[row]]).all()


def test_two_mib_block_decode_matches_plain(cuda, monkeypatch):
    """bmh_tpu's largest block (2 MiB, Nmax 2^21): a container of one text
    block and one random block decodes bit-exact on the card, with BMH_LF2
    on and off, and K1-K4, on the arguments the decode gave them, equal
    their plain versions exactly."""
    from bmh_tpu_torch.ops import decode_kernels as dk

    from bmh_tpu_torch.models import programs

    big = bt.api.MAX_BLOCK_SIZE
    data = synth.smoke_input(0, text_bytes=big, random_bytes=1 << 19)
    blob = bt.compress_bytes(data, block_size=big, device=cuda)
    programs.clear()  # the decode's warm-up run hands the kernels their inputs
    captured = {}
    wrappers = [(dk, "phase_a"), (dk, "phase_b"), (imtf_kernel, "imtf_chunks"),
                (ibwt_kernel, "ibwt_walk")]
    for mod, name in wrappers:
        orig = getattr(mod, name)

        def rec(*args, _name=name, _orig=orig):
            if _name not in captured:
                captured[_name] = [a.clone() if torch.is_tensor(a) else a
                                   for a in args]
            return _orig(*args)

        monkeypatch.setattr(mod, name, rec)
    assert bt.decompress_bytes(blob, device=cuda) == data
    monkeypatch.undo()
    table, starts, steps, hop = captured["ibwt_walk"]
    assert table.shape[1] == big and hop == ibwt_kernel.HOP
    for got, want in (
            (dk.phase_a(*captured["phase_a"]), dk.phase_a_plain(*captured["phase_a"])),
            (dk.phase_b(*captured["phase_b"]), dk.phase_b_plain(*captured["phase_b"])),
            (imtf_kernel.imtf_chunks(*captured["imtf_chunks"]),
             imtf_kernel.imtf_chunks_plain(*captured["imtf_chunks"])),
            (ibwt_kernel.ibwt_walk(table, starts, steps, hop),
             ibwt_kernel.ibwt_walk_plain(table, starts, steps, 1))):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    monkeypatch.setattr(config.DEFAULT, "lf2", False)
    assert bt.decompress_bytes(blob, device=cuda) == data


# --- the program layer: captured CUDA graphs ---------------------------------

def _program_inputs(seed: int):
    """One 8-block batch of 64 KiB blocks: compress staging and its decode
    staging (the flat route)."""
    from bmh_tpu_torch.models import pipeline

    data = synth.smoke_input(seed, text_bytes=7 << 16, random_bytes=1 << 16)
    arrs = [np.frombuffer(data[i:i + 65536], np.uint8) for i in range(0, len(data), 65536)]
    batch = np.zeros((8, 65536), np.uint8)
    ns = np.ones(8, np.int64)
    for r, a in enumerate(arrs):
        batch[r, : a.size] = a
        ns[r] = a.size
    blocks = bt.api._parse(bt.compress_bytes(data, block_size=65536, device="cpu"))[0]
    return data, (batch, ns), blocks, pipeline


def test_capture_has_no_sync_and_replay_equals_eager(cuda):
    """A compress program captured under set_sync_debug_mode("error") (the
    warm-up, which reads its loop flags, outside it), replayed: its output
    equals the eager run of the same function; a second call of the same
    shape captures nothing; LAUNCHES counts every replay."""
    import functools

    from bmh_tpu_torch.models import programs

    _, (batch, ns), _, pipeline = _program_inputs(1)
    fn = functools.partial(pipeline.compress_program, stride=4096, hard=False, b_pad=8)
    k = programs.key("test_compress", b_pad=8, nmax=65536, stride=4096)
    cache = programs._cache_for(cuda)
    prog = programs._Program(cache, fn, (batch, ns))
    prog.load((batch, ns))
    prog.warm_up()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prog.capture()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eager = fn(torch.from_numpy(batch).to(cuda), torch.from_numpy(ns).to(cuda))
    _build.reset_launches()
    trips = prog.replay()
    replayed = dict(_build.LAUNCHES)
    assert torch.equal(prog.out, eager)
    prog.out.zero_()
    assert prog.replay(trips) == trips and torch.equal(prog.out, eager)
    programs.clear()
    programs.reset_stats()
    first = programs.run(cuda, k, fn, (batch, ns)).wait()
    assert programs.STATS["captures"] == 1
    _build.reset_launches()
    again = programs.run(cuda, k, fn, (batch, ns)).wait()
    assert programs.STATS["captures"] == 1 and programs.STATS["hits"] == 1
    assert np.array_equal(first, again) and np.array_equal(again, eager.cpu().numpy())
    assert dict(_build.LAUNCHES) == replayed
    assert programs.STATS["flag_reads"] > 0


@pytest.mark.parametrize("sort3", [False, True], ids=["torch_sort", "sort3"])
def test_programs_replay_the_main_path(cuda, monkeypatch, sort3):
    """compress_bytes / decompress_bytes through the cache: the container
    equals the CPU run's, a second call captures nothing and replays, K1-K4
    (and K5 with its knob) count launches on the replay alone, and a replay
    reads no tensor on the host (sync debug mode "error" around it)."""
    from bmh_tpu_torch.models import programs

    monkeypatch.setattr(config.DEFAULT, "pallas_sort", sort3)
    data, _, _, _ = _program_inputs(2)
    want = bt.compress_bytes(data, block_size=65536, device="cpu")
    programs.clear()
    assert bt.compress_bytes(data, block_size=65536, device=cuda) == want
    assert bt.decompress_bytes(want, device=cuda) == data
    programs.reset_stats()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert bt.compress_bytes(data, block_size=65536, device=cuda) == want
        assert bt.decompress_bytes(want, device=cuda) == data
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert programs.STATS["captures"] == 0 and programs.STATS["hits"] == 2
    assert programs.STATS["replays"] > 0
    assert all(_build.LAUNCHES[k] == 1 for k in ("gap_decode_phase_a",
                                                 "gap_decode_phase_b",
                                                 "imtf_chunks", "ibwt_walk"))
    assert _build.LAUNCHES["code_lengths"] == 1  # one compress batch
    assert _build.LAUNCHES["mtf_forward"] == 1
    assert (_build.LAUNCHES["sort3"] > 0) == sort3


def test_lf2_is_in_the_decode_key(cuda, monkeypatch):
    """BMH_LF2 off after a decode with it on captures a new program (bmh_tpu's
    _decode_flat key forgets it) and walks one row a step: both decode."""
    from bmh_tpu_torch.models import programs

    data, _, _, _ = _program_inputs(3)
    blob = bt.compress_bytes(data, block_size=65536, device=cuda)
    assert bt.decompress_bytes(blob, device=cuda) == data
    programs.reset_stats()
    monkeypatch.setattr(config.DEFAULT, "lf2", False)
    assert bt.decompress_bytes(blob, device=cuda) == data
    assert programs.STATS["captures"] == 1


def test_upload_and_route_programs_replay_without_host_reads(cuda):
    """The inflate program feeding a compress program (32 small files in
    128 KiB rows), the periodic program (four 64 KiB blocks of one record)
    and the single-symbol program (five streams padded to eight rows):
    containers equal the CPU run's, and a second call of each replays
    under sync debug mode "error" without a capture; the decodes read no
    loop flag."""
    from bmh_tpu_torch.models import pipeline, programs

    files = synth.small_files(5, count=32)
    rec = synth.record_stream(5, total=4 * 65536)
    singles = [b"\x00" * 3] * 5
    want = bt.compress_many(files, block_size=131072, uniform=True, device="cpu")
    blob_r = bt.compress_bytes(rec, block_size=65536, device="cpu")
    blobs_s = bt.compress_many(singles, block_size=2048, device="cpu")
    programs.clear()
    before = pipeline.UPLOADS["compact"]
    assert bt.compress_many(files, block_size=131072, uniform=True, device=cuda) == want
    assert pipeline.UPLOADS["compact"] == before + 1
    assert bt.decompress_bytes(blob_r, device=cuda) == rec
    assert bt.decompress_many(blobs_s, uniform=True, device=cuda) == singles
    programs.reset_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert bt.decompress_bytes(blob_r, device=cuda) == rec
        assert bt.decompress_many(blobs_s, uniform=True, device=cuda) == singles
        assert programs.STATS["flag_reads"] == 0
        assert bt.compress_many(files, block_size=131072, uniform=True,
                                device=cuda) == want
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert programs.STATS["captures"] == 0 and programs.STATS["hits"] == 4


def test_recorder_on_the_card(cuda):
    """utils/tracing's recorder around a compress and a decompress on the
    card: the first call of each shape captures inside its programs.run (a
    programs.capture span a capture); a second call captures nothing, its
    programs.flag spans are the cache's flag reads, one each, and each
    run's host copy is waited for once, in a programs.wait span."""
    from bmh_tpu_torch.models import programs
    from bmh_tpu_torch.utils import tracing

    data, _, _, _ = _program_inputs(4)
    programs.clear()
    programs.reset_stats()
    with tracing.recording() as first:
        blob = bt.compress_bytes(data, block_size=65536, device=cuda)
        assert bt.decompress_bytes(blob, device=cuda) == data
    by_id = {s[0]: s for s in first.spans}
    captures = [s for s in first.spans if s[4] == "programs.capture"]
    assert len(captures) == programs.STATS["captures"] >= 2
    assert all(by_id[s[1]][4] == "programs.run" for s in captures)
    programs.reset_stats()
    with tracing.recording() as again:
        assert bt.compress_bytes(data, block_size=65536, device=cuda) == blob
        assert bt.decompress_bytes(blob, device=cuda) == data
    counts = again.counts()
    assert "programs.capture" not in counts and programs.STATS["captures"] == 0
    assert counts["programs.flag"] == programs.STATS["flag_reads"] > 0
    assert counts["programs.wait"] == counts["programs.run"] == programs.STATS["runs"]
    assert [s[4] for s in again.spans if s[1] == 0] == ["api.compress", "api.decompress"]
    waits = again.self_ns()
    assert waits["programs.flag"] > 0 and waits["programs.wait"] > 0


def _reference_blocks(data: bytes, block_size: int) -> bytes:
    """bmhbench/reference.py's container of `data`, its blocks encoded in
    one process per core (one 1 MiB block takes seconds there)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from bmhbench import reference

    blocks = reference.split(data, block_size)
    with ProcessPoolExecutor(min(os.cpu_count() or 1, 8),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        enc = list(pool.map(reference.encode_block, blocks, [4096] * len(blocks)))
    return reference.pack_file(enc, block_size, len(data), 4096)


def test_stage_times_of_a_1mib_compress_batch(cuda):
    """One warm compress batch of 32 blocks of 1 MiB (the archive's
    dispatch): each stage's counter (programs.STATS["stage_ms.*"], timing
    events between the replay's stages) is positive, the three add up to
    within 10% of the batch's device time by the profiler, no capture made
    an empty graph, and the container equals the plain reference's."""
    import warnings

    from bmh_tpu_torch.models import programs
    from bmh_tpu_torch.utils import tracing
    from bmhbench.generators import zipf_text

    data = zipf_text.make(2**31 + 20, 1, text_bytes=32 << 20)[0]
    programs.clear()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        blob = bt.compress_bytes(data, block_size=1 << 20, device=cuda)
    assert not [w for w in seen if "Graph is empty" in str(w.message)]
    programs.reset_stats()
    out = []
    prof = tracing.device_profile(
        lambda: out.append(bt.compress_bytes(data, block_size=1 << 20, device=cuda)))
    assert out == [blob] and programs.STATS["captures"] == 0
    stages = [programs.STATS[f"stage_ms.{s}"] for s in programs.STAGES]
    assert all(ms > 0 for ms in stages), stages
    assert abs(sum(stages) / prof["device_ms"] - 1) <= 0.10, (stages, prof["device_ms"])
    assert blob == _reference_blocks(data, 1 << 20)
