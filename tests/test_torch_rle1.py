"""RLE1 inside the compress program, on the CPU.

K8's plain version (ops/rle.rle1_encode_plain, which the wrapper takes for
a CPU tensor) against bmh_tpu's Python specification of the encoder
(bmh_tpu.utils.nativeio._rle1_encode_py) on runs around every group edge, across
K8's 1024-byte lane edges, where the encoding is as long as the row or one
byte longer (the row stays itself), on rows shorter than Nmax and on dummy
rows; compress_many, which hands the raw blocks to the backend, against
bmh_tpu's containers and the host pass that it replaces; where each
block's RLE1 runs, by the counters of models/pipeline.UPLOADS; and a block
that the host path's rule picks but that RLE1 does not shrink."""

import numpy as np
import pytest
import torch

import bmh_tpu
import bmh_tpu_torch as bt
from bmh_tpu.utils import nativeio as jnativeio
from bmh_tpu_torch import api
from bmh_tpu_torch.models import pipeline, programs
from bmh_tpu_torch.ops import _build
from bmh_tpu_torch.ops import rle as trle
from bmh_tpu_torch.utils import config, container, nativeio, synth
from bmhbench.generators import rocksdb_blocks, zipf_text

RUN_LENGTHS = [1, 2, 3, 4, 5, 6, 254, 255, 256, 258, 259, 260, 510, 100000]
COUNTERS = ("rle1_device_rows", "rle1_device_collapsed", "rle1_host_rows")


def _want(row: np.ndarray) -> np.ndarray:
    enc = jnativeio._rle1_encode_py(row)
    return enc if enc.size < row.size else row


def _check_rows(rows: list[np.ndarray], nmax: int, pad: int = 0) -> None:
    """rle1_encode on the CPU of the rows in a (len(rows), nmax) batch (with
    `pad` garbage bytes past each row's n) equals the specification, zero
    past each row's new length, and counts no launch."""
    rng = np.random.default_rng(len(rows))
    batch = np.zeros((len(rows), nmax), np.uint8)
    for i, r in enumerate(rows):
        batch[i, : r.size] = r
        batch[i, r.size: r.size + pad] = rng.integers(0, 256, min(pad, nmax - r.size))
    n = torch.tensor([r.size for r in rows], dtype=torch.int64)
    before = _build.LAUNCHES["rle1_encode"]
    got, n_out = trle.rle1_encode(torch.from_numpy(batch), n)
    assert _build.LAUNCHES["rle1_encode"] == before
    assert got.dtype == torch.uint8 and got.shape == batch.shape and n_out.dtype == torch.int64
    for i, r in enumerate(rows):
        want = _want(r)
        assert int(n_out[i]) == want.size, i
        assert np.array_equal(got[i, : want.size].numpy(), want), i
        assert not got[i, want.size:].any(), i


@pytest.mark.parametrize("run", RUN_LENGTHS)
def test_plain_equals_the_spec_on_one_run(run):
    """A run of each length alone, and between other bytes, in rows whose
    run starts at 0 and at 1021 (across a lane edge)."""
    nmax = max(256, 1 << (run + 1030).bit_length())
    v = np.full(run, 7, np.uint8)
    _check_rows([v, np.concatenate([[1, 2], v, [3]]).astype(np.uint8),
                 np.concatenate([np.arange(1021) % 5 + 10, v, [7, 9]]).astype(np.uint8)],
                nmax)


@pytest.mark.parametrize("case", ["lane_edges", "equal_length", "one_longer", "short_rows",
                                  "dummy_rows", "mixed_runs"])
def test_plain_equals_the_spec(case):
    rng = np.random.default_rng(23)
    nmax = 8192
    if case == "lane_edges":  # runs that start and end on each side of 1024, 2048, 3072
        rows = [np.concatenate([np.arange(edge - k) % 3, np.full(k + j, 9),
                                np.arange(50) % 4]).astype(np.uint8)
                for edge in (1024, 2048, 3072) for k in (0, 1, 3, 4, 260)
                for j in (0, 1, 5, 300)]
    elif case == "equal_length":  # runs of 5 encode to 5 bytes: m == n, the row stays
        rows = [np.repeat(np.arange(40) % 2, 5).astype(np.uint8),
                np.full(5, 3, np.uint8)]
    elif case == "one_longer":  # one run of 4: m == n + 1
        rows = [np.concatenate([np.arange(30) % 7, [8, 8, 8, 8]]).astype(np.uint8)]
    elif case == "short_rows":  # rows shorter than nmax, garbage past n
        rows = [np.repeat(rng.integers(0, 3, 300), rng.integers(1, 40, 300))[:k]
                .astype(np.uint8) for k in (1, 17, 1000, 4095, 5000)]
        _check_rows(rows, nmax, pad=300)
        return
    elif case == "dummy_rows":  # the n = 1 rows of a padded batch
        rows = [np.zeros(1, np.uint8), np.full(1, 200, np.uint8)]
    else:
        rows = [np.repeat(rng.integers(0, 4, 3000), rng.integers(1, 700, 3000))[:nmax]
                .astype(np.uint8) for _ in range(6)]
    _check_rows(rows, nmax)
    if case in ("equal_length", "one_longer"):
        assert all(_want(r) is r for r in rows)


def _parent(datas, bs, uniform=False):
    """The containers of the host's RLE1 pass and the backend on the blocks
    it collapsed (what compress_many ran before the pass moved): RLE1 off
    in the backend, which then takes the blocks as they are."""
    be = api.get_backend("torch", "cpu")
    kw = {"bucket": pipeline._bucket(bs)} if uniform else {}
    out = []
    rle1 = config.DEFAULT.rle1
    for d in datas:
        raw = container.split_blocks(api._as_array(d), bs)
        blocks = [_want(b) for b in raw] if rle1 else raw
        config.DEFAULT.rle1 = False
        try:
            results = be.compress_blocks(blocks, 4096, **kw)
        finally:
            config.DEFAULT.rle1 = rle1
        out.append(api._pack(results, [b.size for b in raw], bs, len(d), 4096))
    return out


def _bmh_tpu(datas, bs, uniform):
    if uniform:
        return bmh_tpu.api.compress_many(datas, block_size=bs, uniform=True)
    return [bmh_tpu.compress_bytes(d, block_size=bs) for d in datas]


def _mixed() -> bytes:
    rng = np.random.default_rng(9)
    runs = np.repeat(rng.integers(0, 256, 30).astype(np.uint8), rng.integers(200, 2000, 30))
    return (zipf_text.stream(3, 30000, 0) + synth.zero_pages(3, total=40960)
            + runs.tobytes() + bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
            + b"\x00" * 3)


# input -> (streams, block size, uniform, rows per path: device, device
# collapsed, host)
INPUTS = {
    "zipf_text": (lambda: zipf_text.make(4, 2, text_bytes=40000), 16384, False, (6, 0, 0)),
    "rocksdb_uniform": (lambda: rocksdb_blocks.make(4, 12), 16384, True, (12, 12, 0)),
    "zero_pages": (lambda: [synth.zero_pages(4, total=65536, zero_share=0.9)], 16384, False,
                   (0, 0, 4)),
    "zero_pages_uniform": (lambda: [synth.zero_pages(4, total=65536, zero_share=0.9)], 16384,
                           True, (4, 4, 0)),
    "mixed": (lambda: [_mixed()], 8192, False, None),
}


@pytest.mark.parametrize("name", list(INPUTS))
def test_compress_many_equals_the_host_pass(name):
    """The containers equal bmh_tpu's and the host pass's, decode, and the
    counters say where each block's RLE1 ran; the mixed stream's are also
    the oracle's."""
    make, bs, uniform, paths = INPUTS[name]
    datas = make()
    before = dict(pipeline.UPLOADS)
    blobs = bt.compress_many(datas, block_size=bs, uniform=uniform, device="cpu")
    moved = tuple(pipeline.UPLOADS[k] - before[k] for k in COUNTERS)
    assert blobs == _bmh_tpu(datas, bs, uniform)
    assert blobs == _parent(datas, bs, uniform)
    assert bt.decompress_many(blobs, uniform=uniform, device="cpu") == datas
    blocks = sum(-(-len(d) // bs) for d in datas)
    assert moved[0] + moved[2] == blocks
    if paths is not None:
        assert moved == paths
    else:
        assert moved[0] > 0 and moved[2] > 0
        assert bt.compress_many(datas, block_size=bs, backend="oracle") == blobs


def _fools_the_rule(as_long: bool) -> np.ndarray:
    """A 16 KiB block whose strided samples (every 17th byte) mostly start
    a run of 8, which the rule reads as a block RLE1 halves, while runs of
    4 around them make the encoding one byte longer per run: 17-byte
    periods of runs 8, 4, 4, 1 (encoded one byte shorter), of runs 4, 4, 4,
    4, 1 (four bytes longer) and of 17 single bytes, in counts that make
    the encoding longer than the block or exactly as long."""
    counts = (492, 123, 348) if as_long else (490, 473, 0)
    shapes = ([8, 4, 4, 1], [4, 4, 4, 4, 1], [1] * 17)
    runs = [r for shape, c in zip(shapes, counts) for _ in range(c) for r in shape]
    runs += [1] * (16384 - sum(runs))
    vals = np.arange(len(runs)) % 250 + 1  # neighbouring runs differ
    return np.repeat(vals, runs).astype(np.uint8)


@pytest.mark.parametrize("as_long", [False, True], ids=["longer", "as_long"])
def test_a_block_the_rule_picks_but_rle1_does_not_shrink(monkeypatch, as_long):
    """With no C library (nativeio's Python fallback), a block that the rule
    sends to the host's RLE1 but whose encoding is longer than it, or as
    long, stays whole: the container is bmh_tpu's and decodes."""
    monkeypatch.setattr(nativeio, "_load", lambda: None)
    blk = _fools_the_rule(as_long)
    enc = jnativeio._rle1_encode_py(blk)
    assert blk.size == 16384 and pipeline._rle1_on_host(blk)
    assert enc.size == blk.size if as_long else enc.size > blk.size
    before = dict(pipeline.UPLOADS)
    blob = bt.compress_bytes(blk, block_size=16384, device="cpu")
    assert tuple(pipeline.UPLOADS[k] - before[k] for k in COUNTERS) == (0, 0, 1)
    assert blob == bmh_tpu.compress_bytes(blk, block_size=16384)
    assert bt.decompress_bytes(blob, device="cpu") == blk.tobytes()
    assert bt.compress_bytes(blk, block_size=16384, backend="oracle") == blob


def test_rle1_off_runs_it_nowhere(monkeypatch):
    """BMH_RLE1=0: no block takes RLE1 on either path, and the containers
    are those of the host pass with it off."""
    monkeypatch.setattr(config.DEFAULT, "rle1", False)
    datas = [zipf_text.stream(3, 6000, 0) + synth.zero_pages(3, total=16384, zero_share=0.9)]
    before = dict(pipeline.UPLOADS)
    programs.clear()
    blobs = bt.compress_many(datas, block_size=8192, device="cpu")
    assert all(pipeline.UPLOADS[k] == before[k] for k in COUNTERS)
    assert blobs == _parent(datas, 8192)
    assert not any(k[0].endswith("_rle1") for k in programs._cpu_keys)
    assert bt.decompress_many(blobs, device="cpu") == datas


def test_the_host_path_takes_blocks_rle1_may_move_down_a_bucket():
    """The rule: zero pages and a block of a few long runs go to the host;
    the benchmark's text at 128 KiB and 1 MiB blocks and RocksDB's data
    blocks stay on the card; nothing goes where the bucket is the
    smallest."""
    rng = np.random.default_rng(11)
    text = np.frombuffer(zipf_text.stream(5, 6 << 20, 0), np.uint8)
    for bs in (1 << 17, 1 << 20):
        assert not any(map(pipeline._rle1_on_host, container.split_blocks(text, bs)))
    assert not any(pipeline._rle1_on_host(np.frombuffer(b, np.uint8))
                   for b in rocksdb_blocks.make(5, 256))
    pages = np.frombuffer(synth.zero_pages(5, total=4 << 20), np.uint8)
    assert all(map(pipeline._rle1_on_host, container.split_blocks(pages, 1 << 17)))
    runs = np.repeat(rng.integers(0, 256, 12).astype(np.uint8), 10000)
    assert pipeline._rle1_on_host(runs)
    assert not pipeline._rle1_on_host(np.zeros(200, np.uint8))  # the smallest bucket
    assert not pipeline._rle1_on_host(rng.integers(0, 256, 70000).astype(np.uint8))


@pytest.mark.parametrize("hard", [False, True], ids=["sparse", "full_rounds"])
def test_program_with_rle1_equals_the_program_on_collapsed_rows(hard):
    """A batch staged as a card stages it (a dummy row of n = 1 last) by the
    program with RLE1 writes what the program without it writes on the
    host-collapsed rows; the meta row carries each row's length after
    RLE1."""
    nmax = 8192
    rng = np.random.default_rng(12)
    raw = [np.repeat(rng.integers(0, 4, 800), rng.integers(1, 60, 800))[:nmax].astype(np.uint8),
           np.frombuffer(zipf_text.stream(6, 7000, 0), np.uint8),
           np.concatenate([np.full(3000, 5), np.arange(900) % 7]).astype(np.uint8)]
    pre = [_want(r) for r in raw]
    assert [p.size < r.size for p, r in zip(pre, raw)] == [True, False, True]

    def batch(rows):
        out = np.zeros((4, nmax), np.uint8)
        ns = np.ones(4, np.int64)
        for i, r in enumerate(rows):
            out[i, : r.size] = r
            ns[i] = r.size
        return torch.from_numpy(out), torch.from_numpy(ns)

    got = pipeline.compress_program(*batch(raw), 4096, hard, 4, rle1=True)
    want = pipeline.compress_program(*batch(pre), 4096, hard, 4)
    assert torch.equal(got, want)
    cols = pipeline._meta_cols(nmax, 4096)
    assert got[: 4 * cols].reshape(4, cols)[:, 5].tolist() == [p.size for p in pre] + [1]
