"""The compact upload (models/pipeline._upload_batch, inflate_program)
against bmh_tpu's _upload_batch and _inflate_prog on the CPU.

(a) the plain-or-compact decision, the compact stream's length and every
    staged array equal bmh_tpu's on a grid of block sizes, nmax and b_pad;
(b) the inflated batch equals _inflate_prog's (JAX on the CPU), dummy rows
    and a start clamped to s - nmax included;
(c) compress_many(uniform=True) on bmh_tpu's own 30-file case takes the
    compact path and writes bmh_tpu's containers, which equal compress_bytes
    of each file and decode back;
(d) with a small quantum the compact path runs at 4 KiB rows: the inflate
    program feeds the compress program, whose key it leaves as the plain
    upload's, and the containers are bmh_tpu's.
Integers compare exactly."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmh_tpu import api as japi
from bmh_tpu.models import pipeline as jpipe
import bmh_tpu_torch as bt
from bmh_tpu_torch.models import pipeline as tpipe
from bmh_tpu_torch.models import programs
from bmh_tpu_torch.utils import synth

Q = tpipe._UPLOAD_QUANTUM


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in test_torch_programs.py: the 128 KiB
    batches' many parallel ops crawl where several test workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_quantum_is_bmh_tpus():
    assert Q == jpipe._UPLOAD_QUANTUM == 1 << 19


def _sizes(kind: str, nmax: int, b: int, rng) -> list[int]:
    if kind == "full":
        return [nmax] * b
    if kind == "tiny":
        return [int(x) for x in rng.integers(1, 64, b)]
    if kind == "quarter":
        return [nmax // 4] * b
    return [int(x) for x in rng.integers(1, nmax + 1, b)]  # mixed


def _jax_upload(monkeypatch, arrs, idxs, ns, nmax, b_pad):
    """bmh_tpu's _upload_batch with jnp.asarray and _inflate_prog faked:
    returns the plain batch or ("compact", s, (flat, offs, ns))."""
    monkeypatch.setattr(jpipe, "jnp", types.SimpleNamespace(asarray=np.asarray))
    monkeypatch.setattr(jpipe, "_inflate_prog",
                        lambda s, n, b: lambda *a: ("compact", s, a))
    return jpipe._upload_batch(arrs, idxs, ns, nmax, b_pad)


@pytest.mark.parametrize("kind", ["full", "tiny", "quarter", "mixed"])
@pytest.mark.parametrize("nmax,b,b_pad", [
    (4096, 3, 4), (131072, 30, 32), (131072, 8, 8), (524288, 32, 32),
    (1 << 20, 5, 8), (1 << 21, 32, 32), (1 << 21, 2, 2)])
def test_upload_decision_equals_bmh_tpus(monkeypatch, kind, nmax, b, b_pad):
    rng = np.random.default_rng(nmax + b)
    sizes = _sizes(kind, nmax, b, rng)
    arrs = [rng.integers(0, 256, n, dtype=np.uint8) for n in sizes]
    idxs = list(range(b))
    ns = np.ones(b_pad, np.int64)
    ns[:b] = sizes
    got = tpipe._upload_batch(arrs, idxs, ns, nmax, b_pad)
    want = _jax_upload(monkeypatch, arrs, idxs, ns.astype(np.int32), nmax, b_pad)
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and np.array_equal(got, want)
        return
    _, s, (flat, offs, jns) = want
    assert isinstance(got, programs.Feed)
    assert got.k[0] == "inflate" and got.k[1:3] == (b_pad, nmax) and got.k[7] == s
    for g, w in zip(got.inputs, (flat, offs, jns)):
        assert np.array_equal(g, w)


def test_small_blocks_in_a_large_bucket_go_compact():
    """The decision at its edge: a batch goes compact exactly where
    s + 4 quanta < b_pad * nmax."""
    nmax = 131072
    for b_pad, n in ((16, 1000), (20, 1000), (21, 1000), (32, 100000)):
        arrs = [np.zeros(n, np.uint8)] * b_pad
        ns = np.full(b_pad, n, np.int64)
        s = max(-(-(n * b_pad + nmax) // Q) * Q, Q)
        up = tpipe._upload_batch(arrs, list(range(b_pad)), ns, nmax, b_pad)
        assert isinstance(up, programs.Feed) == (s + 4 * Q < b_pad * nmax)


@pytest.mark.parametrize("s,nmax,b", [(1 << 19, 4096, 8), (1 << 20, 65536, 5)])
def test_inflated_batch_equals_bmh_tpus(s, nmax, b):
    rng = np.random.default_rng(s + b)
    flat = rng.integers(0, 256, s, dtype=np.uint8)
    offs = rng.integers(0, s - nmax, b).astype(np.int64)
    ns = rng.integers(1, nmax + 1, b).astype(np.int64)
    offs[-1], ns[-1] = 0, 1                  # a dummy row
    offs[0], ns[0] = s - nmax // 2, nmax     # a start clamped to s - nmax
    want = np.asarray(jpipe._inflate_prog(s, nmax, b)(
        jnp.asarray(flat), jnp.asarray(offs.astype(np.int32)),
        jnp.asarray(ns.astype(np.int32))))
    got = tpipe.inflate_program(torch.from_numpy(flat), torch.from_numpy(offs),
                                torch.from_numpy(ns), nmax)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def thirty_files():
    """bmh_tpu's tests/test_pipeline.py case: 30 files of about 3 KB."""
    rng = np.random.default_rng(1234)
    return [bytes(rng.integers(0, 120, 3000 + 17 * i).astype(np.uint8))
            for i in range(30)]


def test_compress_many_uniform_takes_the_compact_path(thirty_files):
    before = dict(tpipe.UPLOADS)
    blobs = bt.compress_many(thirty_files, block_size=131072, uniform=True,
                             device="cpu")
    assert tpipe.UPLOADS["compact"] == before["compact"] + 1
    assert tpipe.UPLOADS["plain"] == before["plain"]
    sent = tpipe.UPLOADS["bytes"] - before["bytes"]
    assert sent == Q + 2 * 8 * 30 and tpipe.UPLOADS["plain_bytes"] - before[
        "plain_bytes"] == 30 * 131072
    try:
        want = japi.compress_many(thirty_files, block_size=131072, uniform=True)
    finally:
        # bmh_tpu's own test of this case (tests/test_pipeline.py) counts its
        # inflate program's cache misses: leave it no entry to find, in
        # whichever order a test process runs the two files
        jpipe._inflate_prog.cache_clear()
    assert blobs == want
    assert blobs == [bt.compress_bytes(d, block_size=131072, device="cpu")
                     for d in thirty_files]
    assert bt.decompress_many(blobs, uniform=True, device="cpu") == thirty_files


@pytest.mark.parametrize("hard", [False, True], ids=["sparse", "full_rounds"])
def test_inflate_feeds_the_compress_program(monkeypatch, hard):
    """At a 1 KiB quantum four short blocks in 4 KiB rows go compact: the
    inflate program runs first and feeds the compress program, whose key
    equals the plain upload's; both write bmh_tpu's blocks."""
    rng = np.random.default_rng(3)
    text = synth.smoke_input(3, text_bytes=3000, random_bytes=0)
    arrs = [np.frombuffer(text[i * 700:(i + 1) * 700], np.uint8) for i in range(3)]
    arrs.append(rng.integers(0, 256, 500, dtype=np.uint8))
    idxs = list(range(4))
    outs, keys = {}, {}
    for quantum in (Q, 1024):
        monkeypatch.setattr(tpipe, "_UPLOAD_QUANTUM", quantum)
        programs.reset_stats()
        programs.clear()
        before = tpipe.UPLOADS["compact"]
        part = tpipe._compress_dispatch(arrs, idxs, 4096, 4096, hard, 4,
                                        torch.device("cpu"))
        outs[quantum] = tpipe._compress_unpack(part, arrs, idxs, 4096)
        keys[quantum] = list(programs._cpu_keys)  # the keys run, in order
        assert tpipe.UPLOADS["compact"] - before == (quantum == 1024)
        assert programs.STATS["runs"] == 1 + (quantum == 1024)
    assert [k[0] for k in keys[1024]] == ["inflate", keys[Q][0][0]]
    assert keys[1024][1] == keys[Q][0]
    want = jpipe.JaxBackend().compress_blocks(arrs, bucket=4096)
    for got in outs.values():
        for g, w in zip(got, want):
            assert g["payload"] == w["payload"] and g["shift"] == w["shift"]
            assert np.array_equal(g["lens"], w["lens"]) and g["rle_len"] == w["rle_len"]
