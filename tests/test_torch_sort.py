"""Kernel K5's plain version and the BWT programs around it, against
bmh_tpu on the same numpy inputs: sort3_plain against jax.lax.sort and the
Pallas sort3 in interpret mode, the _stable_sort3 dispatch, and the
doubling rounds, round_step and sparse refinement of the sparse/adaptive
program (tests/test_bwt.py's cases) under both values of the sort knob.
Integers compare exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmh_tpu.models import pipeline as jpipe
from bmh_tpu.ops import bwt as jbwt
from bmh_tpu.ops import pallas_sort
from bmh_tpu_torch.models import pipeline as tpipe
from bmh_tpu_torch.ops import bwt as tbwt
from bmh_tpu_torch.ops import sort_kernel
from bmh_tpu_torch.utils import config as tconfig

INT32_MIN, INT32_BIG = -(2**31), 2**31 - 1


@pytest.fixture(params=[False, True], ids=["torch_sort", "sort3"])
def knob(request, monkeypatch):
    """BMH_PALLAS_SORT off and on for the port (bmh_tpu on the CPU always
    takes lax.sort)."""
    monkeypatch.setattr(tconfig.DEFAULT, "pallas_sort", request.param)
    return request.param


def _triples(rng, b, n):
    """Many ties, keys at both int32 extremes; row 0's idx is the iota,
    the other rows' a permutation."""
    k1 = rng.integers(0, max(4, n // 8), (b, n)).astype(np.int32)
    k2 = rng.integers(0, 16, (b, n)).astype(np.int32)
    k1[:, ::7] = INT32_MIN
    k1[:, 3::11] = INT32_BIG
    k2[:, 5::13] = INT32_BIG
    k2[:, 1::17] = INT32_MIN
    idx = np.stack([np.arange(n)] + [rng.permutation(n) for _ in range(b - 1)])
    return k1, k2, idx.astype(np.int32)


@pytest.mark.parametrize("n", [1024, 2048, 4096])
def test_sort3_plain_matches_lax_and_pallas(n):
    k1, k2, idx = _triples(np.random.default_rng(n), 3, n)
    got = sort_kernel.sort3_plain(*(torch.from_numpy(x) for x in (k1, k2, idx)))
    want = jax.vmap(lambda a, c, i: pallas_sort.sort3(a, c, i, interpret=True))(
        jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(idx))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the iota row: the stable sort by (k1, k2); every row: the triple sort
    stable = jax.lax.sort((jnp.asarray(k1[0]), jnp.asarray(k2[0]),
                           jnp.asarray(idx[0])), num_keys=2, is_stable=True)
    for g, w in zip(got, stable):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    for r in range(3):
        full = jax.lax.sort(tuple(jnp.asarray(x[r]) for x in (k1, k2, idx)),
                            num_keys=3)
        for g, w in zip(got, full):
            np.testing.assert_array_equal(g[r].numpy(), np.asarray(w))


def test_sort3_wrapper_envelope():
    z = torch.zeros((2, 1024), dtype=torch.int32)
    out = sort_kernel.sort3(z, z, torch.arange(1024, dtype=torch.int32).expand(2, 1024))
    assert all(o.shape == (2, 1024) for o in out)
    for n in (512, 3000, 1 << 19):
        bad = torch.zeros((1, n), dtype=torch.int32)
        with pytest.raises(ValueError, match="power of two"):
            sort_kernel.sort3(bad, bad, bad)
    with pytest.raises(ValueError, match="int32"):
        sort_kernel.sort3(z.long(), z.long(), z.long())
    assert sort_kernel.in_envelope(1 << 18) and not sort_kernel.in_envelope(1 << 17 | 1)


@pytest.mark.parametrize("n,log_t", [(1024, 10), (2048, 11), (4096, 12),
                                     (1 << 16, 12), (1 << 17, 12), (1 << 18, 12)])
def test_sort3_tile_choice(n, log_t):
    """Rows up to 2^12 are sorted as one tile (the high passes above a tile
    need 2^13 triples of a row); longer rows in 2^12 tiles."""
    assert sort_kernel.pick_log_tile(n) == log_t
    assert log_t == n.bit_length() - 1 or n >= 1 << 13


@pytest.mark.parametrize("n", [512, 2048])
def test_stable_sort3_dispatch(knob, monkeypatch, n):
    """Knob on and n inside the envelope: the wrapper runs (its plain
    version on the CPU); otherwise the packed int64 torch.sort.  Both are
    the stable sort by (key1, key2)."""
    rng = np.random.default_rng(n)
    k1 = rng.integers(-5, 5, (2, n)) * (2**31 // 5)
    k2 = rng.integers(0, 3, (2, n))
    k2[:, ::9] = INT32_BIG
    pay = np.broadcast_to(np.arange(n), (2, n)).copy()
    calls = []
    orig = sort_kernel.sort3
    monkeypatch.setattr(sort_kernel, "sort3",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    got = tbwt._stable_sort3(*(torch.from_numpy(x) for x in (k1, k2, pay)))
    assert calls == ([(2, n)] if knob and n >= 1024 else [])
    for r in range(2):
        want = jax.lax.sort(tuple(jnp.asarray(x[r], jnp.int32) for x in (k1, k2, pay)),
                            num_keys=2, is_stable=True)
        for g, w in zip(got, want):
            assert g.dtype == torch.int64
            np.testing.assert_array_equal(g[r].numpy(), np.asarray(w))


def _test_bwt_blocks(rng):
    """tests/test_bwt.py's sparse-refinement batch: text, a ragged slice,
    a periodic block, a small alphabet."""
    nmax, b = 2048, 4
    blocks = np.zeros((b, nmax), dtype=np.uint8)
    ns = np.array([2048, 1537, 1024, 900], dtype=np.int32)
    words = rng.integers(0, 5, 600)
    text = b"".join([b"the", b"quick", b"brown", b"fox ", b"jumps"][w] for w in words)
    blocks[0, :2048] = np.frombuffer(text[:2048], dtype=np.uint8)
    blocks[1, :1537] = np.frombuffer(text[100:1637], dtype=np.uint8)
    blocks[2, :1024] = np.tile(np.frombuffer(b"ab", dtype=np.uint8), 512)
    blocks[3, :900] = rng.integers(0, 4, 900, dtype=np.uint8)
    return blocks, ns


def _tier2_blocks(rng):
    nmax, b = 8192, 8
    blocks = rng.integers(0, 3, (b, nmax)).astype(np.uint8)
    ns = np.full(b, nmax, dtype=np.int32)
    ns[-1] = nmax - 777
    return blocks, ns


def _overflow_blocks(rng):
    nmax, b = 8192, 8
    motif = rng.integers(0, 200, 32, dtype=np.uint8)
    blocks = np.tile(motif, (b, nmax // 32))  # period 32: ties persist
    blocks[:, -64:] = rng.integers(0, 200, (b, 64))
    return blocks, np.full(b, nmax, dtype=np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("h_stop", [8, 16, 32])
def test_bwt_rounds_and_round_step_match_jax(knob, h_stop):
    blocks, ns = _test_bwt_blocks(np.random.default_rng(1234))
    jr = jax.jit(jax.vmap(lambda d, n: jbwt.bwt_rounds(d, n, h_stop)))(
        jnp.asarray(blocks), jnp.asarray(ns))
    tr = tbwt.bwt_rounds(torch.from_numpy(blocks), _t(ns), h_stop)
    for g, w in zip(tr, jr):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    # one more round from that state, at the batch-level gap
    js = jax.jit(jax.vmap(lambda r, t, n: jbwt.round_step(r, t, jnp.int32(h_stop), n)))(
        jr[0], jr[1], jnp.asarray(ns))
    ts = tbwt.round_step(tr[0], tr[1], h_stop, _t(ns))
    assert ts[2] == 2 * h_stop
    for i in (0, 1, 3):
        np.testing.assert_array_equal(ts[i].numpy().astype(np.int64),
                                      np.asarray(js[i]).astype(np.int64))


def _sparse_both(blocks, ns, h_stop):
    """tests/test_bwt.py's rounds(h_stop) -> host compaction ->
    sparse_refine, through bmh_tpu and through the port."""
    b, nmax = blocks.shape
    rank, tied, _, _ = jax.jit(jax.vmap(lambda d, n: jbwt.bwt_rounds(d, n, h_stop)))(
        jnp.asarray(blocks), jnp.asarray(ns))
    blk_idx, pos_idx = np.nonzero(np.asarray(tied).astype(bool))
    m_pad = 1 << max(blk_idx.size - 1, 1).bit_length()
    blk = np.full(m_pad, b, dtype=np.int32)
    pos = np.zeros(m_pad, dtype=np.int32)
    blk[: blk_idx.size] = blk_idx
    pos[: blk_idx.size] = pos_idx
    hm0 = np.zeros(m_pad, dtype=np.int32)
    hm0[: blk_idx.size] = h_stop % ns[blk_idx]
    want = jax.jit(jbwt.sparse_refine)(rank, jnp.asarray(blk), jnp.asarray(pos),
                                       jnp.asarray(hm0), jnp.asarray(ns),
                                       jnp.int32(h_stop))
    t_rank, t_tied, _, _ = tbwt.bwt_rounds(torch.from_numpy(blocks), _t(ns), h_stop)
    np.testing.assert_array_equal(t_tied.numpy(), np.asarray(tied).astype(bool))
    got = tbwt.sparse_refine(t_rank, _t(blk), _t(pos), _t(hm0), _t(ns), h_stop)
    full = jax.jit(jax.vmap(lambda d, n: jbwt.bwt_rounds(d, n)[0]))(
        jnp.asarray(blocks), jnp.asarray(ns))
    return got.numpy(), np.asarray(want), np.asarray(full), m_pad


@pytest.mark.parametrize("case,h_stop", [("text", 8), ("text", 16), ("text", 32),
                                         ("tier2", 8), ("tier2_overflow", 8)])
def test_sparse_refine_matches_jax(knob, case, h_stop):
    rng = np.random.default_rng(1234)
    blocks, ns = {"text": _test_bwt_blocks, "tier2": _tier2_blocks,
                  "tier2_overflow": _overflow_blocks}[case](rng)
    got, want, full, m_pad = _sparse_both(blocks, ns, h_stop)
    if case != "text":
        assert m_pad >= 4 * 4096  # the tiered path
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(got, full.astype(np.int64))


def test_sparse_compact_hm_no_overflow(knob):
    """bmh_tpu's hm-ladder regression: one odd-length block whose nb * q
    products pass int32 must hand off at the right gap."""
    rng = np.random.default_rng(1234)
    nmax, n = 65536, 53161
    pad = np.zeros(nmax, np.uint8)
    pad[:n] = rng.integers(0, 64, n).astype(np.uint8)
    ns = jnp.asarray([n], jnp.int32)
    rank, tied = jpipe._batched_rounds(nmax, 1)(jnp.asarray(pad)[None, :], ns)[:2]
    cap = jpipe._sparse_cap(1, nmax)
    assert cap == tpipe._sparse_cap(1, nmax)
    want = jpipe._sparse_refine_compact(rank, tied, ns, 1, nmax, cap, h0=jnp.int32(32))
    t_rank, t_tied, _, _ = tbwt.bwt_rounds(torch.from_numpy(pad[None, :]),
                                           torch.tensor([n]), 32)
    got = tpipe._sparse_refine_compact(t_rank, t_tied, torch.tensor([n]), cap, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    full, _, _, _ = tbwt.bwt_rounds(torch.from_numpy(pad[None, :]), torch.tensor([n]))
    np.testing.assert_array_equal(got[0, :n].numpy(), full[0, :n].numpy())


def _adaptive_blocks(rng):
    """A period-32 head of 1300 bytes per block: the batch's ~8 * (1300 - 2h)
    ties exceed the compact capacity (4096) until the gap reaches 1024."""
    blocks = rng.integers(0, 200, (8, 8192)).astype(np.uint8)
    blocks[:, :1300] = np.tile(rng.integers(0, 200, 32, dtype=np.uint8), 41)[:1300]
    return blocks, np.full(8, 8192, dtype=np.int32)


def _periodic_blocks(rng):
    blocks = np.tile(np.frombuffer(b"ab", dtype=np.uint8), (4, 1024))
    return blocks, np.full(4, 2048, dtype=np.int32)


@pytest.mark.parametrize("case,branches", [
    ("text", {"_sparse_refine_compact": 1}),
    ("adaptive", {"round_step": 5, "_sparse_refine_compact": 1}),
    ("periodic", {"round_step": 6, "resume": 1}),
])
def test_sparse_program_ranks_equal_full_rounds(knob, monkeypatch, case, branches):
    """The whole sparse/adaptive program lands on the full-rounds ranks
    through each of its branches: the compact refinement at once;
    whole-batch rounds past the capacity first; periodic blocks whose ties
    outlast every gap, the resume."""
    blocks, ns = {"text": _test_bwt_blocks, "adaptive": _adaptive_blocks,
                  "periodic": _periodic_blocks}[case](np.random.default_rng(1234))
    data, n = torch.from_numpy(blocks), _t(ns)
    full = tbwt.bwt_rounds(data, n)[0]
    calls = {"round_step": 0, "resume": 0, "_sparse_refine_compact": 0}

    def spy(mod, name, key):
        orig = getattr(mod, name)

        def f(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, f)

    spy(tbwt, "round_step", "round_step")
    spy(tbwt, "bwt_rounds_resume", "resume")
    spy(tpipe, "_sparse_refine_compact", "_sparse_refine_compact")
    got = tpipe.sparse_ranks(data, n, len(ns))
    calls["resume"] -= 1  # the first, inside bwt_rounds
    assert calls == {"round_step": 0, "resume": 0, "_sparse_refine_compact": 0,
                     **branches}
    np.testing.assert_array_equal(got.numpy(), full.numpy())
