"""bmh_tpu_torch kernels K1-K4: each plain PyTorch version against its
Pallas function in interpret mode and against bmh_tpu's scan formulation,
on the same numpy inputs.  Integer outputs are compared exactly."""

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
from bmh_tpu_torch.ops import bwt as tbwt
from bmh_tpu_torch.ops import decode_kernels as tdk
from bmh_tpu_torch.ops import huffman as thuf
from bmh_tpu_torch.ops import ibwt_kernel, imtf_kernel

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


def test_ibwt_cursors_match_jax(rng):
    """Several cursors per block (Nmax > stride): the port's LF¹ walk
    against bmh_tpu's bwt_inverse_cursors (which walks LF² at this size)."""
    nmax, b = 16384, 3
    _, _, ns, lasts, shifts, cpss = _lf_tables(rng, nmax, b)
    stride = jbwt.CURSOR_STRIDE
    got = tbwt.bwt_inverse_cursors(
        torch.from_numpy(np.stack(lasts)), torch.tensor(shifts),
        torch.from_numpy(np.stack(cpss).astype(np.int64)), torch.tensor(ns), stride)
    for i in range(b):
        want = np.asarray(jax.jit(jbwt.bwt_inverse_cursors)(
            jnp.asarray(lasts[i]), jnp.int32(shifts[i]), jnp.asarray(cpss[i]),
            jnp.int32(ns[i])))
        np.testing.assert_array_equal(got[i].numpy(), want)
