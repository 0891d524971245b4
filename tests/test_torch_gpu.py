"""bmh_tpu_torch on a CUDA card: each kernel against its plain PyTorch
version, and the codec round trip against its CPU run.

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
from bmh_tpu_torch.utils import config

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


def test_ibwt_kernel_matches_plain(cuda):
    g = torch.Generator(device="cpu").manual_seed(4)
    b, nmax, k = 5, 8192, 2
    rows = torch.stack([torch.randperm(nmax, generator=g) for _ in range(b)])
    byte = torch.randint(0, 256, (b, nmax), generator=g)
    table = ((byte << 23) | rows).to(torch.int32).to(cuda)
    starts = torch.randint(0, nmax, (b, k), generator=g, dtype=torch.int32).to(cuda)
    assert torch.equal(ibwt_kernel.ibwt_walk(table, starts, nmax // k),
                       ibwt_kernel.ibwt_walk_plain(table, starts, nmax // k))


@pytest.mark.parametrize("b,n", [(3, 1024), (32, 1 << 17), (1, 1 << 18)])
def test_sort3_kernel_matches_plain(cuda, b, n):
    """K5 at its envelope's floor, the 32-block doubling-round shape and
    the sparse tier-1 shape; many ties, keys at both int32 extremes."""
    g = torch.Generator(device="cpu").manual_seed(n)
    k1 = torch.randint(0, max(4, n // 64), (b, n), generator=g, dtype=torch.int32)
    k2 = torch.randint(0, 8, (b, n), generator=g, dtype=torch.int32)
    k1[:, ::7] = -(2**31)
    k2[:, 3::11] = 2**31 - 1
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
    bad = torch.zeros((1, 4096), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        sort_kernel.sort3(bad, bad, bad[:, ::2].contiguous())
    with pytest.raises(ValueError):
        sort_kernel.sort3(*(torch.zeros((2, 2048), dtype=torch.int32, device=cuda)[:, ::2]
                            for _ in range(3)))
