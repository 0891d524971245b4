"""Move-to-front, both directions, batched over (B, Nmax) rows.

Port of bmh_tpu/ops/mtf.py.

* Forward: the code at position i is the number of distinct symbols whose
  latest occurrence lies strictly between the previous occurrence of
  data[i] and i.  Each chunk is extended with the 256 symbols of its
  incoming list (least recent first, recovered by a running max of
  per-chunk last-occurrence tables), and the code becomes the windowed
  count #{j : prev[i] < j < i, prev[j] <= prev[i]} inside the extended
  chunk.
* Inverse: each chunk lane runs the in-chunk scan from the identity list
  (kernel K3, ops/imtf_kernel.py); whole-chunk permutations are then
  composed across chunks by a log-depth scan, and every step's list
  position is looked up in its chunk's incoming list.
"""

from __future__ import annotations

import torch

from . import imtf_kernel

ALPHABET = 256
_NEG_BIG = -(2**30)
_IMTF_MIN_LANES = 128  # lanes per block of the in-chunk scan (bmh_tpu's TILE)
_FORWARD_SLICE = 1 << 26  # elements of the (chunks, m, ext) window compare per pass


def mtf_forward(data: torch.Tensor, n: torch.Tensor, chunk: int) -> torch.Tensor:
    """data (B, Nmax) uint8, n (B,) -> (B, Nmax) uint8 codes, zero past n."""
    b, nmax = data.shape
    assert nmax % chunk == 0, "Nmax must be a multiple of the MTF chunk size"
    dev = data.device
    k, m = nmax // chunk, chunk
    ext = ALPHABET + m
    sym = data.to(torch.int64).reshape(b, k, m)
    pos = torch.arange(nmax, device=dev).reshape(1, k, m).expand(b, k, m)

    # last occurrence of each symbol within each chunk (global position)
    last_occ = torch.full((b, k, ALPHABET), _NEG_BIG, dtype=torch.int64, device=dev)
    last_occ.scatter_reduce_(2, sym, pos.contiguous(), "amax")
    # incoming recency per chunk: exclusive running max over chunks, seeded
    # with the initial list's virtual times -(s+1) (front = most recent)
    virt = -(torch.arange(ALPHABET, device=dev) + 1)
    run_max = torch.cummax(last_occ, dim=1).values
    incoming = torch.cat([virt.expand(b, 1, ALPHABET),
                          torch.maximum(run_max[:, :-1], virt)], dim=1)
    # recencies are distinct, so the ascending order is unique
    prefix_syms = torch.argsort(incoming, dim=-1)
    e = torch.cat([prefix_syms, sym], dim=-1).reshape(b * k, ext)

    # previous occurrence inside the extended chunk: sort (symbol, index)
    # pairs packed in one key, link equal neighbours, scatter back
    sh = ext.bit_length()
    j_idx = torch.arange(ext, device=dev).expand(b * k, ext)
    ps = torch.sort((e << sh) | j_idx, dim=-1).values
    sv, sj = ps >> sh, ps & ((1 << sh) - 1)
    same = torch.nn.functional.pad(sv[:, 1:] == sv[:, :-1], (1, 0))
    prev_sorted = torch.where(same, torch.nn.functional.pad(sj[:, :-1], (1, 0)), -1)
    prev = torch.empty_like(prev_sorted).scatter_(1, sj, prev_sorted)

    # windowed distinct count, in slices of chunks to bound the
    # (chunks, m, ext) intermediate
    i_loc = torch.arange(ALPHABET, ext, device=dev)[:, None]   # (m, 1)
    j_loc = torch.arange(ext, device=dev)[None, :]             # (1, ext)
    before = (j_loc < i_loc)[None]                             # (1, m, ext)
    codes = torch.empty((b * k, m), dtype=torch.int64, device=dev)
    step = max(1, _FORWARD_SLICE // (m * ext))
    for s in range(0, b * k, step):
        pv = prev[s:s + step]
        t_i = pv[:, ALPHABET:, None]                           # (c, m, 1)
        inside = before & (j_loc[None] > t_i) & (pv[:, None, :] <= t_i)
        codes[s:s + step] = inside.sum(dim=-1)
    out = codes.reshape(b, nmax)
    p = torch.arange(nmax, device=dev)[None, :]
    return torch.where(p < n[:, None], out, 0).to(torch.uint8)


def _compose_scan(pi: torch.Tensor) -> torch.Tensor:
    """Inclusive scan over dim 1 of permutations under
    compose(a, b)[p] = a[b[p]] (Hillis-Steele doubling)."""
    k = pi.shape[1]
    d = 1
    while d < k:
        nxt = pi.clone()
        nxt[:, d:] = torch.gather(pi[:, :-d], 2, pi[:, d:])
        pi = nxt
        d *= 2
    return pi


def mtf_inverse(codes: torch.Tensor, n: torch.Tensor, imtf_chunk: int) -> torch.Tensor:
    """codes (B, Nmax) uint8 -> (B, Nmax) uint8 symbols, zero past n."""
    b, nmax = codes.shape
    dev = codes.device
    k0 = max(nmax // imtf_chunk, _IMTF_MIN_LANES)
    chunk = max(nmax // k0, 1)
    assert nmax % chunk == 0
    k, m = nmax // chunk, chunk
    c_tm = codes.reshape(b * k, m).T.to(torch.int32).contiguous()  # (m, B*k)
    ys, qf = imtf_kernel.imtf_chunks(c_tm)
    pi = qf.T.reshape(b, k, ALPHABET).to(torch.int64)
    ident = torch.arange(ALPHABET, device=dev).expand(b, 1, ALPHABET)
    if k > 1:
        incoming = torch.cat([ident, _compose_scan(pi)[:, :-1]], dim=1)
    else:
        incoming = ident
    y = ys.T.reshape(b, k, m).to(torch.int64)
    syms = torch.gather(incoming, 2, y).reshape(b, nmax)
    p = torch.arange(nmax, device=dev)[None, :]
    return torch.where(p < n[:, None], syms, 0).to(torch.uint8)
