"""Kernel K3: the inverse-MTF in-chunk scan (csrc/imtf.cu).

Replaces bmh_tpu/ops/pallas_mtf.py `imtf_chunks`.  `imtf_chunks_plain` is
the lax.scan branch of bmh_tpu's mtf_inverse written with tensors
(y = Q[c], then Q' = [y, Q[0..c-1], Q[c+1..]]); a CPU tensor runs it.  The
kernel gives every chunk lane a warp that holds the lane's list in
registers and skips the zero codes.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

ALPHABET = 256
_SRC = "imtf.cu"


def imtf_chunks_plain(codes_tm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """codes_tm (m, K) int32 time-major codes of K chunk lanes ->
    (ys (m, K) int32 per-step list positions, q (256, K) int32 each lane's
    whole-chunk permutation)."""
    m, k = codes_tm.shape
    dev = codes_tm.device
    p = torch.arange(ALPHABET, device=dev)[None, :]
    q = p.expand(k, ALPHABET).to(torch.int32).contiguous()
    ys = torch.empty((m, k), dtype=torch.int32, device=dev)
    for t in range(m):
        c = codes_tm[t].to(torch.int64)[:, None]
        y = torch.gather(q, 1, c)
        q = torch.where(p == 0, y, torch.where(p <= c, torch.roll(q, 1, 1), q))
        ys[t] = y[:, 0]
    return ys, q.T.contiguous()


def imtf_chunks(codes_tm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The in-chunk scan: plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor."""
    if not _build.on_card(codes_tm, "imtf_chunks"):
        return imtf_chunks_plain(codes_tm)
    if codes_tm.dtype != torch.int32 or not codes_tm.is_contiguous():
        raise ValueError("imtf_chunks: needs contiguous int32 (m, K) codes")
    m, k = codes_tm.shape
    ys = torch.empty((m, k), dtype=torch.int32, device=codes_tm.device)
    q = torch.empty((ALPHABET, k), dtype=torch.int32, device=codes_tm.device)
    fn = _build.lib(_SRC).bmh_imtf_chunks
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.count_launch("imtf_chunks")
    with _build.on_device(codes_tm) as stream:
        _build.check(fn(codes_tm.data_ptr(), ys.data_ptr(), q.data_ptr(), m, k,
                        stream), "imtf_chunks")
    return ys, q
