"""Kernels K1 and K2: the gap-decode FSM phases (csrc/gap_decode.cu).

Replace bmh_tpu/ops/pallas_decode.py `phase_a` and `phase_b`.  The plain
versions are bmh_tpu's `phase_a_scan` / `phase_b_scan` written with
tensors, reading bits from the packed words; a CPU tensor runs them.

Inputs: wext (wpc+1, NC) int32 holding the uint32 payload words in
words_ext layout (ops/huffman.py), count_t (32, NC) int32 per-chunk
per-length codeword counts (counts: none below 0), maxl the longest code
length to consider.

Both kernels decode a codeword a turn from per-length limits that they sum
from the counts.  K1's walks each of a chunk's distinct decodes once, in
shared memory or, for chunks too long for it, in a global scratch buffer
that its wrapper allocates; K2's gathers each chunk's indices in windows
of steps that a warp stores 16 bytes a lane, into rows padded to a
multiple of 32 chunks (the wrapper returns the (steps, NC) view).  Both
take any chunk size that `_check` accepts.  Both plain versions run the
FSM a bit a step for every lane, as bmh_tpu does.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

GAPS = 32
AMAX = 256  # canonical-index clip ceiling (257-symbol RLE0 alphabet)
ROW_ALIGN = 32  # K2's output rows: chunks, a multiple of a warp's
_SRC = "gap_decode.cu"


def _bit(w64: torch.Tensor, t: int) -> torch.Tensor:
    return (w64[t >> 5] >> (31 - (t & 31))) & 1


def _count_at(ct: torch.Tensor, ln: torch.Tensor, maxl: int) -> torch.Tensor:
    """ct[ln, chunk] for 1 <= ln <= maxl, else 0."""
    c = torch.gather(ct, 0, ln.clamp(max=ct.shape[0] - 1))
    return torch.where(ln <= maxl, c, 0)


def phase_a_plain(wext: torch.Tensor, count_t: torch.Tensor, chunk_bits: int,
                  maxl: int) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (cnt_map, exit_map), both (32, NC) int32: per (gap, chunk) lane,
    the symbols completed and the exit gap past the chunk end."""
    nc = wext.shape[1]
    dev = wext.device
    w64 = wext.to(torch.int64) & 0xFFFFFFFF
    ct = count_t.to(torch.int64)
    gaps = torch.arange(GAPS, device=dev)[:, None]
    z = torch.zeros((GAPS, nc), dtype=torch.int64, device=dev)
    r, ln, c, cnt, ex = z, z, z, z, z - 1
    for t in range(chunk_bits + GAPS):
        active = (ex < 0) & (t >= gaps)
        r_n = 2 * (r - c) + _bit(w64, t)[None, :]
        ln_n = ln + 1
        c_n = _count_at(ct, ln_n, maxl)
        complete = (c_n > 0) & (r_n >= 0) & (r_n < c_n)
        reset = complete | (ln_n > maxl)
        fire = active & complete
        r = torch.where(active, torch.where(reset, 0, r_n), r)
        ln = torch.where(active, torch.where(reset, 0, ln_n), ln)
        c = torch.where(active, torch.where(reset, 0, c_n), c)
        cnt = torch.where(fire, cnt + 1, cnt)
        ex = torch.where(fire & (t + 1 >= chunk_bits), t + 1 - chunk_bits, ex)
    return cnt.to(torch.int32), ex.clamp(0, GAPS - 1).to(torch.int32)


def phase_b_plain(wext: torch.Tensor, count_t: torch.Tensor, entry: torch.Tensor,
                  chunk_bits: int, maxl: int) -> torch.Tensor:
    """-> (chunk_bits + 32, NC) int32: the canonical index completed at each
    step of each chunk's winning lane (clipped to 256), or -1."""
    nc = wext.shape[1]
    dev = wext.device
    steps = chunk_bits + GAPS
    w64 = wext.to(torch.int64) & 0xFFFFFFFF
    ct = count_t.to(torch.int64)
    e = entry.to(torch.int64)[None, :]
    z = torch.zeros((1, nc), dtype=torch.int64, device=dev)
    r, ln, c, o, done = z, z, z, z, torch.zeros((1, nc), dtype=torch.bool, device=dev)
    out = torch.empty((steps, nc), dtype=torch.int32, device=dev)
    for t in range(steps):
        active = ~done & (t >= e)
        r_n = 2 * (r - c) + _bit(w64, t)[None, :]
        ln_n = ln + 1
        c_n = _count_at(ct, ln_n, maxl)
        complete = (c_n > 0) & (r_n >= 0) & (r_n < c_n)
        reset = complete | (ln_n > maxl)
        fire = active & complete
        out[t] = torch.where(fire, (o + r_n).clamp(0, AMAX), -1)[0]
        r = torch.where(active, torch.where(reset, 0, r_n), r)
        ln = torch.where(active, torch.where(reset, 0, ln_n), ln)
        c = torch.where(active, torch.where(reset, 0, c_n), c)
        o = torch.where(active, torch.where(reset, 0, o + c_n), o)
        done = done | (fire & (t + 1 >= chunk_bits))
    return out


def _check(wext, count_t, chunk_bits, maxl, name):
    if (wext.dtype != torch.int32 or count_t.dtype != torch.int32
            or wext.dim() != 2 or not wext.is_contiguous()
            or not count_t.is_contiguous()
            or count_t.shape != (GAPS, wext.shape[1])
            or count_t.device != wext.device):
        raise ValueError(f"{name}: needs contiguous int32 wext (wpc+1, NC) "
                         "and count_t (32, NC) on one device")
    if (chunk_bits <= 0 or chunk_bits % 32
            or wext.shape[0] != chunk_bits // 32 + 1):
        raise ValueError(f"{name}: chunk_bits must be a positive multiple of "
                         f"32 with wext of chunk_bits / 32 + 1 rows, got "
                         f"{chunk_bits} and {wext.shape[0]} rows")
    if not 1 <= maxl <= GAPS - 1:
        raise ValueError(f"{name}: maxl must lie in 1..31, got {maxl}")


def phase_a(wext: torch.Tensor, count_t: torch.Tensor, chunk_bits: int,
            maxl: int) -> tuple[torch.Tensor, torch.Tensor]:
    _check(wext, count_t, chunk_bits, maxl, "phase_a")
    if not _build.on_card(wext, "phase_a"):
        return phase_a_plain(wext, count_t, chunk_bits, maxl)
    nc = wext.shape[1]
    cnt = torch.empty((GAPS, nc), dtype=torch.int32, device=wext.device)
    ex = torch.empty((GAPS, nc), dtype=torch.int32, device=wext.device)
    lib = _build.lib(_SRC)
    size = lib.bmh_phase_a_scratch_bytes
    size.argtypes = [ctypes.c_int] * 2
    size.restype = ctypes.c_size_t
    # K1's arrays where a chunk's do not fit in shared memory (else empty)
    scratch = torch.empty(size(nc, chunk_bits), dtype=torch.uint8, device=wext.device)
    fn = lib.bmh_phase_a
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.count_launch("gap_decode_phase_a")
    with _build.on_device(wext) as stream:
        _build.check(fn(wext.data_ptr(), count_t.data_ptr(), cnt.data_ptr(),
                        ex.data_ptr(), scratch.data_ptr(), nc, chunk_bits, maxl,
                        stream), "gap_decode_phase_a")
    return cnt, ex


def phase_b(wext: torch.Tensor, count_t: torch.Tensor, entry: torch.Tensor,
            chunk_bits: int, maxl: int) -> torch.Tensor:
    _check(wext, count_t, chunk_bits, maxl, "phase_b")
    if not _build.on_card(wext, "phase_b"):
        return phase_b_plain(wext, count_t, entry, chunk_bits, maxl)
    nc = wext.shape[1]
    if (entry.dtype != torch.int32 or entry.shape != (nc,)
            or not entry.is_contiguous() or entry.device != wext.device):
        raise ValueError("phase_b: needs contiguous int32 (NC,) entry gaps")
    # rows padded to whole warps of chunks: each warp's part of a row is one
    # aligned 128-byte line; the result is the (steps, NC) view
    ld = -(-nc // ROW_ALIGN) * ROW_ALIGN
    out = torch.empty((chunk_bits + GAPS, ld), dtype=torch.int32, device=wext.device)
    fn = _build.lib(_SRC).bmh_phase_b
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.count_launch("gap_decode_phase_b")
    with _build.on_device(wext) as stream:
        _build.check(fn(wext.data_ptr(), count_t.data_ptr(), entry.data_ptr(),
                        out.data_ptr(), nc, ld, chunk_bits, maxl, stream),
                     "gap_decode_phase_b")
    return out[:, :nc]
