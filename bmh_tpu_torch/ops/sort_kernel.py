"""Kernel K5: the sort of (k1, k2, idx) triples (csrc/sort3.cu).

Replaces bmh_tpu/ops/pallas_sort.py `sort3`.  Each row of (B, N) int32
inputs, N a power of two in [MIN_N, MAX_N], comes out ascending by the
triple (k1, k2, idx); with distinct triples (the precondition) that is the
stable sort by (k1, k2).  A row is one vmapped call of bmh_tpu's kernel.

`sort3_plain` is the same bitonic network as whole-tensor compare-exchange
steps in bmh_tpu's (k, j) schedule (`pallas_sort._schedule`: the partner of
element e is e ^ (1 << j), bit k of e picks the direction); a CPU tensor
runs it.  The kernel runs the same network cut into tiles (registers,
warp shuffles, one shared-memory trip per stage); with distinct triples
the sorted result is unique, so any cut equals the plain version exactly.
The library sort that K5 is timed against, `torch.sort`, is not its plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MIN_N = 1024     # bmh_tpu's floor (8 sublanes x 128 lanes)
MAX_N = 1 << 18  # bmh_tpu's _PALLAS_SORT_MAX
_SRC = "sort3.cu"
_LOG_TILE = 12   # the tile rows are sorted in; shorter rows are one tile
TILE_SORT, HIGH_PASSES, MERGE_PASSES = 1, 2, 4  # `kinds` bits of `launch`
ALL_KINDS = TILE_SORT | HIGH_PASSES | MERGE_PASSES


def in_envelope(n: int) -> bool:
    """Row lengths K5 takes: a power of two in [MIN_N, MAX_N]."""
    return MIN_N <= n <= MAX_N and n & (n - 1) == 0


def _lex_gt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a > b lexicographically over the leading (k1, k2, idx) axis."""
    return (a[0] > b[0]) | ((a[0] == b[0]) & (
        (a[1] > b[1]) | ((a[1] == b[1]) & (a[2] > b[2]))))


def sort3_plain(k1: torch.Tensor, k2: torch.Tensor, idx: torch.Tensor):
    """The bitonic network over whole (B, N) tensors, step by step."""
    b, n = k1.shape
    p = n.bit_length() - 1
    t = torch.stack([k1, k2, idx])
    for k in range(1, p + 1):
        for j in range(k - 1, -1, -1):
            d = 1 << j
            # pairs (e, e + d) with bit j of e clear: v[..., q, 0, r] is the
            # element e = 2dq + r, v[..., q, 1, r] its partner
            v = t.view(3, b, n // (2 * d), 2, d)
            lo, hi = v[:, :, :, 0, :].clone(), v[:, :, :, 1, :].clone()
            q = torch.arange(n // (2 * d), device=t.device)[:, None]
            asc = ((q >> (k - j - 1)) & 1) == 0  # bit k of e
            swap = torch.where(asc, _lex_gt(lo, hi), _lex_gt(hi, lo))
            v[:, :, :, 0, :] = torch.where(swap, hi, lo)
            v[:, :, :, 1, :] = torch.where(swap, lo, hi)
    return t[0], t[1], t[2]


def pick_log_tile(n: int) -> int:
    """log2 of the tile K5 sorts rows of n triples with: 2^12, or the whole
    row below that.  Measured on the H100: two 512-thread blocks to an SM
    overlap their loads, steps and stores, which pays more than the pass
    per stage that a 2^13 tile saves; smaller tiles only add passes."""
    return min(_LOG_TILE, n.bit_length() - 1)


def launch(k1, k2, idx, out, log_t: int, kinds: int = ALL_KINDS) -> None:
    """One call into the library on the current stream: the launches of
    `kinds` (TILE_SORT | HIGH_PASSES | MERGE_PASSES) at tile 2^log_t.
    `sort3` is the wrapper; this is what it and the timing of one kind of
    launch go through."""
    b, n = k1.shape
    fn = _build.lib(_SRC).bmh_sort3
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with _build.on_device(k1) as stream:
        _build.check(fn(k1.data_ptr(), k2.data_ptr(), idx.data_ptr(),
                        *(o.data_ptr() for o in out), b, n.bit_length() - 1,
                        log_t, kinds, stream), "sort3")


def sort3(k1: torch.Tensor, k2: torch.Tensor, idx: torch.Tensor):
    """The sort: plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor.  Raises ValueError outside the envelope."""
    if (k1.dim() != 2 or any(x.shape != k1.shape or x.dtype != torch.int32
                             or x.device != k1.device for x in (k1, k2, idx))):
        raise ValueError("sort3: needs three int32 (B, N) tensors on one device")
    n = k1.shape[1]
    if not in_envelope(n):
        raise ValueError(f"sort3: row length {n} is not a power of two in "
                         f"[{MIN_N}, {MAX_N}]")
    if not _build.on_card(k1, "sort3"):
        return sort3_plain(k1, k2, idx)
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in (k1, k2, idx)):
        raise ValueError("sort3: needs contiguous, 16-byte aligned inputs")
    out = tuple(torch.empty_like(k1) for _ in range(3))
    _build.count_launch("sort3")
    launch(k1, k2, idx, out, pick_log_tile(n))
    return out
