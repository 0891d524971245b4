"""Kernel K4: the inverse-BWT cursor walk (csrc/ibwt_walk.cu).

Replaces bmh_tpu/ops/pallas_ibwt.py `ibwt_walk`.  In bmh_tpu the walk runs
as the XLA scan of ops/bwt.py bwt_inverse_cursors, over the self-composed
LF² table for blocks <= 64 KiB; `ibwt_walk_plain` is that scan written with
tensors, and is what a CPU tensor runs.

The table holds the uint32 entries (byte << 23) | next_row in int32
storage.  Two modes:

* hop 1: one dependent load and one byte a step;
* hop 16 (rows only): the table's row links are first composed with
  themselves by four doubling gathers into links 16 steps long.  The
  dependent walk makes steps / 16 loads and only records the row it stands
  on before each; a pass with one independent thread per recorded row then
  reads the 16 bytes from there off the source table.

Output bytes are the low 8 bits of an entry's byte field in both modes: pad
rows (byte field 256, linking to themselves) are never reached from a real
cursor start, and a start clamped onto one emits zeros.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SRC = "ibwt_walk.cu"
_LF_MASK = (1 << 23) - 1
HOP = 16              # LF steps one composed link covers
COMPOSE, WALK = 1, 2  # `parts` bits of `launch`


def _check_hop(steps: int, hop: int) -> None:
    if hop not in (1, HOP) or steps % hop:
        raise ValueError(f"ibwt_walk: hop {hop} must be 1 or {HOP} and "
                         f"divide steps ({steps})")


def compose_plain(table: torch.Tensor) -> torch.Tensor:
    """The table's row links composed to HOP steps by doubling gathers:
    (B, Nmax) int64."""
    links = table.to(torch.int64) & _LF_MASK
    for _ in range(HOP.bit_length() - 1):
        links = torch.gather(links, 1, links)
    return links


def ibwt_walk_plain(table: torch.Tensor, starts: torch.Tensor, steps: int,
                    hop: int = 1) -> torch.Tensor:
    """table (B, Nmax) int32, starts (B, k) int32 -> (B, k, steps) uint8,
    walking `hop` rows a step."""
    _check_hop(steps, hop)
    b, k = starts.shape
    t64 = table.to(torch.int64) & 0xFFFFFFFF
    rows = starts.to(torch.int64)
    emit = steps  # bytes read off the source table from each row of `rows`
    if hop > 1:
        # record each cursor's row every `hop` steps along the composed
        # links; the `hop` bytes after every recorded row are then read
        links = compose_plain(table)
        visited = torch.empty((b, k, steps // hop), dtype=torch.int64,
                              device=table.device)
        for s in range(steps // hop):
            visited[:, :, s] = rows
            rows = torch.gather(links, 1, rows)
        rows, emit = visited.reshape(b, -1), hop
    out = torch.empty(rows.shape + (emit,), dtype=torch.uint8,
                      device=table.device)
    for s in range(emit):
        g = torch.gather(t64, 1, rows)
        out[:, :, s] = ((g >> 23) & 0xFF).to(torch.uint8)
        rows = g & _LF_MASK
    return out.reshape(b, k, steps)


def _check_inputs(table: torch.Tensor, starts: torch.Tensor) -> None:
    if (table.dim() != 2 or starts.dim() != 2
            or table.dtype != torch.int32 or starts.dtype != torch.int32
            or starts.shape[0] != table.shape[0] or starts.device != table.device
            or not table.is_contiguous() or not starts.is_contiguous()):
        raise ValueError("ibwt_walk: needs contiguous int32 (B, Nmax) table "
                         "and (B, k) starts on one device")


def scratch_for(table: torch.Tensor, starts: torch.Tensor, steps: int, hop: int):
    """The buffer the compose kernels fill, in int32 words: None for hop 1,
    else two link tables and the recorded rows."""
    if hop == 1:
        return None
    words = 2 * table.numel() + starts.numel() * (steps // hop)
    return torch.empty(words, dtype=torch.int32, device=table.device)


def launch(table, starts, out, scratch, steps: int, hop: int,
           parts: int = COMPOSE | WALK) -> None:
    """One call into the library: the compose kernels, the walk kernels or
    both (`parts`), on the current stream.  `ibwt_walk` is the wrapper; this
    is what it and the timing of the parts go through."""
    b, nmax = table.shape
    fn = _build.lib(_SRC).bmh_ibwt_walk
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with _build.on_device(table) as stream:
        _build.check(fn(table.data_ptr(), starts.data_ptr(), out.data_ptr(),
                        None if scratch is None else scratch.data_ptr(),
                        b, nmax, starts.shape[1], steps, hop, parts, stream),
                     "ibwt_walk")


def ibwt_walk(table: torch.Tensor, starts: torch.Tensor, steps: int,
              hop: int = 1) -> torch.Tensor:
    """The walk: plain version for a CPU tensor, the CUDA kernels (compose,
    then walk) for a CUDA tensor."""
    if not _build.on_card(table, "ibwt_walk"):
        return ibwt_walk_plain(table, starts, steps, hop)
    _check_inputs(table, starts)
    _check_hop(steps, hop)
    if table.shape[1] > _LF_MASK + 1:
        raise ValueError("ibwt_walk: Nmax above 2^23 does not fit the row field")
    out = torch.empty(starts.shape + (steps,), dtype=torch.uint8,
                      device=table.device)
    _build.count_launch("ibwt_walk")
    launch(table, starts, out, scratch_for(table, starts, steps, hop), steps, hop)
    return out
