"""Kernel K4: the inverse-BWT cursor walk (csrc/ibwt_walk.cu).

Replaces bmh_tpu/ops/pallas_ibwt.py `ibwt_walk`.  In bmh_tpu the walk runs
as the XLA scan of ops/bwt.py bwt_inverse_cursors; `ibwt_walk_plain` is
that scan written with tensors, and is what a CPU tensor runs.

The table holds the uint32 entries (byte << 23) | next_row in int32
storage.  Output bytes are the low 8 bits of the entry's byte field: pad
rows (byte field 256) are never reached from a real cursor start, and
bmh_tpu's final uint8 cast maps them to the same value anyway.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SRC = "ibwt_walk.cu"


def ibwt_walk_plain(table: torch.Tensor, starts: torch.Tensor,
                    steps: int) -> torch.Tensor:
    """table (B, Nmax) int32, starts (B, k) int32 -> (B, k, steps) uint8."""
    t64 = table.to(torch.int64) & 0xFFFFFFFF
    rows = starts.to(torch.int64)
    out = torch.empty(starts.shape + (steps,), dtype=torch.uint8,
                      device=table.device)
    for s in range(steps):
        g = torch.gather(t64, 1, rows)
        out[:, :, s] = ((g >> 23) & 0xFF).to(torch.uint8)
        rows = g & ((1 << 23) - 1)
    return out


def ibwt_walk(table: torch.Tensor, starts: torch.Tensor,
              steps: int) -> torch.Tensor:
    """The walk: plain version for a CPU tensor, the CUDA kernel for a
    CUDA tensor."""
    if not _build.on_card(table, "ibwt_walk"):
        return ibwt_walk_plain(table, starts, steps)
    b, nmax = table.shape
    k = starts.shape[1]
    if (table.dtype != torch.int32 or starts.dtype != torch.int32
            or starts.shape[0] != b or starts.device != table.device
            or not table.is_contiguous() or not starts.is_contiguous()):
        raise ValueError("ibwt_walk: needs contiguous int32 (B, Nmax) table "
                         "and (B, k) starts on one device")
    out = torch.empty((b, k, steps), dtype=torch.uint8, device=table.device)
    fn = _build.lib(_SRC).bmh_ibwt_walk
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.LAUNCHES["ibwt_walk"] += 1
    _build.check(fn(table.data_ptr(), starts.data_ptr(), out.data_ptr(),
                    b, nmax, k, steps,
                    torch.cuda.current_stream(table.device).cuda_stream),
                 "ibwt_walk")
    return out
