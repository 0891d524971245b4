"""Burrows-Wheeler transform: prefix doubling forward, LF-cursor walk inverse.

Port of bmh_tpu/ops/bwt.py, batched over rows of a (B, Nmax) tensor with
per-row true lengths.  The forward runs the classic full-rounds program
(bmh_tpu's `compress_full_fn`): doubling rounds to convergence, then the
gather-free finish that yields the last column, the shift, the cursor
checkpoints and the aperiodic flag.  The sorted order of rotations is
unique, so this gives the same bytes as bmh_tpu's sparse/adaptive program.

uint32 quantities of the JAX version (the biased 4-byte init rank, the
packed LF keys) are carried in int64 here: torch's uint32 has no shifts or
comparisons on the CPU.  Multi-key sorts become one packed int64 key.
"""

from __future__ import annotations

import torch

from . import ibwt_kernel

INT32_BIG = 2**31 - 1
_LF_SHIFT = 23


def _init_rank(data: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """First four bytes of each rotation packed into 32 bits, mapped to
    signed order (v ^ 0x80000000 as int32 == v - 2^31); pads INT32_BIG.

    The cyclic next bytes follow bmh_tpu's three rolls exactly (including
    its wrap for n < 4), as index arithmetic modulo Nmax."""
    b, nmax = data.shape
    pos = torch.arange(nmax, device=data.device).expand(b, nmax)
    nn = n[:, None]
    d = data.to(torch.int64)

    def cyc(j):
        idx = torch.where(pos < nn - j, pos + j,
                          torch.where(pos < 2 * nn - j, pos + j - nn,
                                      pos + j - 2 * nn)) % nmax
        return torch.gather(d, 1, idx)

    v = (d << 24) | (cyc(1) << 16) | (cyc(2) << 8) | cyc(3)
    return torch.where(pos < nn, v - 2**31, INT32_BIG)


def _round_body(rank: torch.Tensor, h: int, n: torch.Tensor):
    """One prefix-doubling round with head-index ranks: rank[i] becomes the
    sorted position of the first member of i's tie group under the key
    (rank[i], rank[(i + h) mod n]).  Returns (new rank, done (B,) bool)."""
    b, nmax = rank.shape
    dev = rank.device
    pos = torch.arange(nmax, device=dev).expand(b, nmax)
    nn = n[:, None]
    real = pos < nn
    h_mod = h % torch.clamp(nn, min=1)
    idx = torch.where(pos < nn - h_mod, pos + h_mod, pos + h_mod - nn)
    rank2 = torch.gather(rank, 1, idx.clamp(0, nmax - 1))
    rank2 = torch.where(real, rank2, INT32_BIG)
    # (rank, rank2) as one int64 key: both lie in int32 range.  Head-index
    # ranks depend only on key equality, so the sort need not be stable.
    key = (rank << 32) + (rank2 + 2**31)
    k_sorted, order = torch.sort(key, dim=1)
    changed = torch.nn.functional.pad(k_sorted[:, 1:] != k_sorted[:, :-1], (1, 0))
    new_rank_sorted = torch.cummax(torch.where(changed, pos, 0), dim=1).values
    new_rank = torch.empty_like(rank).scatter_(1, order, new_rank_sorted)
    n_distinct = (changed & real).sum(dim=1)
    return new_rank, n_distinct >= n - 1


def bwt_rounds(data: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Doubling rounds until every row's ranks are distinct or h >= Nmax.

    Rows that converge stop changing (bmh_tpu vmaps a while_loop, which
    freezes a finished row's carry); only the rows still running are sorted
    in each round.  Returns (B, Nmax) int64 head-index ranks (raw init
    ranks for rows with n <= 1, which run no round)."""
    nmax = data.shape[1]
    rank = _init_rank(data, n)
    active = (n > 1).nonzero().flatten()
    h = 4
    while h < nmax and active.numel():
        sub, done = _round_body(rank[active], h, n[active])
        rank[active] = sub
        active = active[~done]
        h *= 2
    return rank


def bwt_forward_cp(data: torch.Tensor, n: torch.Tensor, stride: int):
    """BWT forward with inverse-walk checkpoints.

    data (B, Nmax) uint8, n (B,) int64.  Returns (last (B, Nmax) uint8,
    shift (B,) int64, cps (B, max(Nmax // stride, 1)) int64 with
    cps[j] = rank[((j+1) * stride) % n], aperiodic (B,) bool)."""
    b, nmax = data.shape
    dev = data.device
    rank = bwt_rounds(data, n)
    pos = torch.arange(nmax, device=dev).expand(b, nmax)
    nn = n[:, None]
    real = pos < nn
    # prev[i] = data[(i-1) mod n]: a roll plus one fix-up at i = 0
    prev = torch.roll(data, 1, dims=1)
    prev[:, 0] = torch.gather(data, 1, (nn - 1).clamp(0, nmax - 1))[:, 0]
    # pads out of the real range before the final sort (see bmh_tpu)
    rank = torch.where(real, rank, INT32_BIG)
    rank_sorted, order = torch.sort(rank, dim=1, stable=True)
    last = torch.where(real, torch.gather(prev, 1, order), 0).to(torch.uint8)
    shift = torch.where(n <= 1, 0, rank[:, 0])
    adj_equal = (rank_sorted[:, 1:] == rank_sorted[:, :-1]) & real[:, 1:]
    aperiodic = ~adj_equal.any(dim=1)
    k = max(nmax // stride, 1)
    j = (torch.arange(k, device=dev) + 1) * stride
    jmod = j[None, :] % torch.clamp(nn, min=1)
    cps = torch.gather(rank, 1, jmod.clamp(0, nmax - 1))
    return last, shift, cps, aperiodic


def _lf_map_packed(last: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """LF mapping as ONE sort of packed keys (byte, or 256 for pads) << 23 |
    position: all keys are distinct, so entry r of the sorted array is
    (last[next] << 23) | next for the row next = LF[r] — one read per walk
    step yields both the next row and the byte it emits.  (B, Nmax) int64
    holding uint32 values."""
    b, nmax = last.shape
    assert nmax <= (1 << _LF_SHIFT), "packed LF sort needs Nmax <= 2^23"
    pos = torch.arange(nmax, device=last.device).expand(b, nmax)
    key = torch.where(pos < n[:, None], last.to(torch.int64), 256)
    return torch.sort((key << _LF_SHIFT) | pos, dim=1).values


def bwt_inverse_cursors(last: torch.Tensor, shift: torch.Tensor,
                        cps: torch.Tensor, n: torch.Tensor,
                        stride: int) -> torch.Tensor:
    """Inverse BWT by checkpointed LF-walk cursors (the LF¹ form at every
    block size: bmh_tpu's LF² variant changes no output byte).

    Cursor j reproduces output positions [j*steps, (j+1)*steps) from
    rank[(j*stride) % n] (cursor 0 from `shift`); the walk is kernel K4.
    Returns (B, Nmax) uint8, zero past n."""
    b, nmax = last.shape
    k = max(nmax // stride, 1)
    assert nmax % k == 0, "Nmax must be a power of two"
    steps = nmax // k
    packed = _lf_map_packed(last, n)
    # uint32 bit pattern into int32 storage for the kernel
    table = (packed - ((packed >> 31) << 32)).to(torch.int32)
    starts = torch.cat([shift[:, None], cps[:, : k - 1]], dim=1)
    starts = starts.clamp(0, nmax - 1).to(torch.int32)
    walked = ibwt_kernel.ibwt_walk(table, starts, steps)  # (B, k, steps)
    out = walked.reshape(b, nmax)  # cursor-major == output order
    pos = torch.arange(nmax, device=last.device)
    return torch.where(pos[None, :] < n[:, None], out, 0)
