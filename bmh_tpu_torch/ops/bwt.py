"""Burrows-Wheeler transform: prefix doubling forward, LF-walk inverses.

Port of bmh_tpu/ops/bwt.py, batched over rows of a (B, Nmax) tensor with
per-row true lengths.  The forward has bmh_tpu's two programs, driven from
models/pipeline.py:

* full rounds: `bwt_rounds` to convergence, then `bwt_finish_cp`;
* sparse/adaptive: `bwt_rounds(h_stop)` and `round_step` until the batch's
  tied positions fit a compact set, `sparse_refine` re-sorts only those,
  then `bwt_finish_cp`.

Every BWT sort goes through `_stable_sort3`: kernel K5 (ops/sort_kernel.py)
with BMH_PALLAS_SORT on and the row length inside its envelope, one packed
int64 torch.sort otherwise.  The sorted order of rotations is unique, so
both programs and both sorts give the same bytes.  bmh_tpu's while_loops
are `control.while_loop`s: eagerly they read one device flag a round, and
in a captured program (models/programs.py) the body is a graph that the
replay repeats while that flag holds.  Inside a loop nothing depends on the
data's shape: every row runs every round, and a row that finished keeps
its carry, as a vmapped while_loop leaves it.

The inverses: the checkpointed LF-cursor walk (kernel K4, over the
self-composed table with lf2 on) for aperiodic blocks, the
permutation-doubling `bwt_inverse` for periodic and single-symbol ones.

uint32 quantities of the JAX version (the biased 4-byte init rank, the
packed LF keys) are carried in int64 here: torch's uint32 has no shifts or
comparisons on the CPU.  Ranks are int64 holding int32 values; K5 takes
them cast to int32.
"""

from __future__ import annotations

import torch

from ..utils import config as config_mod
from . import ibwt_kernel, sort_kernel
from .control import doublings, scalar, while_loop

INT32_BIG = 2**31 - 1
_LF_SHIFT = 23
_TAG = 1 << 30  # sparse_refine's routing plane: compact index | _TAG


def _pad_front(x: torch.Tensor) -> torch.Tensor:
    """Neighbour-difference flags with False in front: (..., N-1) -> (..., N)."""
    return torch.nn.functional.pad(x, (1, 0))


def _use_pallas_sort(n: int) -> bool:
    return config_mod.DEFAULT.pallas_sort and sort_kernel.in_envelope(n)


def _stable_sort3(key1: torch.Tensor, key2: torch.Tensor, payload: torch.Tensor,
                  stable: bool = True):
    """Sort each row of (B, N) int64 tensors holding int32 values by
    (key1, key2); returns the permuted (key1, key2, payload).

    stable=False is sound where the caller reads only key-equality groups.
    With the knob on and N inside K5's envelope the triple goes through
    sort_kernel.sort3 (kernel K5 for a CUDA tensor): every call site's
    triples are distinct, so its order is the stable one."""
    if _use_pallas_sort(key1.shape[-1]):
        s1, s2, s3 = sort_kernel.sort3(
            *(x.to(torch.int32).contiguous() for x in (key1, key2, payload)))
        return s1.to(torch.int64), s2.to(torch.int64), s3.to(torch.int64)
    key = (key1 << 32) + (key2 + 2**31)
    ks, order = torch.sort(key, dim=-1, stable=stable)
    return ks >> 32, (ks & 0xFFFFFFFF) - 2**31, torch.gather(payload, -1, order)


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


def _round_body(rank: torch.Tensor, h, n: torch.Tensor):
    """One prefix-doubling round with head-index ranks: rank[i] becomes the
    sorted position of the first member of i's tie group under the key
    (rank[i], rank[(i + h) mod n]); h is an int or a 0-dim tensor.  Returns
    (new rank, tied (B, Nmax) bool — i is real and in a group of size > 1,
    done (B,) bool)."""
    b, nmax = rank.shape
    dev = rank.device
    pos = torch.arange(nmax, device=dev).expand(b, nmax)
    nn = n[:, None]
    real = pos < nn
    h_mod = h % torch.clamp(nn, min=1)
    idx = torch.where(pos < nn - h_mod, pos + h_mod, pos + h_mod - nn)
    rank2 = torch.gather(rank, 1, idx.clamp(0, nmax - 1))
    rank2 = torch.where(real, rank2, INT32_BIG)
    # head-index ranks and the tied mask depend only on key equality
    k1, k2, order = _stable_sort3(rank, rank2, pos, stable=False)
    changed = _pad_front((k1[:, 1:] != k1[:, :-1]) | (k2[:, 1:] != k2[:, :-1]))
    new_rank_sorted = torch.cummax(torch.where(changed, pos, 0), dim=1).values
    eq_prev = ~changed & (pos > 0)
    tied_sorted = eq_prev | torch.nn.functional.pad(eq_prev[:, 1:], (0, 1))
    # pads share the init sentinel and tie with each other: only REAL
    # positions may enter the sparse compaction
    tied_sorted = tied_sorted & (order < nn)
    new_rank = torch.empty_like(rank).scatter_(1, order, new_rank_sorted)
    tied = torch.empty_like(tied_sorted).scatter_(1, order, tied_sorted)
    n_distinct = (changed & real).sum(dim=1)
    return new_rank, tied, n_distinct >= n - 1


def bwt_rounds_resume(rank: torch.Tensor, tied: torch.Tensor, h,
                      done: torch.Tensor, n: torch.Tensor,
                      h_stop: int | None = None):
    """Continue doubling rounds from a (rank, tied, h, done) state until
    every row is done or h >= min(h_stop, Nmax); h is an int or a 0-dim
    tensor.

    Every row runs every round; a row that is done keeps its carry.
    Returns (rank, tied, h (B,) int64 each row's next gap, done (B,)
    bool)."""
    b, nmax = rank.shape
    h_cap = nmax if h_stop is None else min(h_stop, nmax)
    trips = doublings(h, h_cap)
    h = scalar(h, rank.device)

    def cond(rank, tied, h, done, h_row):
        return (h < h_cap) & ~done.all()

    def body(rank, tied, h, done, h_row):
        sub, sub_tied, sub_done = _round_body(rank, h, n)
        keep = done[:, None]
        return (torch.where(keep, rank, sub), torch.where(keep, tied, sub_tied),
                2 * h, done | sub_done, torch.where(done, h_row, 2 * h))

    rank, tied, _, done, h_row = while_loop(
        cond, body, (rank, tied, h, done, h.expand(b).clone()), trips)
    return rank, tied, h_row, done


def bwt_rounds(data: torch.Tensor, n: torch.Tensor, h_stop: int | None = None):
    """Doubling rounds from the 4-byte init ranks (h = 4) until every row's
    ranks are distinct or h >= min(h_stop, Nmax); rows with n <= 1 run no
    round and keep their raw init ranks.  Returns (rank (B, Nmax) int64
    head-index ranks, tied (B, Nmax) bool, h (B,), done (B,))."""
    rank = _init_rank(data, n)
    tied = torch.zeros(rank.shape, dtype=torch.bool, device=data.device)
    return bwt_rounds_resume(rank, tied, 4, n <= 1, n, h_stop)


def round_step(rank: torch.Tensor, tied: torch.Tensor, h,
               n: torch.Tensor):
    """Exactly ONE doubling round from (rank, tied) at gap h, for every row
    given (the adaptive handoff's batch-level step).  Returns
    (rank, tied, 2h, done)."""
    new_rank, new_tied, done = _round_body(rank, h, n)
    return new_rank, new_tied, 2 * h, done


def _regroup(sk1, sk2, sidx, blk, nmax: int):
    """One compact refinement round's regrouping: sorted keys (block * Nmax
    + own rank, rank at +h) -> (new rank per sorted entry = group head +
    subgroup offset, tied flags in sorted order, done)."""
    midx = torch.arange(sk1.shape[0], device=sk1.device)
    ch1 = _pad_front(sk1[1:] != sk1[:-1])
    ch12 = ch1 | _pad_front(sk2[1:] != sk2[:-1])
    head1 = torch.cummax(torch.where(ch1, midx, 0), dim=0).values
    head12 = torch.cummax(torch.where(ch12, midx, 0), dim=0).values
    new_rank_s = sk1 - blk[sidx] * nmax + (head12 - head1)
    eq12 = ~ch12 & (midx > 0)
    tied_s = eq12 | torch.nn.functional.pad(eq12[1:], (0, 1))
    done = (ch12 | (midx == 0)).all()
    return new_rank_s, tied_s, done


def _sort_compact(k1, k2, midx):
    s1, s2, s3 = _stable_sort3(k1[None], k2[None], midx[None], stable=False)
    return s1[0], s2[0], s3[0]


def sparse_refine(rank: torch.Tensor, blk: torch.Tensor, pos: torch.Tensor,
                  hm0: torch.Tensor, ns: torch.Tensor, h0,
                  tier1_rounds: int = 2, tier2_div: int = 4) -> torch.Tensor:
    """Finish prefix doubling by refining only the tied positions.

    rank: (B, Nmax) head-index ranks; blk/pos: (M,) compact entries, pads
    with blk == B; hm0: (M,) h0 mod ns[blk]; ns: (B,); h0: the gap the full
    rounds handed off at (an int or a 0-dim tensor).  A tie group at gap 2h
    holds only positions tied at gap h, so each round sorts the M-entry
    compact set instead of B * Nmax.  Head-index ranks make the refinement
    in place: a group's head rank IS its first sorted index, so refined
    ranks are head + subgroup offset.  Tier 1 runs `tier1_rounds` rounds at
    capacity M, then the survivors move to a tier-2 set of M / tier2_div
    entries; if they overflow it, full-capacity rounds run on.  bmh_tpu's
    lax.cond between the two tails is two loops here, each of which runs
    only under its branch's predicate.  Returns the refined rank.
    """
    b, nmax = rank.shape
    dev = rank.device
    m = blk.shape[0]
    midx = torch.arange(m, device=dev)
    valid = blk < b
    blk_c = blk.clamp(0, b - 1)
    nb = ns[blk_c]
    flat_pos = blk_c * nmax + pos
    pad_key = b * nmax + midx  # distinct, sorts last
    rank_flat = rank.reshape(-1)
    # ONE routing plane: the rank itself for resolved positions, the
    # compact index | _TAG for tied ones (ranks < 2^23 < _TAG)
    comb = torch.cat([rank_flat, rank_flat.new_zeros(1)])
    comb[torch.where(valid, flat_pos, b * nmax)] = _TAG | midx
    comb = comb[: b * nmax]
    rc = rank_flat[torch.where(valid, flat_pos, 0)]  # compact working ranks

    def body(rc, tied, hm, h, done):
        p2 = pos + hm
        p2 = torch.where(p2 >= nb, p2 - nb, p2)
        g2 = comb[(blk_c * nmax + p2).clamp(0, b * nmax - 1)]
        r2 = torch.where(g2 >= _TAG, rc[(g2 & (_TAG - 1)).clamp(0, m - 1)], g2)
        k1 = torch.where(valid, blk * nmax + rc, pad_key)
        k2 = torch.where(valid, r2, 0)
        sk1, sk2, sidx = _sort_compact(k1, k2, midx)
        new_rank_s, tied_s, done = _regroup(sk1, sk2, sidx, blk, nmax)
        rc = torch.empty_like(rc).scatter_(0, sidx, new_rank_s)
        tied = torch.empty_like(tied_s).scatter_(0, sidx, tied_s)
        hm = 2 * hm
        return rc, tied, torch.where(hm >= nb, hm - nb, hm), 2 * h, done

    def cond(rc, tied, hm, h, done):
        return (h < nmax) & ~done

    trips = doublings(h0, nmax)
    h0 = scalar(h0, dev)
    state = (rc, torch.ones(m, dtype=torch.bool, device=dev), hm0, h0,
             torch.zeros((), dtype=torch.bool, device=dev))
    m2 = min(max(m // tier2_div, 4096), m)
    if m2 >= m:
        rc = while_loop(cond, body, state, trips)[0]
    else:
        # TIER 1: a few rounds at full capacity (the tied set roughly
        # halves per round on text) — bmh_tpu's cond1 has no h < Nmax test
        h_t1 = h0 * (1 << tier1_rounds)
        state = while_loop(lambda rc, tied, hm, h, done: (h < h_t1) & ~done,
                           body, state, tier1_rounds)
        to_tier2 = state[1].sum() <= m2
        # the survivors overflow the tier-2 set: full-capacity rounds
        state = while_loop(lambda *st: ~to_tier2 & cond(*st), body, state, trips)
        rc = _tier2(*state, to_tier2, comb, blk, pos, ns, b, nmax, m2, trips)
    out = torch.cat([rank_flat.clone(), rank_flat.new_zeros(1)])
    out[torch.where(valid, flat_pos, b * nmax)] = rc
    return out[: b * nmax].reshape(b, nmax)


def _tier2(rc, tied, hm, h, done, go, comb, blk, pos, ns, b: int, nmax: int,
           m2: int, trips: int) -> torch.Tensor:
    """sparse_refine's second tier: the <= m2 still-tied entries, in
    compact-index order, refined in an m2-entry set until done or h >= Nmax
    (at most `trips` rounds), while `go` (the tier's predicate) holds.  Writes through oidx into the
    full compact ranks `rc` (pads write to the dropped slot m)."""
    dev = rc.device
    m = rc.shape[0]
    midx2 = torch.arange(m2, device=dev)
    # stable compaction: tied entries first, in index order (entries past
    # m2, where `go` is false, all land in the dropped slot)
    dest = torch.where(tied, torch.cumsum(tied, 0) - 1, m2).clamp(max=m2)
    oidx = torch.full((m2 + 1,), m, dtype=torch.int64, device=dev)
    oidx = oidx.scatter_(0, dest, torch.arange(m, device=dev))[:m2]
    inval = oidx >= m
    src = oidx.clamp(0, m - 1)
    blk2 = torch.where(inval, b, blk[src])
    pos2 = torch.where(inval, 0, pos[src])
    hmc = torch.where(inval, 0, hm[src])
    nb2 = ns[blk2.clamp(0, b - 1)]
    pad_key2 = b * nmax + midx2
    rc = torch.cat([rc, rc.new_zeros(1)])  # slot m: the pads' dropped writes

    def body(rc, hmc, h, done):
        p2 = pos2 + hmc
        p2 = torch.where(p2 >= nb2, p2 - nb2, p2)
        g2 = comb[(blk2.clamp(0, b - 1) * nmax + p2).clamp(0, b * nmax - 1)]
        r2 = torch.where(g2 >= _TAG, rc[(g2 & (_TAG - 1)).clamp(0, m - 1)], g2)
        rself = rc[src]
        k1 = torch.where(inval, pad_key2, blk2 * nmax + rself)
        k2 = torch.where(inval, 0, r2)
        sk1, sk2, sidx = _sort_compact(k1, k2, midx2)
        new_rank_s, _, done = _regroup(sk1, sk2, sidx, blk2, nmax)
        rc = rc.scatter(0, oidx[sidx], new_rank_s)
        hmc = 2 * hmc
        return rc, torch.where(hmc >= nb2, hmc - nb2, hmc), 2 * h, done

    rc = while_loop(lambda rc, hmc, h, done: go & (h < nmax) & ~done, body,
                    (rc, hmc, h, done), trips)[0]
    return rc[:m]


def bwt_finish_cp(data: torch.Tensor, n: torch.Tensor, rank: torch.Tensor,
                  stride: int):
    """BWT tail for final ranks: the last column, shift, cursor checkpoints
    and the aperiodic flag.

    The previous byte of each rotation rides the final (rank, pos) sort as
    its payload; with head-index ranks and the stable order, rotation 0 is
    the first of its tie group, so the shift is rank[0].  Returns (last
    (B, Nmax) uint8, shift (B,) int64, cps (B, max(Nmax // stride, 1))
    int64 with cps[j] = rank[((j+1) * stride) % n], aperiodic (B,) bool)."""
    b, nmax = data.shape
    dev = data.device
    pos = torch.arange(nmax, device=dev).expand(b, nmax)
    nn = n[:, None]
    real = pos < nn
    # prev[i] = data[(i-1) mod n]: a roll plus one fix-up at i = 0
    prev = torch.roll(data, 1, dims=1)
    prev[:, 0] = torch.gather(data, 1, (nn - 1).clamp(0, nmax - 1))[:, 0]
    # pads out of the real range before the final sort (see bmh_tpu)
    rank = torch.where(real, rank, INT32_BIG)
    rank_sorted, _, last_sorted = _stable_sort3(rank, pos, prev.to(torch.int64))
    last = torch.where(real, last_sorted, 0).to(torch.uint8)
    # n <= 1 rows ran no round: their rank is the raw init, shift 0
    shift = torch.where(n <= 1, 0, rank[:, 0])
    adj_equal = (rank_sorted[:, 1:] == rank_sorted[:, :-1]) & real[:, 1:]
    aperiodic = ~adj_equal.any(dim=1)
    k = max(nmax // stride, 1)
    j = (torch.arange(k, device=dev) + 1) * stride
    jmod = j[None, :] % torch.clamp(nn, min=1)
    cps = torch.gather(rank, 1, jmod.clamp(0, nmax - 1))
    return last, shift, cps, aperiodic


def _bwt_ranks(data: torch.Tensor, n: torch.Tensor):
    """The full-rounds ranks and the final order of rotations: by rank,
    ties by index (stable; equal full rotations).  Returns (rank, order,
    real mask, pos), each (B, Nmax)."""
    b, nmax = data.shape
    pos = torch.arange(nmax, device=data.device).expand(b, nmax)
    rank = bwt_rounds(data, n)[0]
    order = _stable_sort3(rank, pos, pos)[2]
    return rank, order, pos < n[:, None], pos


def bwt_forward(data: torch.Tensor, n: torch.Tensor):
    """Cyclic-rotation BWT without checkpoints, as bmh_tpu's bwt_forward.

    data (B, Nmax) uint8, first n[b] bytes of row b valid.  Returns (last
    (B, Nmax) uint8, zero past n; shift (B,) int64, the sorted position of
    rotation 0)."""
    nmax = data.shape[1]
    _, order, real, pos = _bwt_ranks(data, n)
    prev = torch.where(order == 0, n[:, None] - 1, order - 1).clamp(0, nmax - 1)
    last = torch.where(real, torch.gather(data, 1, prev), 0).to(torch.uint8)
    shift = torch.where(order == 0, pos, 0).sum(dim=1)
    return last, shift


def bwt_forward_cp(data: torch.Tensor, n: torch.Tensor, stride: int):
    """BWT forward with inverse-walk checkpoints by the full-rounds program.

    data (B, Nmax) uint8, n (B,) int64; returns bwt_finish_cp's tuple."""
    return bwt_finish_cp(data, n, bwt_rounds(data, n)[0], stride)


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


def _lf_map(last: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """LF[r]: the row that row r's walk step moves to, (B, Nmax) int64."""
    return _lf_map_packed(last, n) & ((1 << _LF_SHIFT) - 1)


def _walk_hop(steps: int) -> int:
    """LF links one step of the cursor walk follows: K4's composed hop with
    lf2 on (the default) where it divides `steps`, else 1."""
    hop = ibwt_kernel.HOP
    return hop if config_mod.DEFAULT.lf2 and steps % hop == 0 else 1


def bwt_inverse_cursors(last: torch.Tensor, shift: torch.Tensor,
                        cps: torch.Tensor, n: torch.Tensor,
                        stride: int) -> torch.Tensor:
    """Inverse BWT by checkpointed LF-walk cursors.

    Cursor j reproduces output positions [j*steps, (j+1)*steps) from
    rank[(j*stride) % n] (cursor 0 from `shift`); the walk is kernel K4,
    over the table composed with itself `_walk_hop` times (BMH_LF2, read
    at call time; no mode changes an output byte).
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
    walked = ibwt_kernel.ibwt_walk(table, starts, steps,
                                   _walk_hop(steps))  # (B, k, steps)
    out = walked.reshape(b, nmax)  # cursor-major == output order
    pos = torch.arange(nmax, device=last.device)
    return torch.where(pos[None, :] < n[:, None], out, 0)


def bwt_inverse(last: torch.Tensor, shift: torch.Tensor,
                n: torch.Tensor) -> torch.Tensor:
    """Inverse BWT by LF mapping + permutation doubling, for blocks without
    checkpoints (periodic: the rank is no bijection).

    The output is last[LF^(i+1)(shift)]: orbit[m:2m] = LF^m(orbit[:m]) with
    LF^m squared after each round, log2(Nmax) rounds of gathers instead of
    an Nmax-step walk.  Returns (B, Nmax) uint8, zero past n."""
    b, nmax = last.shape
    p_m = _lf_map(last, n)
    orbit = torch.zeros((b, nmax), dtype=torch.int64, device=last.device)
    orbit[:, 0] = torch.gather(p_m, 1, shift.clamp(0, nmax - 1)[:, None])[:, 0]
    m = 1
    while m < nmax:
        orbit[:, m:2 * m] = torch.gather(p_m, 1, orbit[:, :m])
        m *= 2
        if m < nmax:
            p_m = torch.gather(p_m, 1, p_m)
    out = torch.gather(last, 1, orbit)
    pos = torch.arange(nmax, device=last.device)
    return torch.where(pos[None, :] < n[:, None], out, 0).to(torch.uint8)
