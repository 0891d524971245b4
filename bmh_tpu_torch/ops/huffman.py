"""Canonical Huffman: device table construction, bit packing, gap decode.

Port of bmh_tpu/ops/huffman.py, batched over blocks.

* Encode: two-queue code lengths over each block's 257-bin histogram
  (a step loop with the batch written out), canonical (length, symbol)
  codes, and a bit packer in which every symbol adds its code to at most
  two 32-bit words (bits of distinct symbols never overlap, so the sum is
  their OR).  Words are uint32 values carried in int64.
* Decode: the payloads of a whole batch are cut into chunks of
  `chunk_bits` bits on one flat chunk axis.  Kernel K1 decodes every chunk
  from each of the 32 possible codeword-boundary offsets ("gaps"); a
  segmented scan composes the per-chunk exit-gap maps into each chunk's
  true entry gap; kernel K2 re-decodes each chunk from that gap and emits
  canonical indices.  On the main path the RLE0 inverse is fused in: run
  lengths are resolved in the (steps, NC) emission layout and only
  literals are placed (`gap_decode_rle0_flat`); the periodic route takes
  the symbols themselves (`gap_decode_flat`).
"""

from __future__ import annotations

import torch

from . import decode_kernels

MAX_LEN = 31
GAPS = 32
_BIG = 1 << 30


def histogram(syms: torch.Tensor, m: torch.Tensor, bins: int) -> torch.Tensor:
    """(B, N) symbols, first m[b] counted -> (B, bins) int64 counts."""
    b, nsym = syms.shape
    pos = torch.arange(nsym, device=syms.device)[None, :]
    idx = torch.where(pos < m[:, None], syms, bins)
    idx = idx + (bins + 1) * torch.arange(b, device=syms.device)[:, None]
    cnt = torch.bincount(idx.reshape(-1), minlength=b * (bins + 1))
    return cnt.reshape(b, bins + 1)[:, :bins]


def code_lengths_device(freqs: torch.Tensor) -> torch.Tensor:
    """(B, A) histograms -> (B, A) int64 optimal code lengths.

    The two-queue method exactly as bmh_tpu's code_lengths_device: leaves
    sorted by (freq, symbol) stably, pop-min prefers the leaf queue on
    ties, internal nodes are born in non-decreasing weight order.  The
    length profile (not just its total) decides the container bytes."""
    b, a = freqs.shape
    dev = freqs.device
    f = freqs.to(torch.int64)
    leafw, leafsym = torch.sort(torch.where(f > 0, f, _BIG), dim=1, stable=True)
    s = (f > 0).sum(dim=1)
    n_nodes = 2 * a - 1
    q_iota = torch.arange(a - 1, device=dev)[None, :]
    p_iota = torch.arange(n_nodes, device=dev)[None, :]
    parent = p_iota.expand(b, n_nodes).clone()
    q2 = torch.full((b, a - 1), _BIG, dtype=torch.int64, device=dev)
    i = torch.zeros(b, dtype=torch.int64, device=dev)
    j = torch.zeros_like(i)
    k = torch.zeros_like(i)

    def pick(i, j):
        lw = torch.gather(leafw, 1, i.clamp(0, a - 1)[:, None])[:, 0]
        lw = torch.where(i < a, lw, _BIG)
        iw = torch.gather(q2, 1, j.clamp(0, a - 2)[:, None])[:, 0]
        iw = torch.where(j < k, iw, _BIG)
        take_leaf = lw <= iw
        return (torch.where(take_leaf, i + 1, i), torch.where(take_leaf, j, j + 1),
                torch.where(take_leaf, lw, iw), torch.where(take_leaf, i, a + j))

    # steps t >= s-1 are no-ops for a row; stop after the busiest row
    for t in range(max(int(s.max()) - 1, 0)):
        active = t < s - 1
        i1, j1, aw, an = pick(i, j)
        i2, j2, bw, bn = pick(i1, j1)
        q2 = torch.where(active[:, None] & (q_iota == k[:, None]),
                         (aw + bw)[:, None], q2)
        hit = (p_iota == an[:, None]) | (p_iota == bn[:, None])
        parent = torch.where(active[:, None] & hit, a + t, parent)
        i = torch.where(active, i2, i)
        j = torch.where(active, j2, j)
        k = torch.where(active, k + 1, k)

    # leaf depth = number of proper ancestors, by pointer doubling
    jump = parent
    dist = (parent != p_iota).to(torch.int64)
    for _ in range(9):
        dist = dist + torch.gather(dist, 1, jump)
        jump = torch.gather(jump, 1, jump)
    return torch.zeros((b, a), dtype=torch.int64, device=dev).scatter_(
        1, leafsym, dist[:, :a])


def canonical_codes_device(lens: torch.Tensor) -> torch.Tensor:
    """(B, A) lengths -> (B, A) int64 canonical codes (uint32 values),
    assigned in (length, symbol) order."""
    ls = torch.arange(1, MAX_LEN + 1, device=lens.device)[None, :, None]
    onehot = (lens[:, None, :] == ls).to(torch.int64)       # (B, 31, A)
    count = onehot.sum(dim=2)
    first = torch.empty_like(count)
    code = torch.zeros_like(count[:, 0])
    for l in range(MAX_LEN):
        first[:, l] = code
        code = ((code + count[:, l]) << 1) & 0xFFFFFFFF
    rank_in_len = torch.cumsum(onehot, dim=2) - onehot
    sel = (onehot * (first[:, :, None] + rank_in_len)).sum(dim=1) & 0xFFFFFFFF
    return torch.where(lens > 0, sel, 0)


def decode_tables_device(lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, A) lengths -> (count (B, 32) per-length codeword counts,
    sym (B, A) symbols in (length, symbol) order, absent symbols last)."""
    lv = torch.arange(32, device=lens.device)[None, :, None]
    count = (lens[:, None, :] == lv).sum(dim=2)
    count[:, 0] = 0
    sym = torch.sort(torch.where(lens > 0, lens, 64), dim=1, stable=True).indices
    return count, sym


def words_cap(nmax: int) -> int:
    """Word capacity of the bitpack output for Nmax symbols (< 10 b/sym)."""
    return (10 * nmax + 31) // 32 + 1


def encode_bitpack(syms: torch.Tensor, m: torch.Tensor, lens: torch.Tensor,
                   codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack canonical codes MSB-first into 32-bit words.

    syms (B, N) int64, first m[b] coded; lens/codes (B, A).  Returns
    (words (B, words_cap(N)) int64 holding uint32 values, total_bits (B,))."""
    b, nsym = syms.shape
    w_out = words_cap(nsym)
    pos = torch.arange(nsym, device=syms.device)[None, :]
    valid = pos < m[:, None]
    ln = torch.where(valid, torch.gather(lens, 1, syms), 0)
    code = torch.where(valid, torch.gather(codes, 1, syms), 0)
    offs = torch.cumsum(ln, dim=1) - ln
    total_bits = ln.sum(dim=1)
    rr = (offs & 31) + ln          # bits consumed in the 64-bit window
    word = offs >> 5
    straddles = rr > 32
    hi = torch.where(straddles, code >> (rr - 32).clamp(0, 31),
                     code << (32 - rr).clamp(0, 31))
    spill = (rr - 32).clamp(0, 31)
    lo = torch.where(straddles, (code & ((1 << spill) - 1)) << (64 - rr).clamp(0, 31), 0)
    words = torch.zeros((b, w_out + 1), dtype=torch.int64, device=syms.device)
    words.scatter_add_(1, word, hi)
    words.scatter_add_(1, word + 1, lo)
    return words[:, :w_out], total_bits


def words_ext(words: torch.Tensor, chunk_bits: int) -> torch.Tensor:
    """(NC * wpc,) int32 payload words -> (wpc+1, NC) int32, word-time-major;
    the extra last row is the first word of the following chunk (the
    32-bit codeword lookahead past each chunk cut)."""
    wpc = chunk_bits // 32
    nc = words.shape[0] // wpc
    assert nc * wpc == words.shape[0], "pad words to a multiple of chunk_bits"
    wmat = words.reshape(nc, wpc)
    nxt = torch.cat([wmat[1:, :1], torch.zeros_like(wmat[:1, :1])], dim=0)
    return torch.cat([wmat, nxt], dim=1).T.contiguous()


def _seg_scan(vals: torch.Tensor, seg_start: torch.Tensor, op) -> torch.Tensor:
    """Inclusive segmented scan along dim 0 (restarting at each seg_start)
    by Hillis-Steele doubling of the operator
    (a, fa) + (b, fb) = (b if fb else op(a, b), fa | fb)."""
    flags = seg_start.clone()
    nc = vals.shape[0]
    d = 1
    while d < nc:
        fb = flags[d:].reshape((-1,) + (1,) * (vals.dim() - 1))
        nv = vals.clone()
        nv[d:] = torch.where(fb, vals[d:], op(vals[:-d], vals[d:]))
        nf = flags.clone()
        nf[d:] = flags[:-d] | flags[d:]
        vals, flags = nv, nf
        d *= 2
    return vals


def _seg_scan_chunks(vals: torch.Tensor, seg_start: torch.Tensor, op,
                     init: int) -> torch.Tensor:
    """Exclusive segmented scan over the (NC,) chunk axis: per chunk, the
    combine of all earlier chunks of its block (init at a block's first)."""
    inc = _seg_scan(vals, seg_start, op)
    prev = torch.cat([torch.full_like(inc[:1], init), inc[:-1]])
    return torch.where(seg_start, init, prev)


def _decode_phases(wext, count_t, seg_start, seg_start_idx, chunk_bits: int,
                   maxl: int):
    """Phase A (K1), segmented composition of exit maps into per-chunk
    entry gaps, phase B (K2).  Returns (idxs (steps, NC) int32 emitted
    canonical indices or -1, out_off (NC,) exclusive symbol offset of each
    chunk within its block, entry (NC,) int32)."""
    cnt_map, exit_map = decode_kernels.phase_a(wext, count_t, chunk_bits, maxl)
    maps = exit_map.T.to(torch.int64)           # maps[c][g] = exit gap from g
    # composed[c, g] = later[c, earlier[c, g]]
    pmaps = _seg_scan(maps, seg_start, lambda ea, lb: torch.gather(lb, 1, ea))
    prev = torch.cat([torch.zeros_like(pmaps[:1, 0]), pmaps[:-1, 0]])
    entry = torch.where(seg_start, 0, prev)
    counts_sel = torch.gather(cnt_map.to(torch.int64), 0, entry[None, :])[0]
    ex = torch.cumsum(counts_sel, dim=0) - counts_sel
    out_off = ex - ex[seg_start_idx]
    entry = entry.to(torch.int32)
    idxs = decode_kernels.phase_b(wext, count_t, entry, chunk_bits, maxl)
    return idxs, out_off, entry


def gap_decode_flat(wext: torch.Tensor, count_t: torch.Tensor,
                    seg_start: torch.Tensor, seg_start_idx: torch.Tensor,
                    seg_id: torch.Tensor, sym_tbl: torch.Tensor, n: torch.Tensor,
                    nmax: int, chunk_bits: int, maxl: int = MAX_LEN) -> torch.Tensor:
    """Gap decode over the flat chunk axis to RLE0 symbols (the periodic
    route's front end, without the fused RLE0 inverse).

    Arguments as gap_decode_rle0_flat's, with n (B,) the RLE0 symbol counts.
    Returns (B, nmax) int64 symbols: each row's first n[b] decoded symbols
    in place; every other position (and any the payload fails to reach)
    holds the row's first canonical symbol, as bmh_tpu's index-0 fill."""
    idxs, out_off, _ = _decode_phases(wext, count_t, seg_start, seg_start_idx,
                                      chunk_bits, maxl)
    b, a = sym_tbl.shape
    valid = idxs >= 0
    vi = valid.to(torch.int64)
    within = out_off[None, :] + torch.cumsum(vi, dim=0) - vi
    keep = valid & (within < n[seg_id][None, :]) & (within < nmax)
    flat_cap = b * nmax
    target = torch.where(keep, seg_id[None, :] * nmax + within, flat_cap)
    cidx = torch.zeros(flat_cap + 1, dtype=torch.int64, device=wext.device)
    cidx[target.reshape(-1)] = idxs.to(torch.int64).reshape(-1)
    cidx = cidx[:flat_cap].reshape(b, nmax).clamp(0, a - 1)
    return torch.gather(sym_tbl, 1, cidx)


def gap_decode_rle0_flat(wext: torch.Tensor, count_t: torch.Tensor,
                         seg_start: torch.Tensor, seg_start_idx: torch.Tensor,
                         seg_id: torch.Tensor, sym_tbl: torch.Tensor,
                         ms: torch.Tensor, ns: torch.Tensor, nmax: int,
                         chunk_bits: int, maxl: int = MAX_LEN):
    """Fused gap decode + RLE0 inverse over the flat chunk axis.

    wext (wpc+1, NC) int32 payload words (words_ext), count_t (32, NC)
    int32 each chunk's block's per-length counts, seg_start (NC,) bool,
    seg_start_idx/seg_id (NC,) int64, sym_tbl (B, A) canonical symbol
    lists, ms/ns (B,) RLE0 symbol counts and decoded lengths.

    Returns ((B, nmax) uint8 MTF codes, runs left as the zero fill;
    (B,) int64 exact decoded totals).  A total differs from ns[b] exactly
    when the payload, rle_len or lens lie about the stream.  bmh_tpu
    computes these sums in int32 and guards a mod-2^32 wrap with a
    max-prefix poison; here the sums are int64 (every contribution is at
    most 3 * 2^22 and a block has at most 2^21 symbols), so they cannot
    wrap and the total itself is the integrity signal."""
    idxs, out_off, _ = _decode_phases(wext, count_t, seg_start, seg_start_idx,
                                      chunk_bits, maxl)
    b, a = sym_tbl.shape
    valid = idxs >= 0
    vi = valid.to(torch.int64)
    local = torch.cumsum(vi, dim=0) - vi
    within = out_off[None, :] + local           # symbol index within the block
    keep = valid & (within < ms[seg_id][None, :])

    ci = idxs.to(torch.int64).clamp(0, a - 1)
    s = sym_tbl.reshape(-1)[seg_id[None, :] * a + ci]
    isrun = keep & (s <= 1)
    islit = keep & (s > 1)

    # j = index within the current zero-run group (symbol order is
    # chunk-major: down each chunk column, then across chunks of a block)
    lit_pos = torch.where(islit, within, -1)
    cm = torch.cummax(lit_pos, dim=0).values
    carry_max = _seg_scan_chunks(cm[-1], seg_start, torch.maximum, -1)
    j = within - torch.maximum(cm, carry_max[None, :]) - 1

    contrib = torch.where(islit, 1, torch.where(
        isrun, (1 + s) << j.clamp(0, 22), 0))
    cs = torch.cumsum(contrib, dim=0)
    carry_sum = _seg_scan_chunks(cs[-1], seg_start, torch.add, 0)
    out_pos = cs - contrib + carry_sum[None, :]  # exclusive, within block

    # each block's total is its last chunk's sum: scattered to the block's
    # slot, every other chunk's to a slot past the end (no boolean index,
    # which would wait for the card)
    is_last = torch.cat([seg_start[1:], torch.ones_like(seg_start[:1])])
    totals = torch.zeros(b + 1, dtype=torch.int64, device=wext.device)
    totals = totals.scatter(0, torch.where(is_last, seg_id, b),
                            carry_sum + cs[-1])[:b]

    place = islit & (out_pos < ns[seg_id][None, :])
    flat_cap = b * nmax
    target = torch.where(place, seg_id[None, :] * nmax + out_pos, flat_cap)
    out = torch.zeros(flat_cap + 1, dtype=torch.uint8, device=wext.device)
    out[target.reshape(-1)] = (s - 1).clamp(0, 255).to(torch.uint8).reshape(-1)
    return out[:flat_cap].reshape(b, nmax), totals
