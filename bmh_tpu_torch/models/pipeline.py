"""Batched block codec on torch devices — the port's backend.

Compress, bmh_tpu's two programs: BWT with checkpoints -> MTF -> RLE0 ->
histogram -> two-queue code lengths -> canonical codes -> bitpack, for a
batch of blocks at once, then one device->host copy of [per-block metadata
| compacted payload words].  The BWT runs the sparse/adaptive program
(`sparse_ranks`: a few doubling rounds, the adaptive handoff, sparse
refinement of the tied positions) unless the batch looks run-dominated,
which takes the full-rounds program (`ops/bwt.bwt_forward_cp`).  A compress
program marks its stages (ops/control.stage), which the card times: `rle1`
(the RLE1 of raw blocks, kernel K8, where the program takes them raw),
`bwt`, `mtf` (MTF, RLE0, histograms) and `entropy` (code lengths,
canonical codes, bitpack, the flattened output).

RLE1 (`TorchBackend.compress_blocks` takes raw blocks): each block's RLE1
runs inside its compress program, on the card, unless the block may
shrink into a smaller bucket (`_rle1_on_host`: no bucket forced, a sampled
check finds it run-heavy); such a block is collapsed on the host first and
bucketed on its collapsed length.  The bytes are the same either way;
`UPLOADS` counts the rows of each path.

Decompress, bmh_tpu's three routes:
* flat (aperiodic blocks): host staging of the batch's payloads on one
  flat chunk axis -> fused gap decode + RLE0 inverse (kernels K1, K2) ->
  inverse MTF (K3) -> LF-cursor inverse BWT (K4) -> row compaction;
* periodic (no checkpoints): the same gap decode to RLE0 symbols, then
  RLE0 inverse, inverse MTF (K3) and the doubling inverse BWT;
* single-symbol (no payload): the constant RLE0 stream, then the inverses.
Each route brings each block's decoded total back in the same single copy,
and a total that differs from the block length raises.

Blocks are grouped by power-of-two size bucket and batched up to
`max_dispatch` blocks; a batch is padded to a power of two of rows, and a
decode batch's chunk count to bmh_tpu's bucket, so that programs are
reused.  Both compress programs (`compress_program`), the compact upload's
`inflate_program` and the three decode routes (`decode_flat_program`,
`decode_periodic_program`, `decode_single_program`) run through
models/programs.py, bmh_tpu's cache of compiled programs: on a card each
is a captured CUDA graph per shape and knob set, with no host decision
inside (their loops are ops/control.while_loop).

Upload, bmh_tpu's: a compress batch goes to the card as the padded
(b_pad, nmax) array, or, where that would waste more than 4 quanta of
padding (2 MiB), as one compact byte stream that `inflate_program`
rebuilds into the padded batch on the card, feeding the compress program
without a trip to the host (`_upload_batch`, `UPLOADS`).

Dispatch, bmh_tpu's: each batch is split into a *dispatch* (stage, upload,
launch, start the one device->host copy) and a *drain* (wait for the copy,
unpack), and up to `inflight` (BMH_INFLIGHT) batches wait between the two
(`_run_window`).  A decompress dispatch never waits for the card, so the
host stages batch k+1 while the card decodes batch k; a compress dispatch
waits inside (a loop flag a round), so its window holds only the copies.
Every dispatch runs on the calling thread with its device current.  A
compress dispatch of b_pad blocks splits its rows over `_ndev_for(b_pad)`
of the backend's devices, as bmh_tpu's shard_map splits the block axis;
decompress dispatches go round-robin over them.  `LAST_DISPATCH` records
the last fan-out of each direction.

Spans (utils/tracing.annotate, layer "pipeline"), per batch, never per
block: `pipeline.group` (grouping; on compress the pathology test and,
inside `pipeline.rle1`, the RLE1 rule and the host's RLE1 of the blocks
it picks), one
dispatch span a batch (`compress_dispatch_b*`, `decompress_dispatch_b*`,
`decompress_single_b*`) holding `pipeline.stage` (host staging and the
upload's arrays) and models/programs.py's `programs.run`, then
`compress_assemble` or `pipeline.drain` around each drain.
"""

from __future__ import annotations

import functools
from collections import defaultdict, deque

import numpy as np
import torch

from ..ops import bwt as ops_bwt
from ..ops import huffman as ops_huf
from ..ops import mtf as ops_mtf
from ..ops import rle as ops_rle
from ..ops.control import doublings, scalar, stage, while_loop
from ..utils import config as config_mod
from ..utils import nativeio
from ..utils.tracing import annotate
from . import programs

A = ops_rle.RLE_ALPHABET
# a decode batch's chunk count is padded to a power of two times the
# chunks that hold this many payload bits: bmh_tpu's CHUNK_ALIGN (1024, the
# Pallas phase-B tile times its 8 sublanes) of its 512-bit chunks.  At the
# default 512-bit chunks that is bmh_tpu's bucket; longer chunks pad to as
# many payload bits, not to 1024 chunks
CHUNK_ALIGN_BITS = 1024 * 512
# minimum compact-set capacity of the sparse refinement
_SPARSE_MIN = 4096
# Prefix doubling runs until every block of a batch converges, so one block
# of long runs forces the most rounds on all of them.  Blocks whose sampled
# self-similarity at distance 2048 exceeds this go to their own batches and
# the full-rounds program (bmh_tpu's threshold, from Calgary).
_PATHOLOGICAL_SELF_SIM = 0.45


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length()


def _bucket(n: int) -> int:
    return max(config_mod.DEFAULT.min_bucket, _next_pow2(n))


def _n_cps(n: int, stride: int) -> int:
    """Checkpoints stored for a block of true length n."""
    return max(-(-n // stride) - 1, 0)


def _put(x: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`; to a card through pinned memory, without
    waiting for the copy."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _chunks(seq: list, size: int | None = None):
    size = size or config_mod.DEFAULT.max_dispatch
    return [seq[i:i + size] for i in range(0, len(seq), size)]


def _looks_pathological(blk: np.ndarray) -> bool:
    if blk.size < 8192:
        return False
    return float(np.mean(blk[:-2048:37] == blk[2048::37])) > _PATHOLOGICAL_SELF_SIM


# RLE1 collapses a run of L >= 8 bytes to at most L - 3: a sampled byte
# counts as collapsed where it and the next _RLE1_RUN_SPAN - 1 bytes are
# equal; about _RLE1_SAMPLES bytes of a block are sampled, at an odd stride
_RLE1_RUN_SPAN = 8
_RLE1_SAMPLES = 1024


def _rle1_on_host(blk: np.ndarray) -> bool:
    """Whether RLE1 may move a raw block to a smaller bucket: the share of
    strided samples that start a run of _RLE1_RUN_SPAN equal bytes (one
    compare at that span first, all of them only where that share could
    pass) at least the share of its bytes it must lose to fit the next
    bucket down.  No pass over the whole block."""
    n = blk.size
    target = max(_bucket(n) // 2, config_mod.DEFAULT.min_bucket)
    if target >= _bucket(n) or n <= _RLE1_RUN_SPAN:
        return False
    k = _RLE1_RUN_SPAN - 1
    step = (n // _RLE1_SAMPLES) | 1
    head = blk[:n - k:step]
    need = (1 - target / n) * head.size
    run = head == blk[k::step]
    if np.count_nonzero(run) < need:
        return False
    for d in range(1, k):
        run &= head == blk[d:n - k + d:step]
    return np.count_nonzero(run) >= need


# ---------------------------------------------------------------------------
# Compress
# ---------------------------------------------------------------------------

def _symbols(last: torch.Tensor, n: torch.Tensor):
    """Last column -> (RLE0 symbols, their counts m, 257-bin histograms)."""
    codes = ops_mtf.mtf_forward(last, n, config_mod.DEFAULT.mtf_chunk)
    syms, m = ops_rle.rle0_encode(codes, n)
    return syms, m, ops_huf.histogram(syms, m, A)


def compress_stage1_fn(data: torch.Tensor, n: torch.Tensor, stride: int):
    """Compress stage 1 of a (B, Nmax) batch by the full-rounds BWT:
    (RLE0 symbols, their counts m, 257-bin histograms, bwt shift, cursor
    checkpoints every `stride` positions, aperiodic flag)."""
    last, shift, cps, aperiodic = ops_bwt.bwt_forward_cp(data, n, stride)
    return (*_symbols(last, n), shift, cps, aperiodic)


def _sparse_cap(b_pad: int, nmax: int) -> int:
    """Compact-set capacity: 1/sparse_cap_div of the padded batch, at least
    _SPARSE_MIN, at most the batch itself.  With b_pad and nmax powers of
    two it is one too, so the compact sorts fit K5's envelope."""
    div = config_mod.DEFAULT.sparse_cap_div
    return min(max((b_pad * nmax) // div, _SPARSE_MIN), b_pad * nmax)


def sparse_ranks(data: torch.Tensor, n: torch.Tensor, b_pad: int) -> torch.Tensor:
    """Final BWT ranks by bmh_tpu's adaptive handoff (_compress_core with
    hard=False), with no decision on the host.

    Doubling rounds stop at h = 2^(full_rounds + 1).  While the batch's tied
    positions exceed the compact capacity, whole-batch rounds go on (every
    row: for a row without ties a round changes nothing); the tie total
    stays on the card, as bmh_tpu's cont_cond keeps it.  The tied set is
    then refined sparsely from the gap reached.  Where the ties still
    exceed the capacity (h has passed Nmax: exactly periodic blocks) the
    ranks are already final, bmh_tpu's resume branch leaves them as they
    are, and one select on the card keeps them."""
    cfg = config_mod.DEFAULT
    nmax = data.shape[1]
    m_cap = _sparse_cap(b_pad, nmax)
    h_s = 1 << (cfg.full_rounds + 1)
    rank, tied, _, _ = ops_bwt.bwt_rounds(data, n, h_s)

    def cont(rank, tied, h, total):
        return (total > m_cap) & (h < nmax)

    def handoff(rank, tied, h, total):
        rank, tied, h, _ = ops_bwt.round_step(rank, tied, h, n)
        return rank, tied, h, tied.sum()

    rank, tied, h_s, total = while_loop(
        cont, handoff, (rank, tied, scalar(h_s, data.device), tied.sum()),
        doublings(h_s, nmax))
    refined = _sparse_refine_compact(rank, tied, n, m_cap, h_s)
    return torch.where(total <= m_cap, refined, rank)


def _sparse_refine_compact(rank: torch.Tensor, tied: torch.Tensor,
                           ns: torch.Tensor, m_cap: int, h0) -> torch.Tensor:
    """Compact the tied positions of the batch (in index order, pads
    blk == B) into an m_cap set and refine them from gap h0 (an int or a
    0-dim tensor).  Ties past m_cap fall into a dropped slot (the caller
    discards such a result)."""
    b, nmax = rank.shape
    dev = rank.device
    flat = tied.reshape(-1)
    dest = torch.where(flat, torch.cumsum(flat, 0) - 1, m_cap).clamp(max=m_cap)
    idx = torch.full((m_cap + 1,), b * nmax, dtype=torch.int64, device=dev)
    idx = idx.scatter_(0, dest, torch.arange(b * nmax, device=dev))[:m_cap]
    blk = idx // nmax
    pos = idx - blk * nmax
    nb = ns[blk.clamp(0, b - 1)]
    # hm0 = h0 mod nb by bmh_tpu's binary conditional subtraction (the
    # quotient is at most h0 <= nmax); products past nmax are masked to
    # int32-max as there, so the ladder gives bmh_tpu's values exactly
    h0 = scalar(h0, dev)
    hm = h0.expand(m_cap).clone()
    q = 1 << (nmax.bit_length() - 1)
    while q >= 1:
        prod = torch.where(nb <= nmax // q, nb * q, 2**31 - 1)
        hm = torch.where(hm >= prod, hm - prod, hm)
        q //= 2
    cfg = config_mod.DEFAULT
    return ops_bwt.sparse_refine(rank, blk, pos, hm, ns, h0,
                                 tier1_rounds=cfg.tier1_rounds,
                                 tier2_div=cfg.tier2_div)


def _meta_cols(nmax: int, stride: int) -> int:
    """Columns of a compress program's meta row: bits, nw, shift, m,
    aperiodic, n (the block's length as the BWT took it), present (257),
    lens (257), cps (max(nmax // stride, 1))."""
    return 6 + 2 * A + max(nmax // stride, 1)


def _flatten_out(words, bits, lens, freqs, m, shift, cps, aper, n) -> torch.Tensor:
    """A compress program's one output at a static size, as bmh_tpu's
    _flatten_payloads and _merge_out (with each row's length n in its meta
    row): (B * meta_cols + B * W,) int32, the meta rows, then every block's
    word-aligned payload back to back (the rest zero).  Payload words are
    uint32 bit patterns; meta values fit 31 bits."""
    b, w = words.shape
    nw = (bits + 31) // 32
    woffs = torch.cumsum(nw, 0) - nw
    slot = torch.arange(w, device=words.device)[None, :]
    dest = torch.where(slot < nw[:, None], woffs[:, None] + slot, b * w)
    flat = torch.zeros(b * w + 1, dtype=torch.int64, device=words.device)
    flat = flat.scatter_(0, dest.reshape(-1), words.reshape(-1))[: b * w]
    meta = torch.cat([torch.stack([bits, nw, shift, m, aper.to(torch.int64), n], 1),
                      (freqs > 0).to(torch.int64), lens, cps], dim=1)
    out = torch.cat([meta.reshape(-1), flat])
    return (out - ((out >> 31) << 32)).to(torch.int32)


def compress_program(data: torch.Tensor, n: torch.Tensor, stride: int,
                     hard: bool, b_pad: int, rle1: bool = False) -> torch.Tensor:
    """The whole compress of a (B, Nmax) batch as one program: with `rle1`
    the RLE1 of the raw rows first (kernel K8, ops/rle.rle1_encode), then
    the BWT by the full-rounds program (hard) or the sparse/adaptive one,
    whose compact set b_pad (the batch rounded up to a power of two) sizes,
    then MTF, RLE0 and histograms, then code lengths, canonical codes,
    bitpack and _flatten_out, each stage marked.  On a card B = b_pad, the
    rows past the batch carrying n = 1 as bmh_tpu's dummy rows do."""
    if rle1:
        with stage("rle1"):
            data, n = ops_rle.rle1_encode(data, n)
    with stage("bwt"):
        if hard:
            last, shift, cps, aper = ops_bwt.bwt_forward_cp(data, n, stride)
        else:
            rank = sparse_ranks(data, n, b_pad)
            last, shift, cps, aper = ops_bwt.bwt_finish_cp(data, n, rank, stride)
    with stage("mtf"):
        syms, m, freqs = _symbols(last, n)
    with stage("entropy"):
        lens = ops_huf.code_lengths_device(freqs)
        canon = ops_huf.canonical_codes_device(lens)
        words, bits = ops_huf.encode_bitpack(syms, m, lens, canon)
        return _flatten_out(words, bits, lens, freqs, m, shift, cps, aper, n)


# The compact upload (bmh_tpu's _upload_batch): a batch whose padding would
# waste more than 4 quanta goes to the card as one byte stream padded to a
# multiple of this quantum, and inflate_program rebuilds the padded batch
# there; the quantum bounds the inflate programs a batch shape can need
_UPLOAD_QUANTUM = 1 << 19

# host->device uploads of compress batches since the process started:
# batches sent plain and compact, the bytes of their data sent, and the
# bytes the plain (rows, nmax) upload would have sent; and the blocks whose
# RLE1 ran on the card, those of them it shrank, and those collapsed on the
# host instead (_rle1_on_host)
UPLOADS = {"plain": 0, "compact": 0, "bytes": 0, "plain_bytes": 0,
           "rle1_device_rows": 0, "rle1_device_collapsed": 0, "rle1_host_rows": 0}


def inflate_program(flat: torch.Tensor, offs: torch.Tensor, ns: torch.Tensor,
                    nmax: int) -> torch.Tensor:
    """bmh_tpu's _inflate_prog: (s,) uint8 compact stream, (B,) offsets and
    lengths -> (B, nmax) uint8 padded batch, zero past each row's length.
    Row r is flat[clamp(offs[r], 0, s - nmax) + arange(nmax)], one gather
    (dynamic_slice's start clamp)."""
    pos = torch.arange(nmax, device=flat.device)
    start = offs.clamp(0, flat.shape[0] - nmax)
    rows = flat[start[:, None] + pos[None, :]]
    return torch.where(pos[None, :] < ns[:, None], rows, 0)


def _upload_batch(arrs, idxs, ns: np.ndarray, nmax: int, rows: int):
    """A dispatch's batch as the compress program's `data` input, by
    bmh_tpu's rule: the plain (rows, nmax) array, or (where the padding
    would waste more than 4 quanta) a Feed of inflate_program on the
    compact stream of the blocks back to back, padded to a multiple of
    _UPLOAD_QUANTUM.  Rows past the batch read offset 0 with length ns
    (1), as in bmh_tpu."""
    total = int(sum(arrs[i].size for i in idxs))
    q = _UPLOAD_QUANTUM
    s = max(-(-(total + nmax) // q) * q, q)
    UPLOADS["plain_bytes"] += rows * nmax
    if s + 4 * q >= rows * nmax:
        batch = np.zeros((rows, nmax), dtype=np.uint8)
        for row, i in enumerate(idxs):
            batch[row, : arrs[i].size] = arrs[i]
        UPLOADS["plain"] += 1
        UPLOADS["bytes"] += batch.nbytes
        return batch
    flat = np.zeros(s, dtype=np.uint8)
    offs = np.zeros(rows, dtype=np.int64)
    off = 0
    for row, i in enumerate(idxs):
        flat[off: off + arrs[i].size] = arrs[i]
        offs[row] = off
        off += arrs[i].size
    UPLOADS["compact"] += 1
    UPLOADS["bytes"] += flat.nbytes + offs.nbytes + ns.nbytes
    k = programs.key("inflate", b_pad=rows, nmax=nmax, s=s)
    return programs.Feed(k, functools.partial(inflate_program, nmax=nmax),
                         (flat, offs, ns))


def _compress_dispatch(arrs, idxs, nmax: int, stride: int, hard: bool,
                       b_pad: int, device, rle1: bool = False):
    """Dispatch the blocks `idxs` on `device`: stage them (on a card as a
    b_pad-row batch, so that shapes repeat; the CPU keeps no graph to
    reuse and takes the rows as they are) by _upload_batch, run the
    compress program (hard: the full-rounds one; rle1: the blocks are raw,
    and their RLE1 runs first) through the program cache and start the ONE
    copy of [per-block meta | compacted payload words] to the host.
    Returns (the copy, (rows, meta columns))."""
    rows = b_pad if device.type == "cuda" else len(idxs)
    with annotate("pipeline.stage"):
        ns = np.ones(rows, dtype=np.int64)  # dummy rows compress n = 1
        for row, i in enumerate(idxs):
            ns[row] = arrs[i].size
        data = _upload_batch(arrs, idxs, ns, nmax, rows)
    name = ("compress_full" if hard else "compress_sparse") + ("_rle1" if rle1 else "")
    k = programs.key(name, b_pad=rows, nmax=nmax, stride=stride)
    fn = functools.partial(compress_program, stride=stride, hard=hard, b_pad=b_pad,
                           rle1=rle1)
    if rle1:
        UPLOADS["rle1_device_rows"] += len(idxs)
    return programs.run(device, k, fn, (data, ns)), (rows, _meta_cols(nmax, stride))


def _compress_unpack(part, arrs, idxs, stride: int) -> list[dict]:
    """Wait for a compress dispatch's copy; returns its per-block result
    dicts, each block's "orig_len" the length its BWT took (shorter than
    the block where the program's RLE1 shrank it, which UPLOADS
    counts)."""
    copy, (rows, cols) = part
    host = copy.wait()
    meta_np = host[: rows * cols].reshape(rows, cols).astype(np.int64)
    flat_np = host[rows * cols:].view(np.uint32).astype(">u4")
    woffs = np.cumsum(meta_np[:, 1]) - meta_np[:, 1]
    results = []
    for row, i in enumerate(idxs):
        tb, nwr, sh, mr, ap, n_r = (int(v) for v in meta_np[row, :6])
        UPLOADS["rle1_device_collapsed"] += n_r < arrs[i].size
        present = meta_np[row, 6:6 + A].astype(bool)
        lens_r = meta_np[row, 6 + A:6 + 2 * A].astype(np.uint8)
        payload = (flat_np[woffs[row]: woffs[row] + nwr].tobytes()[: (tb + 7) // 8]
                   if (lens_r > 0).any() else b"")
        results.append({
            "orig_len": n_r,
            "shift": sh,
            "lens": lens_r,
            "present": present,
            "payload": payload,
            "total_bits": tb,
            "rle_len": mr,
            "cps": (meta_np[row, 6 + 2 * A:6 + 2 * A + _n_cps(n_r, stride)]
                    .astype(np.int32) if ap else None),
        })
    return results


# ---------------------------------------------------------------------------
# Decompress
# ---------------------------------------------------------------------------

def _stage_flat_np(blocks: list[dict], idxs: list[int], chunk_bits: int,
                   pad: bool = True):
    """Host staging of a batch on one flat chunk axis, as bmh_tpu's: every
    block's payload padded to whole chunks, back to back, plus per-chunk
    block ids and per-block tables and scalars.  With `pad` the shapes are
    bmh_tpu's buckets, so that programs are reused: b_pad = the batch
    rounded up to a power of two (rows past the batch: ns = ms = 1, no
    chunks), the chunk count rounded up to a power of two times the chunks
    of CHUNK_ALIGN_BITS; each pad chunk is a block of its own in a dummy
    row b_pad (no code lengths, ms = 0), so it decodes to nothing.  A
    dispatch pads on a card only: the CPU keeps no graph to reuse, and its
    plain versions pay for every pad row and chunk (b_pad is then the
    batch).  Returns numpy arrays (lens_all, ms and ns with b_pad + 1 rows,
    shifts with b_pad) and maxl."""
    wbytes = chunk_bits // 8
    b_pad = _next_pow2(len(idxs)) if pad else len(idxs)
    spans = []  # (start_chunk, n_chunks) per block
    nc_true = 0
    maxl = 0
    for i in idxs:
        nc_b = max(1, -(-len(blocks[i]["payload"]) // wbytes))
        spans.append((nc_true, nc_b))
        nc_true += nc_b
        maxl = max(maxl, int(np.asarray(blocks[i]["lens"]).max()))
    maxl = min(max(8, -(-maxl // 8) * 8), 31)
    align = max(CHUNK_ALIGN_BITS // chunk_bits, 1)
    nc = _next_pow2(-(-nc_true // align)) * align if pad else nc_true
    words = np.zeros(nc * wbytes // 4, dtype=np.uint32)
    lens_all = np.zeros((b_pad + 1, A), dtype=np.int64)
    seg_id = np.full(nc, b_pad, dtype=np.int64)
    seg_start = np.zeros(nc, dtype=bool)
    seg_start[nc_true:] = True
    seg_start_idx = np.arange(nc, dtype=np.int64)
    ms = np.ones(b_pad + 1, dtype=np.int64)
    ms[b_pad] = 0
    ns = np.ones(b_pad + 1, dtype=np.int64)
    shifts = np.zeros(b_pad, dtype=np.int64)
    for row, (i, (c0, nc_b)) in enumerate(zip(idxs, spans)):
        blk = blocks[i]
        buf = blk["payload"] + b"\x00" * (nc_b * wbytes - len(blk["payload"]))
        words[c0 * wbytes // 4:(c0 + nc_b) * wbytes // 4] = np.frombuffer(buf, dtype=">u4")
        lens_all[row, : np.asarray(blk["lens"]).size] = np.asarray(blk["lens"])
        seg_id[c0:c0 + nc_b] = row
        seg_start[c0] = True
        seg_start_idx[c0:c0 + nc_b] = c0
        ns[row] = int(blk["orig_len"])
        ms[row] = int(blk["rle_len"])
        shifts[row] = int(blk["shift"])
    return (words, lens_all, seg_start, seg_start_idx, seg_id, ms, ns, shifts,
            maxl)


def _tables(words, lens_all, seg_id, chunk_bits: int):
    """Device decode tables: (wext, count_t (32, NC) int32, sym (B, A))."""
    count_b, sym_b = ops_huf.decode_tables_device(lens_all)
    count_t = count_b[seg_id].T.to(torch.int32).contiguous()
    return ops_huf.words_ext(words, chunk_bits), count_t, sym_b


def _compact_rows(data: torch.Tensor, totals: torch.Tensor,
                  ncopy: torch.Tensor) -> torch.Tensor:
    """bmh_tpu's _compact_rows_diag at a static size: the first ncopy[r]
    bytes of each row r back to back, then each row's decoded total as 8
    little-endian bytes, in a (B * Nmax + 8 * B,) uint8 buffer.  The host
    knows sum(ncopy) and copies only that and the real rows' trailer."""
    b, nmax = data.shape
    dev = data.device
    cap = b * nmax + 8 * b
    offs = torch.cumsum(ncopy, 0) - ncopy
    i = torch.arange(nmax, device=dev)[None, :]
    dest = torch.where(i < ncopy[:, None], offs[:, None] + i, cap)
    dest_t = (ncopy.sum() + 8 * torch.arange(b, device=dev)[:, None]
              + torch.arange(8, device=dev)[None, :])
    out = torch.zeros(cap + 1, dtype=torch.uint8, device=dev)
    out = out.scatter_(0, torch.cat([dest.reshape(-1), dest_t.reshape(-1)]),
                       torch.cat([data.reshape(-1),
                                  totals.contiguous().view(torch.uint8)]))
    return out[:cap]


def decode_flat(words, lens_all, seg_start, seg_start_idx, seg_id, ms, ns,
                shifts, cps, nmax: int, chunk_bits: int, maxl: int,
                stride: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The flat route on device tensors: fused gap decode + inverse MTF +
    cursor iBWT.  Takes _stage_flat_np's arrays (cps (B, k) with one row a
    shift).  Returns ((B, nmax) uint8 rows, (B,) int64 decoded totals), B
    = the rows of `shifts` (the dummy row of pad chunks dropped)."""
    wext, count_t, sym_b = _tables(words, lens_all, seg_id, chunk_bits)
    codes, totals = ops_huf.gap_decode_rle0_flat(
        wext, count_t, seg_start, seg_start_idx, seg_id, sym_b, ms, ns,
        nmax, chunk_bits, maxl)
    b = shifts.shape[0]
    last = ops_mtf.mtf_inverse(codes[:b], ns[:b], config_mod.DEFAULT.imtf_chunk)
    return (ops_bwt.bwt_inverse_cursors(last, shifts, cps, ns[:b], stride),
            totals[:b])


def decode_flat_program(words, lens_all, seg_start, seg_start_idx, seg_id, ms,
                        ns, shifts, cps, ncopy, nmax: int, chunk_bits: int,
                        maxl: int, stride: int) -> torch.Tensor:
    """The flat route as one program: decode_flat, then the rows compacted
    with their totals (_compact_rows; ncopy is ns with 0 past the batch)."""
    data, totals = decode_flat(words, lens_all, seg_start, seg_start_idx,
                               seg_id, ms, ns, shifts, cps, nmax, chunk_bits,
                               maxl, stride)
    return _compact_rows(data, totals, ncopy)


def decompress_stage2_fn(syms: torch.Tensor, m: torch.Tensor,
                         shift: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(B, Nmax) RLE0 symbols -> original block bytes (doubling iBWT)."""
    codes = ops_rle.rle0_decode(syms, m, n)
    last = ops_mtf.mtf_inverse(codes, n, config_mod.DEFAULT.imtf_chunk)
    return ops_bwt.bwt_inverse(last, shift, n)


def decode_flat_periodic(words, lens_all, seg_start, seg_start_idx, seg_id,
                         ms, ns, shifts, nmax: int, chunk_bits: int,
                         maxl: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The periodic route (no cursor checkpoints: the rank is no
    bijection): gap decode to RLE0 symbols (K1, K2), their exact decoded
    totals, then RLE0 inverse + inverse MTF (K3) + doubling iBWT.  Returns
    decode_flat's pair."""
    wext, count_t, sym_b = _tables(words, lens_all, seg_id, chunk_bits)
    syms = ops_huf.gap_decode_flat(wext, count_t, seg_start, seg_start_idx,
                                   seg_id, sym_b, ms, nmax, chunk_bits, maxl)
    b = shifts.shape[0]
    syms, ms, ns = syms[:b], ms[:b], ns[:b]
    totals = ops_rle.rle0_decoded_len(syms, ms)
    return decompress_stage2_fn(syms, ms, shifts, ns), totals


def decode_periodic_program(words, lens_all, seg_start, seg_start_idx, seg_id,
                            ms, ns, shifts, ncopy, nmax: int, chunk_bits: int,
                            maxl: int) -> torch.Tensor:
    """The periodic route as one program (bmh_tpu's _decode_flat_periodic):
    decode_flat_periodic, then the rows compacted with their totals."""
    data, totals = decode_flat_periodic(words, lens_all, seg_start, seg_start_idx,
                                        seg_id, ms, ns, shifts, nmax, chunk_bits,
                                        maxl)
    return _compact_rows(data, totals, ncopy)


def _decompress_dispatch(blocks, idxs, nmax: int, stride: int | None, device):
    """Dispatch one batch on `device` by the flat route, or the periodic
    route when stride is None: stage it on the host, then run the route's
    program through the cache (a captured graph on a card: decode, compact
    the rows with their totals) and start the ONE copy of [bytes | decoded
    totals] to the host.  Nothing here waits for the card.  Returns (the
    copy, the block lengths)."""
    chunk_bits = config_mod.DEFAULT.decode_chunk_bits
    with annotate("pipeline.stage"):
        staged = _stage_flat_np(blocks, idxs, chunk_bits, device.type == "cuda")
        words, lens_all, seg_start, seg_start_idx, seg_id, ms, ns, shifts, maxl = staged
        b, b_pad = len(idxs), shifts.size
        ncopy = np.zeros(b_pad, dtype=np.int64)
        ncopy[:b] = ns[:b]
        n_out = int(ncopy.sum()) + 8 * b
        arrays = (words.view(np.int32), lens_all, seg_start, seg_start_idx, seg_id,
                  ms, ns, shifts)
        if stride is not None:
            kcp = max(max(nmax // stride, 1) - 1, 1)
            cps = np.zeros((b_pad, kcp), dtype=np.int64)
            for row, i in enumerate(idxs):
                bc = blocks[i].get("cps")
                if bc is not None and len(bc) > 0:
                    cc = np.asarray(bc, dtype=np.int64)[:kcp]
                    cps[row, : cc.size] = cc
    if stride is None:
        k = programs.key("decode_periodic", b_pad=b_pad, nmax=nmax, nc=seg_id.size,
                         chunk_bits=chunk_bits, maxl=maxl)
        fn = functools.partial(decode_periodic_program, nmax=nmax,
                               chunk_bits=chunk_bits, maxl=maxl)
        return programs.run(device, k, fn, (*arrays, ncopy), n_out), ns[:b]
    k = programs.key("decode_flat", b_pad=b_pad, nmax=nmax, nc=seg_id.size,
                     chunk_bits=chunk_bits, maxl=maxl, stride=stride)
    fn = functools.partial(decode_flat_program, nmax=nmax, chunk_bits=chunk_bits,
                           maxl=maxl, stride=stride)
    return programs.run(device, k, fn, (*arrays, cps, ncopy), n_out), ns[:b]


def _decompress_drain(part, idxs, results) -> None:
    """Wait for a decompress dispatch's copy and slice its blocks into
    `results`; raises ValueError on a block whose decoded total is not its
    length."""
    with annotate("pipeline.drain"):
        copy, ns = part
        flat_np = copy.wait()
        total = int(ns.sum())
        totals = flat_np[total:].view("<i8")
        offs = np.cumsum(ns) - ns
        for row, i in enumerate(idxs):
            if int(totals[row]) != int(ns[row]):
                raise ValueError(
                    f"corrupt container: block {i}'s RLE0 stream decodes to "
                    f"{int(totals[row])} bytes, expected {int(ns[row])}")
            results[i] = flat_np[offs[row]: offs[row] + ns[row]]


def _stage_single_np(blocks: list[dict], idxs: list[int], pad: bool = True):
    """Host staging of a single-symbol batch: per row its one RLE0 symbol,
    symbol count, shift and length, padded (with `pad`) to b_pad = the
    batch rounded up to a power of two by bmh_tpu's dummy rows (symbol 0,
    ms = ns = 1, shift 0).  Returns (sym, ms, shifts, ns, ncopy) numpy
    arrays of b_pad rows, ncopy being ns with 0 past the batch."""
    b = len(idxs)
    b_pad = _next_pow2(b) if pad else b
    sym = np.zeros(b_pad, dtype=np.int64)
    ms = np.ones(b_pad, dtype=np.int64)
    ns = np.ones(b_pad, dtype=np.int64)
    shifts = np.zeros(b_pad, dtype=np.int64)
    for row, i in enumerate(idxs):
        blk = blocks[i]
        sym[row] = int(np.nonzero(np.asarray(blk["present"]))[0][0])
        ms[row] = int(blk["rle_len"])
        ns[row] = int(blk["orig_len"])
        shifts[row] = int(blk["shift"])
    ncopy = np.zeros(b_pad, dtype=np.int64)
    ncopy[:b] = ns[:b]
    return sym, ms, shifts, ns, ncopy


def decode_single_program(sym, ms, shifts, ns, ncopy, nmax: int) -> torch.Tensor:
    """The single-symbol route as one program (bmh_tpu's _batched_decode2 on
    the constant RLE0 stream): each row's stream, its first ms[r] symbols
    sym[r], made on the card; RLE0 inverse, inverse MTF (K3), doubling
    iBWT; then the rows compacted with their decoded totals."""
    pos = torch.arange(nmax, device=sym.device)[None, :]
    syms = torch.where(pos < ms[:, None], sym[:, None], 0)
    totals = ops_rle.rle0_decoded_len(syms, ms)
    return _compact_rows(decompress_stage2_fn(syms, ms, shifts, ns), totals, ncopy)


def _decompress_single(blocks, idxs, nmax: int, device):
    """Dispatch one single-symbol batch (no payload) on `device` through
    the cache (padded to b_pad on a card) and start its ONE copy of
    [bytes | decoded totals] to the host.  api._validate_block_info has
    checked that each stream decodes to its block length.  Returns
    _decompress_dispatch's pair."""
    with annotate("pipeline.stage"):
        staged = _stage_single_np(blocks, idxs, device.type == "cuda")
    ns = staged[3]
    b = len(idxs)
    k = programs.key("decode_single", b_pad=ns.size, nmax=nmax)
    fn = functools.partial(decode_single_program, nmax=nmax)
    return programs.run(device, k, fn, staged, int(ns[:b].sum()) + 8 * b), ns[:b]


# ---------------------------------------------------------------------------
# Dispatch: the in-flight window and the fan-out over devices
# ---------------------------------------------------------------------------

# the last compress / decompress fan-out, as bmh_tpu records it
LAST_DISPATCH = {"compress_ndev": 1, "decompress_ndev": 1}


def _ndev_for(b_pad: int, n_devices: int) -> int:
    """Devices to split a b_pad-block compress dispatch over: the largest
    power of two <= min(n_devices, b_pad)."""
    return 1 << max(min(n_devices, b_pad).bit_length() - 1, 0)


def _dispatch_on(device, label: str, fn):
    """fn(device) under `label`, on a card with that card current."""
    with annotate(label):
        if device.type != "cuda":
            return fn(device)
        with torch.cuda.device(device):
            return fn(device)


def _run_window(batches, drain, depth: int) -> None:
    """bmh_tpu's bounded in-flight window.

    `batches` yields (key, parts), a part being (device, label, dispatch);
    dispatch(device) returns (a programs.HostCopy, anything).  Batches are
    dispatched in order on the calling thread, and while more than `depth`
    wait, the oldest is drained by drain(key, [its parts' results]); the
    rest are drained in order at the end.  If a dispatch or a drain raises,
    every copy started lands before the error goes on."""
    pending: deque = deque()
    try:
        for key, parts in batches:
            done: list = []
            pending.append((key, done))
            for part in parts:
                done.append(_dispatch_on(*part))
            while len(pending) > depth:
                drain(*pending[0])
                pending.popleft()
        while pending:
            drain(*pending[0])
            pending.popleft()
    finally:
        for _, done in pending:
            for copy, _ in done:
                copy.wait()


# ---------------------------------------------------------------------------
# Backend
# ---------------------------------------------------------------------------

class TorchBackend:
    """Block codec on torch devices ("cuda" runs the kernels, "cpu" the
    plain PyTorch versions).  `devices` is one device or a list that the
    batches fan out over, of which the first BMH_DEVICES are kept (0 = all,
    as in bmh_tpu); a list may repeat a device ([cpu] * 4 drives the
    fan-out on the CPU)."""

    name = "torch"

    def __init__(self, devices):
        devs = devices if isinstance(devices, (list, tuple)) else [devices]
        cap = config_mod.DEFAULT.devices
        self.devices = [torch.device(d) for d in (devs[:cap] if cap > 0 else devs)]
        if not self.devices:
            raise ValueError("TorchBackend needs at least one device")

    def compress_blocks(self, blocks: list[np.ndarray], stride: int,
                        bucket: int | None = None,
                        full_rounds: bool = False) -> list[dict]:
        """The blocks are raw: each takes RLE1 where that strictly shrinks
        it (unless BMH_RLE1=0), on the card or, for a block _rle1_on_host
        picks where no bucket is forced, on the host; a result's "orig_len"
        is the block's length after RLE1.  bucket: force one padded size
        for every block; full_rounds: run the full-rounds program for every
        batch (the same bytes)."""
        results: list[dict | None] = [None] * len(blocks)
        groups: dict[tuple[int, bool, bool], list[int]] = defaultdict(list)
        with annotate("pipeline.group"):
            arrs = [np.asarray(b, dtype=np.uint8) for b in blocks]
            dev_rle1 = config_mod.DEFAULT.rle1
            on_card = [dev_rle1] * len(arrs)
            if dev_rle1 and bucket is None:
                with annotate("pipeline.rle1"):
                    for i, blk in enumerate(arrs):
                        if _rle1_on_host(blk):
                            arrs[i] = nativeio.rle1_encode(blk)
                            on_card[i] = False
                            UPLOADS["rle1_host_rows"] += 1
            for i, blk in enumerate(arrs):
                nmax = max(bucket, _bucket(blk.size)) if bucket else _bucket(blk.size)
                groups[(nmax, _looks_pathological(blk), on_card[i])].append(i)

        def batches():
            for (nmax, hard, dev_rle1), all_idxs in groups.items():
                for idxs in _chunks(all_idxs):
                    b_pad = _next_pow2(len(idxs))
                    ndev = _ndev_for(b_pad, len(self.devices))
                    LAST_DISPATCH["compress_ndev"] = ndev
                    # device d takes rows [d * b_loc, (d + 1) * b_loc) of
                    # the padded batch, with b_loc sizing its compact set
                    # as bmh_tpu's per-shard program; rows past the batch
                    # are padding, and a device with none of the real rows
                    # gets no work
                    b_loc = b_pad // ndev
                    shards = [s for s in (idxs[d * b_loc:(d + 1) * b_loc]
                                          for d in range(ndev)) if s]
                    yield shards, [
                        (self.devices[d], f"compress_dispatch_b{b_pad}",
                         functools.partial(_compress_dispatch, arrs, s, nmax,
                                           stride, hard or full_rounds, b_loc,
                                           rle1=dev_rle1))
                        for d, s in enumerate(shards)]

        def drain(shards, parts):
            with annotate("compress_assemble"):
                for s, part in zip(shards, parts):
                    for i, r in zip(s, _compress_unpack(part, arrs, s, stride)):
                        results[i] = r

        _run_window(batches(), drain, config_mod.DEFAULT.inflight)
        return results  # type: ignore[return-value]

    def decompress_blocks(self, blocks: list[dict],
                          bucket: int | None = None) -> list[np.ndarray]:
        """bucket: force a uniform padded block size.  Blocks are grouped
        as bmh_tpu groups them: single-symbol; periodic (no checkpoints,
        longer than one stride); the rest by (bucket, stride).  Flat and
        periodic batches go round-robin over the devices through the
        window; single-symbol batches run after them, one at a time, on the
        first device, as in bmh_tpu."""
        results: list[np.ndarray | None] = [None] * len(blocks)
        fgroups: dict[tuple[int, int], list[int]] = defaultdict(list)
        pgroups: dict[int, list[int]] = defaultdict(list)
        sgroups: dict[int, list[int]] = defaultdict(list)
        with annotate("pipeline.group"):
            for i, b in enumerate(blocks):
                n = int(b["orig_len"])
                stride = int(b["stride"])
                nmax = max(bucket, _bucket(n)) if bucket else _bucket(n)
                if n == 0:
                    results[i] = np.zeros(0, dtype=np.uint8)
                elif int(np.asarray(b["present"]).sum()) == 1:
                    sgroups[nmax].append(i)
                elif b.get("cps") is None and n > stride:
                    pgroups[nmax].append(i)
                else:
                    fgroups[(nmax, stride)].append(i)
            jobs = [(idxs, nmax, stride) for (nmax, stride), all_idxs in fgroups.items()
                    for idxs in _chunks(all_idxs)]
            jobs += [(idxs, nmax, None) for nmax, all_idxs in pgroups.items()
                     for idxs in _chunks(all_idxs)]
        devs = self.devices
        # successive dispatches round-robin over the devices by a
        # monotonic count, as in bmh_tpu; the window keeps at least one
        # dispatch a device in flight
        batches = ((idxs, [(devs[k % len(devs)], f"decompress_dispatch_b{len(idxs)}",
                            functools.partial(_decompress_dispatch, blocks, idxs,
                                              nmax, stride))])
                   for k, (idxs, nmax, stride) in enumerate(jobs))
        _run_window(batches, lambda idxs, parts: _decompress_drain(parts[0], idxs, results),
                    max(config_mod.DEFAULT.inflight, len(devs)))
        LAST_DISPATCH["decompress_ndev"] = max(1, min(len(jobs), len(devs)))
        for nmax, all_idxs in sgroups.items():
            for idxs in _chunks(all_idxs):
                part = _dispatch_on(self.devices[0], f"decompress_single_b{len(idxs)}",
                                    functools.partial(_decompress_single, blocks,
                                                      idxs, nmax))
                _decompress_drain(part, idxs, results)
        return results  # type: ignore[return-value]
