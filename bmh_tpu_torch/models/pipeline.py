"""Batched block codec on torch devices — the port's backend.

Compress, bmh_tpu's two programs: BWT with checkpoints -> MTF -> RLE0 ->
histogram -> two-queue code lengths -> canonical codes -> bitpack, for a
batch of blocks at once, then one device->host copy of [per-block metadata
| compacted payload words].  The BWT runs the sparse/adaptive program
(`compress_sparse_fn`: a few doubling rounds, the adaptive handoff, sparse
refinement of the tied positions) unless the batch looks run-dominated,
which takes the full-rounds program (`compress_full_fn`).

Decompress, bmh_tpu's three routes:
* flat (aperiodic blocks): host staging of the batch's payloads on one
  flat chunk axis -> fused gap decode + RLE0 inverse (kernels K1, K2) ->
  inverse MTF (K3) -> LF-cursor inverse BWT (K4) -> row compaction;
* periodic (no checkpoints): the same gap decode to RLE0 symbols, then
  RLE0 inverse, inverse MTF (K3) and the doubling inverse BWT;
* single-symbol (no payload): the constant RLE0 stream, then the inverses.
The flat and periodic routes bring each block's decoded total back in the
same single copy, and a total that differs from the block length raises.

Blocks are grouped by power-of-two size bucket and batched up to
`max_dispatch` blocks.  PyTorch runs eagerly, so no program cache exists
and every knob is read at call time.

Dispatch, bmh_tpu's: each batch is split into a *dispatch* (stage, upload,
launch, start the one device->host copy) and a *drain* (wait for the copy,
unpack), and up to `inflight` (BMH_INFLIGHT) batches wait between the two
(`_run_window`).  A decompress dispatch never waits for the card, so the
host stages batch k+1 while the card decodes batch k; a compress dispatch
waits inside (a tie count a round), so its window holds only the copies.
Every dispatch runs on the calling thread with its device current.  A
compress dispatch of b_pad blocks splits its rows over `_ndev_for(b_pad)`
of the backend's devices, as bmh_tpu's shard_map splits the block axis;
decompress dispatches go round-robin over them.  `LAST_DISPATCH` records
the last fan-out of each direction.
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
from ..utils import config as config_mod
from ..utils.tracing import annotate

A = ops_rle.RLE_ALPHABET
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


# ---------------------------------------------------------------------------
# Compress
# ---------------------------------------------------------------------------

def _encode(last: torch.Tensor, n: torch.Tensor):
    """Last column -> (words, total_bits, lens, freqs, m RLE0 counts)."""
    cfg = config_mod.DEFAULT
    codes = ops_mtf.mtf_forward(last, n, cfg.mtf_chunk)
    syms, m = ops_rle.rle0_encode(codes, n)
    freqs = ops_huf.histogram(syms, m, A)
    lens = ops_huf.code_lengths_device(freqs)
    canon = ops_huf.canonical_codes_device(lens)
    words, total_bits = ops_huf.encode_bitpack(syms, m, lens, canon)
    return words, total_bits, lens, freqs, m


def compress_full_fn(data: torch.Tensor, n: torch.Tensor, stride: int):
    """Whole compress of a (B, Nmax) batch by the full-rounds program.

    Returns (words (B, W) int64 uint32 values, total_bits, lens (B, 257),
    freqs (B, 257), m RLE0 counts, shift, cps, aperiodic)."""
    last, shift, cps, aperiodic = ops_bwt.bwt_forward_cp(data, n, stride)
    return (*_encode(last, n), shift, cps, aperiodic)


def compress_sparse_fn(data: torch.Tensor, n: torch.Tensor, stride: int,
                       b_pad: int):
    """Whole compress of a (B, Nmax) batch by the sparse/adaptive program;
    b_pad is the batch size rounded up to a power of two, which sizes the
    compact set.  Returns compress_full_fn's tuple."""
    rank = sparse_ranks(data, n, b_pad)
    last, shift, cps, aperiodic = ops_bwt.bwt_finish_cp(data, n, rank, stride)
    return (*_encode(last, n), shift, cps, aperiodic)


def _sparse_cap(b_pad: int, nmax: int) -> int:
    """Compact-set capacity: 1/sparse_cap_div of the padded batch, at least
    _SPARSE_MIN, at most the batch itself.  With b_pad and nmax powers of
    two it is one too, so the compact sorts fit K5's envelope."""
    div = config_mod.DEFAULT.sparse_cap_div
    return min(max((b_pad * nmax) // div, _SPARSE_MIN), b_pad * nmax)


def sparse_ranks(data: torch.Tensor, n: torch.Tensor, b_pad: int) -> torch.Tensor:
    """Final BWT ranks by bmh_tpu's adaptive handoff (_compress_core with
    hard=False).

    Doubling rounds stop at h = 2^(full_rounds + 1).  While the batch's tied
    positions exceed the compact capacity, whole-batch rounds go on (only
    rows with ties are sorted: for the others a round changes nothing); the
    tied set is then refined sparsely from the gap reached.  One sync per
    round reads the per-row tie counts."""
    cfg = config_mod.DEFAULT
    nmax = data.shape[1]
    m_cap = _sparse_cap(b_pad, nmax)
    h_s = 1 << (cfg.full_rounds + 1)
    rank, tied, _, _ = ops_bwt.bwt_rounds(data, n, h_s)
    cnt = tied.sum(dim=1).tolist()
    while sum(cnt) > m_cap and h_s < nmax:
        rows = torch.tensor([r for r, c in enumerate(cnt) if c], device=data.device)
        sub, sub_tied, h_s, _ = ops_bwt.round_step(rank[rows], tied[rows], h_s, n[rows])
        rank[rows] = sub
        tied[rows] = sub_tied
        cnt = tied.sum(dim=1).tolist()
    total = sum(cnt)
    if total > m_cap:
        # only h_s >= nmax with ties left (exactly periodic blocks): doubling
        # has covered every block, the ranks are final and this exits at once
        return ops_bwt.bwt_rounds_resume(rank, torch.zeros_like(tied), h_s,
                                         torch.zeros_like(n, dtype=torch.bool),
                                         n)[0]
    if total == 0:
        return rank
    return _sparse_refine_compact(rank, tied, n, m_cap, h_s)


def _sparse_refine_compact(rank: torch.Tensor, tied: torch.Tensor,
                           ns: torch.Tensor, m_cap: int, h0: int) -> torch.Tensor:
    """Compact the tied positions of the batch (in index order, pads
    blk == B) into an m_cap set and refine them from gap h0."""
    b, nmax = rank.shape
    dev = rank.device
    flat = tied.reshape(-1)
    dest = torch.where(flat, torch.cumsum(flat, 0) - 1, m_cap)
    idx = torch.full((m_cap + 1,), b * nmax, dtype=torch.int64, device=dev)
    idx = idx.scatter_(0, dest, torch.arange(b * nmax, device=dev))[:m_cap]
    blk = idx // nmax
    pos = idx - blk * nmax
    nb = ns[blk.clamp(0, b - 1)]
    # hm0 = h0 mod nb by bmh_tpu's binary conditional subtraction (the
    # quotient is at most h0 <= nmax); products past nmax are masked to
    # int32-max as there, so the ladder gives bmh_tpu's values exactly
    hm = torch.full((m_cap,), h0, dtype=torch.int64, device=dev)
    q = 1 << (nmax.bit_length() - 1)
    while q >= 1:
        prod = torch.where(nb <= nmax // q, nb * q, 2**31 - 1)
        hm = torch.where(hm >= prod, hm - prod, hm)
        q //= 2
    cfg = config_mod.DEFAULT
    return ops_bwt.sparse_refine(rank, blk, pos, hm, ns, h0,
                                 tier1_rounds=cfg.tier1_rounds,
                                 tier2_div=cfg.tier2_div)


class _HostCopy:
    """The device->host copy that ends a dispatch: on a card, into pinned
    memory with an event recorded after it (started, not waited for); on
    the CPU, the tensor itself."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type != "cuda":
            self.host = t
            return
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _compress_dispatch(arrs, idxs, nmax: int, stride: int, hard: bool,
                       b_pad: int, device):
    """Dispatch the blocks `idxs` on `device`: stage and upload them, run
    the compress program (hard: the full-rounds one; b_pad sizes the
    sparse one's compact set) and start the ONE copy of [per-block meta |
    compacted payload words] to the host.  Returns (the copy, the meta's
    column count)."""
    b = len(idxs)
    batch = np.zeros((b, nmax), dtype=np.uint8)
    ns = np.zeros(b, dtype=np.int64)
    for row, i in enumerate(idxs):
        batch[row, : arrs[i].size] = arrs[i]
        ns[row] = arrs[i].size
    data = _put(batch, device)
    n = _put(ns, device)
    if hard:
        out = compress_full_fn(data, n, stride)
    else:
        out = compress_sparse_fn(data, n, stride, b_pad)
    words, bits, lens, freqs, m, shift, cps, aper = out

    # ragged concat of each block's word-aligned payload: meta row = bits,
    # nw, shift, m, aperiodic, present (257), lens (257), cps (k)
    nw = (bits + 31) // 32
    slot = torch.arange(words.shape[1], device=data.device)[None, :]
    flat = words[slot < nw[:, None]]
    meta = torch.cat([torch.stack([bits, nw, shift, m, aper.to(torch.int64)], 1),
                      (freqs > 0).to(torch.int64), lens, cps], dim=1)
    return _HostCopy(torch.cat([meta.reshape(-1), flat])), meta.shape[1]


def _compress_unpack(part, arrs, idxs, stride: int) -> list[dict]:
    """Wait for a compress dispatch's copy; returns its per-block result
    dicts."""
    copy, cols = part
    host = copy.wait()
    b = len(idxs)
    meta_np = host[: b * cols].reshape(b, cols)
    flat_np = host[b * cols:].astype(">u4")
    woffs = np.cumsum(meta_np[:, 1]) - meta_np[:, 1]
    results = []
    for row, i in enumerate(idxs):
        tb, nwr, sh, mr, ap = (int(v) for v in meta_np[row, :5])
        present = meta_np[row, 5:5 + A].astype(bool)
        lens_r = meta_np[row, 5 + A:5 + 2 * A].astype(np.uint8)
        n_r = int(arrs[i].size)
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
            "cps": (meta_np[row, 5 + 2 * A:5 + 2 * A + _n_cps(n_r, stride)]
                    .astype(np.int32) if ap else None),
        })
    return results


# ---------------------------------------------------------------------------
# Decompress
# ---------------------------------------------------------------------------

def _stage_flat_np(blocks: list[dict], idxs: list[int], chunk_bits: int):
    """Host staging of a batch on one flat chunk axis: every block's payload
    padded to whole chunks, back to back, plus per-chunk block ids and
    per-block tables and scalars.  Returns numpy arrays and maxl."""
    wbytes = chunk_bits // 8
    spans = []  # (start_chunk, n_chunks) per block
    nc = 0
    maxl = 0
    for i in idxs:
        nc_b = max(1, -(-len(blocks[i]["payload"]) // wbytes))
        spans.append((nc, nc_b))
        nc += nc_b
        maxl = max(maxl, int(np.asarray(blocks[i]["lens"]).max()))
    maxl = min(max(8, -(-maxl // 8) * 8), 31)
    b = len(idxs)
    words = np.zeros(nc * wbytes // 4, dtype=np.uint32)
    lens_all = np.zeros((b, A), dtype=np.int64)
    seg_id = np.zeros(nc, dtype=np.int64)
    seg_start = np.zeros(nc, dtype=bool)
    seg_start_idx = np.zeros(nc, dtype=np.int64)
    ms = np.zeros(b, dtype=np.int64)
    ns = np.zeros(b, dtype=np.int64)
    shifts = np.zeros(b, dtype=np.int64)
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
                  ns: np.ndarray) -> torch.Tensor:
    """The decoded rows compacted back to back (sum(ns) bytes), then each
    row's decoded total as 8 little-endian bytes, so the caller's single
    copy carries the integrity trailer.  The lengths are host data: the
    compaction's size is known without waiting for the card."""
    rows = [data[row, :n] for row, n in enumerate(ns.tolist())]
    return torch.cat(rows + [totals.contiguous().view(torch.uint8)])


def decode_flat(words, lens_all, seg_start, seg_start_idx, seg_id, ms, ns,
                shifts, cps, nmax: int, chunk_bits: int, maxl: int,
                stride: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The flat route on device tensors: fused gap decode + inverse MTF +
    cursor iBWT.  Returns ((B, nmax) uint8 rows, (B,) int64 decoded
    totals)."""
    wext, count_t, sym_b = _tables(words, lens_all, seg_id, chunk_bits)
    codes, totals = ops_huf.gap_decode_rle0_flat(
        wext, count_t, seg_start, seg_start_idx, seg_id, sym_b, ms, ns,
        nmax, chunk_bits, maxl)
    last = ops_mtf.mtf_inverse(codes, ns, config_mod.DEFAULT.imtf_chunk)
    return ops_bwt.bwt_inverse_cursors(last, shifts, cps, ns, stride), totals


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
    totals = ops_rle.rle0_decoded_len(syms, ms)
    return decompress_stage2_fn(syms, ms, shifts, ns), totals


def _decompress_dispatch(blocks, idxs, nmax: int, stride: int | None, device):
    """Dispatch one batch on `device` by the flat route, or the periodic
    route when stride is None: stage it on the host, upload, decode,
    compact the rows and start the ONE copy of [bytes | decoded totals] to
    the host.  Nothing here waits for the card.  Returns (the copy, the
    block lengths)."""
    chunk_bits = config_mod.DEFAULT.decode_chunk_bits
    (words, lens_all, seg_start, seg_start_idx, seg_id, ms, ns, shifts,
     maxl) = _stage_flat_np(blocks, idxs, chunk_bits)
    args = tuple(_put(x, device) for x in (words.view(np.int32), lens_all,
                                           seg_start, seg_start_idx, seg_id,
                                           ms, ns, shifts))
    if stride is None:
        data, totals = decode_flat_periodic(*args, nmax, chunk_bits, maxl)
    else:
        kcp = max(max(nmax // stride, 1) - 1, 1)
        cps = np.zeros((len(idxs), kcp), dtype=np.int64)
        for row, i in enumerate(idxs):
            bc = blocks[i].get("cps")
            if bc is not None and len(bc) > 0:
                cc = np.asarray(bc, dtype=np.int64)[:kcp]
                cps[row, : cc.size] = cc
        data, totals = decode_flat(*args, _put(cps, device), nmax, chunk_bits,
                                   maxl, stride)
    return _HostCopy(_compact_rows(data, totals, ns)), ns


def _decompress_drain(part, idxs, results) -> None:
    """Wait for a decompress dispatch's copy and slice its blocks into
    `results`; raises ValueError on a block whose decoded total is not its
    length."""
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


def _decompress_single(blocks, idxs, nmax: int, device, results):
    """Single-symbol blocks (no payload): the constant RLE0 stream, then the
    inverse transforms.  api._validate_block_info has checked that it
    decodes to the block length."""
    b = len(idxs)
    syms = np.zeros((b, nmax), dtype=np.int64)
    ms = np.zeros(b, dtype=np.int64)
    ns = np.zeros(b, dtype=np.int64)
    shifts = np.zeros(b, dtype=np.int64)
    for row, i in enumerate(idxs):
        blk = blocks[i]
        ms[row] = int(blk["rle_len"])
        syms[row, : ms[row]] = int(np.nonzero(np.asarray(blk["present"]))[0][0])
        ns[row] = int(blk["orig_len"])
        shifts[row] = int(blk["shift"])
    data = decompress_stage2_fn(*(torch.from_numpy(x).to(device)
                                  for x in (syms, ms, shifts, ns)))
    data_np = data.cpu().numpy()
    for row, i in enumerate(idxs):
        results[i] = data_np[row, : ns[row]]


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
    dispatch(device) returns (a _HostCopy, anything).  Batches are
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
        """bucket: force one padded size for every block; full_rounds: run
        the full-rounds program for every batch (the same bytes)."""
        results: list[dict | None] = [None] * len(blocks)
        groups: dict[tuple[int, bool], list[int]] = defaultdict(list)
        arrs = [np.asarray(b, dtype=np.uint8) for b in blocks]
        for i, blk in enumerate(arrs):
            nmax = max(bucket, _bucket(blk.size)) if bucket else _bucket(blk.size)
            groups[(nmax, _looks_pathological(blk))].append(i)

        def batches():
            for (nmax, hard), all_idxs in groups.items():
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
                                           stride, hard or full_rounds, b_loc))
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
                _decompress_single(blocks, idxs, nmax, self.devices[0], results)
        return results  # type: ignore[return-value]
