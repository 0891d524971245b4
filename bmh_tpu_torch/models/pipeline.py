"""Batched block codec on one torch device — the port's backend.

Compress (bmh_tpu's classic full-rounds program, `compress_full_fn`): BWT
with checkpoints -> MTF -> RLE0 -> histogram -> two-queue code lengths ->
canonical codes -> bitpack, for a batch of blocks at once, then one
device->host copy of [per-block metadata | compacted payload words].

Decompress (bmh_tpu's flat route): host staging of the batch's payloads on
one flat chunk axis -> fused gap decode + RLE0 inverse (kernels K1, K2) ->
inverse MTF (K3) -> LF-cursor inverse BWT (K4) -> row compaction, with
each block's decoded total riding the same single copy back.

Blocks are grouped by power-of-two size bucket and batched up to
`max_dispatch` blocks.  PyTorch runs eagerly, so no program cache exists
and every knob is read at call time.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..ops import bwt as ops_bwt
from ..ops import huffman as ops_huf
from ..ops import mtf as ops_mtf
from ..ops import rle as ops_rle
from ..utils import config as config_mod

A = ops_rle.RLE_ALPHABET


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length()


def _bucket(n: int) -> int:
    return max(config_mod.DEFAULT.min_bucket, _next_pow2(n))


def _n_cps(n: int, stride: int) -> int:
    """Checkpoints stored for a block of true length n."""
    return max(-(-n // stride) - 1, 0)


def _chunks(seq: list, size: int | None = None):
    size = size or config_mod.DEFAULT.max_dispatch
    return [seq[i:i + size] for i in range(0, len(seq), size)]


# ---------------------------------------------------------------------------
# Compress
# ---------------------------------------------------------------------------

def compress_full_fn(data: torch.Tensor, n: torch.Tensor, stride: int):
    """Whole compress of a (B, Nmax) batch: raw bytes -> packed words.

    Returns (words (B, W) int64 uint32 values, total_bits, lens (B, 257),
    freqs (B, 257), m RLE0 counts, shift, cps, aperiodic)."""
    cfg = config_mod.DEFAULT
    last, shift, cps, aperiodic = ops_bwt.bwt_forward_cp(data, n, stride)
    codes = ops_mtf.mtf_forward(last, n, cfg.mtf_chunk)
    syms, m = ops_rle.rle0_encode(codes, n)
    freqs = ops_huf.histogram(syms, m, A)
    lens = ops_huf.code_lengths_device(freqs)
    canon = ops_huf.canonical_codes_device(lens)
    words, total_bits = ops_huf.encode_bitpack(syms, m, lens, canon)
    return words, total_bits, lens, freqs, m, shift, cps, aperiodic


def _compress_batch(arrs, idxs, nmax: int, device, stride: int):
    """Compress one batch; returns its per-block result dicts."""
    b = len(idxs)
    batch = np.zeros((b, nmax), dtype=np.uint8)
    ns = np.zeros(b, dtype=np.int64)
    for row, i in enumerate(idxs):
        batch[row, : arrs[i].size] = arrs[i]
        ns[row] = arrs[i].size
    data = torch.from_numpy(batch).to(device)
    n = torch.from_numpy(ns).to(device)
    words, bits, lens, freqs, m, shift, cps, aper = compress_full_fn(data, n, stride)

    # ragged concat of each block's word-aligned payload, then ONE copy of
    # [meta | payload]: meta row = bits, nw, shift, m, aperiodic,
    # present (257), lens (257), cps (k)
    nw = (bits + 31) // 32
    slot = torch.arange(words.shape[1], device=data.device)[None, :]
    flat = words[slot < nw[:, None]]
    meta = torch.cat([torch.stack([bits, nw, shift, m, aper.to(torch.int64)], 1),
                      (freqs > 0).to(torch.int64), lens, cps], dim=1)
    host = torch.cat([meta.reshape(-1), flat]).cpu().numpy()
    cols = meta.shape[1]
    meta_np = host[: b * cols].reshape(b, cols)
    flat_np = host[b * cols:].astype(">u4")
    woffs = np.cumsum(meta_np[:, 1]) - meta_np[:, 1]
    results = []
    for row in range(b):
        tb, nwr, sh, mr, ap = (int(v) for v in meta_np[row, :5])
        present = meta_np[row, 5:5 + A].astype(bool)
        lens_r = meta_np[row, 5 + A:5 + 2 * A].astype(np.uint8)
        n_r = int(ns[row])
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
# Decompress (flat route)
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


def decode_flat(words, lens_all, seg_start, seg_start_idx, seg_id, ms, ns,
                shifts, cps, nmax: int, chunk_bits: int, maxl: int,
                stride: int) -> torch.Tensor:
    """Fused flat gap decode + inverse MTF + cursor iBWT on device tensors.

    Returns one uint8 tensor: the decoded rows compacted back to back
    (sum(ns) bytes), then each row's decoded total as 8 little-endian
    bytes — so the caller's single copy carries the integrity trailer."""
    count_b, sym_b = ops_huf.decode_tables_device(lens_all)
    count_t = count_b[seg_id].T.to(torch.int32).contiguous()
    wext = ops_huf.words_ext(words, chunk_bits)
    codes, totals = ops_huf.gap_decode_rle0_flat(
        wext, count_t, seg_start, seg_start_idx, seg_id, sym_b, ms, ns,
        nmax, chunk_bits, maxl)
    last = ops_mtf.mtf_inverse(codes, ns, config_mod.DEFAULT.imtf_chunk)
    data = ops_bwt.bwt_inverse_cursors(last, shifts, cps, ns, stride)
    pos = torch.arange(nmax, device=data.device)[None, :]
    rows = data[pos < ns[:, None]]
    return torch.cat([rows, totals.contiguous().view(torch.uint8)])


def _decompress_batch(blocks, idxs, nmax: int, stride: int, device, results):
    chunk_bits = config_mod.DEFAULT.decode_chunk_bits
    (words, lens_all, seg_start, seg_start_idx, seg_id, ms, ns, shifts,
     maxl) = _stage_flat_np(blocks, idxs, chunk_bits)
    kcp = max(max(nmax // stride, 1) - 1, 1)
    cps = np.zeros((len(idxs), kcp), dtype=np.int64)
    for row, i in enumerate(idxs):
        bc = blocks[i].get("cps")
        if bc is not None and len(bc) > 0:
            cc = np.asarray(bc, dtype=np.int64)[:kcp]
            cps[row, : cc.size] = cc

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    flat = decode_flat(put(words.view(np.int32)), put(lens_all), put(seg_start),
                       put(seg_start_idx), put(seg_id), put(ms), put(ns),
                       put(shifts), put(cps), nmax, chunk_bits, maxl, stride)
    flat_np = flat.cpu().numpy()
    total = int(ns.sum())
    totals = flat_np[total:].view("<i8")
    offs = np.cumsum(ns) - ns
    for row, i in enumerate(idxs):
        if int(totals[row]) != int(ns[row]):
            raise ValueError(
                f"corrupt container: block {i}'s RLE0 stream decodes to "
                f"{int(totals[row])} bytes, expected {int(ns[row])}")
        results[i] = flat_np[offs[row]: offs[row] + ns[row]]


# ---------------------------------------------------------------------------
# Backend
# ---------------------------------------------------------------------------

class TorchBackend:
    """Block codec on one torch device ("cuda" runs the kernels, "cpu" the
    plain PyTorch versions)."""

    name = "torch"

    def __init__(self, device: torch.device):
        self.device = device

    def compress_blocks(self, blocks: list[np.ndarray], stride: int,
                        bucket: int | None = None) -> list[dict]:
        """bucket: force one padded size for every block."""
        results: list[dict | None] = [None] * len(blocks)
        groups: dict[int, list[int]] = defaultdict(list)
        arrs = [np.asarray(b, dtype=np.uint8) for b in blocks]
        for i, blk in enumerate(arrs):
            nmax = max(bucket, _bucket(blk.size)) if bucket else _bucket(blk.size)
            groups[nmax].append(i)
        for nmax, all_idxs in groups.items():
            for idxs in _chunks(all_idxs):
                for i, r in zip(idxs, _compress_batch(arrs, idxs, nmax,
                                                      self.device, stride)):
                    results[i] = r
        return results  # type: ignore[return-value]

    def decompress_blocks(self, blocks: list[dict],
                          bucket: int | None = None) -> list[np.ndarray]:
        """bucket: force a uniform padded block size."""
        results: list[np.ndarray | None] = [None] * len(blocks)
        groups: dict[tuple[int, int], list[int]] = defaultdict(list)
        for i, b in enumerate(blocks):
            n = int(b["orig_len"])
            stride = int(b["stride"])
            if n == 0:
                results[i] = np.zeros(0, dtype=np.uint8)
            elif int(np.asarray(b["present"]).sum()) == 1:
                raise NotImplementedError(
                    "decompress of single-symbol blocks is not ported yet "
                    "(ROADMAP A11); bmh_tpu decodes them")
            elif b.get("cps") is None and n > stride:
                raise NotImplementedError(
                    "decompress of periodic blocks is not ported yet "
                    "(ROADMAP A11); bmh_tpu decodes them")
            else:
                nmax = max(bucket, _bucket(n)) if bucket else _bucket(n)
                groups[(nmax, stride)].append(i)
        for (nmax, stride), all_idxs in groups.items():
            for idxs in _chunks(all_idxs):
                _decompress_batch(blocks, idxs, nmax, stride, self.device, results)
        return results  # type: ignore[return-value]
