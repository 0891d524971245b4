"""Runtime configuration: a copy of bmh_tpu's CodecConfig reading the same
BMH_* environment knobs, so one environment configures both packages.

The port reads the knobs at call time; the program cache
(models/programs.py) keys every program on every knob a program reads,
and the kernel build cache (ops/_build.py) keys on source and flags only.
`pallas_sort` (BMH_PALLAS_SORT, off by default as in bmh_tpu) sends every
BWT sort inside its envelope through kernel K5 (ops/bwt._stable_sort3);
full_rounds, tier1_rounds, tier2_div and sparse_cap_div shape the
sparse/adaptive compress program as in bmh_tpu.  `lf2` (BMH_LF2, on by
default as in bmh_tpu) lets the inverse-BWT walk, kernel K4, run over the
LF table composed with itself (ops/bwt._walk_hop: 16-step row links at
every block size, where bmh_tpu packs two-step LF² entries for blocks <=
64 KiB only); off, it walks one row a step.
`inflight` (BMH_INFLIGHT, 4) bounds the batches between dispatch and drain
in models/pipeline.TorchBackend, and `devices` (BMH_DEVICES, 0 = all) caps
the devices a TorchBackend keeps and so fans out over, as in bmh_tpu.
The other TPU knobs (pallas_decode, pallas_imtf, decode_place) and
debug_sparse are accepted and validated but not read: the decode kernels
always run on a card, decode_place selects machinery the port does not
have, and the port has no sparse debug path.  min_bucket is read on the
host only (models/pipeline._bucket, the smallest padded row).  None of
these five is in the program key (models/programs.KNOBS).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v not in ("0", "false", "False", "")


@dataclass
class CodecConfig:
    """Knobs for the block codec and its device pipeline."""

    # 128 KiB is the benched configuration: every TPU artifact (BENCH/TRACE/
    # PROFILE), the size-win measurement, and the compile cache live at this
    # block size, so it is also the default (VERDICT r2 item 6)
    block_size: int = field(default_factory=lambda: _env_int("BMH_BLOCK_SIZE", 1 << 17))
    mtf_chunk: int = field(default_factory=lambda: _env_int("BMH_MTF_CHUNK", 128))
    decode_chunk_bits: int = field(default_factory=lambda: _env_int("BMH_DECODE_CHUNK_BITS", 512))
    backend: str = field(default_factory=lambda: _env_str("BMH_BACKEND", "torch"))
    min_bucket: int = field(default_factory=lambda: _env_int("BMH_MIN_BUCKET", 256))
    # kernel routing: the Pallas gap-decode kernels (on TPU) and the Pallas
    # bitonic sort (off by default: XLA's sort measured ~2x faster at the
    # production 128K-1M block sizes on v5e)
    pallas_decode: bool = field(default_factory=lambda: _env_bool("BMH_PALLAS_DECODE", True))
    pallas_sort: bool = field(default_factory=lambda: _env_bool("BMH_PALLAS_SORT", False))
    # full prefix-doubling rounds before switching to sparse refinement of
    # the remaining tied positions (ops/bwt.py sparse_refine); measured on
    # Calgary, text leaves ~1-5% of positions tied after 4 rounds
    full_rounds: int = field(default_factory=lambda: _env_int("BMH_FULL_ROUNDS", 4))
    # blocks per device dispatch (models/pipeline._chunks, read at call time)
    max_dispatch: int = field(default_factory=lambda: _env_int("BMH_MAX_DISPATCH", 32))
    # two-tier sparse refinement shape: full-capacity rounds before the
    # surviving tied set is re-compacted (tier1_rounds) and the tier-2
    # capacity divisor (ops/bwt.sparse_refine) — TPU tuning knobs, part of
    # the compiled compress program's cache key
    tier1_rounds: int = field(default_factory=lambda: _env_int("BMH_TIER1_ROUNDS", 2))
    tier2_div: int = field(default_factory=lambda: _env_int("BMH_TIER2_DIV", 4))
    # sparse compact-set capacity = (batch * nmax) / sparse_cap_div; the
    # refinement loop's per-iteration cost is CAP-sized (static shapes), so
    # a deeper full_rounds pairs with a larger divisor (measured corpus
    # tied fraction: 4.5% after 4 rounds)
    sparse_cap_div: int = field(default_factory=lambda: _env_int("BMH_SPARSE_CAP_DIV", 16))
    # inverse-MTF: VMEM-resident Pallas in-chunk kernel (TPU) + its chunk
    # size (the XLA scan path keeps mtf_chunk)
    pallas_imtf: bool = field(default_factory=lambda: _env_bool("BMH_PALLAS_IMTF", True))
    imtf_chunk: int = field(default_factory=lambda: _env_int("BMH_IMTF_CHUNK", 1024))
    # inverse-BWT cursor checkpoint stride, recorded per file so any stride
    # stays decodable.  Measured: the LF-walk scan is gather-THROUGHPUT
    # bound (total gathers = n regardless of stride), so a smaller stride
    # buys no decode time and only costs 4/stride bytes/input byte of
    # container — 4096 is the sweet spot
    cursor_stride: int = field(default_factory=lambda: _env_int("BMH_CURSOR_STRIDE", 4096))
    # composed inverse-BWT walk: shortens the dependent gather chain (the
    # decompress roofline) by walking a self-composed LF map.  bmh_tpu's
    # entries pack two emitted bytes + a 16-bit next row into one uint32,
    # for blocks <= 64 KiB; here the walk follows a table of 16-step row
    # links at every block size (ops/bwt.bwt_inverse_cursors).  Read at
    # every call.
    lf2: bool = field(default_factory=lambda: _env_bool("BMH_LF2", True))
    # RLE1 pre-BWT run collapse (bzip2-style): applied per block when it
    # strictly shrinks; collapses the long-run inputs that force maximum
    # doubling rounds (Calgary pic) and shrinks them further
    rle1: bool = field(default_factory=lambda: _env_bool("BMH_RLE1", True))
    # production multi-device dispatch: 0 = auto (shard every compress batch
    # over all of the backend's devices), 1 = single-device, N = cap at N
    devices: int = field(default_factory=lambda: _env_int("BMH_DEVICES", 0))
    # bound on in-flight device dispatches per direction: a 1 GiB stream is
    # 256 batches, and an unbounded pending list pins every batch's padded
    # outputs in HBM at once (measured 1.5x decompress degradation); a few
    # batches suffice to overlap host assembly with device work
    inflight: int = field(default_factory=lambda: _env_int("BMH_INFLIGHT", 4))
    # literal placement in the fused decode (ops/huffman.gap_decode_rle0_flat):
    # "sort" = packed single-array sort + indices-sorted scatter (default;
    # falls back to scatter when the packed key exceeds 32 bits),
    # "scatter" = direct ragged scatter
    decode_place: str = field(default_factory=lambda: _env_str("BMH_DECODE_PLACE", "sort"))
    debug_sparse: bool = field(default_factory=lambda: _env_bool("BMH_DEBUG_SPARSE", False))

    def validate(self) -> "CodecConfig":
        if self.block_size < 1:
            raise ValueError("block_size must be positive")
        if self.block_size > (1 << 21):
            # Huffman depth > 31 becomes reachable past ~2 MiB (Fibonacci
            # frequency pathologies); 5-bit container lengths cap at 31.
            raise ValueError("block_size above 2 MiB risks code lengths > 31")
        if self.mtf_chunk & (self.mtf_chunk - 1):
            raise ValueError("mtf_chunk must be a power of two")
        if self.decode_chunk_bits % 32:
            raise ValueError("decode_chunk_bits must be a multiple of 32")
        if not 2 <= self.full_rounds <= 16:
            # the 4-byte packed init already orders 4-byte prefixes
            # (h starts at 4); at least one executed doubling round is
            # required before sparse refinement (head-index ranks)
            raise ValueError("full_rounds must be in [2, 16]")
        if self.imtf_chunk & (self.imtf_chunk - 1):
            raise ValueError("imtf_chunk must be a power of two")
        if self.cursor_stride & (self.cursor_stride - 1) or self.cursor_stride < 64:
            raise ValueError("cursor_stride must be a power of two >= 64")
        if self.devices < 0:
            raise ValueError("devices must be >= 0 (0 = all local devices)")
        if self.decode_place not in ("sort", "scatter"):
            raise ValueError("decode_place must be 'sort' or 'scatter'")
        if self.inflight < 1:
            raise ValueError("inflight must be >= 1")
        if self.sparse_cap_div < 1:
            raise ValueError("sparse_cap_div must be >= 1")
        if not 1 <= self.tier1_rounds <= 8:
            raise ValueError("tier1_rounds must be in [1, 8]")
        if self.tier2_div < 1:
            raise ValueError("tier2_div must be >= 1")
        return self

    def describe(self) -> str:
        return " ".join(f"{f.name}={getattr(self, f.name)}" for f in fields(self))


DEFAULT = CodecConfig().validate()
