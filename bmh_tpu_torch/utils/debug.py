"""Debug printers: hex dumps, bitstreams, code tables and container
summaries, with the same strings as bmh_tpu/utils/debug.py.

A canonical Huffman code is fully determined by its lengths, so the code
table view is the tree view.
"""

from __future__ import annotations

import numpy as np


def char_to_bin(byte: int) -> str:
    """8-char MSB-first bit string of one byte."""
    return format(byte & 0xFF, "08b")


def format_bytes(data: bytes | np.ndarray, limit: int = 64) -> str:
    """Hex dump of the first `limit` bytes (print_vector equivalent)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    shown = arr[:limit]
    hexes = " ".join(f"{b:02x}" for b in shown.tolist())
    suffix = f" ... (+{arr.size - limit} bytes)" if arr.size > limit else ""
    return hexes + suffix


def format_bitstream(payload: bytes, limit_bits: int = 128) -> str:
    """MSB-first bit string of a payload prefix (print_binary_vector)."""
    out = []
    for i, byte in enumerate(payload):
        if 8 * i >= limit_bits:
            out.append("...")
            break
        out.append(char_to_bin(byte))
    return " ".join(out)


def format_code_table(lens: np.ndarray, codes: np.ndarray | None = None) -> str:
    """Canonical codebook listing, one line per present symbol (print_map /
    print2D equivalent: lengths fully determine the canonical tree)."""
    from ..models import oracle

    lens = np.asarray(lens)
    if codes is None:
        codes = oracle.canonical_codes(lens)
    lines = []
    for s in range(256):
        l = int(lens[s])
        if l == 0:
            continue
        bits = format(int(codes[s]), f"0{l}b")
        printable = chr(s) if 32 <= s < 127 else "."
        lines.append(f"  {s:3d} '{printable}' len {l:2d}  {bits}")
    return "\n".join(lines) if lines else "  (empty code table)"


def describe_container(buf: bytes) -> str:
    """Multi-line summary of a .bzt container (header + per-block stats)."""
    from . import container

    block_size, total_size, raw_blocks = container.unpack_file(buf)
    lines = [f".bzt: {len(buf)} bytes, {len(raw_blocks)} block(s), "
             f"block_size {block_size}, original {total_size} bytes"]
    for i, raw in enumerate(raw_blocks):
        orig_len, shift, lens, present, cps, rle_len, payload, _pre = container.unpack_block(raw)
        ncp = "periodic" if cps is None else len(cps)
        lines.append(
            f"  block {i}: orig {orig_len} B, shift {shift}, "
            f"{int(np.count_nonzero(present))} symbols, "
            f"max len {int(lens.max())}, checkpoints {ncp}, "
            f"payload {len(payload)} B")
    return "\n".join(lines)
