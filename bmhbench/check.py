"""The comparison that decides `correct`: what the timed calls produced,
against the plain reference (reference.py).

Compress: every container a window call returned must parse as the
reference parses it, carry a CRC that matches its body and the header the
reference writes for its input (`containers_wrong`); every container made
again from the same pool item must equal, byte for byte, the first one
made from it (`repeats_differ`); and blocks drawn from the seed over all
of the window's containers, with the last block of the longest input
among them, must equal byte for byte the block that the reference encodes
from the same input bytes (`sampled_blocks_wrong`).  So every container
of the window is tied to the reference: a call that differs from the
others of its item fails `repeats_differ`, and where they all differ from
the reference, the sample finds it.

Decompress: every window call's bytes must equal the input that was
compressed (`outputs_wrong`, compared once the window has closed), and
the containers that the set-up made with the program, which the window
decodes, are held to the reference as the compress direction's are.

Every number is a count of answers that differ, so every limit is 0."""

from __future__ import annotations

import struct

import numpy as np

from . import reference

LIMITS = {"containers_wrong": 0, "repeats_differ": 0, "sampled_blocks_wrong": 0,
          "outputs_wrong": 0}


def _expected_head(data: bytes, block_size: int, stride: int) -> dict:
    return {"version": reference.VERSION, "stride": stride, "block_size": block_size,
            "n_blocks": -(-len(data) // block_size), "total": len(data), "crc_ok": True}


def containers(pool: list[list[bytes]], produced: list[tuple[int, list[bytes] | None]],
               config: dict, sample: int, seed: int) -> dict:
    """Counts of wrong containers, of repeats unlike the first, and of
    wrong sampled blocks.  `produced` holds (pool index, the call's
    containers, or None where it raised)."""
    bs, stride = int(config["block_size"]), int(config["cursor_stride"])
    wrong = differ = 0
    first: dict[tuple[int, int], bytes] = {}  # (pool index, item) -> container
    blocks: list[tuple[int, int, int]] = []  # (produced index, item, block)
    parsed: dict = {}
    for k, (p, outs) in enumerate(produced):
        items = pool[p]
        if outs is None or len(outs) != len(items):
            wrong += len(items)
            continue
        for j, (data, buf) in enumerate(zip(items, outs)):
            differ += first.setdefault((p, j), buf) != buf
            try:
                head, blks = reference.unpack_file(buf)
            except (ValueError, TypeError, struct.error):
                wrong += 1
                continue
            if head != _expected_head(data, bs, stride):
                wrong += 1
                continue
            parsed[(k, j)] = blks
            blocks += [(k, j, b) for b in range(len(blks))]
    if not blocks:
        return {"containers_wrong": wrong, "repeats_differ": differ,
                "sampled_blocks_wrong": sample}
    rng = np.random.default_rng(seed)
    picks = {blocks[i] for i in rng.choice(len(blocks), min(sample, len(blocks)),
                                           replace=False)}
    k, j = max(parsed, key=lambda kj: len(pool[produced[kj[0]][0]][kj[1]]))
    picks.add((k, j, len(parsed[(k, j)]) - 1))
    bad = 0
    for k, j, b in sorted(picks):
        data = pool[produced[k][0]][j]
        raw = np.frombuffer(data, np.uint8)[b * bs:(b + 1) * bs]
        bad += parsed[(k, j)][b] != reference.encode_block(raw, stride)
    return {"containers_wrong": wrong, "repeats_differ": differ,
            "sampled_blocks_wrong": bad}


def items_wrong(expected: list[bytes], outs: list[bytes] | None) -> int:
    """Items of one decompress call that differ from the inputs that were
    compressed: all of them where the call raised or returned another
    number of items."""
    if outs is None or len(outs) != len(expected):
        return len(expected)
    return sum(o != d for o, d in zip(outs, expected))
