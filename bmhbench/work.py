"""The least time the decode kernels need, counted from the containers a
window decoded: the bytes they must move over the card's bandwidth.

Counted at the data's real sizes, each byte read once and written once,
whatever implements the decode: K1 and K2 (gap decode) read the payload
and write the RLE0 symbols (2 bytes each); K3 (inverse MTF) reads a code
and writes a byte per position; K4 (inverse BWT walk) reads the last
column and writes the block.  A periodic block skips K4 (the doubling
inverse), a single-symbol block K1, K2 and K4.  Operations are not
counted: no count of them follows from the format alone, so the bound is
the bytes' alone, and the share a lower bound's.  The kernels' names are
the program's (bmh_tpu_torch/csrc/*.cu)."""

from __future__ import annotations

from . import reference

# per card name: bytes/s of device memory (NVIDIA's data sheet, H100 SXM)
BANDWIDTH = {"NVIDIA H100 80GB HBM3": 3.35e12}

KERNELS = {
    "gap_decode": ("phase_a_kernel", "phase_b_kernel"),
    "imtf": ("imtf_kernel",),
    "ibwt_walk": ("compose_rows", "walk_rows", "fill_bytes", "walk_hop1"),
}


def kernel_of(op_name: str) -> str | None:
    for group, names in KERNELS.items():
        if any(n in op_name for n in names):
            return group
    return None


def decode_work(containers: list[bytes]) -> dict:
    """{kernel group: bytes} over every block of `containers`."""
    work = dict.fromkeys(KERNELS, 0)
    for buf in containers:
        for blk in reference.unpack_file(buf)[1]:
            s = reference.block_sizes(blk)
            if s["n"] == 0:
                continue
            if s["present"] > 1:
                work["gap_decode"] += s["payload"] + 2 * s["rle_len"]
                if not s["periodic"]:
                    work["ibwt_walk"] += 2 * s["n"]
            work["imtf"] += 2 * s["n"]
    return work


def least_seconds(work: dict, card: str) -> float | None:
    """The bytes over the card's bandwidth; None on a card not in the
    table."""
    if card not in BANDWIDTH:
        return None
    return sum(work.values()) / BANDWIDTH[card]
