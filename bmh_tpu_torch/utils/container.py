"""The `.bzt` container, byte for byte as bmh_tpu/utils/container.py writes it.

    file header (24 B, little-endian):
        magic      4s   = b"BZT1"
        version    u8   = 3 (readers accept 2 and 3)
        flags      u8   FLAG_STREAMING | FLAG_CRC32
        reserved   u16  log2 of the iBWT cursor stride (0 = legacy 4096)
        block_size u32  nominal uncompressed block length
        n_blocks   u32
        total_size u64  original stream length
    block table: u32 compressed byte length per block (absent when streaming)
    crc:         u32 IEEE CRC of the block region (when FLAG_CRC32)
    blocks, concatenated:
        orig_len   u32  block length; bit 31 flags the RLE1 pre-pass
        bwt_shift  u32  sorted position of rotation 0
        n_cps      u16  cursor checkpoint count; 0xFFFF = periodic block
        rle_len    u32  RLE0 symbol count of the Huffman stream
        pre_len    u32  post-RLE1 length (only when bit 31 of orig_len is set)
        cps        n_cps x u32 cursor starts
        bitmap     33 B present-symbol bitmap over the 257-symbol alphabet
        lens       ceil(5*S/8) B, 5-bit code lengths of the S present symbols
        payload    MSB-first canonical Huffman bits

This module keeps its own copy of the format: the port imports nothing of
bmh_tpu, and the tests hold the two copies to the same bytes.
"""

from __future__ import annotations

import struct

import numpy as np

from . import nativeio

MAGIC = b"BZT1"
VERSION = 3
COMPAT_VERSIONS = (2, 3)
FLAG_STREAMING = 0x01
FLAG_CRC32 = 0x02
FILE_HEADER = struct.Struct("<4sBBHIIQ")
BLOCK_HEADER = struct.Struct("<IIHI")
PERIODIC_SENTINEL = 0xFFFF
ALPHABET = 257
BITMAP_BYTES = (ALPHABET + 7) // 8
# the CLI's and the resumable writer's default block size, as in bmh_tpu
# (the API's default is config.DEFAULT.block_size)
DEFAULT_BLOCK_SIZE = 1 << 20
RLE1_FLAG = 0x80000000
_LEN_WEIGHTS = np.array([16, 8, 4, 2, 1], dtype=np.int64)


def pack_lens(lens: np.ndarray, present: np.ndarray) -> bytes:
    """Bitmap + packed 5-bit lengths for present symbols (ascending symbol)."""
    lens = np.asarray(lens)
    present = np.asarray(present, dtype=bool)
    nbits = 8 * ((lens.size + 7) // 8)
    bitmap = np.packbits(np.pad(present, (0, nbits - present.size)),
                         bitorder="little")
    v = lens[present].astype(np.int64)
    bits = ((v[:, None] >> np.arange(4, -1, -1)) & 1).astype(np.uint8)
    return bitmap.tobytes() + np.packbits(bits.reshape(-1)).tobytes()


def unpack_lens(buf: bytes, off: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Returns (lens (257,) uint8, present mask (257,) bool, new offset)."""
    if len(buf) < off + BITMAP_BYTES:
        raise ValueError("truncated code-length table")
    bitmap = np.frombuffer(buf, dtype=np.uint8, count=BITMAP_BYTES, offset=off)
    off += BITMAP_BYTES
    present = np.unpackbits(bitmap, bitorder="little")[:ALPHABET].astype(bool)
    nsyms = int(present.sum())
    nbytes = (5 * nsyms + 7) // 8
    if len(buf) < off + nbytes:
        raise ValueError("truncated code-length table")
    packed = np.frombuffer(buf, dtype=np.uint8, count=nbytes, offset=off)
    off += nbytes
    bits = np.unpackbits(packed)[: 5 * nsyms].reshape(nsyms, 5)
    lens = np.zeros(ALPHABET, dtype=np.uint8)
    lens[present] = (bits.astype(np.int64) @ _LEN_WEIGHTS).astype(np.uint8)
    return lens, present, off


def pack_block(orig_len: int, bwt_shift: int, lens: np.ndarray,
               present: np.ndarray, payload: bytes,
               cps: np.ndarray | None = (), rle_len: int = 0,
               pre_len: int | None = None) -> bytes:
    """cps: cursor checkpoints (possibly empty); None marks a periodic block.
    pre_len: post-RLE1 length when the run-collapse pre-pass was applied."""
    rle1 = pre_len is not None and pre_len != orig_len
    len_field = orig_len | (RLE1_FLAG if rle1 else 0)
    pre_bytes = struct.pack("<I", pre_len) if rle1 else b""
    if cps is None:
        head = BLOCK_HEADER.pack(len_field, bwt_shift, PERIODIC_SENTINEL, rle_len)
        cp_bytes = b""
    else:
        cps = np.asarray(cps, dtype=np.uint32)
        if cps.size >= PERIODIC_SENTINEL:
            raise ValueError(f"too many checkpoints ({cps.size}); shrink the block")
        head = BLOCK_HEADER.pack(len_field, bwt_shift, cps.size, rle_len)
        cp_bytes = cps.astype("<u4").tobytes()
    return head + pre_bytes + cp_bytes + pack_lens(lens, present) + payload


def unpack_block(buf: bytes) -> tuple[int, int, np.ndarray, np.ndarray,
                                      np.ndarray | None, int, bytes, int]:
    """Returns (orig_len, bwt_shift, lens, present, cps, rle_len, payload,
    pre_len); cps is None for a periodic block."""
    len_field, bwt_shift, n_cps, rle_len = BLOCK_HEADER.unpack_from(buf, 0)
    orig_len = len_field & ~RLE1_FLAG
    off = BLOCK_HEADER.size
    if len_field & RLE1_FLAG:
        (pre_len,) = struct.unpack_from("<I", buf, off)
        off += 4
    else:
        pre_len = orig_len
    if n_cps == PERIODIC_SENTINEL:
        cps = None
    else:
        cps = np.frombuffer(buf, dtype="<u4", count=n_cps, offset=off).astype(np.int32)
        off += 4 * n_cps
    lens, present, off = unpack_lens(buf, off)
    return orig_len, bwt_shift, lens, present, cps, rle_len, buf[off:], pre_len


def file_stride(buf: bytes) -> int:
    """Cursor stride recorded in a .bzt header (reserved==0 -> legacy 4096)."""
    if len(buf) < FILE_HEADER.size:
        raise ValueError(f"truncated .bzt file: {len(buf)} bytes < header")
    _, _, _, res, _, _, _ = FILE_HEADER.unpack_from(buf, 0)
    return (1 << res) if res else 4096


def pack_file(blocks: list[bytes], block_size: int, total_size: int,
              stride: int, crc: bool = True) -> bytes:
    flags = FLAG_CRC32 if crc else 0
    header = FILE_HEADER.pack(MAGIC, VERSION, flags, stride.bit_length() - 1,
                              block_size, len(blocks), total_size)
    table = struct.pack(f"<{len(blocks)}I", *(len(b) for b in blocks))
    body = b"".join(blocks)
    trailer = struct.pack("<I", nativeio.crc32(body)) if crc else b""
    return header + table + trailer + body


def unpack_file(buf: bytes) -> tuple[int, int, list[bytes]]:
    """Returns (block_size, total_size, list of raw block buffers)."""
    if len(buf) < FILE_HEADER.size:
        raise ValueError(f"truncated .bzt file: {len(buf)} bytes < header")
    magic, version, flags, _res, block_size, n_blocks, total_size = \
        FILE_HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic!r}; not a .bzt file")
    if version not in COMPAT_VERSIONS:
        raise ValueError(f"unsupported .bzt version {version}")
    off = FILE_HEADER.size
    if flags & FLAG_STREAMING:
        blocks = []
        for _ in range(n_blocks):
            if len(buf) < off + 4:
                raise ValueError("truncated .bzt file: streaming block prefix")
            (sz,) = struct.unpack_from("<I", buf, off)
            off += 4
            if len(buf) < off + sz:
                raise ValueError("truncated .bzt file: streaming block data")
            blocks.append(buf[off:off + sz])
            off += sz
        return block_size, total_size, blocks
    if len(buf) < off + 4 * n_blocks:
        raise ValueError("truncated .bzt file: block table incomplete")
    sizes = struct.unpack_from(f"<{n_blocks}I", buf, off)
    off += 4 * n_blocks
    if flags & FLAG_CRC32:
        if len(buf) < off + 4:
            raise ValueError("truncated .bzt file: missing CRC trailer")
        (want_crc,) = struct.unpack_from("<I", buf, off)
        off += 4
        if len(buf) < off + sum(sizes):
            raise ValueError("truncated .bzt file: block data incomplete")
        if nativeio.crc32(buf[off:off + sum(sizes)]) != want_crc:
            raise ValueError("corrupt .bzt file: block CRC mismatch")
    if len(buf) < off + sum(sizes):
        raise ValueError("truncated .bzt file: block data incomplete")
    blocks = []
    for sz in sizes:
        blocks.append(buf[off:off + sz])
        off += sz
    return block_size, total_size, blocks


def header_bytes(buf: bytes) -> int:
    """Total non-payload (metadata) bytes of a .bzt container."""
    _, _, raw_blocks = unpack_file(buf)
    payload = sum(len(unpack_block(raw)[6]) for raw in raw_blocks)
    return len(buf) - payload


def split_blocks(data: np.ndarray, block_size: int) -> list[np.ndarray]:
    return [data[i:i + block_size] for i in range(0, data.size, block_size)]
