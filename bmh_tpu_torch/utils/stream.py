"""Resumable streaming compression (bmh_tpu/utils/stream.py on the port).

The container's streaming layout (FLAG_STREAMING: u32-length-prefixed,
self-delimiting blocks) makes every completed block a durable checkpoint:
a `StreamCompressor` appends blocks as they finish and fsyncs each, and
`resume()` re-opens a partial file, truncates a torn final block and
continues from the first missing one.  The read side is
utils/container.unpack_file.

The header records the cursor stride the blocks were encoded with: the one
value that `compress_file_resumable` passes to every compress call, written
by `create` and again by `finalize`.  A resume whose recorded stride
differs from the encoder's starts afresh, as a block_size mismatch does:
blocks of two strides in one file would carry checkpoints that the header's
stride cannot decode.  (bmh_tpu's resume ignores the recorded stride.)
"""

from __future__ import annotations

import os
import struct

import numpy as np

from . import container
from .config import DEFAULT as CONFIG


class StreamCompressor:
    """Append-only .bzt writer with crash recovery.

    Usage:
        sc = StreamCompressor.create(path, block_size, stride)  # or .resume(path)
        for blk in blocks[sc.blocks_done:]:
            sc.append(packed_block(blk))
        sc.finalize(total_size)
    """

    def __init__(self, path: str, block_size: int, stride: int,
                 blocks_done: int):
        self.path = path
        self.block_size = block_size
        self.stride = stride
        self.blocks_done = blocks_done
        self._f = open(path, "r+b")

    def _write_header(self, total_size: int) -> None:
        self._f.seek(0)
        self._f.write(container.FILE_HEADER.pack(
            container.MAGIC, container.VERSION, container.FLAG_STREAMING,
            self.stride.bit_length() - 1, self.block_size, self.blocks_done,
            total_size))
        self._f.flush()
        os.fsync(self._f.fileno())

    @classmethod
    def create(cls, path: str, block_size: int,
               stride: int | None = None) -> "StreamCompressor":
        """A new file whose blocks are encoded with cursor stride `stride`
        (default: config.DEFAULT.cursor_stride, read now)."""
        open(path, "wb").close()
        sc = cls(path, block_size, stride or CONFIG.cursor_stride, 0)
        sc._write_header(0)
        return sc

    @classmethod
    def resume(cls, path: str) -> "StreamCompressor":
        """Re-open a partial streaming file and truncate any torn final
        block.  The writer's `stride` is the one the file records."""
        with open(path, "rb") as f:
            buf = f.read()
        if len(buf) < container.FILE_HEADER.size:
            raise ValueError("not a resumable .bzt: missing header")
        magic, _version, flags, _res, block_size, _nb, _ts = \
            container.FILE_HEADER.unpack_from(buf, 0)
        if magic != container.MAGIC or not (flags & container.FLAG_STREAMING):
            raise ValueError("not a streaming .bzt file")
        off = container.FILE_HEADER.size
        done = 0
        while off + 4 <= len(buf):
            (sz,) = struct.unpack_from("<I", buf, off)
            if off + 4 + sz > len(buf):
                break  # torn block: rewrite it
            off += 4 + sz
            done += 1
        with open(path, "r+b") as f:
            f.truncate(off)
        return cls(path, block_size, container.file_stride(buf), done)

    def append(self, packed_block: bytes) -> None:
        self._f.seek(0, os.SEEK_END)
        self._f.write(struct.pack("<I", len(packed_block)))
        self._f.write(packed_block)
        self._f.flush()
        os.fsync(self._f.fileno())
        self.blocks_done += 1

    def finalize(self, total_size: int) -> None:
        """Patch the header with the block count and stream length, and
        close the file."""
        self._write_header(total_size)
        self._f.close()

    def close(self) -> None:
        """Close without finalizing (what a crash leaves)."""
        self._f.close()


def compress_file_resumable(in_path: str, out_path: str,
                            block_size: int = container.DEFAULT_BLOCK_SIZE,
                            backend: str = "torch", device="cuda") -> dict:
    """Compress with per-block durability; resumes where out_path holds a
    partial run over the same input at the same block size and stride.
    One compress call per block: each block is a checkpoint."""
    from .. import api

    api._validate_block_size(block_size)
    stride = CONFIG.cursor_stride
    be = api.get_backend(backend, device)
    with open(in_path, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8)
    blocks = container.split_blocks(data, block_size)

    sc = None
    if os.path.exists(out_path):
        try:
            sc = StreamCompressor.resume(out_path)
        except ValueError:
            pass
        if sc is not None and (sc.block_size != block_size or sc.stride != stride
                               or sc.blocks_done > len(blocks)):
            sc.close()
            sc = None
    if sc is None:
        sc = StreamCompressor.create(out_path, block_size, stride)

    resumed_from = sc.blocks_done
    try:
        for blk in blocks[resumed_from:]:
            (pre,), (raw_len,) = api._rle1_blocks([blk])
            sc.append(api._pack_block(be.compress_blocks([pre], stride)[0], raw_len))
    except BaseException:
        sc.close()  # the blocks appended so far stay for a resume
        raise
    sc.finalize(data.size)
    return {"blocks": len(blocks), "resumed_from": resumed_from,
            "encoded_file_size": os.path.getsize(out_path)}
