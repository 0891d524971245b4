"""Multi-process runtime: initialization, block stripes, ordered assembly
(bmh_tpu/parallel/distributed.py on torch.distributed).

Blocks are dealt round-robin over processes, each process codes its stripe
with its own backend (its cards, or the CPU), and the variable-length
results are gathered to rank 0 as (lengths, padded bytes) rows in chunks
of GATHER_CHUNK_BLOCKS block slots a process.  The bytes gathered are host
bytes, so the process group is gloo over CPU tensors whatever device the
codec runs on; that also lets several processes share one card.  With one
process everything is the local path.

Unlike bmh_tpu's, decompress_stream validates every block (api._parse:
_validate_block_size and _validate_block_info) before it decodes any.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .. import api
from ..utils import container

# block slots a process sends per gather: the peak transient buffer on rank
# 0 is GATHER_CHUNK_BLOCKS x the longest item x the process count
GATHER_CHUNK_BLOCKS = int(os.environ.get("BMH_GATHER_CHUNK_BLOCKS", "256"))


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """A gloo process group, with env fallbacks BMH_NUM_PROCESSES (1),
    BMH_COORDINATOR (localhost:9711) and BMH_PROCESS_ID (0); a no-op for
    one process."""
    num = (num_processes if num_processes is not None
           else int(os.environ.get("BMH_NUM_PROCESSES", "1")))
    if num <= 1:
        return
    addr = coordinator_address or os.environ.get("BMH_COORDINATOR", "localhost:9711")
    pid = (process_id if process_id is not None
           else int(os.environ.get("BMH_PROCESS_ID", "0")))
    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=num, rank=pid)


def process_info() -> tuple[int, int]:
    """(rank, process count); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _ragged_gather_to0(local_items: dict[int, bytes], n_total: int,
                       pid: int, pcount: int) -> list[bytes] | None:
    """Gather {block_id: bytes} from every process (process p holds the
    ids i with i % pcount == p) to rank 0, GATHER_CHUNK_BLOCKS block slots
    a process at a time.  Returns the byte strings in id order on rank 0,
    None elsewhere."""
    out: list[bytes] = []
    rows = GATHER_CHUNK_BLOCKS
    span = rows * pcount
    for c0 in range(0, max(n_total, 1), span):
        ids_chunk = range(c0, min(c0 + span, n_total))
        mine = [i for i in ids_chunk if i % pcount == pid]
        gmax = torch.tensor(max((len(local_items[i]) for i in mine), default=0))
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX)
        buf = np.zeros((rows, max(int(gmax), 1)), dtype=np.uint8)
        heads = np.full((2, rows), -1, dtype=np.int64)  # lengths, ids
        for row, i in enumerate(mine):
            raw = np.frombuffer(local_items[i], dtype=np.uint8)
            buf[row, : raw.size] = raw
            heads[:, row] = raw.size, i
        bufs = [torch.empty(buf.shape, dtype=torch.uint8) for _ in range(pcount)] \
            if pid == 0 else None
        hs = [torch.empty(heads.shape, dtype=torch.int64) for _ in range(pcount)] \
            if pid == 0 else None
        dist.gather(torch.from_numpy(buf), bufs, dst=0)
        dist.gather(torch.from_numpy(heads), hs, dst=0)
        if pid == 0:
            by_id = {int(i): b[row, : int(n)].numpy().tobytes()
                     for b, h in zip(bufs, hs)
                     for row, (n, i) in enumerate(h.T.tolist()) if i >= 0}
            out.extend(by_id[i] for i in ids_chunk)
    return out if pid == 0 else None


def compress_stream(data: bytes | np.ndarray, block_size: int,
                    backend) -> bytes | None:
    """Distributed compress: every process codes its block stripe.

    Returns the container bytes on rank 0, None elsewhere.  With one
    process this is exactly the local path."""
    api._validate_block_size(block_size)
    pid, pcount = process_info()
    stride = api.CONFIG.cursor_stride
    arr = api._as_array(data)
    blocks = container.split_blocks(arr, block_size)
    mine = [i for i in range(len(blocks)) if i % pcount == pid]
    results = backend.compress_blocks([blocks[i] for i in mine], stride)
    local = {i: api._pack_block(r, blocks[i].size) for i, r in zip(mine, results)}
    if pcount == 1:
        packed = [local[i] for i in range(len(blocks))]
    else:
        packed = _ragged_gather_to0(local, len(blocks), pid, pcount)
        if packed is None:
            return None
    return container.pack_file(packed, block_size, arr.size, stride=stride)


def decompress_stream(blob: bytes, backend) -> bytes | None:
    """Distributed decompress: every process decodes its block stripe.

    Every process passes the same container bytes (each read the same
    file) and validates all of its blocks first; the decoded blocks are
    gathered to rank 0 in block order.  Returns the stream bytes on rank 0,
    None elsewhere.  With one process this is exactly the local path."""
    pid, pcount = process_info()
    infos, raw_lens, total, _ = api._parse(blob)
    mine = [i for i in range(len(infos)) if i % pcount == pid]
    parts = backend.decompress_blocks([infos[i] for i in mine]) if mine else []
    local = {i: api._rle1_restore(p, raw_lens[i]).tobytes()
             for i, p in zip(mine, parts)}
    if pcount == 1:
        gathered = [local[i] for i in range(len(infos))]
    else:
        gathered = _ragged_gather_to0(local, len(infos), pid, pcount)
        if gathered is None:
            return None
    out = b"".join(gathered)
    if len(out) != total:
        raise ValueError(f"decoded {len(out)} bytes, expected {total}")
    return out
