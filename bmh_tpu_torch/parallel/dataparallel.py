"""Data parallelism over blocks with collectives
(bmh_tpu/parallel/dataparallel.py and the dry run of bmh_tpu's
__graft_entry__.py on torch.distributed).

A batch of independent blocks is split over a 1-D mesh (parallel/mesh.py,
one process per device): every process holds the whole batch, works on
its stripe of the block axis (`block_sharding`), and the stripes' results
are gathered back in block order, which is what shard_map's SPMD body and
its sharded outputs do in bmh_tpu.  The round-trip step compresses each
block with its real Huffman table (device histogram -> host canonical
tables -> device encode), decodes it by the production kernels (K1, K2 gap
decode; K3 inverse MTF; K4 cursor inverse BWT), and reduces: the byte-match
count by all_reduce(SUM), the compressed bit counts by
all_gather_into_tensor, both over the mesh's group.

Each function that a `make_*` call returns is one program of
models/programs.py per input shape, as bmh_tpu's jax.jit(shard_map(...))
is: on a card a captured CUDA graph with its collectives inside (each
process captures its own, after a warm-up that runs every collective once
and so makes the NCCL communicator), replayed on later calls; on the CPU
(gloo) it runs as it is through the same keys.  The key holds a token of
the `make_*` call, so a later maker (perhaps on a new group) never
replays another's program; drop the programs (`programs.clear()`) before
destroying a group whose programs were captured.
"""

from __future__ import annotations

import functools
import itertools
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..models import programs
from ..models.pipeline import compress_stage1_fn, decompress_stage2_fn
from ..ops import bwt as ops_bwt
from ..ops import huffman as ops_huf
from ..ops import mtf as ops_mtf
from ..ops import rle as ops_rle
from ..utils import config as config_mod
from .mesh import BLOCK_AXIS, block_sharding, make_mesh, mesh_device

A = ops_rle.RLE_ALPHABET


# one token a make_* call: its programs' keys
_MAKERS = itertools.count()


def _host(x):
    """A program input: a host array (uint8 and bool keep their type,
    other integers, uint32 code values included, become int64) or a
    tensor, likewise."""
    if torch.is_tensor(x):
        return x if x.dtype in (torch.uint8, torch.bool) else x.to(torch.int64)
    x = np.asarray(x)
    return x if x.dtype in (np.uint8, np.bool_) else x.astype(np.int64)


def _gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every process's (b, ...) stripe, concatenated in mesh order (into a
    buffer allocated here: inside a captured program, the graph's own)."""
    group = mesh.get_group(BLOCK_AXIS)
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _program(mesh, name: str, fn):
    """fn(*inputs) -> a tuple of tensors, as a program of the cache on this
    process's device, keyed on `name`, the first input's shape (b_pad = the
    batch, nmax = its second axis) and this maker's token (which fixes the
    maker's statics) with the group's size and this process's rank."""
    dev = mesh_device(mesh)
    group = mesh.get_group(BLOCK_AXIS)
    ident = (next(_MAKERS), dist.get_world_size(group), dist.get_rank(group))

    def run(*args):
        args = [_host(a) for a in args]
        k = programs.key(name, b_pad=args[0].shape[0], nmax=args[0].shape[1],
                         mesh=ident)
        return programs.run_device(dev, k, fn, args)

    return run


def _sharded(mesh, name: str, fn):
    """shard_map's counterpart: fn runs on this process's stripe of every
    argument, and each of its outputs is gathered over the mesh; one
    program (_program)."""
    stripe = block_sharding(mesh)
    return _program(mesh, name, lambda *args: tuple(
        _gather(o, mesh) for o in fn(*(stripe(a) for a in args))))


def make_sharded_stage1(mesh, nmax: int):
    """Batched compress stage 1, block-sharded over the mesh:
    (B, nmax) uint8, (B,) -> (syms, ms, freqs, shifts, cps, aperiodic), each
    (B, ...).  B must be divisible by the mesh size."""
    return _sharded(mesh, "sharded_stage1", functools.partial(
        compress_stage1_fn, stride=config_mod.DEFAULT.cursor_stride))


def make_sharded_encode(mesh, nmax: int):
    """(syms, ms, lens, codes) -> (words, total bits), block-sharded."""
    return _sharded(mesh, "sharded_encode", ops_huf.encode_bitpack)


def make_sharded_decode2(mesh, nmax: int):
    """(syms, ms, shifts, ns) -> (decoded,): RLE0 inverse, inverse MTF and
    the doubling inverse BWT, block-sharded."""
    return _sharded(mesh, "sharded_decode2", lambda *a: (decompress_stage2_fn(*a),))


def host_tables(freqs: np.ndarray) -> dict:
    """Canonical tables of a (B, 257) histogram batch, computed on the
    host: encode lengths and codes, decode per-length counts and symbol
    lists (zero past the present symbols), and the longest length (at
    least 1).  bmh_tpu's host_tables, by the port's two-queue and
    canonical code functions run on the CPU."""
    f = torch.as_tensor(np.asarray(freqs), dtype=torch.int64)
    lens = ops_huf.code_lengths_device(f)
    codes = ops_huf.canonical_codes_device(lens)
    count, sym = ops_huf.decode_tables_device(lens)
    npres = (lens > 0).sum(dim=1, keepdim=True)
    sym = torch.where(torch.arange(A)[None, :] < npres, sym, 0)
    return {"enc_len": lens.numpy().astype(np.int32),
            "enc_code": codes.numpy().astype(np.uint32),
            "count": count.numpy().astype(np.int32),
            "sym": sym.numpy().astype(np.int32),
            "maxl": max(1, int(lens.max())) if lens.numel() else 1}


def make_roundtrip_step(mesh, nmax: int, chunk_bits: int = 256,
                        mtf_chunk: int = 128):
    """Round trip of a block-sharded batch with real tables.

    step(data (B, nmax) u8, ns (B,), enc_len (B, 257), enc_code (B, 257),
         count (B, 32), sym (B, 257)) ->
        (decoded (B, nmax) u8, total_ok 0-d int64, all_bits (B,) int64)

    Each process: BWT + MTF + RLE0 of its blocks -> canonical bitpack with
    each block's table -> gap decode of its blocks on one flat chunk axis
    at `chunk_bits` (K1, K2) -> RLE0 inverse -> inverse MTF at `mtf_chunk`
    (K3) -> cursor inverse BWT (K4).  total_ok is the all_reduce(SUM) of the
    byte-match counts; all_bits and decoded are gathered in block order.
    One program (_program), its collectives inside."""
    stride = config_mod.DEFAULT.cursor_stride
    w_enc = ops_huf.words_cap(nmax)
    # pad so each block's chunk count is a multiple of 8, as bmh_tpu's
    # flat-decode tiling does
    align_bits = 8 * chunk_bits
    nc_b = (w_enc * 32 + align_bits - 1) // align_bits * 8
    w_pad = nc_b * chunk_bits // 32
    stripe = block_sharding(mesh)
    group = mesh.get_group(BLOCK_AXIS)

    def step(*args):
        data, ns, enc_len, enc_code, count, sym = (stripe(a) for a in args)
        dev = data.device
        bl = data.shape[0]
        nc = bl * nc_b
        syms, ms, _, shifts, cps, _ = compress_stage1_fn(data, ns, stride)
        words, bits = ops_huf.encode_bitpack(syms, ms, enc_len, enc_code)
        words = torch.nn.functional.pad(words, (0, w_pad - w_enc)).reshape(-1)
        # uint32 bit patterns into int32 storage for the kernels
        wext = ops_huf.words_ext((words - ((words >> 31) << 32)).to(torch.int32),
                                 chunk_bits)
        cidx = torch.arange(nc, device=dev)
        seg_id = cidx // nc_b
        count_t = count[seg_id].T.to(torch.int32).contiguous()
        dec = ops_huf.gap_decode_flat(wext, count_t, cidx % nc_b == 0, seg_id * nc_b,
                                      seg_id, sym, ms, nmax, chunk_bits)
        codes = ops_rle.rle0_decode(dec, ms, ns)
        last = ops_mtf.mtf_inverse(codes, ns, mtf_chunk)
        out = ops_bwt.bwt_inverse_cursors(last, shifts, cps, ns, stride)
        pos = torch.arange(nmax, device=dev)[None, :]
        total_ok = ((out == data) & (pos < ns[:, None])).sum()
        dist.all_reduce(total_ok, op=dist.ReduceOp.SUM, group=group)
        return _gather(out, mesh), total_ok, _gather(bits, mesh)

    return _program(mesh, "roundtrip_step", step)


# ---------------------------------------------------------------------------
# Entry points: the forward step, and the multi-device dry run
# ---------------------------------------------------------------------------

def entry(device="cuda"):
    """(fn, example_args): compress stage 1 of the pipeline (BWT -> MTF ->
    RLE0 -> histogram) on one 64 KiB block."""
    nmax = 65536
    rng = np.random.default_rng(0)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu'")
    data = torch.from_numpy(rng.integers(0, 256, (1, nmax)).astype(np.uint8)).to(dev)
    n = torch.tensor([nmax - 137], device=dev)
    return (functools.partial(compress_stage1_fn,
                              stride=config_mod.DEFAULT.cursor_stride), (data, n))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The sharded round-trip step and the production API on an
    n_devices mesh, one process per device, each process calling this.
    Where no process group exists and n_devices is 1, a one-process group
    (NCCL on a card, gloo on the CPU) is made for the run and destroyed.

    Three passes: 512-byte blocks, two a device, with a ragged tail; one
    128 KiB block a device (BMH_DRYRUN_BLOCK; 0 skips this pass and the
    next) of the Calgary book1 text or, without the corpus, the seeded
    stream of utils/synth.py; then api.compress_bytes / decompress_bytes
    of the same bytes over n_devices devices of this process, with
    LAST_DISPATCH["compress_ndev"] checked.  The sharded stage and the step
    run as programs of the cache: on a card, captured graphs with their
    collectives inside."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for "
                           "a dry run on gloo over the CPU")
    made_group = False
    if not dist.is_initialized():
        if n_devices != 1:
            raise RuntimeError(f"a dry run on {n_devices} devices needs "
                               f"{n_devices} processes in a process group")
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
        made_group = True
    try:
        _dryrun(n_devices, device)
    finally:
        if made_group:
            programs.clear()  # its captured collectives go before the group
            dist.destroy_process_group()


def _dryrun(n_devices: int, device) -> None:
    from .. import api
    from ..models import pipeline
    from ..utils import corpus, synth

    mesh = make_mesh(n_devices, device=device)

    def run_case(nmax: int, batch: np.ndarray, ns: np.ndarray) -> None:
        b = batch.shape[0]
        stage1 = make_sharded_stage1(mesh, nmax)
        freqs = stage1(batch, ns)[2]
        tbl = host_tables(freqs.cpu().numpy())
        step = make_roundtrip_step(mesh, nmax, chunk_bits=256)
        out, total_ok, all_bits = step(batch, ns, tbl["enc_len"], tbl["enc_code"],
                                       tbl["count"], tbl["sym"])
        out = out.cpu().numpy()
        expect = int(ns.sum())
        if int(total_ok) != expect:
            raise AssertionError(f"round-trip mismatch at nmax={nmax}: "
                                 f"{int(total_ok)} != {expect}")
        if tuple(all_bits.shape) != (b,):
            raise AssertionError(f"all_bits has shape {tuple(all_bits.shape)}")
        for row in range(b):
            if not (out[row, : ns[row]] == batch[row, : ns[row]]).all():
                raise AssertionError(f"block {row} did not round-trip at nmax={nmax}")

    # pass 1: tiny shapes, two blocks a device, ragged tail
    nmax = 512
    b = 2 * n_devices
    rng = np.random.default_rng(1)
    batch = rng.integers(0, 256, (b, nmax)).astype(np.uint8)
    ns = np.full(b, nmax, dtype=np.int64)
    ns[-1] = nmax - 100
    run_case(nmax, batch, ns)

    nmax = int(os.environ.get("BMH_DRYRUN_BLOCK", "131072"))
    if nmax == 0:
        return
    # pass 2: one block a device at the production block size
    b = n_devices
    text = corpus.read_corpus_file("book1")
    if text is None:  # no corpus: the seeded stream
        text = synth.smoke_input(0)
    buf = (text * (b * nmax // len(text) + 1))[: b * nmax]
    batch = np.frombuffer(buf, dtype=np.uint8).reshape(b, nmax).copy()
    ns = np.full(b, nmax, dtype=np.int64)
    ns[-1] = nmax - 12345 if nmax > 12345 else nmax // 2
    run_case(nmax, batch, ns)

    # pass 3: the production API, its batch split over n_devices devices
    devices = ([torch.device("cpu")] * n_devices if mesh.device_type == "cpu"
               else [torch.device("cuda", i % torch.cuda.device_count())
                     for i in range(n_devices)])
    stream = bytes(buf)
    blob = api.compress_bytes(stream, block_size=nmax, device=devices)
    ndev_c = pipeline.LAST_DISPATCH["compress_ndev"]
    if ndev_c != n_devices:
        raise AssertionError(f"production compress used {ndev_c} devices, "
                             f"expected {n_devices}")
    if api.decompress_bytes(blob, device=devices) != stream:
        raise AssertionError("production multi-device round trip mismatch")
