"""Where the time goes: per-stage times of one 32-block, 128 KiB batch and a
device-time profile of the whole 9 MiB smoke stream, on one CUDA card.

The compress table holds both BWT programs (full rounds; the sparse/
adaptive program's rounds to the handoff gap and its whole rank
computation) and the forward BWT without checkpoints (bwt_forward, as
bmh_tpu's profiler times its BWT stage).  It is taken twice, the second
time with BMH_PALLAS_SORT on (the BWT sorts through kernel K5).

    python -m bmh_tpu_torch.tools.profile_stages [--seed 0] [--out PATH]

Stage times are host-clock medians of 5 warm runs, each stage ended by
torch.cuda.synchronize().  The profile (torch.profiler, CPU + CUDA) runs
one warm compress_bytes and one decompress_bytes of the stream, and the
backend's compress of its blocks by each BWT program, and reports wall
time, summed device kernel time, busy time (the union of the kernels'
intervals), the idle share 1 - busy/wall, and the kernels with the most
device time.  Prints one JSON object per section and,
with --out, also writes them all to that file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .. import api
from ..models import pipeline
from ..ops import bwt, huffman, mtf, rle
from ..utils import config, tracing
from ..utils.synth import smoke_input

BLOCK = 1 << 17


def _timed(fn, reps=5):
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return out, statistics.median(times)


def compress_stages(blocks, dev) -> dict:
    """Stage times of one batch: the BWT of both programs, then the shared
    tail, then the whole batch by each program."""
    cfg = config.DEFAULT
    batch = np.zeros((len(blocks), BLOCK), np.uint8)
    for i, b in enumerate(blocks):
        batch[i, : b.size] = b
    data = torch.from_numpy(batch).to(dev)
    n = torch.tensor([b.size for b in blocks], device=dev)
    b_pad = pipeline._next_pow2(len(blocks))
    h_stop = 1 << (cfg.full_rounds + 1)
    ms = {}
    # full-rounds program's BWT, then the sparse/adaptive program's
    _, ms["bwt_rounds_full"] = _timed(lambda: bwt.bwt_rounds(data, n))
    _, ms["bwt_forward"] = _timed(lambda: bwt.bwt_forward(data, n))
    (_, tied, _, _), ms[f"bwt_rounds_to_h{h_stop}"] = _timed(
        lambda: bwt.bwt_rounds(data, n, h_stop))
    ms["tied_at_handoff"] = int(tied.sum())
    ms["sparse_cap"] = pipeline._sparse_cap(b_pad, BLOCK)
    rank_s, ms["sparse_ranks"] = _timed(lambda: pipeline.sparse_ranks(data, n, b_pad))
    (last, _, _, _), ms["bwt_finish_cp"] = _timed(
        lambda: bwt.bwt_finish_cp(data, n, rank_s, cfg.cursor_stride))
    codes, ms["mtf_forward"] = _timed(lambda: mtf.mtf_forward(last, n, cfg.mtf_chunk))
    (syms, m), ms["rle0_encode"] = _timed(lambda: rle.rle0_encode(codes, n))
    freqs, ms["histogram"] = _timed(lambda: huffman.histogram(syms, m, rle.RLE_ALPHABET))
    lens, ms["code_lengths_device"] = _timed(lambda: huffman.code_lengths_device(freqs))
    canon, ms["canonical_codes_device"] = _timed(
        lambda: huffman.canonical_codes_device(lens))
    _, ms["encode_bitpack"] = _timed(lambda: huffman.encode_bitpack(syms, m, lens, canon))
    arrs = list(blocks)
    idxs = list(range(len(arrs)))
    for label, hard in (("sparse", False), ("full", True)):
        _, ms[f"whole_batch_{label}"] = _timed(lambda: pipeline._compress_unpack(
            pipeline._compress_dispatch(arrs, idxs, BLOCK, cfg.cursor_stride, hard,
                                        b_pad, dev), arrs, idxs, cfg.cursor_stride))
    return ms


def decompress_stages(blob: bytes, dev) -> dict:
    cfg = config.DEFAULT
    infos = api._parse(blob)[0]
    idxs = list(range(len(infos)))
    ms = {}
    staged, ms["host_stage_flat"] = _timed(
        lambda: pipeline._stage_flat_np(infos, idxs, cfg.decode_chunk_bits))
    words, lens_all, seg_start, seg_start_idx, seg_id, m, ns, shifts, maxl = staged
    b_pad = shifts.size
    kcp = max(BLOCK // cfg.cursor_stride - 1, 1)
    cps_np = np.zeros((b_pad, kcp), np.int64)
    for row, i in enumerate(idxs):
        cps_np[row, : len(infos[i]["cps"])] = infos[i]["cps"]
    ncopy_np = np.zeros(b_pad, np.int64)
    ncopy_np[: len(idxs)] = ns[: len(idxs)]

    def upload():
        return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
                (words.view(np.int32), lens_all, seg_start, seg_start_idx,
                 seg_id, m, ns, shifts, cps_np, ncopy_np)]

    t, ms["upload"] = _timed(upload)
    w, la, ss, ssi, sid, mt, nt, sh, cps, ncopy = t
    cb = cfg.decode_chunk_bits

    def tables():
        count_b, sym_b = huffman.decode_tables_device(la)
        count_t = count_b[sid].T.to(torch.int32).contiguous()
        return count_t, sym_b, huffman.words_ext(w, cb)

    (count_t, sym_b, wext), ms["decode_tables"] = _timed(tables)
    (codes, _), ms["gap_decode_rle0_flat"] = _timed(
        lambda: huffman.gap_decode_rle0_flat(wext, count_t, ss, ssi, sid, sym_b,
                                             mt, nt, BLOCK, cb, maxl))
    last, ms["mtf_inverse"] = _timed(lambda: mtf.mtf_inverse(
        codes[:b_pad], nt[:b_pad], cfg.imtf_chunk))
    _, ms["bwt_inverse_cursors"] = _timed(
        lambda: bwt.bwt_inverse_cursors(last, sh, cps, nt[:b_pad], cfg.cursor_stride))
    _, ms["whole_decode_flat"] = _timed(lambda: pipeline.decode_flat_program(
        w, la, ss, ssi, sid, mt, nt, sh, cps, ncopy, BLOCK, cb, maxl,
        cfg.cursor_stride).cpu())
    # the same batch as the pipeline runs it: a replay of the captured
    # program and the copy of its output
    _, ms["whole_batch_program"] = _timed(lambda: pipeline._decompress_drain(
        pipeline._decompress_dispatch(infos, idxs, BLOCK, cfg.cursor_stride, dev),
        idxs, [None] * len(idxs)))
    return ms


def with_sort_kernel(fn):
    """fn() with BMH_PALLAS_SORT on: every BWT sort inside K5's envelope
    runs the kernel."""
    config.DEFAULT.pallas_sort = True
    try:
        return fn()
    finally:
        config.DEFAULT.pallas_sort = False


def profile(fn, label: str) -> dict:
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    # the card's own work only: not the host side, and not the device side
    # of the pipeline's annotated ranges, which span the kernels again
    by_name: dict = {}
    spans = tracing.device_activity(prof)
    for name, a, b in spans:
        ms, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) / 1e3, calls + 1)
    device_ms = sum(ms for ms, _ in by_name.values())
    busy = tracing.busy_ms(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "section": f"profile_{label}", "wall_ms": wall, "device_ms": device_ms,
        "busy_ms": busy, "idle_share": 1 - busy / wall if wall > 0 else None,
        "top": [{"kernel": k[:90], "device_ms": ms, "calls": calls}
                for k, (ms, calls) in top],
    }


def program_profiles(arr: np.ndarray, dev) -> list[dict]:
    """Device time and idle share of the backend's compress of the whole
    stream's RLE1'd blocks by each BWT program, and by the sparse program
    with BMH_PALLAS_SORT on."""
    blocks, _ = api._rle1_blocks([arr[i:i + BLOCK] for i in range(0, arr.size, BLOCK)])
    be = pipeline.TorchBackend(dev)
    stride = config.DEFAULT.cursor_stride
    return [
        profile(lambda: be.compress_blocks(blocks, stride), "backend_sparse_9MiB"),
        profile(lambda: be.compress_blocks(blocks, stride, full_rounds=True),
                "backend_full_rounds_9MiB"),
        with_sort_kernel(lambda: profile(lambda: be.compress_blocks(blocks, stride),
                                         "backend_sparse_pallas_sort_9MiB")),
    ]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the sections to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_stages needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    data = smoke_input(args.seed)
    arr = np.frombuffer(data, np.uint8)
    blocks, _ = api._rle1_blocks([arr[i:i + BLOCK] for i in range(0, 32 * BLOCK, BLOCK)])
    blob_head = api.compress_bytes(data[: 32 * BLOCK], block_size=BLOCK, device=dev)
    blob = api.compress_bytes(data, block_size=BLOCK, device=dev)
    sections = [
        {"section": "card", "card": card, "torch": torch.__version__,
         "cuda": torch.version.cuda},
        {"section": "compress_stages_ms_32x128KiB_text", **compress_stages(blocks, dev)},
        {"section": "compress_stages_ms_32x128KiB_text_pallas_sort",
         **with_sort_kernel(lambda: compress_stages(blocks, dev))},
        {"section": "decompress_stages_ms_32x128KiB_text",
         **decompress_stages(blob_head, dev)},
        profile(lambda: api.compress_bytes(data, block_size=BLOCK, device=dev),
                "compress_9MiB"),
        profile(lambda: api.decompress_bytes(blob, device=dev), "decompress_9MiB"),
        *program_profiles(arr, dev),
    ]
    for s in sections:
        print(json.dumps(s))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(sections, indent=1) + "\n")


if __name__ == "__main__":
    main()
