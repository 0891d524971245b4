#!/usr/bin/env python3
"""Drive bmh_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each of which raises (non-zero exit) on any mismatch:
  1. card     no CUDA device -> exit 2 before any result is printed
  2. build    nvcc every kernel source in parallel; print -Xptxas -v
  3. kernels  capture K1-K4's inputs from a real 32-block, 128 KiB decode
              batch and K5's from a real compress of the same batch with
              BMH_PALLAS_SORT on (first doubling round, (32, 131072));
              kernel vs plain PyTorch version, exact.  K4 in both modes
              (one row a step; 16-step row links) at the captured shape and
              on a captured batch of 64 KiB blocks, against its plain
              one-row-a-step walk, each timed whole and as compose and walk
              parts.  K5 timed per kind
              of launch and, beside torch.sort (library_ms), at the sparse
              sets' one-row shapes; the casts around it timed too.  K1 and
              K3 also on inputs made to hurt their designs: K1 under a
              table that lets no two of a chunk's decodes meet, under one
              with maxl = 8 that forces overflow resets, and at 32- and
              64-bit chunks; K2 where the clip fires, under the all-zero
              table, at maxl = 8 with longer counts, on codes of up to 31
              bits, under a table per chunk, at 32-, 64- and 544-bit
              chunks; K3 on all-zero, all-255 and random codes.  K1 and K2
              on bitpacked streams whose codes reach 25 and 28 bits
              (utils/synth.fibonacci_stream), decoded back.  K6 on the
              histograms of the stream's first 32 blocks.  K7 on BWT last
              columns of the seeded text at 32 x 128 KiB and 32 x 1 MiB
              and on a puts batch (32 blocks of about 4000 bytes in
              128 KiB rows).  bound_ms
              counts the least work any implementation needs
  4. round    seeded 8 MiB text-like + 1 MiB random stream, compress and
     trip     decompress at 128 KiB on the card, with default knobs, with
              BMH_PALLAS_SORT on and with BMH_LF2 off: bit-exact, container
              SHA-256 equal to bmh_tpu's (tests/data/torch_golden.json),
              every kernel launched by the union of the runs; MB/s of the
              runs, and compress MB/s of the sparse/adaptive against the
              full-rounds program; peak memory.  Then the stream's first
              4 MiB at 64 KiB blocks with BMH_LF2 on and off (the composed
              and the one-row walk): bit-exact, one container.  Then K1
              and K2 at 32800-bit chunks against their plain versions, and
              the stream's first MiB decoded at 65536-bit chunks: bit-exact
  5. routes   a 512 KiB tiled random 1024-byte motif (pathological batch,
              periodic blocks) and b"\x00" * 3 (single symbol) round-trip
              on the card, containers equal to the CPU run's.  Then the
              periodic and single-symbol programs at their users' sizes:
              8 MiB of one seeded 1024-byte record (utils/synth.
              record_stream: 64 periodic blocks, its first MiB bmh_tpu's
              SHA-256) and 99 b"\x00" * 3 streams through
              decompress_many(uniform=True) (batches 32, 32, 32, 3 -> 4);
              each decode from an empty program cache and warm: graphs
              captured and replayed, capture s, host waits a batch (the
              drain only), a replay equal to the eager run, K1-K3 against
              their plain versions at the captured shapes
     upload   the compact upload and its inflate program: the main stream
              stays plain; 2048 seeded small files (synth.small_files,
              about 17 MiB) through compress_many(uniform=True) at 128 KiB
              (64 compact batches) and 32 MiB of zero-heavy 4 KiB pages
              (synth.zero_pages) at 1 MiB blocks (one compact batch): the
              inflate's runs and bytes against the plain upload's,
              bmh_tpu's SHA-256 (first 64 files, first 4 MiB of pages),
              per-file containers equal compress_bytes of each file,
              bit-exact decodes, cold and warm program counts, a replay
              equal to the eager run, K5 (BMH_PALLAS_SORT=1) at the
              inflated batch's shapes, K1-K4 at the pages' decode
  6. hostile  CRC-valid containers with a lying rle_len (a flat-route and
              a periodic-route block) raise ValueError, at BMH_INFLIGHT 1
              and 4
  7. inflight the stream at BMH_INFLIGHT 1 and 4 in turns (1, 4, 4, 1), and
              once more each with BMH_PALLAS_SORT=1: golden SHA-256,
              bit-exact; wall ms, device ms and busy ms (profiler), idle
              share and peak memory of each direction, LAST_DISPATCH
     graphs   the program layer (models/programs.py): the stream from an
              empty program cache at BMH_INFLIGHT 1 and 4, K5 off and on:
              golden SHA-256, bit-exact, graphs captured and replayed,
              capture seconds, host waits per batch (ab_trees.count_syncs),
              wall / device / busy ms, idle share, peak memory cold and
              warm; the code lengths of 32 stream blocks as a graph of
              their own, by K6 and by its plain 256-step loop: equal,
              each replay's card time and device operations; what the loop
              flags cost a compress (replays with the rounds given)
  8. blocks   the stream's first 2 MiB at 1 MiB blocks, at 100000-byte
              blocks and at BMH_CURSOR_STRIDE=64: bmh_tpu's SHA-256 for each
              (torch_golden.json "cases"), bit-exact
  9. dist     two processes on the one card (gloo, block stripes): rank 0's
              container equals the single-process one, both decode it
 10. cli      `python -m bmh_tpu_torch` children on the card: compress of the
              stream (golden SHA-256), again with BMH_PALLAS_SORT=1,
              decompress + verify, info, bench without a corpus (exit 1);
              each child's launch counts
 11. stream   compress --resumable's writer on 4 MiB beside compress_file
              (MB/s); cut after block 5 plus torn bytes, it resumes from 5,
              its blocks equal the one-shot container's, it decodes
 12. oracle   64 KiB: the oracle backend's container equals the card's, and
              each backend decodes the other's
 13. bench    bench.run_synthetic(total_mb=16) at BMH_INFLIGHT 1 and 4,
              bit-exact
 14. data-    make_roundtrip_step on a one-process NCCL group, 8 x 128 KiB
     parallel with a ragged last block, and the sharded stage 1: each a
              captured program with its collectives inside, from an empty
              cache and warm (no wait but its loops' flags, a replay equal
              to the eager run); rows, total and bits checked; K1-K4
              launched and each equal to its plain version at the step's
              shapes (256-bit chunks, MTF chunk 128); then dryrun_multichip(1)
 15. max-     bmh_tpu's largest block: the stream at 2 MiB blocks, with and
     block    without BMH_PALLAS_SORT (bmh_tpu's SHA-256, torch_golden.json
              case blocks_2mib), decoded with BMH_LF2 on and off; K1-K4
              against their plain versions at the 2^21 batch's shapes; peak
              memory.  Its largest dispatch: 64 MiB of seeded text as one
              dispatch of 32 x 2 MiB at BMH_INFLIGHT 1 and 4, bit-exact;
              wall ms, MB/s, peak memory of each direction
 16. micro-   bmh_tpu_torch.tools.microbench, every case at 3 timed calls;
     bench    its agreement checks must hold; its JSON line
Every program of the port (both compress programs, the inflate, the
three decode routes, the sharded stages and step) runs as captured CUDA
graphs (models/programs.py); a wrapper's launches inside a graph are
counted at every replay.  The kernels' inputs are taken from a program's
warm-up run (the cache is emptied first: a replay runs no Python).  Each
phase after the main path's reads its own launch counts, set to 0 just
before it; they go beside the main path's in the kernels line
(launches_by_run).  `[seconds]` lines give each phase's time.  The line
before the last is the kernels JSON; the last line is {"ok": true,
"device": {...}}.  `--dist-rank` runs one process of phase 9.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BLOCK = 1 << 17
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): device memory
# bandwidth, and the non-tensor-core 32-bit rate used for integer work
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# clock cycles of the sleep kernel that cuda_ms queues its calls behind
# (about 10 ms)
HOLD_CYCLES = 20_000_000


class Clock:
    """Prints the seconds each phase took, as `[seconds] phase: s`."""

    def __init__(self):
        self.start = self.t = time.perf_counter()

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"[seconds] {phase}: {now - self.t:.1f} (total {now - self.start:.1f})",
              flush=True)
        self.t = now


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` warm calls, by CUDA events.  A sleep
    kernel holds the stream while the host queues the calls, so that the
    events time the card's work and not the wrappers' launch overhead
    (where the host is the slower, as in the plain versions' Python loops,
    they time the host)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def capture_kernel_inputs(fn):
    """Run fn() with the wrappers of K1-K4 recording their first call's
    arguments (cloned), so the comparisons run at the shapes the path gives
    each kernel (K4's include the hop the path chose).  Returns (the
    captured arguments by kernel, fn's result)."""
    from bmh_tpu_torch.models import programs
    from bmh_tpu_torch.ops import decode_kernels, ibwt_kernel, imtf_kernel

    captured: dict = {}
    patched = [(decode_kernels, "phase_a"), (decode_kernels, "phase_b"),
               (imtf_kernel, "imtf_chunks"), (ibwt_kernel, "ibwt_walk")]
    originals = [getattr(mod, name) for mod, name in patched]

    def recorder(name, orig):
        def rec(*args):
            if name not in captured:
                captured[name] = [a.clone() if torch.is_tensor(a) else a
                                  for a in args]
            return orig(*args)
        return rec

    # a cached program replays without running its Python: dropped, the
    # next call's warm-up hands the wrappers their real inputs
    programs.clear()
    try:
        for (mod, name), orig in zip(patched, originals):
            setattr(mod, name, recorder(name, orig))
        result = fn()
    finally:
        for (mod, name), orig in zip(patched, originals):
            setattr(mod, name, orig)
    torch.cuda.synchronize()
    return captured, result


def capture_sort_inputs(bt, data: bytes, fn=None) -> dict:
    """Compress `data` once (or call fn()) with BMH_PALLAS_SORT on,
    recording (cloned) the first K5 call of each shape: (32, 131072) is the
    first doubling round, (1, 262144) the sparse tier-1 set."""
    from bmh_tpu_torch.models import programs
    from bmh_tpu_torch.ops import sort_kernel
    from bmh_tpu_torch.utils import config

    captured: dict = {}
    orig = sort_kernel.sort3

    def rec(*args):
        if tuple(args[0].shape) not in captured:
            captured[tuple(args[0].shape)] = [a.clone() for a in args]
        return orig(*args)

    programs.clear()
    config.DEFAULT.pallas_sort = True
    sort_kernel.sort3 = rec
    try:
        if fn is None:
            bt.compress_bytes(data, block_size=BLOCK, device="cuda")
        else:
            fn()
    finally:
        sort_kernel.sort3 = orig
        config.DEFAULT.pallas_sort = False
    torch.cuda.synchronize()
    return captured


def sort_library(k1, k2, idx):
    """What one library sort takes for K5's function: the packed int64
    (k1, k2) key, torch.sort(stable=True), and the gather of idx."""
    key = (k1.to(torch.int64) << 32) + (k2.to(torch.int64) + 2**31)
    ks, order = torch.sort(key, dim=-1, stable=True)
    return ks, torch.gather(idx, -1, order)


def sort_bound(k1) -> tuple[int, int]:
    """K5's least work on these inputs: bytes = 12 read + 12 written per
    triple; operations = a comparison sort's B * N * log2(N) comparisons of
    three int32 keys each."""
    b, n = k1.shape
    return 24 * b * n, 3 * b * n * (n.bit_length() - 1)


def sort_side_shapes(sorts: dict, card: str) -> None:
    """K5 beside the library call at the sparse sets' one-row shapes
    (captured from the compress when its ties reached them, else random),
    its launches by kind at the doubling-round shape, and the int64 <->
    int32 casts that ops/bwt._stable_sort3 makes around every call."""
    from bmh_tpu_torch.ops import sort_kernel

    for shape in ((1, 2 * BLOCK), (1, BLOCK // 2)):
        args = sorts.get(shape)
        if args is None:
            g = torch.Generator(device="cuda").manual_seed(1)
            args = [torch.randint(0, 1 << 17, shape, generator=g, device="cuda",
                                  dtype=torch.int32) for _ in range(2)]
            args.append(torch.arange(shape[1], device="cuda", dtype=torch.int32)[None])
        got, want = sort_kernel.sort3(*args), sort_kernel.sort3_plain(*args)
        require(all(torch.equal(x, y) for x, y in zip(got, want)),
                f"sort3 disagrees with its plain version at {shape}")
        print(f"[kernels] sort3 at {list(shape)} "
              f"({'captured' if shape in sorts else 'random'}): "
              f"ms={cuda_ms(lambda: sort_kernel.sort3(*args), 20):.4f} "
              f"library_ms={cuda_ms(lambda: sort_library(*args), 20):.4f} bound_ms="
              f"{sort_bound(args[0])[0] / PEAK_BYTES_PER_S * 1e3:.4f}", flush=True)
    k5 = sorts[(32, BLOCK)]
    out = tuple(torch.empty_like(x) for x in k5)
    log_t = sort_kernel.pick_log_tile(BLOCK)
    kinds = {name: cuda_ms(lambda: sort_kernel.launch(*k5, out, log_t, kind), 10)
             for name, kind in (("tile sort", sort_kernel.TILE_SORT),
                                ("high passes", sort_kernel.HIGH_PASSES),
                                ("merge passes", sort_kernel.MERGE_PASSES))}
    wide = [x.to(torch.int64) for x in k5]
    casts = cuda_ms(lambda: [x.to(torch.int32).contiguous() for x in wide]
                    + [x.to(torch.int64) for x in k5], 10)
    print(f"[kernels] sort3 at [32, {BLOCK}] by kind of launch, tile 2^{log_t}, "
          f"{card}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in kinds.items())
          + f"; the six casts around it {casts:.4f} ms", flush=True)


def walk_modes(bt, data: bytes, cap: dict, card: str) -> None:
    """K4 in both modes against its plain one-row-a-step walk, at the
    captured (32, 131072) shape and on a captured batch of 64 KiB blocks.
    Each mode's whole call, its compose and walk parts, and the walk's time
    per dependent step."""
    from bmh_tpu_torch.ops import ibwt_kernel

    small = bt.compress_bytes(data[: 32 * (BLOCK // 2)], block_size=BLOCK // 2,
                              device="cuda")
    t64k, s64k, steps64k, hop64k = capture_kernel_inputs(
        lambda: bt.decompress_bytes(small, device="cuda"))[0]["ibwt_walk"]
    require(hop64k == ibwt_kernel.HOP and t64k.shape[1] == BLOCK // 2,
            f"the 64 KiB path did not take the composed walk (hop {hop64k})")
    table, starts, steps, _ = cap["ibwt_walk"]
    for tab, st, nsteps in ((table, starts, steps), (t64k, s64k, steps64k)):
        want = ibwt_kernel.ibwt_walk_plain(tab, st, nsteps, 1)
        out = torch.empty_like(want)
        # what a hostile container's clamped start gives: the last row (a pad
        # row wherever a block is shorter than its bucket)
        hostile = st.clone()
        hostile[:, -1] = tab.shape[1] - 1
        want_hostile = ibwt_kernel.ibwt_walk_plain(tab, hostile, nsteps, 1)
        for hop in (1, ibwt_kernel.HOP):
            got = ibwt_kernel.ibwt_walk(tab, st, nsteps, hop)
            torch.cuda.synchronize()
            require(torch.equal(ibwt_kernel.ibwt_walk(tab, hostile, nsteps, hop),
                                want_hostile),
                    f"ibwt_walk hop {hop} at {list(tab.shape)} disagrees with the "
                    "plain one-row walk from a start clamped onto the last row")
            require(torch.equal(got, want)
                    and torch.equal(ibwt_kernel.ibwt_walk_plain(tab, st, nsteps, hop), want),
                    f"ibwt_walk hop {hop} at {list(tab.shape)}: the kernel or the "
                    "plain version at that hop disagrees with the plain one-row walk")
            scratch = ibwt_kernel.scratch_for(tab, st, nsteps, hop)
            ms = cuda_ms(lambda: ibwt_kernel.ibwt_walk(tab, st, nsteps, hop), 20)
            compose = cuda_ms(lambda: ibwt_kernel.launch(
                tab, st, out, scratch, nsteps, hop, ibwt_kernel.COMPOSE), 20) if hop > 1 else 0.0
            walk = cuda_ms(lambda: ibwt_kernel.launch(
                tab, st, out, scratch, nsteps, hop, ibwt_kernel.WALK), 20)
            print(f"[kernels] ibwt_walk hop {hop} at {list(tab.shape)}, starts "
                  f"{list(st.shape)}, {card}: equal=True ms={ms:.4f} "
                  f"compose_ms={compose:.4f} walk_ms={walk:.4f} "
                  f"({nsteps // hop} dependent steps a cursor, walk_ms over "
                  f"them {walk * 1e6 / (nsteps // hop):.0f} ns)",
                  flush=True)


def hostile_kernel_inputs(card: str, shape: tuple[int, int]) -> None:
    """K1, K2 and K3 against their plain versions on inputs made to hurt
    their designs (utils/synth.py): K1 where no two of a chunk's decodes
    meet, where overflow resets at maxl = 8 make the boundaries, and at 32-
    and 64-bit chunks; K2 where the clip fires, under the all-zero table, at
    maxl = 8 with longer counts, on codes of up to 31 bits, under a table
    per chunk, at 32-, 64- and 544-bit chunks; K3 on all-zero, all-255 and
    random codes.  1003 chunks or lanes: no multiple of a block's.  Then
    K3's time on codes that are all steps, at `shape` (the main path's) and
    narrower."""
    from bmh_tpu_torch.ops import decode_kernels as dk
    from bmh_tpu_torch.ops import imtf_kernel
    from bmh_tpu_torch.utils import synth

    for name, wext, count_t, chunk_bits, maxl in synth.phase_a_hostile_cases(0, 1003):
        args = (torch.from_numpy(wext).cuda(), torch.from_numpy(count_t).cuda(),
                chunk_bits, maxl)
        got, want = dk.phase_a(*args), dk.phase_a_plain(*args)
        torch.cuda.synchronize()
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"phase_a disagrees with its plain version on {name}")
        print(f"[kernels] phase_a on hostile input {name} {list(wext.shape)}, "
              f"chunk_bits {chunk_bits}, maxl {maxl}: equal=True "
              f"ms={cuda_ms(lambda: dk.phase_a(*args), 5):.4f}", flush=True)
    for name, *arrays, chunk_bits, maxl in synth.phase_b_hostile_cases(0, 1003):
        args = (*(torch.from_numpy(a).cuda() for a in arrays), chunk_bits, maxl)
        got, want = dk.phase_b(*args), dk.phase_b_plain(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"phase_b disagrees with its plain version on {name}")
        print(f"[kernels] phase_b on hostile input {name} {list(arrays[0].shape)}, "
              f"chunk_bits {chunk_bits}, maxl {maxl}: equal=True "
              f"ms={cuda_ms(lambda: dk.phase_b(*args), 5):.4f}, codewords of the "
              f"longest chunk {int((want >= 0).sum(0).max())}", flush=True)
    for name, codes in synth.imtf_hostile_cases(0, 300, 1003):
        codes = torch.from_numpy(codes).cuda()
        got, want = imtf_kernel.imtf_chunks(codes), imtf_kernel.imtf_chunks_plain(codes)
        torch.cuda.synchronize()
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"imtf_chunks disagrees with its plain version on {name}")
        print(f"[kernels] imtf_chunks on hostile input {name} {list(codes.shape)}: "
              f"equal=True ms={cuda_ms(lambda: imtf_kernel.imtf_chunks(codes), 5):.4f}",
              flush=True)
    # K3 where every code is a step: at the main path's shape (about 8
    # lanes to a warp scheduler), and with one lane to a scheduler
    m, k = shape
    schedulers = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    for lanes in (k, schedulers):
        codes = torch.randint(1, 256, (m, lanes), dtype=torch.int32, device="cuda")
        ms = cuda_ms(lambda: imtf_kernel.imtf_chunks(codes), 20)
        print(f"[kernels] imtf_chunks on non-zero random codes {[m, lanes]}, "
              f"{card}: ms={ms:.4f}, a step of a lane {ms * 1e6 / m:.1f} ns",
              flush=True)


def gap_decode_cases(cap: dict) -> list[dict]:
    """decode_cases' K1 and K2 (the first carries its bound's note)."""
    from bmh_tpu_torch.ops import decode_kernels as dk

    wext, count_t, chunk_bits, maxl = cap["phase_a"]
    wext_b, count_b, entry, cb_b, maxl_b = cap["phase_b"]
    nc = wext.shape[1]
    fsm_steps = chunk_bits + 32

    cases = []
    # K1: the least any implementation needs is one FSM step (12 integer
    # operations) per bit of each chunk.  Beside it, what walking every
    # (gap, chunk) decode to its exit takes, as the bound was counted while
    # the kernel did that.
    _, ex = dk.phase_a(wext, count_t, chunk_bits, maxl)
    gaps = torch.arange(32, device=wext.device)[:, None]
    k1_steps = int((chunk_bits + ex.to(torch.int64) - gaps).clamp(min=0).sum())
    k1_ops = 12 * fsm_steps * nc
    cases.append(dict(
        name="gap_decode_phase_a", source="bmh_tpu_torch/csrc/gap_decode.cu",
        replaces="bmh_tpu/ops/pallas_decode.py:179",
        kernel=lambda: dk.phase_a(wext, count_t, chunk_bits, maxl),
        plain=lambda: dk.phase_a_plain(wext, count_t, chunk_bits, maxl),
        bytes=nbytes(wext, count_t) + 2 * 4 * 32 * nc, ops=k1_ops, reps=20,
        chain=fsm_steps, chain_unit="bits of a chunk (one thread walks them)",
        shapes=[list(wext.shape), list(count_t.shape)],
        note=f"phase_a {k1_ops} / {12 * k1_steps} "
             f"({k1_ops / PEAK_OPS_PER_S * 1e3:.4f} / "
             f"{12 * k1_steps / PEAK_OPS_PER_S * 1e3:.4f} ms), "))
    # K2: the least is the bytes, its output above all.  Its chain is a
    # codeword a turn: the call ends with the chunk that completes the most.
    k2_words = int((dk.phase_b(wext_b, count_b, entry, cb_b, maxl_b) >= 0).sum(0).max())
    cases.append(dict(
        name="gap_decode_phase_b", source="bmh_tpu_torch/csrc/gap_decode.cu",
        replaces="bmh_tpu/ops/pallas_decode.py:207",
        kernel=lambda: dk.phase_b(wext_b, count_b, entry, cb_b, maxl_b),
        plain=lambda: dk.phase_b_plain(wext_b, count_b, entry, cb_b, maxl_b),
        bytes=nbytes(wext_b, count_b, entry) + 4 * fsm_steps * nc,
        ops=14 * fsm_steps * nc, reps=20,
        chain=k2_words, chain_unit="codewords of the longest chunk (one thread decodes them)",
        fill=lambda: torch.full((fsm_steps, nc), -1, dtype=torch.int32, device="cuda"),
        shapes=[list(wext_b.shape), list(count_b.shape), list(entry.shape)]))
    return cases


def decode_cases(cap: dict, tag: str = "[kernels]") -> list[dict]:
    """K1-K4 on the arguments captured from a decode (capture_kernel_inputs),
    each with its plain version and the least work any implementation needs
    for its bound.  A kernel the decode did not call has no case: K4 on the
    periodic route (its doubling iBWT), K1, K2 and K4 on the single-symbol
    one."""
    from bmh_tpu_torch.ops import ibwt_kernel, imtf_kernel

    cases = []
    k1_note = ""
    if "phase_a" in cap:  # K1 and K2 (not on the single-symbol route)
        cases += gap_decode_cases(cap)
        k1_note = cases[0].pop("note")
    (codes_tm,) = cap["imtf_chunks"]
    # K3: the least is a constant per code (look up, move, store: 4).
    # Beside it, the serial shift's count (the sum of the codes on top), as
    # the bound was counted while the kernel shifted entry by entry.
    m, k = codes_tm.shape
    k3_ops = 4 * m * k
    k3_shift = int((codes_tm.to(torch.int64) & 255).sum())
    k3_lane_steps = ((codes_tm & 255) != 0).sum(0)
    k3_steps, k3_dense = int(k3_lane_steps.sum()), int(k3_lane_steps.max())
    cases.append(dict(
        name="imtf_chunks", source="bmh_tpu_torch/csrc/imtf.cu",
        replaces="bmh_tpu/ops/pallas_mtf.py:53",
        kernel=lambda: imtf_kernel.imtf_chunks(codes_tm),
        plain=lambda: imtf_kernel.imtf_chunks_plain(codes_tm),
        bytes=2 * nbytes(codes_tm) + 4 * 256 * k, ops=k3_ops, reps=20,
        chain=k3_dense, chain_unit="non-zero codes of the densest lane",
        shapes=[list(codes_tm.shape)]))
    print(f"{tag} operations counted for the bounds, least work / as the "
          f"earlier kernels worked: {k1_note}imtf_chunks {k3_ops} / "
          f"{k3_ops + k3_shift} ({k3_ops / PEAK_OPS_PER_S * 1e3:.4f} / "
          f"{(k3_ops + k3_shift) / PEAK_OPS_PER_S * 1e3:.4f} ms); "
          f"{k3_steps} of imtf_chunks' {m * k} codes are non-zero, "
          f"{k3_dense} of {m} in the densest lane, "
          f"{int(k3_lane_steps.median())} in the median lane", flush=True)
    if "ibwt_walk" not in cap:  # the periodic and single-symbol routes
        return cases
    table, starts, steps, hop = cap["ibwt_walk"]
    b, kc = starts.shape
    cases.append(dict(
        name="ibwt_walk", source="bmh_tpu_torch/csrc/ibwt_walk.cu",
        replaces="bmh_tpu/ops/pallas_ibwt.py:68",
        kernel=lambda: ibwt_kernel.ibwt_walk(table, starts, steps, hop),
        plain=lambda: ibwt_kernel.ibwt_walk_plain(table, starts, steps, 1),
        bytes=nbytes(table, starts) + b * kc * steps, ops=3 * b * kc * steps,
        reps=20, shapes=[list(table.shape), list(starts.shape)],
        detail=f"{steps} steps a cursor, hop {hop}"))
    return cases


def hold(cases: list[dict], tag: str = "[kernels]") -> list[dict]:
    """Each case's kernel against its plain version (exactly) on the card,
    timed (mean of its warm calls) beside the plain version, its bound and
    the library call where one exists.  Returns the kernels line's rows;
    fails on the first disagreement."""
    rows = []
    for c in cases:
        got, want = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(float((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  if g.numel() else 0.0 for g, w in zip(got, want))
        ms = cuda_ms(c["kernel"], c["reps"])
        plain_ms = cuda_ms(c["plain"], 1)
        library_ms = cuda_ms(c["library"], c["reps"]) if "library" in c else None
        t_bytes = c["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = c["ops"] / PEAK_OPS_PER_S * 1e3
        rows.append({
            "name": c["name"], "route": "cuda", "source": c["source"],
            "replaces": c["replaces"], "equal": equal, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shapes": c["shapes"],
        })
        print(f"{tag} {c['name']} at {c['shapes']}{', ' + c['detail'] if 'detail' in c else ''}: "
              f"equal={equal} ms={ms:.4f} plain_ms={plain_ms:.2f} "
              f"bound_ms={max(t_bytes, t_ops):.4f} library_ms={library_ms}", flush=True)
        if c.get("chain"):  # (all-zero MTF codes: no step, no chain)
            print(f"{tag} {c['name']}: a thread's dependent chain is "
                  f"{c['chain']:.0f} {c['chain_unit']}, ms over them "
                  f"{ms * 1e6 / c['chain']:.1f} ns", flush=True)
        if "fill" in c:  # the least any kernel writing this output takes here
            print(f"{tag} {c['name']}: a fill of its output's bytes "
                  f"(torch.full) ms={cuda_ms(c['fill'], c['reps']):.4f}", flush=True)
        require(equal, f"{tag} {c['name']} disagrees with its plain version "
                       f"(max abs err {err})")
    return rows


def long_codes(card: str) -> None:
    """K1 and K2 on bitpacked streams whose Huffman codes reach 25 and 28
    bits (utils/synth.fibonacci_stream: 26 and 29 symbols with Fibonacci
    counts), encoded and decoded on the card by the port's ops: the decode
    gives the stream back, and each kernel, at the maxl the staging gives
    it, equals its plain version on the inputs captured from that decode."""
    from bmh_tpu_torch.models import pipeline
    from bmh_tpu_torch.ops import decode_kernels as dk
    from bmh_tpu_torch.ops import huffman
    from bmh_tpu_torch.utils import synth

    for k in (26, 29):
        stream = torch.from_numpy(synth.fibonacci_stream(k, 0)).cuda()
        m = stream.numel()
        nmax = 1 << (m - 1).bit_length()
        syms = torch.zeros((1, nmax), dtype=torch.int64, device="cuda")
        syms[0, :m] = stream
        mt = torch.tensor([m], device="cuda")
        lens = huffman.code_lengths_device(huffman.histogram(syms, mt, 257))
        words, bits = huffman.encode_bitpack(syms, mt, lens,
                                             huffman.canonical_codes_device(lens))
        nw = (int(bits) + 31) // 32
        block = {"payload": words[0, :nw].cpu().numpy().astype(">u4").tobytes()
                 [: (int(bits) + 7) // 8], "lens": lens[0].cpu().numpy().astype(np.uint8),
                 "orig_len": m, "rle_len": m, "shift": 0}
        tw, tl, tss, tssi, tsid, tms, _, _, maxl = pipeline._stage_flat_np([block], [0], 512)
        tw, tl, tss, tssi, tsid, tms = (torch.from_numpy(x).cuda()
                                        for x in (tw.view(np.int32), tl, tss, tssi, tsid, tms))
        wext, count_t, sym_b = pipeline._tables(tw, tl, tsid, 512)
        cap, out = capture_kernel_inputs(lambda: huffman.gap_decode_flat(
            wext, count_t, tss, tssi, tsid, sym_b, tms, nmax, 512, maxl))
        require(torch.equal(out[0, :m], stream),
                f"the {k}-symbol Fibonacci stream does not decode back")
        a_args, b_args = cap["phase_a"], cap["phase_b"]
        require(all(torch.equal(g, w) for g, w in zip(dk.phase_a(*a_args),
                                                      dk.phase_a_plain(*a_args)))
                and torch.equal(dk.phase_b(*b_args), dk.phase_b_plain(*b_args)),
                f"phase_a or phase_b disagrees with its plain version on the "
                f"{int(lens.max())}-bit code")
        print(f"[kernels] long codes: {k} symbols, {m} in the stream, longest code "
              f"{int(lens.max())} bits, {int(bits)} bits, maxl {maxl}, wext "
              f"{list(a_args[0].shape)}, {card}: decoded back, phase_a and phase_b "
              f"equal their plain versions; phase_a ms="
              f"{cuda_ms(lambda: dk.phase_a(*a_args), 20):.4f}, phase_b ms="
              f"{cuda_ms(lambda: dk.phase_b(*b_args), 20):.4f}", flush=True)


def kernel_phase(bt, blob: bytes, head: bytes, card: str) -> list[dict]:
    from bmh_tpu_torch.ops import sort_kernel

    cap = capture_kernel_inputs(lambda: bt.decompress_bytes(blob, device="cuda"))[0]
    sorts = capture_sort_inputs(bt, head)
    require((32, BLOCK) in sorts, f"no (32, {BLOCK}) K5 call captured: "
                                  f"{sorted(sorts)}")
    k5 = sorts[(32, BLOCK)]
    sort_side_shapes(sorts, card)
    walk_modes(bt, head, cap, card)
    hostile_kernel_inputs(card, tuple(cap["imtf_chunks"][0].shape))
    long_codes(card)
    cases = decode_cases(cap)
    k5_bytes, k5_ops = sort_bound(k5[0])
    cases.append(dict(
        name="sort3", source="bmh_tpu_torch/csrc/sort3.cu",
        replaces="bmh_tpu/ops/pallas_sort.py:149",
        kernel=lambda: sort_kernel.sort3(*k5),
        plain=lambda: sort_kernel.sort3_plain(*k5),
        library=lambda: sort_library(*k5),
        bytes=k5_bytes, ops=k5_ops, reps=10, shapes=[list(t.shape) for t in k5]))
    cases.append(code_lengths_case(head))
    cases.extend(mtf_forward_cases(0))
    return hold(cases)


def long_chunks(bt, data: bytes, card: str) -> None:
    """Chunk sizes past the 32768 bits that K1 once refused: K1 and K2 at
    32800 bits (K1's memo one chunk a block in shared memory) on 24 chunks
    of random words against their plain versions; then the stream's first
    MiB decoded at 65536-bit chunks (K1's memo in its global scratch),
    which must give back its bytes, and both kernels timed at the shapes
    that decode gave them."""
    from bmh_tpu_torch.ops import _build
    from bmh_tpu_torch.ops import decode_kernels as dk
    from bmh_tpu_torch.utils import config

    g = torch.Generator(device="cuda").manual_seed(32800)
    nc, chunk_bits, maxl = 24, 32800, 16
    wext = torch.randint(-2**31, 2**31, (chunk_bits // 32 + 1, nc), generator=g,
                         device="cuda", dtype=torch.int64).to(torch.int32)
    counts = torch.zeros(32, dtype=torch.int32, device="cuda")
    counts[[2, 3, 4, 6, 9]] = torch.tensor([1, 2, 3, 10, 20], dtype=torch.int32,
                                           device="cuda")
    count_t = counts[:, None].repeat(1, nc).contiguous()
    entry = torch.randint(0, 32, (nc,), generator=g, device="cuda", dtype=torch.int32)
    got, want = dk.phase_a(wext, count_t, chunk_bits, maxl), \
        dk.phase_a_plain(wext, count_t, chunk_bits, maxl)
    torch.cuda.synchronize()
    require(all(torch.equal(x, y) for x, y in zip(got, want)),
            f"phase_a disagrees with its plain version at {chunk_bits}-bit chunks")
    got = dk.phase_b(wext, count_t, entry, chunk_bits, maxl)
    require(torch.equal(got, dk.phase_b_plain(wext, count_t, entry, chunk_bits, maxl)),
            f"phase_b disagrees with its plain version at {chunk_bits}-bit chunks")
    print(f"[long] phase_a and phase_b at {chunk_bits}-bit chunks, wext "
          f"{list(wext.shape)}, {card}: equal=True, phase_a "
          f"ms={cuda_ms(lambda: dk.phase_a(wext, count_t, chunk_bits, maxl), 5):.4f}, "
          f"phase_b ms={cuda_ms(lambda: dk.phase_b(wext, count_t, entry, chunk_bits, maxl), 5):.4f}",
          flush=True)

    part = data[: 1 << 20]
    blob = bt.compress_bytes(part, block_size=BLOCK, device="cuda")
    default_bits = config.DEFAULT.decode_chunk_bits
    config.DEFAULT.decode_chunk_bits = 65536
    try:
        cap = capture_kernel_inputs(lambda: bt.decompress_bytes(blob, device="cuda"))[0]
        _build.reset_launches()
        out = bt.decompress_bytes(blob, device="cuda")
        launches = dict(_build.LAUNCHES)
    finally:
        config.DEFAULT.decode_chunk_bits = default_bits
    require(out == part, "the round trip at 65536-bit decode chunks is not bit-exact")
    require(launches["gap_decode_phase_a"] > 0 and launches["gap_decode_phase_b"] > 0,
            f"the 65536-bit decode did not launch K1 and K2: {launches}")
    a_args, b_args = cap["phase_a"], cap["phase_b"]
    print(f"[long] {len(part)} bytes decoded at 65536-bit chunks, bit-exact, "
          f"launches {launches}; wext {list(a_args[0].shape)}, {card}: phase_a "
          f"ms={cuda_ms(lambda: dk.phase_a(*a_args), 3):.4f}, phase_b "
          f"ms={cuda_ms(lambda: dk.phase_b(*b_args), 3):.4f}", flush=True)


def program_rates(bt, data: bytes, card: str) -> None:
    """Compress MB/s of the sparse/adaptive and the full-rounds program on
    the stream's RLE1'd blocks, through the pipeline's backend, in turns
    (sparse, full, full, sparse) three times; both must write the same
    blocks."""
    from bmh_tpu_torch.models import pipeline
    from bmh_tpu_torch.utils import config

    arr = np.frombuffer(data, np.uint8)
    blocks, _ = bt.api._rle1_blocks([arr[i:i + BLOCK] for i in range(0, arr.size, BLOCK)])
    be = pipeline.TorchBackend(torch.device("cuda"))
    stride = config.DEFAULT.cursor_stride
    times: dict = {False: [], True: []}
    outs = {}
    for full in (False, True, True, False) * 3:
        t = time.perf_counter()
        outs[full] = be.compress_blocks(blocks, stride, full_rounds=full)
        torch.cuda.synchronize()
        times[full].append(time.perf_counter() - t)
    require(all(a["payload"] == b["payload"] for a, b in zip(outs[False], outs[True])),
            "the sparse and full-rounds programs wrote different blocks")
    mb = len(data) / 1e6
    print(f"[programs] {card}: compress MB/s of the backend on the stream's "
          f"blocks, median of 6: sparse/adaptive "
          f"{mb / statistics.median(times[False]):.3f}, full rounds "
          f"{mb / statistics.median(times[True]):.3f}; runs {times}", flush=True)


def mutate_rle_len(blob: bytes, delta: int) -> bytes:
    """Re-pack block 0 with rle_len + delta and a fresh CRC."""
    from bmh_tpu_torch.utils import container as C

    bs, total, raws = C.unpack_file(blob)
    (orig_len, shift, lens, present, cps, rle_len, payload,
     pre_len) = C.unpack_block(raws[0])
    raws[0] = C.pack_block(orig_len, shift, lens, present, payload, cps=cps,
                           rle_len=rle_len + delta, pre_len=pre_len)
    return C.pack_file(raws, bs, total, stride=C.file_stride(blob))


def device_profile(fn) -> dict:
    """fn() under torch.profiler (utils/tracing.device_profile): wall ms,
    device ms, busy ms and idle share, and the five names of most device
    time; fails if the card did nothing or was busier than the wall."""
    from bmh_tpu_torch.utils import tracing

    prof = tracing.device_profile(fn)
    spans = prof.pop("spans")
    require(bool(spans), "the profiler saw no work on the card")
    require(prof["busy_ms"] <= prof["prof_wall_ms"],
            f"the card was busy {prof['busy_ms']:.3f} ms in a "
            f"{prof['prof_wall_ms']:.3f} ms call: annotated ranges were counted as work")
    by_name: dict = {}
    for name, a, b in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    prof["top"] = [[k[:60], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]]
    return prof


def inflight_phase(bt, data: bytes, golden: dict | None, card: str) -> None:
    """The stream at BMH_INFLIGHT 1 and 4 in turns (1, 4, 4, 1), then with
    BMH_PALLAS_SORT=1 at (1, 4): each turn a timed compress and decompress
    (host clock, peak memory), then one of each under the profiler."""
    from bmh_tpu_torch.models import pipeline
    from bmh_tpu_torch.ops import _build
    from bmh_tpu_torch.utils import config

    walls: dict = {}
    for sort3, turns in ((False, (1, 4, 4, 1)), (True, (1, 4))):
        config.DEFAULT.pallas_sort = sort3
        for depth in turns:
            config.DEFAULT.inflight = depth
            row = {"inflight": depth, "pallas_sort": sort3}
            for side in ("compress", "decompress"):
                fn = ((lambda: bt.compress_bytes(data, block_size=BLOCK, device="cuda"))
                      if side == "compress" else
                      (lambda: bt.decompress_bytes(blob, device="cuda")))
                _build.reset_launches()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
                walls.setdefault((side, sort3, depth), []).append(wall)
                row[side] = {"wall_ms": wall,
                             "peak_bytes": torch.cuda.max_memory_allocated(),
                             "launches": dict(_build.LAUNCHES),
                             "last_dispatch": dict(pipeline.LAST_DISPATCH)}
                if side == "compress":
                    blob = out
                    sha = hashlib.sha256(blob).hexdigest()
                    require(golden is None or sha == golden["container_sha256"],
                            f"inflight {depth} (K5 {sort3}): container differs from "
                            "bmh_tpu's recorded one")
                    require(not sort3 or row[side]["launches"]["sort3"] > 0,
                            "BMH_PALLAS_SORT=1 launched no sort3")
                else:
                    require(out == data, f"inflight {depth} (K5 {sort3}) round "
                                         "trip is not bit-exact")
                    require(all(row[side]["launches"][k] > 0 for k in
                                ("gap_decode_phase_a", "gap_decode_phase_b",
                                 "imtf_chunks", "ibwt_walk")),
                            f"inflight {depth} decode missed a kernel: "
                            f"{row[side]['launches']}")
            print(f"[inflight] {card}: {json.dumps(row)}", flush=True)
        for depth in (1, 4):
            config.DEFAULT.inflight = depth
            prof = {"inflight": depth, "pallas_sort": sort3,
                    "compress": device_profile(
                        lambda: bt.compress_bytes(data, block_size=BLOCK, device="cuda")),
                    "decompress": device_profile(
                        lambda: bt.decompress_bytes(blob, device="cuda"))}
            print(f"[inflight] profiled {card}: {json.dumps(prof)}", flush=True)
    config.DEFAULT.pallas_sort = False
    config.DEFAULT.inflight = 4
    # two slots on the one card: compress batches split over both,
    # decompress batches dealt to both
    two = ["cuda:0", "cuda:0"]
    t = time.perf_counter()
    blob2 = bt.compress_bytes(data, block_size=BLOCK, device=two)
    c_ms = (time.perf_counter() - t) * 1e3
    fan = dict(pipeline.LAST_DISPATCH)
    t = time.perf_counter()
    out = bt.decompress_bytes(blob2, device=two)
    d_ms = (time.perf_counter() - t) * 1e3
    fan["decompress_ndev"] = pipeline.LAST_DISPATCH["decompress_ndev"]
    require(blob2 == blob and out == data and fan == {"compress_ndev": 2,
                                                      "decompress_ndev": 2},
            f"two slots on the card: container equal {blob2 == blob}, bit-exact "
            f"{out == data}, fan-out {fan}")
    print(f"[inflight] two slots on the card {card}: container equal, bit-exact, "
          f"LAST_DISPATCH {fan}, compress {c_ms:.3f} ms, decompress {d_ms:.3f} ms",
          flush=True)
    print(f"[inflight] {card}: wall ms by (direction, K5, inflight), medians: "
          + json.dumps({f"{side} K5={k5} inflight={d}": statistics.median(v)
                        for (side, k5, d), v in walls.items()}), flush=True)


def graphs_phase(bt, data: bytes, golden: dict | None, card: str) -> dict:
    """The program layer (models/programs.py) on the stream, at BMH_INFLIGHT
    1 and 4, with K5 off and on.  Each setting starts from an empty program
    cache: a first compress and decompress (each shape warmed up, captured,
    replayed), then a warm call of each (replays only) whose host waits for
    the card are counted (ab_trees.count_syncs), then one of each under the
    profiler.  Printed: the golden SHA-256 and the bit-exact round trip,
    graphs captured and replayed, capture seconds, host waits per batch,
    wall / device / busy ms, idle share and peak memory.  Returns the warm
    calls' launches."""
    from bmh_tpu_torch.models import programs
    from bmh_tpu_torch.ops import _build
    from bmh_tpu_torch.tools.ab_trees import count_syncs
    from bmh_tpu_torch.utils import config

    t0 = time.perf_counter()
    counts: dict = {}
    for sort3 in (False, True):
        for depth in (1, 4):
            config.DEFAULT.pallas_sort = sort3
            config.DEFAULT.inflight = depth
            tag = f"K5={int(sort3)} inflight={depth}"
            try:
                programs.clear()
                row: dict = {}
                for side in ("compress", "decompress"):
                    fn = ((lambda: bt.compress_bytes(data, block_size=BLOCK, device="cuda"))
                          if side == "compress" else
                          (lambda: bt.decompress_bytes(blob, device="cuda")))
                    programs.reset_stats()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t = time.perf_counter()
                    out = fn()
                    cold_ms = (time.perf_counter() - t) * 1e3
                    cold = dict(programs.STATS)
                    cold_peak = (torch.cuda.max_memory_allocated(),
                                 torch.cuda.max_memory_reserved())
                    if side == "compress":
                        blob = out
                        sha = hashlib.sha256(blob).hexdigest()
                        require(golden is None or sha == golden["container_sha256"],
                                f"[graphs] {tag}: the container differs from bmh_tpu's")
                    else:
                        require(out == data, f"[graphs] {tag}: not bit-exact")
                    programs.reset_stats()
                    _build.reset_launches()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t = time.perf_counter()
                    out2, syncs = count_syncs(fn)
                    torch.cuda.synchronize()
                    warm_ms = (time.perf_counter() - t) * 1e3
                    warm = dict(programs.STATS)
                    counts[f"graphs {side} {tag}"] = dict(_build.LAUNCHES)
                    require(out2 == out, f"[graphs] {tag}: a replay's {side} differs")
                    require(warm["captures"] == 0 and warm["hits"] == warm["runs"] > 0,
                            f"[graphs] {tag}: the warm {side} captured: {warm}")
                    batches = warm["runs"]
                    row[side] = {
                        "cold_wall_ms": cold_ms, "captures": cold["captures"],
                        "graphs_captured": cold["graphs"], "capture_s": cold["capture_s"],
                        "warm_wall_ms": warm_ms, "batches": batches,
                        "graph_replays": warm["replays"], "flag_reads": warm["flag_reads"],
                        "host_waits": syncs,
                        "host_waits_per_batch": (syncs["event_waits"]
                                                 + syncs["torch_syncs"]) / batches,
                        "cold_peak_allocated": cold_peak[0],
                        "cold_peak_reserved": cold_peak[1],
                        "warm_peak_allocated": torch.cuda.max_memory_allocated(),
                        "warm_reserved": torch.cuda.memory_reserved(),
                        "profile": {k: v for k, v in device_profile(fn).items()
                                    if k != "top"}}
                note = " (bmh_tpu's)" if golden else ""
                print(f"[graphs] {tag} {card}: sha256 {sha}{note}, bit-exact; "
                      f"{json.dumps(row)}", flush=True)
            finally:
                config.DEFAULT.pallas_sort = False
                config.DEFAULT.inflight = 4
    huffman_graph(bt, data, card)
    flag_cost(bt, data, card)
    print(f"[graphs] {card}: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def flag_cost(bt, data: bytes, card: str) -> None:
    """What the loops' flag reads cost a compress: each batch of the
    stream's compress (default knobs) replayed as the pipeline replays it,
    a flag read a loop round, and again with each loop's rounds given, no
    read (what a conditional WHILE node on the card would save), in turns
    (flags, given, given, flags) five times; host clock around each
    batch's input copy, replay and synchronize, summed over the batches.
    Both must write the same output."""
    from bmh_tpu_torch.models import programs

    calls = []
    run = programs.run

    def rec(device, k, fn, inputs, out_len=None):
        calls.append((torch.device(device), k, inputs))
        return run(device, k, fn, inputs, out_len)

    programs.run = rec
    try:
        bt.compress_bytes(data, block_size=BLOCK, device="cuda")
    finally:
        programs.run = run
    progs = [programs._cache_for(dev).entries[k] for dev, k, _ in calls]
    trips, outs = [], []
    for prog, (_, _, inputs) in zip(progs, calls):
        prog.load(inputs)
        trips.append(prog.replay())
        outs.append(prog.out.clone())
    ms: dict = {"flags": [], "given": []}
    for _ in range(5):
        for mode in ("flags", "given", "given", "flags"):
            total = 0.0
            for prog, (_, _, inputs), t_i, want in zip(progs, calls, trips, outs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                prog.load(inputs)
                prog.replay(None if mode == "flags" else t_i)
                torch.cuda.synchronize()
                total += time.perf_counter() - t
                require(torch.equal(prog.out, want),
                        f"[graphs] a replay with {mode} rounds wrote another output")
            ms[mode].append(total * 1e3)
    reads = sum(sum(t) + len(t) for t in trips)
    print(f"[graphs] flag reads of a compress {card}: {len(calls)} batches, loop "
          f"rounds {trips}, {reads} reads; ms a call, median of 10: with the "
          f"reads {statistics.median(ms['flags']):.3f}, rounds given "
          f"{statistics.median(ms['given']):.3f}; runs {json.dumps(ms)}", flush=True)


def stream_histograms(data: bytes) -> torch.Tensor:
    """The (32, 257) RLE0 histograms of the stream's first 32 blocks, as the
    compress program computes them: the batch of the benchmark's cells."""
    from bmh_tpu_torch.models import pipeline
    from bmh_tpu_torch.ops import bwt
    from bmh_tpu_torch.utils import config

    arr = np.frombuffer(data[: 32 * BLOCK], np.uint8)
    batch = torch.from_numpy(arr.reshape(32, BLOCK).copy()).cuda()
    n = torch.full((32,), BLOCK, dtype=torch.int64, device="cuda")
    last = bwt.bwt_forward_cp(batch, n, config.DEFAULT.cursor_stride)[0]
    return pipeline._symbols(last, n)[2]


def code_lengths_case(data: bytes) -> dict:
    """K6 on the stream's 32 histograms, for the kernels check.  The least
    work: the bytes in and out; the operations of a sort of each row's 257
    leaves and of its merges (two compares, an add, a store).  The chain
    is the fullest row's merges, which one thread runs in order."""
    from bmh_tpu_torch.ops import huffman

    freqs = stream_histograms(data)
    merges = ((freqs > 0).sum(1) - 1).clamp(min=0)
    b, a = freqs.shape
    return dict(
        name="code_lengths", source="bmh_tpu_torch/csrc/code_lengths.cu",
        replaces="none (bmh_tpu/ops/huffman.py code_lengths_device is a lax.scan)",
        kernel=lambda: huffman.code_lengths_device(freqs),
        plain=lambda: huffman.code_lengths_plain(freqs),
        bytes=2 * nbytes(freqs), ops=b * a * 9 + 4 * int(merges.sum()), reps=20,
        chain=int(merges.max()), chain_unit="merges of the fullest row (one thread runs them)",
        shapes=[list(freqs.shape)])


def mtf_forward_cases(seed: int) -> list[dict]:
    """K7 at the main path's three shapes, for the kernels check: BWT last
    columns of the seeded text at 32 x 128 KiB and 32 x 1 MiB, and a puts
    batch of 32 blocks of about 4000 bytes in 128 KiB rows
    (tools/microbench.mtf_inputs).  The least work: n bytes in and n bytes
    out a row."""
    from bmh_tpu_torch.ops import mtf
    from bmh_tpu_torch.tools import microbench

    return [dict(name="mtf_forward", source="bmh_tpu_torch/csrc/mtf_forward.cu",
                 replaces="none (bmh_tpu/ops/mtf.py mtf_forward is jnp ops)",
                 kernel=functools.partial(mtf.mtf_forward, last, n, 128),
                 plain=functools.partial(mtf.mtf_forward_plain, last, n, 128),
                 bytes=2 * int(n.sum()), ops=0, reps=20, detail=label,
                 shapes=[list(last.shape)])
            for label, (last, n) in microbench.mtf_inputs(seed).items()]


def huffman_graph(bt, data: bytes, card: str) -> None:
    """The code lengths of the stream's first 32 blocks, each way as a
    program of its own: kernel K6 (code_lengths_device, one launch) and its
    plain version (the fixed 256-step loop).  Both replays must equal the
    eager kernel; printed: each replay's card time (CUDA events), its device
    operations (one profiled replay), and each run as it is (host clock,
    synchronized)."""
    from bmh_tpu_torch.models import programs
    from bmh_tpu_torch.ops import huffman
    from bmh_tpu_torch.utils import tracing

    freqs = stream_histograms(data)
    eager = huffman.code_lengths_device(freqs)
    present = int((freqs > 0).sum(1).max())
    for label, fn in (("kernel", huffman.code_lengths_device),
                      ("plain", huffman.code_lengths_plain)):
        # device inputs: no pinned staging buffer in flight at the capture
        torch.cuda.synchronize()
        prog = programs._Program(programs._cache_for(torch.device("cuda")), fn, (freqs,))
        prog.load((freqs,))
        prog.warm_up()
        prog.capture()
        prog.out.zero_()
        prog.replay()
        torch.cuda.synchronize()
        require(torch.equal(prog.out, eager),
                f"[graphs] the code-length graph ({label}) differs from the kernel")
        replay_ms = cuda_ms(prog.replay, 10)
        ops = len(tracing.device_profile(prog.replay)["spans"])
        walls = []
        for _ in range(5):
            t = time.perf_counter()
            fn(freqs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        print(f"[graphs] code lengths ({label}) at {list(freqs.shape)} (at most {present} "
              f"symbols in a row) {card}: equal to the kernel; one graph of {ops} device "
              f"operations (kernels, fills, copies), replay {replay_ms:.4f} ms by CUDA "
              f"events ({replay_ms * 1e3 / max(ops, 1):.2f} us each); run as it is "
              f"{statistics.median(walls):.3f} ms (host clock, median of 5)", flush=True)


def blocks_phase(bt, data: bytes, golden: dict | None, card: str) -> None:
    """Round trips the main phases do not reach: 1 MiB blocks (rows above
    2^18 sort through torch.sort; K3 and K4 at Nmax 2^20), 100000-byte
    blocks (no power of two) and BMH_CURSOR_STRIDE=64 (K4's step count),
    each on the stream's first 2 MiB against bmh_tpu's digest."""
    from bmh_tpu_torch.ops import _build
    from bmh_tpu_torch.utils import config

    cases = {"blocks_1mib": (1 << 20, 4096), "blocks_100000": (100000, 4096),
             "stride_64": (BLOCK, 64)}
    for name, (block, stride) in cases.items():
        part = data[: 2 << 20]
        config.DEFAULT.cursor_stride = stride
        _build.reset_launches()
        try:
            t = time.perf_counter()
            blob = bt.compress_bytes(part, block_size=block, device="cuda")
            out = bt.decompress_bytes(blob, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            config.DEFAULT.cursor_stride = 4096
        launches = dict(_build.LAUNCHES)
        sha = hashlib.sha256(blob).hexdigest()
        require(out == part, f"{name} round trip is not bit-exact")
        require(launches["imtf_chunks"] > 0 and launches["ibwt_walk"] > 0,
                f"{name} launched no K3 or K4: {launches}")
        if golden is not None:
            want = golden["cases"][name]
            require((want["block_size"], want["cursor_stride"]) == (block, stride)
                    and sha == want["container_sha256"],
                    f"{name} container differs from bmh_tpu's recorded one")
        print(f"[blocks] {name} {card}: {len(part)} -> {len(blob)} bytes, sha256 "
              f"{sha} (bmh_tpu's), bit-exact, round trip {wall:.3f} s, launches "
              f"{launches}", flush=True)


def dist_worker(rank: int, port: int, workdir: str) -> None:
    """One process of the [dist] phase: block stripes of the input through
    compress_stream and decompress_stream on the card, over gloo."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    import bmh_tpu_torch as bt
    from bmh_tpu_torch.parallel import distributed

    distributed.initialize(f"localhost:{port}", 2, rank)
    wd = Path(workdir)
    data = (wd / "input").read_bytes()
    be = bt.get_backend("torch", "cuda")
    t = time.perf_counter()
    blob = distributed.compress_stream(data, BLOCK, be)
    c_s = time.perf_counter() - t
    require((blob is not None) == (rank == 0), f"rank {rank} got blob {blob is not None}")
    if rank == 0:
        (wd / "container").write_bytes(blob)
    dist.barrier()
    t = time.perf_counter()
    back = distributed.decompress_stream((wd / "container").read_bytes(), be)
    d_s = time.perf_counter() - t
    require(back == data if rank == 0 else back is None,
            f"rank {rank}: the distributed round trip is wrong")
    dist.destroy_process_group()
    print(f"[dist] rank {rank}: compress_stream {c_s:.3f} s, decompress_stream "
          f"{d_s:.3f} s, ok", flush=True)


def dist_phase(bt, data: bytes, card: str) -> None:
    """Two processes on the one card, gloo on localhost, 4 MiB of the
    stream: rank 0's container equals this process's, and both ranks decode
    it.  The kernels are built already, so the children only load them."""
    part = data[: 4 << 20]
    single = bt.compress_bytes(part, block_size=BLOCK, device="cuda")
    torch.cuda.empty_cache()  # the children share the card
    with tempfile.TemporaryDirectory() as wd, socket.socket() as s:
        (Path(wd) / "input").write_bytes(part)
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        env = dict(os.environ, GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
        t = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                   "--dist-rank", str(r), "--dist-port", str(port),
                                   "--dist-dir", wd], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                p.kill()
                p.wait()
        wall = time.perf_counter() - t
        for r, (p, out) in enumerate(zip(procs, outs)):
            print("\n".join(f"[dist] rank {r}| {line}" for line in out.splitlines()[-20:]),
                  flush=True)
            require(p.returncode == 0, f"[dist] rank {r} exited {p.returncode}")
        blob = (Path(wd) / "container").read_bytes()
    require(blob == single, "rank 0's container differs from the single-process one")
    print(f"[dist] {card}: 2 processes, {len(part)} -> {len(blob)} bytes, rank 0's "
          f"container equals the single-process one, both ranks decoded it; "
          f"{wall:.1f} s with the processes' start", flush=True)


K1_K4 = ("gap_decode_phase_a", "gap_decode_phase_b", "imtf_chunks", "ibwt_walk")

# python -m bmh_tpu_torch, with the child's kernel launch counts (set to 0
# at its start) printed to stderr as its last line when it exits
COUNTING_MAIN = (
    "import atexit, json, runpy, sys\n"
    "from bmh_tpu_torch.ops import _build\n"
    "atexit.register(lambda: print('LAUNCHES ' + json.dumps(_build.LAUNCHES), "
    "file=sys.stderr, flush=True))\n"
    "runpy.run_module('bmh_tpu_torch', run_name='__main__', alter_sys=True)\n")


def launched(launches: dict, names=K1_K4) -> bool:
    return all(launches[k] > 0 for k in names)


def cli_phase(data: bytes, golden: dict | None, card: str) -> dict:
    """`python -m bmh_tpu_torch` in child processes on the card: compress
    the stream at 128 KiB blocks (golden SHA-256), again with
    BMH_PALLAS_SORT=1, decompress and verify, info, and bench without a
    corpus (exit 1).  Returns each verb's launch counts."""
    t0 = time.perf_counter()
    counts = {}
    with tempfile.TemporaryDirectory() as wd:
        wd = Path(wd)
        (wd / "stream").write_bytes(data)

        def run(label, args, expect=0, **env):
            t = time.perf_counter()
            p = subprocess.run([sys.executable, "-c", COUNTING_MAIN, *map(str, args)],
                               cwd=ROOT, env=dict(os.environ, **env), capture_output=True,
                               text=True, timeout=600)
            secs = time.perf_counter() - t
            require(p.returncode == expect, f"[cli] {label} exited {p.returncode}, "
                                            f"not {expect}:\n{p.stdout}\n{p.stderr}")
            tail = [ln for ln in p.stderr.splitlines() if ln.startswith("LAUNCHES ")]
            counts[label] = json.loads(tail[-1][len("LAUNCHES "):])
            out = (p.stdout.strip().splitlines() or [""])[-1]
            print(f"[cli] {label}: exit {p.returncode} in {secs:.1f} s, launches "
                  f"{counts[label]}: {out}", flush=True)
            return p

        block = ["--block-size", str(BLOCK)]
        run("compress", ["compress", wd / "stream", wd / "a.bzt", *block])
        run("compress BMH_PALLAS_SORT=1",
            ["compress", wd / "stream", wd / "k5.bzt", *block], BMH_PALLAS_SORT="1")
        require(counts["compress BMH_PALLAS_SORT=1"]["sort3"] > 0,
                "the CLI compress with BMH_PALLAS_SORT=1 launched no sort3")
        for name in ("a.bzt", "k5.bzt"):
            sha = hashlib.sha256((wd / name).read_bytes()).hexdigest()
            require(golden is None or sha == golden["container_sha256"],
                    f"[cli] {name} differs from bmh_tpu's recorded container")
        run("decompress", ["decompress", wd / "a.bzt", wd / "out"])
        require(launched(counts["decompress"]),
                f"the CLI decompress missed a kernel: {counts['decompress']}")
        p = run("verify", ["verify", wd / "stream", wd / "out"])
        require(p.stdout.strip() == "success", "[cli] verify did not print success")
        run("info", ["info", wd / "a.bzt"])
        p = run("bench without a corpus", ["bench"], expect=1,
                BMH_CORPUS_DIR=str(wd / "absent"))
        require("no corpus found" in p.stderr, "[cli] bench without a corpus: "
                                               "no message on stderr")
    print(f"[cli] {card}: golden SHA-256 with and without K5, bit-exact, "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def stream_phase(bt, data: bytes, card: str) -> dict:
    """compress --resumable's writer on the stream's first 4 MiB, beside
    compress_file's MB/s; the file cut after block 5 plus three bytes of
    block 6 resumes from 5 and ends with the one-shot container's blocks;
    the result decodes bit-exact.  Returns the decode's launch counts."""
    from bmh_tpu_torch.ops import _build
    from bmh_tpu_torch.utils import container as C
    from bmh_tpu_torch.utils.stream import compress_file_resumable

    t0 = time.perf_counter()
    part = data[: 4 << 20]
    with tempfile.TemporaryDirectory() as wd:
        src, one, res = (Path(wd) / n for n in ("in", "one.bzt", "res.bzt"))
        src.write_bytes(part)
        walls: dict = {"compress_file": [], "compress_file_resumable": []}
        for _ in range(2):
            res.unlink(missing_ok=True)
            t = time.perf_counter()
            bt.compress_file(str(src), str(one), block_size=BLOCK, device="cuda")
            walls["compress_file"].append(time.perf_counter() - t)
            t = time.perf_counter()
            info = compress_file_resumable(str(src), str(res), block_size=BLOCK,
                                           device="cuda")
            walls["compress_file_resumable"].append(time.perf_counter() - t)
            require(info["resumed_from"] == 0 and info["blocks"] == 32,
                    f"[stream] fresh run: {info}")
        blob = res.read_bytes()
        raws = C.unpack_file(blob)[2]
        cut = C.FILE_HEADER.size + sum(4 + len(r) for r in raws[:5]) + 3
        res.write_bytes(blob[:cut])
        t = time.perf_counter()
        info = compress_file_resumable(str(src), str(res), block_size=BLOCK, device="cuda")
        resume_s = time.perf_counter() - t
        require(info["resumed_from"] == 5, f"[stream] resume: {info}")
        blob = res.read_bytes()
        require(C.unpack_file(blob)[2] == C.unpack_file(one.read_bytes())[2],
                "[stream] the resumed file's blocks differ from the one-shot container's")
        _build.reset_launches()
        out = bt.decompress_bytes(blob, device="cuda")
        launches = dict(_build.LAUNCHES)
    require(out == part, "[stream] the resumed container does not decode bit-exact")
    require(launched(launches), f"[stream] the decode missed a kernel: {launches}")
    mb = len(part) / 1e6
    print(f"[stream] {card}: {len(part)} bytes at {BLOCK}-byte blocks, compress MB/s "
          f"(best of 2) compress_file {mb / min(walls['compress_file']):.3f}, "
          f"compress_file_resumable {mb / min(walls['compress_file_resumable']):.3f}; "
          f"runs s {walls}; resumed from block 5 in {resume_s:.3f} s, blocks equal "
          f"the one-shot container's, decode bit-exact, launches {launches}; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def oracle_phase(bt, data: bytes, card: str) -> dict:
    """On 64 KiB of the stream the oracle backend's container equals the
    card's, and each backend decodes the other's.  Returns the card
    decode's launch counts."""
    from bmh_tpu_torch.ops import _build

    t0 = time.perf_counter()
    part = data[: 1 << 16]
    t = time.perf_counter()
    oracle = bt.compress_bytes(part, block_size=BLOCK, backend="oracle")
    o_s = time.perf_counter() - t
    card_blob = bt.compress_bytes(part, block_size=BLOCK, device="cuda")
    require(oracle == card_blob, "[oracle] the oracle's container differs from the card's")
    _build.reset_launches()
    out = bt.decompress_bytes(oracle, device="cuda")
    launches = dict(_build.LAUNCHES)
    require(out == part and launched(launches),
            f"[oracle] the card did not decode the oracle's container ({launches})")
    t = time.perf_counter()
    require(bt.decompress_bytes(card_blob, backend="oracle") == part,
            "[oracle] the oracle did not decode the card's container")
    print(f"[oracle] {card}: {len(part)} -> {len(oracle)} bytes, containers equal, "
          f"cross-decoded, launches {launches}; oracle compress {o_s:.3f} s, "
          f"decompress {time.perf_counter() - t:.3f} s; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def bench_phase(card: str) -> dict:
    """bench.run_synthetic(total_mb=16) at BMH_INFLIGHT 1 and 4: each
    record bit-exact.  Returns the launch counts at each depth."""
    from bmh_tpu_torch import bench
    from bmh_tpu_torch.ops import _build
    from bmh_tpu_torch.utils import config

    t0 = time.perf_counter()
    counts = {}
    for depth in (1, 4):
        config.DEFAULT.inflight = depth
        _build.reset_launches()
        rec = bench.run_synthetic(total_mb=16, device="cuda")
        counts[f"bench inflight {depth}"] = dict(_build.LAUNCHES)
        require(rec["bit_exact"] is True, f"[bench] inflight {depth}: not bit-exact")
        require(rec["inflight"] == depth and rec["device_ms"] > 0,
                f"[bench] inflight {depth}: record {rec}")
        print(f"[bench] inflight {depth} {card}: {json.dumps(rec)}", flush=True)
    config.DEFAULT.inflight = 4
    print(f"[bench] {card}: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def dataparallel_phase(bt, data: bytes, card: str) -> dict:
    """make_roundtrip_step on a one-process NCCL group over 8 blocks of
    128 KiB of the stream with a ragged last block: stage 1 and the step
    each from an empty program cache and warm (program_run: a captured
    graph with its collectives inside, no wait but the loops' flags), a
    replay equal to the eager run; the total, every row, and the bits
    against the tables' lengths over the histograms; K1-K4 launched, each
    equal to its plain version on the step's captured inputs (256-bit
    chunks, MTF chunk 128) and timed there; the step's wall and device ms;
    then dryrun_multichip(1).  NCCL takes one process per card, so on one
    card the group has one process.  Returns launch counts."""
    import torch.distributed as dist

    from bmh_tpu_torch.models import programs
    from bmh_tpu_torch.ops import _build
    from bmh_tpu_torch.parallel import dataparallel as tdp
    from bmh_tpu_torch.parallel import mesh as tmesh

    t0 = time.perf_counter()
    nmax, b = BLOCK, 8
    batch = np.frombuffer(data[: b * nmax], np.uint8).reshape(b, nmax).copy()
    ns = np.full(b, nmax, dtype=np.int64)
    ns[-1] = nmax - 12345
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    counts = {}
    try:
        mesh = tmesh.make_mesh(1, device="cuda")
        stage1 = tdp.make_sharded_stage1(mesh, nmax)
        stage_out, _, _ = program_run(
            lambda: stage1(batch, ns), "[dataparallel] sharded stage 1",
            same=lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b)))
        freqs = stage_out[2].cpu().numpy()
        tbl = tdp.host_tables(freqs)
        step = tdp.make_roundtrip_step(mesh, nmax)
        args = (batch, ns, *(tbl[k] for k in ("enc_len", "enc_code", "count", "sym")))
        _, row, counts["dataparallel step warm"] = program_run(
            lambda: step(*args), "[dataparallel] step",
            same=lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b)))
        require(row["host_waits"]["torch_syncs"] == 0
                and row["host_waits"]["event_waits"] == row["flag_reads"],
                f"[dataparallel] the step waited past its loop flags: {row}")
        _, calls = program_calls(lambda: step(*args))
        replay_equals_eager(calls, "[dataparallel]")
        _build.reset_launches()
        cap, (out, total_ok, bits) = capture_kernel_inputs(lambda: step(*args))
        counts["dataparallel step"] = dict(_build.LAUNCHES)
        require(launched(counts["dataparallel step"]),
                f"[dataparallel] the step missed a kernel: {counts['dataparallel step']}")
        require(int(total_ok) == int(ns.sum()),
                f"[dataparallel] total_ok {int(total_ok)} != {int(ns.sum())}")
        out = out.cpu().numpy()
        require(all((out[r, : ns[r]] == batch[r, : ns[r]]).all() for r in range(b)),
                "[dataparallel] a decoded row differs from its input")
        require(np.array_equal(bits.cpu().numpy(), (freqs * tbl["enc_len"]).sum(1)),
                "[dataparallel] all_bits differ from the tables' bit counts")
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        prof = device_profile(lambda: step(*args))
        print(f"[dataparallel] step {card}: {b} x {nmax} (last {int(ns[-1])}), "
              f"chunk_bits 256, mtf_chunk 128: total_ok {int(total_ok)}, rows and bits "
              f"equal; wall ms {statistics.median(walls):.3f} (median of 3, runs {walls}); "
              f"profiled {json.dumps(prof)}; launches {counts['dataparallel step']}",
              flush=True)

        chunk_bits, cb_b = cap["phase_a"][2], cap["phase_b"][3]
        require((chunk_bits, cb_b) == (256, 256),
                f"[dataparallel] chunk bits {chunk_bits}, {cb_b}, not 256")
        hold(decode_cases(cap, "[dataparallel]"), "[dataparallel]")

        _build.reset_launches()
        t = time.perf_counter()
        tdp.dryrun_multichip(1, device="cuda")
        counts["dataparallel dryrun"] = dict(_build.LAUNCHES)
        require(launched(counts["dataparallel dryrun"]),
                f"[dataparallel] the dry run missed a kernel: {counts['dataparallel dryrun']}")
        print(f"[dataparallel] dryrun_multichip(1) {card}: passed in "
              f"{time.perf_counter() - t:.1f} s, launches {counts['dataparallel dryrun']}",
              flush=True)
    finally:
        # the captured collectives go before their communicator
        programs.clear()
        dist.destroy_process_group()
    print(f"[dataparallel] {card}: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def program_calls(fn):
    """fn() with programs.run and programs.run_device recording each call
    (entry point, device, key, function, inputs, out_len).  Returns (fn's
    result, the calls)."""
    from bmh_tpu_torch.models import programs

    calls = []
    run, run_device = programs.run, programs.run_device

    def rec_run(device, k, f, inputs, out_len=None):
        calls.append(("run", device, k, f, inputs, out_len))
        return run(device, k, f, inputs, out_len)

    def rec_device(device, k, f, inputs):
        calls.append(("run_device", device, k, f, inputs, None))
        return run_device(device, k, f, inputs)

    programs.run, programs.run_device = rec_run, rec_device
    try:
        return fn(), calls
    finally:
        programs.run, programs.run_device = run, run_device


def eager_inputs(inputs) -> list:
    """A program's inputs on the card, a Feed's program run as it is."""
    from bmh_tpu_torch.models import programs

    return [x.fn(*eager_inputs(x.inputs)) if isinstance(x, programs.Feed)
            else x.cuda() if torch.is_tensor(x)
            else torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in inputs]


def replay_equals_eager(calls: list, tag: str) -> list[str]:
    """For the first recorded call of each program (and of each Feed's
    program): its function run as it is on the card on that call's inputs
    equals a replay of its cache entry, which must be warm (no capture).
    Returns the program names checked."""
    from bmh_tpu_torch.models import programs

    todo, names = [], []
    for entry, device, k, fn, inputs, out_len in calls:
        for x in inputs:
            if isinstance(x, programs.Feed):
                todo.append(("run", device, x.k, x.fn, x.inputs, None))
        todo.append((entry, device, k, fn, inputs, out_len))
    for entry, device, k, fn, inputs, out_len in todo:
        if k[0] in names:
            continue
        names.append(k[0])
        eager = fn(*eager_inputs(inputs))
        captures = programs.STATS["captures"]
        if entry == "run":
            got = programs.run(device, k, fn, inputs, out_len).wait()
            want = (eager if out_len is None else eager[:out_len]).cpu().numpy()
            same = np.array_equal(got, want)
        else:
            got = programs.run_device(device, k, fn, inputs)
            same = all(torch.equal(a, b) for a, b in zip(got, eager))
        require(programs.STATS["captures"] == captures,
                f"{tag} {k[0]}: a warm key captured again")
        require(same, f"{tag} {k[0]}: a replay differs from the eager run")
    print(f"{tag} replay equals the eager run (its warm-up's function) for "
          f"{names}", flush=True)
    return names


def program_run(fn, tag: str, same=None) -> tuple:
    """fn() from an empty program cache (each new key warmed up, captured
    under sync debug mode "error", replayed), then again warm (replays
    only): captures, graphs and capture seconds of the cold call; replays,
    flag reads and host waits (ab_trees.count_syncs) a batch of the warm
    call; wall ms of both.  Fails if the warm call captured or gave
    another result.  Returns (the result, the printed row, the warm call's
    launches)."""
    from bmh_tpu_torch.models import programs
    from bmh_tpu_torch.ops import _build
    from bmh_tpu_torch.tools.ab_trees import count_syncs

    programs.clear()
    programs.reset_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t) * 1e3
    cold = dict(programs.STATS)
    programs.reset_stats()
    _build.reset_launches()
    t = time.perf_counter()
    out2, syncs = count_syncs(fn)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t) * 1e3
    warm = dict(programs.STATS)
    launches = dict(_build.LAUNCHES)
    require(out2 == out if same is None else same(out, out2),
            f"{tag}: the warm call's result differs from the cold one's")
    require(warm["captures"] == 0 and warm["hits"] == warm["runs"] > 0,
            f"{tag}: the warm call captured: {warm}")
    row = {"cold_wall_ms": cold_ms, "programs_run": cold["runs"],
           "captures": cold["captures"], "graphs_captured": cold["graphs"],
           "capture_s": cold["capture_s"], "cold_replays": cold["replays"],
           "warm_wall_ms": warm_ms, "warm_runs": warm["runs"],
           "warm_replays": warm["replays"], "flag_reads": warm["flag_reads"],
           "host_waits": syncs,
           "host_waits_per_run": (syncs["event_waits"] + syncs["torch_syncs"])
           / warm["runs"]}
    print(f"{tag}: {json.dumps(row)}; launches {launches}", flush=True)
    return out, row, launches


def routes_programs(bt, seed: int, golden: dict | None, card: str) -> dict:
    """The periodic and single-symbol programs at their users' sizes: 8 MiB
    of one seeded 1024-byte record (64 periodic blocks of 128 KiB, two
    batches) and 99 b"\x00" * 3 streams through decompress_many(uniform)
    (single-symbol batches of 32, 32, 32 and 3 padded to 4).  Each decode
    from an empty cache and warm (program_run): bit-exact, no host wait in
    a batch but its drain; wall and device ms (profiler); its first MiB's
    container is bmh_tpu's (torch_golden.json records_1mib); a replay
    equals the eager run; K1-K3 equal their plain versions at the captured
    shapes.  Returns the warm decodes' launches."""
    from bmh_tpu_torch.models import programs
    from bmh_tpu_torch.utils import container as C
    from bmh_tpu_torch.utils import synth

    t0 = time.perf_counter()
    counts = {}
    stream = synth.record_stream(seed)
    head = bt.compress_bytes(stream[: 1 << 20], block_size=BLOCK, device="cuda")
    sha = hashlib.sha256(head).hexdigest()
    if golden is not None:
        require(sha == golden["cases"]["records_1mib"]["container_sha256"],
                "[routes] the record stream's first MiB differs from bmh_tpu's")
    t = time.perf_counter()
    blob = bt.compress_bytes(stream, block_size=BLOCK, device="cuda")
    c_ms = (time.perf_counter() - t) * 1e3
    require(all(C.unpack_block(r)[4] is None for r in C.unpack_file(blob)[2]),
            "[routes] a record block has checkpoints: not the periodic route")
    out, row, counts["routes periodic decode"] = program_run(
        lambda: bt.decompress_bytes(blob, device="cuda"), "[routes] periodic decode")
    require(out == stream, "[routes] the record stream is not bit-exact")
    require(row["host_waits"]["torch_syncs"] == 0 and row["flag_reads"] == 0
            and row["host_waits"]["event_waits"] == row["warm_runs"],
            f"[routes] the periodic program waited inside a batch: {row}")
    prof = device_profile(lambda: bt.decompress_bytes(blob, device="cuda"))
    print(f"[routes] records {card}: {len(stream)} -> {len(blob)} bytes "
          f"(first compress, its shape captured, {c_ms:.1f} ms; first MiB sha256 {sha}"
          f"{' = bmh_tpu' if golden else ''}), decode bit-exact, profiled "
          f"{json.dumps({k: v for k, v in prof.items() if k != 'top'})}", flush=True)
    _, calls = program_calls(lambda: bt.decompress_bytes(blob, device="cuda"))
    require(replay_equals_eager(calls, "[routes]") == ["decode_periodic"],
            "[routes] the record stream did not take the periodic program")
    cap = capture_kernel_inputs(lambda: bt.decompress_bytes(blob, device="cuda"))[0]
    hold(decode_cases(cap, "[routes] periodic"), "[routes] periodic")

    singles = [b"\x00" * 3] * 99
    blobs = bt.compress_many(singles, block_size=2048, device="cuda")
    require(blobs == [bt.compress_bytes(b"\x00" * 3, block_size=2048, device="cpu")] * 99,
            "[routes] a single-symbol container differs from the CPU run's")
    out, row, counts["routes single decode"] = program_run(
        lambda: bt.decompress_many(blobs, uniform=True, device="cuda"),
        "[routes] single-symbol decode")
    require(out == singles, "[routes] the single-symbol streams are not bit-exact")
    prof = device_profile(lambda: bt.decompress_many(blobs, uniform=True, device="cuda"))
    print(f"[routes] single-symbol decode profiled {card}: "
          f"{json.dumps({k: v for k, v in prof.items() if k != 'top'})}", flush=True)
    require(row["host_waits"]["torch_syncs"] == 0 and row["flag_reads"] == 0
            and row["host_waits"]["event_waits"] == row["warm_runs"] == 4,
            f"[routes] the single-symbol program waited inside a batch: {row}")
    keys = sorted(k[1] for k in programs._cache_for(torch.device("cuda")).entries)
    require(keys == [4, 32], f"[routes] single-symbol batches were not padded: {keys}")
    _, calls = program_calls(lambda: bt.decompress_many(blobs, uniform=True, device="cuda"))
    require(replay_equals_eager(calls, "[routes]") == ["decode_single"],
            "[routes] the streams did not take the single-symbol program")
    cap = capture_kernel_inputs(
        lambda: bt.decompress_many(blobs, uniform=True, device="cuda"))[0]
    hold(decode_cases(cap, "[routes] single"), "[routes] single")
    print(f"[routes] {card}: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def upload_phase(bt, data: bytes, seed: int, golden: dict | None, card: str) -> dict:
    """The compact upload and its inflate program (bmh_tpu's _upload_batch):
    the main stream keeps the plain upload (bmh_tpu's rule); 2048 seeded
    small files (utils/synth.small_files, about 17 MiB) through
    compress_many(uniform=True) at 128 KiB (64 batches of 32, each compact)
    and 32 MiB of zero-heavy 4 KiB pages at 1 MiB blocks (RLE1 shrinks
    them under the 512 KiB bucket: one compact batch).  Each compress and
    decode from an empty cache and warm (program_run); the inflate's runs
    and bytes uploaded against the plain upload's; bmh_tpu's SHA-256 for
    the first 64 files and the first 4 MiB of pages; per-file containers
    equal compress_bytes of each file; bit-exact; wall and device ms
    (profiler); a replay equals the eager run; K5 (BMH_PALLAS_SORT=1) at
    the compact batch's captured shapes and K1-K4 at the pages' decode.
    Returns the warm calls' launches."""
    from bmh_tpu_torch.models import pipeline
    from bmh_tpu_torch.ops import _build, sort_kernel
    from bmh_tpu_torch.utils import synth

    t0 = time.perf_counter()
    counts = {}
    before = dict(pipeline.UPLOADS)
    bt.compress_bytes(data, block_size=BLOCK, device="cuda")
    main = {k: pipeline.UPLOADS[k] - before[k] for k in before}
    require(main["compact"] == 0 and main["plain"] == 3,
            f"[upload] the main stream took the compact upload: {main}")
    print(f"[upload] main stream: {main} (bmh_tpu's rule: plain)", flush=True)

    def uploads(fn):
        """fn()'s upload counts, a call (program_run calls it twice)."""
        before = dict(pipeline.UPLOADS)
        out = fn()
        return out, {k: (pipeline.UPLOADS[k] - before[k]) // 2 for k in before}

    files = synth.small_files(seed)
    (blobs, row, counts["upload small files compress"]), up = uploads(lambda: program_run(
        lambda: bt.compress_many(files, block_size=BLOCK, uniform=True, device="cuda"),
        "[upload] small files compress"))
    require(up["compact"] == 64 and up["plain"] == 0,
            f"[upload] the small files did not take the compact upload: {up}")
    require(row["host_waits"]["torch_syncs"] == 0
            and row["host_waits"]["event_waits"] == row["flag_reads"] + 64,
            f"[upload] a compress batch waited past its loop flags and drain: {row}")
    sha = hashlib.sha256(b"".join(blobs[:64])).hexdigest()
    if golden is not None:
        require(sha == golden["cases"]["small_files_64"]["container_sha256"],
                "[upload] the first 64 files' containers differ from bmh_tpu's")
    # device time of one warm compress batch of the 64 (each replays some
    # 20,000 kernels, and the profiler's trace costs host time for every one)
    prof_c = device_profile(lambda: bt.compress_many(files[:32], block_size=BLOCK,
                                                     uniform=True, device="cuda"))
    t = time.perf_counter()
    each = [bt.compress_bytes(f, block_size=BLOCK, device="cuda") for f in files]
    each_ms = (time.perf_counter() - t) * 1e3
    require(each == blobs, "[upload] a file's container differs from compress_bytes'")
    outs, _, counts["upload small files decode"] = program_run(
        lambda: bt.decompress_many(blobs, uniform=True, device="cuda"),
        "[upload] small files decode")
    require(outs == files, "[upload] the small files are not bit-exact")
    total = sum(len(f) for f in files)
    prof_d = device_profile(lambda: bt.decompress_many(blobs, uniform=True,
                                                       device="cuda"))
    print(f"[upload] small files profiled {card}: warm compress of the first 32 "
          f"files (one batch) {json.dumps({k: v for k, v in prof_c.items() if k != 'top'})}; "
          f"decode of all {json.dumps({k: v for k, v in prof_d.items() if k != 'top'})}",
          flush=True)
    print(f"[upload] small files {card}: {len(files)} files, {total} bytes -> "
          f"{sum(len(b) for b in blobs)}; uploads a call {up}: inflate runs "
          f"{up['compact']}, {up['bytes']} bytes sent against {up['plain_bytes']} "
          f"plain; first 64 sha256 {sha}{' = bmh_tpu' if golden else ''}; "
          f"compress_bytes of each file: {each_ms:.1f} ms for {len(files)} calls, "
          f"containers equal; decode bit-exact", flush=True)
    _, calls = program_calls(lambda: bt.compress_many(files[:32], block_size=BLOCK,
                                                      uniform=True, device="cuda"))
    names = replay_equals_eager(calls, "[upload]")
    require(names[0] == "inflate" and names[1].startswith("compress"),
            f"[upload] 32 small files did not take the inflate program: {names}")
    k5_blobs: list = []
    _build.reset_launches()
    sorts = capture_sort_inputs(bt, b"", lambda: k5_blobs.extend(bt.compress_many(
        files[:32], block_size=BLOCK, uniform=True, device="cuda")))
    counts["upload 32 small files compress K5"] = dict(_build.LAUNCHES)
    require(k5_blobs == blobs[:32],
            "[upload] BMH_PALLAS_SORT changed a small file's container")
    require(counts["upload 32 small files compress K5"]["sort3"] > 0,
            "[upload] the inflated batch launched no K5 with BMH_PALLAS_SORT=1")
    k5 = sorts[(32, BLOCK)]
    k5_bytes, k5_ops = sort_bound(k5[0])
    hold([dict(name="sort3", source="bmh_tpu_torch/csrc/sort3.cu",
               replaces="bmh_tpu/ops/pallas_sort.py:149",
               kernel=lambda: sort_kernel.sort3(*k5),
               plain=lambda: sort_kernel.sort3_plain(*k5),
               library=lambda: sort_library(*k5), bytes=k5_bytes, ops=k5_ops,
               reps=10, shapes=[list(t.shape) for t in k5])], "[upload] inflated")

    pages = synth.zero_pages(seed)
    part = pages[: 4 << 20]
    sha = hashlib.sha256(bt.compress_bytes(part, block_size=1 << 20,
                                           device="cuda")).hexdigest()
    if golden is not None:
        require(sha == golden["cases"]["zero_pages_4mib"]["container_sha256"],
                "[upload] the pages' first 4 MiB differ from bmh_tpu's")
    (blob, row, counts["upload zero pages compress"]), up = uploads(lambda: program_run(
        lambda: bt.compress_bytes(pages, block_size=1 << 20, device="cuda"),
        "[upload] zero pages compress"))
    require(up["compact"] == 1, f"[upload] the pages did not go compact: {up}")
    prof_c = device_profile(lambda: bt.compress_bytes(pages, block_size=1 << 20,
                                                      device="cuda"))
    out, _, counts["upload zero pages decode"] = program_run(
        lambda: bt.decompress_bytes(blob, device="cuda"), "[upload] zero pages decode")
    require(out == pages, "[upload] the zero-heavy pages are not bit-exact")
    prof_d = device_profile(lambda: bt.decompress_bytes(blob, device="cuda"))
    print(f"[upload] zero pages profiled {card}: warm compress "
          f"{json.dumps({k: v for k, v in prof_c.items() if k != 'top'})}; decode "
          f"{json.dumps({k: v for k, v in prof_d.items() if k != 'top'})}", flush=True)
    print(f"[upload] zero pages {card}: {len(pages)} -> {len(blob)} bytes; uploads a "
          f"call {up}: inflate runs {up['compact']}, {up['bytes']} bytes sent against "
          f"{up['plain_bytes']} plain; first 4 MiB sha256 {sha}"
          f"{' = bmh_tpu' if golden else ''}; decode bit-exact", flush=True)
    cap = capture_kernel_inputs(lambda: bt.decompress_bytes(blob, device="cuda"))[0]
    hold(decode_cases(cap, "[upload] zero pages"), "[upload] zero pages")
    print(f"[upload] {card}: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def maxblock_phase(bt, data: bytes, seed: int, golden: dict | None,
                   card: str) -> dict:
    """bmh_tpu's largest block (MAX_BLOCK_SIZE, 2 MiB) and its largest
    dispatch (BMH_MAX_DISPATCH = 32 such blocks) on the card.

    (a) The stream at 2 MiB blocks: its four text blocks batch at Nmax 2^21,
    its random MiB at 2^20.  Compressed with default knobs and with
    BMH_PALLAS_SORT=1, each container must carry bmh_tpu's SHA-256
    (torch_golden.json case blocks_2mib); decoded with BMH_LF2 on and off,
    bit-exact, K1-K4 launched; peak memory of each direction.  Then K1-K4 on
    the inputs captured from the 2^21 batch's decode, each against its plain
    version, timed there.
    (b) 64 MiB of seeded text as one dispatch of 32 x 2 MiB at BMH_INFLIGHT
    1 and 4: one container, bit-exact; wall ms, MB/s and peak memory of
    each direction.
    Returns the launches of each run, counted from 0 just before it."""
    from bmh_tpu_torch.models import pipeline, programs
    from bmh_tpu_torch.ops import _build, bwt, sort_kernel
    from bmh_tpu_torch.utils import config, synth

    t0 = time.perf_counter()
    big = bt.api.MAX_BLOCK_SIZE
    counts: dict = {}

    warmups: dict = {}

    def run(label, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        w0 = programs.STATS["warmups"]
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        counts[label] = dict(_build.LAUNCHES)
        warmups[label] = programs.STATS["warmups"] - w0
        return out, wall, torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()

    want = golden["cases"]["blocks_2mib"] if golden is not None else None
    blobs = {}
    for sort3 in (False, True):
        label = f"maxblock compress K5={int(sort3)}"
        config.DEFAULT.pallas_sort = sort3
        try:
            blob, wall, peak, reserved = run(label, lambda: bt.compress_bytes(
                data, block_size=big, device="cuda"))
        finally:
            config.DEFAULT.pallas_sort = False
        sha = hashlib.sha256(blob).hexdigest()
        require(want is None or (want["block_size"] == big and want["cursor_stride"] == 4096
                                 and sha == want["container_sha256"]),
                f"{label}: the container differs from bmh_tpu's recorded one")
        blobs[sort3] = blob
        print(f"[maxblock] {label} {card}: {len(data)} -> {len(blob)} bytes at "
              f"{big}-byte blocks, sha256 {sha} (bmh_tpu's), {wall:.3f} ms, peak "
              f"max_memory_allocated {peak} B (reserved {reserved} B), launches "
              f"{counts[label]}", flush=True)
    # why K5 launches so seldom here: the text batch's tied positions at the
    # sparse handoff against its compact set (tier 1) and tier-2 set
    arr = np.frombuffer(data, np.uint8)
    text = bt.api._rle1_blocks([arr[i:i + big] for i in range(0, 4 * big, big)])[0]
    nt = torch.tensor([x.size for x in text], device="cuda")
    batch = torch.zeros((len(text), big), dtype=torch.uint8, device="cuda")
    for i, x in enumerate(text):
        batch[i, : x.size] = torch.from_numpy(x.copy())
    tied = int(bwt.bwt_rounds(batch, nt, 1 << (config.DEFAULT.full_rounds + 1))[1].sum())
    m_cap = pipeline._sparse_cap(len(text), big)
    print(f"[maxblock] sort3 launches under BMH_PALLAS_SORT=1: "
          f"{counts['maxblock compress K5=1']['sort3']}.  K5 takes rows of 2^10..2^"
          f"{sort_kernel.MAX_N.bit_length() - 1}, as bmh_tpu's sort3 does; every "
          f"doubling round here sorts rows of 2^21 or 2^20.  The text batch "
          f"leaves {tied} positions tied at the sparse handoff: its tier-1 set "
          f"holds {m_cap} (above the envelope, torch.sort), and only a tier-2 "
          f"set of {m_cap // config.DEFAULT.tier2_div} (inside it) would reach K5; "
          f"the random MiB's rows leave no tie to refine", flush=True)
    for lf2 in (True, False):
        label = f"maxblock decompress lf2={int(lf2)}"
        config.DEFAULT.lf2 = lf2
        try:
            out, wall, peak, reserved = run(label, lambda: bt.decompress_bytes(
                blobs[False], device="cuda"))
        finally:
            config.DEFAULT.lf2 = True
        require(out == data, f"{label}: not bit-exact")
        require(launched(counts[label]), f"{label} missed a kernel: {counts[label]}")
        print(f"[maxblock] {label} {card}: bit-exact, {wall:.3f} ms, peak "
              f"max_memory_allocated {peak} B (reserved {reserved} B), launches "
              f"{counts[label]}", flush=True)
    cap = capture_kernel_inputs(lambda: bt.decompress_bytes(blobs[False], device="cuda"))[0]
    require(cap["ibwt_walk"][0].shape[1] == big,
            f"the first decode batch is not at Nmax {big}: {list(cap['ibwt_walk'][0].shape)}")
    rows = hold(decode_cases(cap, "[maxblock]"), "[maxblock]")
    print(f"[maxblock] kernels at the 2 MiB shape {card}: {json.dumps(rows)}", flush=True)

    stream = synth.smoke_input(seed, text_bytes=64 << 20, random_bytes=0)
    mb = len(stream) / 1e6
    blobs64 = {}
    for depth in (1, 4):
        config.DEFAULT.inflight = depth
        c_label = f"maxblock 64 MiB compress inflight {depth}"
        d_label = f"maxblock 64 MiB decompress inflight {depth}"
        try:
            blob, c_ms, c_peak, c_res = run(c_label, lambda: bt.compress_bytes(
                stream, block_size=big, device="cuda"))
            out, d_ms, d_peak, d_res = run(d_label, lambda: bt.decompress_bytes(
                blob, device="cuda"))
        finally:
            config.DEFAULT.inflight = 4
        blobs64[depth] = blob
        require(out == stream, f"{d_label}: not bit-exact")
        # one dispatch: one walk, and one more in the program's warm-up
        # where this shape was first seen
        require(launched(counts[d_label])
                and counts[d_label]["ibwt_walk"] == 1 + warmups[d_label],
                f"{d_label}: not one dispatch through every kernel: {counts[d_label]}, "
                f"{warmups[d_label]} warm-ups")
        print(f"[maxblock] 64 MiB, {len(stream) // big} x {big} in one dispatch, "
              f"BMH_INFLIGHT {depth} "
              f"{card}: {len(stream)} -> {len(blob)} bytes, bit-exact; compress "
              f"{c_ms:.3f} ms ({mb / c_ms * 1e3:.3f} MB/s), peak max_memory_allocated "
              f"{c_peak} B (reserved {c_res} B); decompress {d_ms:.3f} ms "
              f"({mb / d_ms * 1e3:.3f} MB/s), peak max_memory_allocated {d_peak} B "
              f"(reserved {d_res} B); launches {counts[c_label]} / {counts[d_label]}",
              flush=True)
    require(blobs64[1] == blobs64[4], "BMH_INFLIGHT changed the 64 MiB container")
    torch.cuda.empty_cache()
    print(f"[maxblock] {card}: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def microbench_phase(card: str) -> dict:
    """bmh_tpu_torch.tools.microbench, every case once at 3 timed calls:
    the checks it makes (the stable sorts and K5 give one order, both
    placements the same bytes, the histograms agree, ...) must hold.
    Returns its launch counts."""
    from bmh_tpu_torch.ops import _build
    from bmh_tpu_torch.tools import microbench

    _build.reset_launches()
    res = microbench.run(reps=3)
    counts = {"microbench": dict(_build.LAUNCHES)}
    bad = [(case, k) for case, r in res["cases"].items()
           for k, ok in r.get("equal", {}).items() if not ok]
    require(not bad, f"[microbench] formulations disagree: {bad}")
    print(f"[microbench] {card}: {json.dumps(res)}", flush=True)
    return counts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dist-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dist-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dist-dir", help=argparse.SUPPRESS)
    args = ap.parse_args()

    # 1. card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if args.dist_rank is not None:
        dist_worker(args.dist_rank, args.dist_port, args.dist_dir)
        return
    clock = Clock()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    sys.path.insert(0, str(ROOT))
    import bmh_tpu_torch as bt
    from bmh_tpu_torch.ops import _build

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(logs)} sources in {time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line:
                print(f"[build] {src}: {line.strip()}")

    golden = json.loads((ROOT / "tests" / "data" / "torch_golden.json").read_text())
    from bmh_tpu_torch.utils.synth import smoke_input

    data = smoke_input(args.seed)
    in_sha = hashlib.sha256(data).hexdigest()
    print(f"[input] {len(data)} bytes sha256 {in_sha}", flush=True)
    check_golden = args.seed == golden["seed"]
    if check_golden:
        require(in_sha == golden["input_sha256"],
                "input stream differs from the one the golden digest was made from")

    clock.lap("card, build, input")

    # 3. kernels, at the shapes of one real 32-block batch
    head = bt.compress_bytes(data[: 32 * BLOCK], block_size=BLOCK, device="cuda")
    kernels = kernel_phase(bt, head, data[: 32 * BLOCK], card)
    clock.lap("kernels")

    # 4. round trip, default knobs, BMH_PALLAS_SORT on, BMH_LF2 off: counts
    #    set to 0 just before each run of the main path, read just after
    from bmh_tpu_torch.utils import config

    runs = {}
    knobs = (("default", False, True), ("pallas_sort", True, True),
             ("lf2_off", False, False))
    for label, sort3, lf2 in knobs:
        config.DEFAULT.pallas_sort = sort3
        config.DEFAULT.lf2 = lf2
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        blob = bt.compress_bytes(data, block_size=BLOCK, device="cuda")
        out = bt.decompress_bytes(blob, device="cuda")
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        config.DEFAULT.pallas_sort = False
        config.DEFAULT.lf2 = True
        require(out == data, f"{label} round trip is not bit-exact")
        blob_sha = hashlib.sha256(blob).hexdigest()
        print(f"[roundtrip] {label}: {len(data)} -> {len(blob)} bytes, sha256 "
              f"{blob_sha}, max_memory_allocated {peak} B, launches {launches}",
              flush=True)
        if check_golden:
            require(blob_sha == golden["container_sha256"]
                    and len(blob) == golden["container_bytes"],
                    f"{label} container differs from bmh_tpu's recorded one")
        runs[label] = launches
    union = {k: sum(r[k] for r in runs.values()) for k in runs["default"]}
    require(all(v > 0 for v in union.values()),
            f"a kernel was not launched on the main path: {union}")
    for row in kernels:
        row["launches"] = union[row["name"]]
        row["launches_by_run"] = {label: r[row["name"]] for label, r in runs.items()}

    mb = len(data) / 1e6
    for label, sort3, lf2 in knobs:
        config.DEFAULT.pallas_sort = sort3
        config.DEFAULT.lf2 = lf2
        c_times, d_times = [], []
        for _ in range(3):
            t = time.perf_counter()
            bt.compress_bytes(data, block_size=BLOCK, device="cuda")
            c_times.append(time.perf_counter() - t)
            t = time.perf_counter()
            bt.decompress_bytes(blob, device="cuda")
            d_times.append(time.perf_counter() - t)
        config.DEFAULT.pallas_sort = False
        config.DEFAULT.lf2 = True
        print(f"[roundtrip] {label} {card}: compressed {len(blob)} B "
              f"(ratio {len(blob) / len(data):.4f}), compress "
              f"{mb / statistics.median(c_times):.3f} MB/s, decompress "
              f"{mb / statistics.median(d_times):.3f} MB/s (median of 3 warm); "
              f"runs c={c_times} d={d_times}", flush=True)
    program_rates(bt, data, card)
    clock.lap("roundtrip, programs")

    # 64 KiB blocks: the composed walk (BMH_LF2 on) and the one-row walk (off)
    part = data[: 4 << 20]
    blobs64 = {}
    for lf2 in (True, False):
        config.DEFAULT.lf2 = lf2
        _build.reset_launches()
        blobs64[lf2] = bt.compress_bytes(part, block_size=BLOCK // 2, device="cuda")
        out = bt.decompress_bytes(blobs64[lf2], device="cuda")
        walks = _build.LAUNCHES["ibwt_walk"]
        config.DEFAULT.lf2 = True
        require(out == part, f"64 KiB-block round trip (lf2={lf2}) is not bit-exact")
        require(walks > 0, f"64 KiB-block round trip (lf2={lf2}) launched no walk")
        print(f"[roundtrip] 64 KiB blocks, lf2={lf2}: {len(part)} -> "
              f"{len(blobs64[lf2])} bytes, bit-exact, ibwt_walk launches {walks}",
              flush=True)
    require(blobs64[True] == blobs64[False],
            "BMH_LF2 changed the 64 KiB-block container")

    # long decode chunks: K1 and K2 past 32768 bits, a 65536-bit round trip
    long_chunks(bt, data, card)
    clock.lap("64 KiB blocks, long")

    # 5. routes: pathological + periodic blocks, and a single-symbol block
    rng = np.random.default_rng(args.seed)
    motif = bytes(rng.integers(0, 256, 1024, dtype=np.uint8))
    periodic = motif * 512
    route_blobs = {}
    for label, stream, bs in (("periodic", periodic, BLOCK),
                              ("single-symbol", b"\x00" * 3, 2048)):
        route_blobs[label] = blob_r = bt.compress_bytes(stream, block_size=bs,
                                                        device="cuda")
        require(blob_r == bt.compress_bytes(stream, block_size=bs, device="cpu"),
                f"{label} container differs from the CPU run's")
        require(bt.decompress_bytes(blob_r, device="cuda") == stream,
                f"{label} round trip is not bit-exact")
        print(f"[routes] {label}: {len(stream)} -> {len(blob_r)} bytes, equal "
              f"to the CPU container, round trip bit-exact", flush=True)
    from bmh_tpu_torch.models import pipeline
    from bmh_tpu_torch.utils import container as C

    raws = C.unpack_file(route_blobs["periodic"])[2]
    require(all(C.unpack_block(r)[4] is None for r in raws)
            and pipeline._looks_pathological(np.frombuffer(periodic[:BLOCK], np.uint8)),
            "the motif stream did not take the pathological and periodic routes")
    clock.lap("routes")
    route_counts = routes_programs(bt, args.seed, golden if check_golden else None, card)
    clock.lap("routes, programs")
    route_counts.update(upload_phase(bt, data, args.seed,
                                     golden if check_golden else None, card))
    clock.lap("upload")

    # 6. hostile: a lying rle_len must fail closed on the card, on the flat
    #    and on the periodic route
    small = bt.compress_bytes(data[:12000], block_size=16384, device="cuda")
    period = bt.compress_bytes(periodic[:2 * BLOCK], block_size=BLOCK, device="cuda")
    for depth in (1, 4):
        config.DEFAULT.inflight = depth
        for label, bad in (("flat", mutate_rle_len(small, -3)),
                           ("periodic", mutate_rle_len(period, -2))):
            try:
                bt.decompress_bytes(bad, device="cuda")
            except ValueError as e:
                print(f"[hostile] {label}, inflight {depth}: lying rle_len "
                      f"rejected: {e}", flush=True)
            else:
                raise SystemExit(f"chip_smoke FAILED: {label} lying rle_len "
                                 f"container decoded at inflight {depth}")
    config.DEFAULT.inflight = 4

    # 7-9. the dispatch layer: the in-flight window, the block sizes the main
    #      phases do not reach, two processes on the card
    clock.lap("hostile")
    inflight_phase(bt, data, golden if check_golden else None, card)
    clock.lap("inflight")
    graph_counts = graphs_phase(bt, data, golden if check_golden else None, card)
    clock.lap("graphs")
    blocks_phase(bt, data, golden if check_golden else None, card)
    clock.lap("blocks")
    dist_phase(bt, data, card)
    clock.lap("dist")

    # 10-14. the rest of bmh_tpu: the command line, the resumable writer,
    #        the oracle backend, the bench, the block-parallel step; each
    #        path's launches, counted from 0 just before it, go beside the
    #        main path's in the kernels line
    paths = cli_phase(data, golden if check_golden else None, card)
    paths.update(graph_counts)
    paths.update(route_counts)
    clock.lap("cli")
    paths["stream decode"] = stream_phase(bt, data, card)
    paths["oracle container decode"] = oracle_phase(bt, data, card)
    clock.lap("stream, oracle")
    paths.update(bench_phase(card))
    clock.lap("bench")
    paths.update(dataparallel_phase(bt, data, card))
    clock.lap("dataparallel")

    # 15-16. bmh_tpu's largest block and dispatch; the microbench twins
    paths.update(maxblock_phase(bt, data, args.seed, golden if check_golden else None,
                                card))
    clock.lap("maxblock")
    paths.update(microbench_phase(card))
    clock.lap("microbench")
    for row in kernels:
        row["launches_by_run"].update({label: c[row["name"]] for label, c in paths.items()})

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
