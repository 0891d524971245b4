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
              chunks; K3 on all-zero, all-255 and random codes.  bound_ms
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
              on the card, containers equal to the CPU run's
  6. hostile  CRC-valid containers with a lying rle_len (a flat-route and
              a periodic-route block) raise ValueError, at BMH_INFLIGHT 1
              and 4
  7. inflight the stream at BMH_INFLIGHT 1 and 4 in turns (1, 4, 4, 1), and
              once more each with BMH_PALLAS_SORT=1: golden SHA-256,
              bit-exact; wall ms, device ms and busy ms (profiler), idle
              share and peak memory of each direction, LAST_DISPATCH
  8. blocks   the stream's first 2 MiB at 1 MiB blocks, at 100000-byte
              blocks and at BMH_CURSOR_STRIDE=64: bmh_tpu's SHA-256 for each
              (torch_golden.json "cases"), bit-exact
  9. dist     two processes on the one card (gloo, block stripes): rank 0's
              container equals the single-process one, both decode it
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  `--dist-rank` runs one process of phase 9.
"""

from __future__ import annotations

import argparse
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


def capture_kernel_inputs(bt, blob: bytes) -> dict:
    """Decompress `blob` once with every kernel wrapper recording its first
    call's arguments (cloned), so the comparisons run at the shapes the
    main path gives each kernel (K4's include the hop the path chose)."""
    from bmh_tpu_torch.ops import decode_kernels, ibwt_kernel, imtf_kernel

    captured: dict = {}
    patched = [(decode_kernels, "phase_a"), (decode_kernels, "phase_b"),
               (imtf_kernel, "imtf_chunks"), (ibwt_kernel, "ibwt_walk")]
    originals = [getattr(mod, name) for mod, name in patched]

    def recorder(name, orig):
        def rec(*args):
            captured.setdefault(name, [a.clone() if torch.is_tensor(a) else a
                                       for a in args])
            return orig(*args)
        return rec

    try:
        for (mod, name), orig in zip(patched, originals):
            setattr(mod, name, recorder(name, orig))
        bt.decompress_bytes(blob, device="cuda")
    finally:
        for (mod, name), orig in zip(patched, originals):
            setattr(mod, name, orig)
    torch.cuda.synchronize()
    return captured


def capture_sort_inputs(bt, data: bytes) -> dict:
    """Compress `data` once with BMH_PALLAS_SORT on, recording (cloned) the
    first K5 call of each shape: (32, 131072) is the first doubling round,
    (1, 262144) the sparse tier-1 set."""
    from bmh_tpu_torch.ops import sort_kernel
    from bmh_tpu_torch.utils import config

    captured: dict = {}
    orig = sort_kernel.sort3

    def rec(*args):
        captured.setdefault(tuple(args[0].shape), [a.clone() for a in args])
        return orig(*args)

    config.DEFAULT.pallas_sort = True
    sort_kernel.sort3 = rec
    try:
        bt.compress_bytes(data, block_size=BLOCK, device="cuda")
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
    t64k, s64k, steps64k, hop64k = capture_kernel_inputs(bt, small)["ibwt_walk"]
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


def kernel_phase(bt, blob: bytes, head: bytes, card: str) -> list[dict]:
    from bmh_tpu_torch.ops import decode_kernels as dk
    from bmh_tpu_torch.ops import ibwt_kernel, imtf_kernel, sort_kernel

    cap = capture_kernel_inputs(bt, blob)
    sorts = capture_sort_inputs(bt, head)
    require((32, BLOCK) in sorts, f"no (32, {BLOCK}) K5 call captured: "
                                  f"{sorted(sorts)}")
    k5 = sorts[(32, BLOCK)]
    sort_side_shapes(sorts, card)
    walk_modes(bt, head, cap, card)
    hostile_kernel_inputs(card, tuple(cap["imtf_chunks"][0].shape))
    wext, count_t, chunk_bits, maxl = cap["phase_a"]
    wext_b, count_b, entry, cb_b, maxl_b = cap["phase_b"]
    (codes_tm,) = cap["imtf_chunks"]
    table, starts, steps, hop = cap["ibwt_walk"]
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
        chain=fsm_steps, chain_unit="bits of a chunk (one thread walks them)"))
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
        fill=lambda: torch.full((fsm_steps, nc), -1, dtype=torch.int32, device="cuda")))
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
        chain=k3_dense, chain_unit="non-zero codes of the densest lane"))
    print(f"[kernels] operations counted for the bounds, least work / as the "
          f"earlier kernels worked: phase_a {k1_ops} / {12 * k1_steps} "
          f"({k1_ops / PEAK_OPS_PER_S * 1e3:.4f} / "
          f"{12 * k1_steps / PEAK_OPS_PER_S * 1e3:.4f} ms), imtf_chunks {k3_ops} / "
          f"{k3_ops + k3_shift} ({k3_ops / PEAK_OPS_PER_S * 1e3:.4f} / "
          f"{(k3_ops + k3_shift) / PEAK_OPS_PER_S * 1e3:.4f} ms); "
          f"{k3_steps} of imtf_chunks' {m * k} codes are non-zero, "
          f"{k3_dense} of {m} in the densest lane, "
          f"{int(k3_lane_steps.median())} in the median lane", flush=True)
    b, kc = starts.shape
    cases.append(dict(
        name="ibwt_walk", source="bmh_tpu_torch/csrc/ibwt_walk.cu",
        replaces="bmh_tpu/ops/pallas_ibwt.py:68",
        kernel=lambda: ibwt_kernel.ibwt_walk(table, starts, steps, hop),
        plain=lambda: ibwt_kernel.ibwt_walk_plain(table, starts, steps, 1),
        bytes=nbytes(table, starts) + b * kc * steps, ops=3 * b * kc * steps,
        reps=20))
    k5_bytes, k5_ops = sort_bound(k5[0])
    cases.append(dict(
        name="sort3", source="bmh_tpu_torch/csrc/sort3.cu",
        replaces="bmh_tpu/ops/pallas_sort.py:149",
        kernel=lambda: sort_kernel.sort3(*k5),
        plain=lambda: sort_kernel.sort3_plain(*k5),
        library=lambda: sort_library(*k5),
        bytes=k5_bytes, ops=k5_ops, reps=10, shapes=[list(t.shape) for t in k5]))

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
            "library_ms": library_ms,
            "shapes": c.get("shapes") or [
                list(t.shape) for t in cap[c["name"].replace("gap_decode_", "")]
                if torch.is_tensor(t)],
        })
        print(f"[kernels] {c['name']}: equal={equal} ms={ms:.4f} "
              f"plain_ms={plain_ms:.2f} library_ms={library_ms}", flush=True)
        if "chain" in c:
            print(f"[kernels] {c['name']}: a thread's dependent chain is "
                  f"{c['chain']:.0f} {c['chain_unit']}, ms over them "
                  f"{ms * 1e6 / c['chain']:.1f} ns", flush=True)
        if "fill" in c:  # the least any kernel writing this output takes here
            print(f"[kernels] {c['name']}: a fill of its output's bytes "
                  f"(torch.full) ms={cuda_ms(c['fill'], c['reps']):.4f}", flush=True)
        require(equal, f"{c['name']} disagrees with its plain version "
                       f"(max abs err {err})")
    return rows


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
        cap = capture_kernel_inputs(bt, blob)
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
    """fn() under torch.profiler: wall ms, device ms (the card's kernels,
    copies and fills summed over every stream), busy ms (the union of
    their intervals: work on several streams may overlap), idle share
    1 - busy / wall, and the five names of most device time."""
    from bmh_tpu_torch.utils import tracing

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    spans = tracing.device_activity(prof)
    require(bool(spans), "the profiler saw no work on the card")
    busy = tracing.busy_ms(spans)
    require(busy <= wall, f"the card was busy {busy:.3f} ms in a {wall:.3f} ms "
                          "call: annotated ranges were counted as work")
    by_name: dict = {}
    for name, a, b in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"prof_wall_ms": wall, "device_ms": sum(by_name.values()),
            "busy_ms": busy, "idle_share": 1 - busy / wall,
            "top": [[k[:60], v] for k, v in top]}


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

    # 3. kernels, at the shapes of one real 32-block batch
    head = bt.compress_bytes(data[: 32 * BLOCK], block_size=BLOCK, device="cuda")
    kernels = kernel_phase(bt, head, data[: 32 * BLOCK], card)

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
    inflight_phase(bt, data, golden if check_golden else None, card)
    blocks_phase(bt, data, golden if check_golden else None, card)
    dist_phase(bt, data, card)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
