#!/usr/bin/env python3
"""Drive bmh_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each of which raises (non-zero exit) on any mismatch:
  1. card     no CUDA device -> exit 2 before any result is printed
  2. build    nvcc every kernel source in parallel; print -Xptxas -v
  3. kernels  capture each kernel's inputs from a real 32-block, 128 KiB
              decode batch; kernel vs plain PyTorch version, exact
  4. round    seeded 8 MiB text-like + 1 MiB random stream, compress and
     trip     decompress at 128 KiB on the card: bit-exact, container
              SHA-256 equal to bmh_tpu's (tests/data/torch_golden.json),
              every kernel launched by the main path; MB/s and peak memory
  5. hostile  a CRC-valid container with a lying rle_len raises ValueError
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
BLOCK = 1 << 17
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): device memory
# bandwidth, and the non-tensor-core 32-bit rate used for integer work
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` warm calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
    main path gives each kernel."""
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


def kernel_phase(bt, blob: bytes) -> list[dict]:
    from bmh_tpu_torch.ops import decode_kernels as dk
    from bmh_tpu_torch.ops import ibwt_kernel, imtf_kernel

    cap = capture_kernel_inputs(bt, blob)
    wext, count_t, chunk_bits, maxl = cap["phase_a"]
    wext_b, count_b, entry, cb_b, maxl_b = cap["phase_b"]
    (codes_tm,) = cap["imtf_chunks"]
    table, starts, steps = cap["ibwt_walk"]
    nc = wext.shape[1]
    fsm_steps = chunk_bits + 32

    cases = []
    # K1: ops counted from this run's exits (a lane stops at its exit gap)
    cnt, ex = dk.phase_a(wext, count_t, chunk_bits, maxl)
    gaps = torch.arange(32, device=wext.device)[:, None]
    k1_steps = int((chunk_bits + ex.to(torch.int64) - gaps).clamp(min=0).sum())
    cases.append(dict(
        name="gap_decode_phase_a", source="bmh_tpu_torch/csrc/gap_decode.cu",
        replaces="bmh_tpu/ops/pallas_decode.py:179",
        kernel=lambda: dk.phase_a(wext, count_t, chunk_bits, maxl),
        plain=lambda: dk.phase_a_plain(wext, count_t, chunk_bits, maxl),
        bytes=nbytes(wext, count_t) + 2 * 4 * 32 * nc, ops=12 * k1_steps, reps=20))
    cases.append(dict(
        name="gap_decode_phase_b", source="bmh_tpu_torch/csrc/gap_decode.cu",
        replaces="bmh_tpu/ops/pallas_decode.py:207",
        kernel=lambda: dk.phase_b(wext_b, count_b, entry, cb_b, maxl_b),
        plain=lambda: dk.phase_b_plain(wext_b, count_b, entry, cb_b, maxl_b),
        bytes=nbytes(wext_b, count_b, entry) + 4 * fsm_steps * nc,
        ops=14 * fsm_steps * nc, reps=20))
    m, k = codes_tm.shape
    k3_ops = int((codes_tm.to(torch.int64) & 255).sum()) + 4 * m * k
    cases.append(dict(
        name="imtf_chunks", source="bmh_tpu_torch/csrc/imtf.cu",
        replaces="bmh_tpu/ops/pallas_mtf.py:53",
        kernel=lambda: imtf_kernel.imtf_chunks(codes_tm),
        plain=lambda: imtf_kernel.imtf_chunks_plain(codes_tm),
        bytes=2 * nbytes(codes_tm) + 4 * 256 * k, ops=k3_ops, reps=20))
    b, kc = starts.shape
    cases.append(dict(
        name="ibwt_walk", source="bmh_tpu_torch/csrc/ibwt_walk.cu",
        replaces="bmh_tpu/ops/pallas_ibwt.py:68",
        kernel=lambda: ibwt_kernel.ibwt_walk(table, starts, steps),
        plain=lambda: ibwt_kernel.ibwt_walk_plain(table, starts, steps),
        bytes=nbytes(table, starts) + b * kc * steps, ops=3 * b * kc * steps,
        reps=20))

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
        t_bytes = c["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = c["ops"] / PEAK_OPS_PER_S * 1e3
        rows.append({
            "name": c["name"], "route": "cuda", "source": c["source"],
            "replaces": c["replaces"], "equal": equal, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "shapes": [list(t.shape) for t in cap[c["name"].replace(
                "gap_decode_", "")] if torch.is_tensor(t)],
        })
        print(f"[kernels] {c['name']}: equal={equal} ms={ms:.4f} "
              f"plain_ms={plain_ms:.2f}", flush=True)
        require(equal, f"{c['name']} disagrees with its plain version "
                       f"(max abs err {err})")
    return rows


def mutate_rle_len(blob: bytes, delta: int) -> bytes:
    """Re-pack block 0 with rle_len + delta and a fresh CRC."""
    from bmh_tpu_torch.utils import container as C

    bs, total, raws = C.unpack_file(blob)
    (orig_len, shift, lens, present, cps, rle_len, payload,
     pre_len) = C.unpack_block(raws[0])
    raws[0] = C.pack_block(orig_len, shift, lens, present, payload, cps=cps,
                           rle_len=rle_len + delta, pre_len=pre_len)
    return C.pack_file(raws, bs, total, stride=C.file_stride(blob))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # 1. card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
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

    # 3. kernels, at the shapes of one real 32-block decode batch
    head = bt.compress_bytes(data[: 32 * BLOCK], block_size=BLOCK, device="cuda")
    kernels = kernel_phase(bt, head)

    # 4. round trip: counts set to 0 just before the main path, read after
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    blob = bt.compress_bytes(data, block_size=BLOCK, device="cuda")
    out = bt.decompress_bytes(blob, device="cuda")
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(out == data, "round trip is not bit-exact")
    blob_sha = hashlib.sha256(blob).hexdigest()
    print(f"[roundtrip] {len(data)} -> {len(blob)} bytes, sha256 {blob_sha}, "
          f"launches {launches}", flush=True)
    if check_golden:
        require(blob_sha == golden["container_sha256"]
                and len(blob) == golden["container_bytes"],
                "container differs from bmh_tpu's recorded one")
    require(all(v > 0 for v in launches.values()),
            f"a kernel was not launched on the main path: {launches}")
    for row in kernels:
        row["launches"] = launches[row["name"]]

    c_times, d_times = [], []
    for _ in range(3):
        t = time.perf_counter()
        bt.compress_bytes(data, block_size=BLOCK, device="cuda")
        c_times.append(time.perf_counter() - t)
        t = time.perf_counter()
        bt.decompress_bytes(blob, device="cuda")
        d_times.append(time.perf_counter() - t)
    mb = len(data) / 1e6
    print(f"[roundtrip] {card}: compressed {len(blob)} B "
          f"(ratio {len(blob) / len(data):.4f}), compress "
          f"{mb / statistics.median(c_times):.3f} MB/s, decompress "
          f"{mb / statistics.median(d_times):.3f} MB/s (median of 3 warm), "
          f"max_memory_allocated {peak} B; runs c={c_times} d={d_times}",
          flush=True)

    # 5. hostile: a lying rle_len must fail closed on the card
    small = bt.compress_bytes(data[:12000], block_size=16384, device="cuda")
    bad = mutate_rle_len(small, -3)
    try:
        bt.decompress_bytes(bad, device="cuda")
    except ValueError as e:
        print(f"[hostile] lying rle_len rejected: {e}", flush=True)
    else:
        raise SystemExit("chip_smoke FAILED: lying rle_len container decoded")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
