"""Round-trip benchmark of the port; prints ONE JSON line.

    python -m bmh_tpu_torch.bench [block_size]     # the Calgary corpus
    python -m bmh_tpu_torch.bench --synthetic MB   # a seeded stream of MB MiB

Metric: round-trip throughput (compress + decompress, bit-exact checked)
in MB/s of input, host clock, on the card.  A warm pass comes first, then
five timed passes; `value` is the median pass and `passes_s` lists every
(wall, compress, decompress) in run order.  `vs_baseline` divides by the
reference C++ codec's rate on the corpus on one CPU core (0.568 MB/s, its
14 files each way in 11.06 s).

Beside the rates the record carries what a reader needs to compare two
records: the card's name and power limit (nvidia-smi), BMH_INFLIGHT, the
card's device ms, busy ms and idle share over one more pass under the
profiler (kept out of the timed five: the profiler lengthens wall time),
and a calibration of the pipeline's own primitives on the card: a null
launch and synchronize, the pinned host->device upload (pipeline._put) and
the device->host copy (programs.HostCopy).  The corpus is found through
BMH_CORPUS_DIR; without it `run` returns a "corpus not found" record.
On device="cpu" (the tests') the card's fields are None: not measured.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REFERENCE_ROUNDTRIP_MBPS = 2 * 3141622 / 11.06 / 1e6  # 0.568
REFERENCE_TOTAL_OUT = 1006498  # the reference codec's summed corpus sizes


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def calibrate_device(device, size_mb: float = 4.0, reps: int = 8) -> dict:
    """The pipeline's primitives on the card: a null launch plus
    synchronize (median ms), and the host->device upload and device->host
    copy of size_mb MiB (median of 3, less the null launch)."""
    from .models.pipeline import _put
    from .models.programs import HostCopy

    dev = torch.device(device)
    n = int(size_mb * (1 << 20))
    tiny = torch.zeros(8, dtype=torch.int32, device=dev)
    nulls = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        tiny.add_(1)
        torch.cuda.synchronize(dev)
        nulls.append(time.perf_counter() - t0)
    null_s = statistics.median(nulls[1:])
    host = np.zeros(n, dtype=np.uint8)
    ups = []
    for _ in range(4):
        t0 = time.perf_counter()
        _put(host, dev)
        torch.cuda.synchronize(dev)
        ups.append(time.perf_counter() - t0)
    bufs = [torch.full((n,), i, dtype=torch.uint8, device=dev) for i in range(4)]
    torch.cuda.synchronize(dev)
    pulls = []
    for buf in bufs:
        t0 = time.perf_counter()
        HostCopy(buf).wait()
        pulls.append(time.perf_counter() - t0)
    mb = n / 1e6
    return {"null_launch_ms": null_s * 1e3,
            "upload_MBps": mb / max(statistics.median(ups[1:]) - null_s, 1e-9),
            "pull_MBps": mb / max(statistics.median(pulls[1:]) - null_s, 1e-9),
            "calib_mb": size_mb}


def _card_fields(device, round_trip) -> dict:
    """The record's card fields: calibration, nvidia-smi's line, the
    device profile of one more round trip; None each off the card."""
    from .utils import config
    from .utils.tracing import device_profile

    fields = {"device": "cpu", "card": None, "inflight": config.DEFAULT.inflight,
              "null_launch_ms": None, "upload_MBps": None, "pull_MBps": None,
              "calib_mb": None, "prof_wall_ms": None, "device_ms": None,
              "busy_ms": None, "idle_share": None}
    if torch.device(device).type != "cuda":
        return fields
    prof = device_profile(round_trip)
    prof.pop("spans")
    fields.update(device=torch.cuda.get_device_name(), card=card_line(), **prof,
                  **calibrate_device(device))
    return fields


def _timed(compress, decompress, expect) -> dict:
    """A warm pass, then five timed passes of compress -> decompress."""
    blobs = compress()
    ok = decompress(blobs) == expect
    passes = []
    for _ in range(5):
        t0 = time.perf_counter()
        blobs = compress()
        t1 = time.perf_counter()
        backs = decompress(blobs)
        t2 = time.perf_counter()
        ok = ok and backs == expect
        passes.append((t2 - t0, t1 - t0, t2 - t1))
    wall, t_comp, t_dec = sorted(passes)[len(passes) // 2]
    return {"ok": ok, "blobs": blobs, "wall": wall, "best_wall": min(passes)[0],
            "compress_s": t_comp, "decompress_s": t_dec,
            "passes_s": [list(p) for p in passes]}


def run(block_size: int = 131072, backend: str = "torch", files=None,
        device="cuda") -> dict:
    """The Calgary corpus (or `files` of it), every file in one batched
    compress_many / decompress_many call a pass, uniform buckets."""
    from . import api
    from .utils import corpus

    if backend == "torch":
        api._resolve_devices(device)
    d = corpus.corpus_dir()
    if d is None:
        return {"metric": "calgary_roundtrip_throughput", "value": 0.0,
                "unit": "MB/s", "vs_baseline": 0.0, "error": "corpus not found"}
    names = files or corpus.CALGARY_FILES
    datas = [corpus.read_corpus_file(n) for n in names]
    total_in = sum(len(x) for x in datas)

    def compress():
        return api.compress_many(datas, block_size=block_size, backend=backend,
                                 uniform=True, device=device)

    def decompress(blobs):
        return api.decompress_many(blobs, backend=backend, uniform=True, device=device)

    t = _timed(compress, decompress, datas)
    total_out = sum(len(b) for b in t["blobs"])
    mbps = 2 * total_in / t["wall"] / 1e6
    return {
        "metric": "calgary_roundtrip_throughput",
        "value": mbps,
        "unit": "MB/s",
        "vs_baseline": mbps / REFERENCE_ROUNDTRIP_MBPS,
        "bit_exact": t["ok"],
        "median_MBps": mbps,
        "best_MBps": 2 * total_in / t["best_wall"] / 1e6,
        "compress_s": t["compress_s"],
        "decompress_s": t["decompress_s"],
        "compressed_bytes": total_out,
        "ratio": total_out / total_in,
        "ratio_vs_reference": total_out / REFERENCE_TOTAL_OUT,
        "block_size": block_size,
        "backend": backend,
        "passes_s": t["passes_s"],
        **_card_fields(device, lambda: decompress(compress())),
    }


def _enwik_like_stream(n: int, rng) -> bytes:
    """Random slices of Calgary book1 spliced at random offsets, aperiodic
    at every scale; without the corpus, a skewed 64-symbol alphabet with 5%
    spaces."""
    from .utils import corpus

    book1 = corpus.read_corpus_file("book1")
    if book1 is None:
        probs = np.exp(-0.25 * np.arange(64))
        probs /= probs.sum()
        sym = rng.choice(64, n, p=probs).astype(np.uint8) + 32
        sym[rng.random(n) < 0.05] = 32
        return sym.tobytes()
    base = np.frombuffer(book1, dtype=np.uint8)
    parts = []
    got = 0
    while got < n:
        ln = int(rng.integers(4096, 65536))
        st = int(rng.integers(0, max(base.size - ln, 1)))
        parts.append(base[st:st + ln])
        got += parts[-1].size
    return np.concatenate(parts)[:n].tobytes()


def run_synthetic(total_mb: int = 64, block_size: int = 131072,
                  backend: str = "torch", device="cuda") -> dict:
    """A total_mb MiB stream (seed 42, `_enwik_like_stream`) through
    compress_bytes / decompress_bytes."""
    from . import api

    if backend == "torch":
        api._resolve_devices(device)
    n = total_mb << 20
    data = _enwik_like_stream(n, np.random.default_rng(42))

    def compress():
        return api.compress_bytes(data, block_size=block_size, backend=backend,
                                  device=device)

    def decompress(blob):
        return api.decompress_bytes(blob, backend=backend, device=device)

    t = _timed(compress, decompress, data)
    mbps = 2 * n / t["wall"] / 1e6
    return {
        "metric": "synthetic_roundtrip_throughput",
        "value": mbps,
        "unit": "MB/s",
        "vs_baseline": mbps / REFERENCE_ROUNDTRIP_MBPS,
        "bit_exact": t["ok"],
        "median_MBps": mbps,
        "best_MBps": 2 * n / t["best_wall"] / 1e6,
        "compress_s": t["compress_s"],
        "decompress_s": t["decompress_s"],
        "stream_mb": total_mb,
        "ratio": len(t["blobs"]) / n,
        "block_size": block_size,
        "backend": backend,
        "passes_s": t["passes_s"],
        **_card_fields(device, lambda: decompress(compress())),
    }


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if args and args[0] == "--synthetic":
        print(json.dumps(run_synthetic(total_mb=int(args[1]) if len(args) > 1 else 64)))
    else:
        print(json.dumps(run(block_size=int(args[0]) if args else 131072)))


if __name__ == "__main__":
    main()
