#!/usr/bin/env python3
"""Drive bmh_tpu_torch's main paths on one NVIDIA GPU and hold its kernels.

    python3 chip_smoke.py [--seed 0]

Each path runs from an empty program cache with `_build.LAUNCHES` set to 0
just before it, and the kernels it calls record the arguments of their
first call (tools/microbench.capture_kernel_inputs):
  stream          the seeded 9 MiB stream (utils/synth.smoke_input) at
                  128 KiB blocks, compressed and decompressed with default
                  knobs: bmh_tpu's SHA-256 (tests/data/torch_golden.json),
                  bit-exact, every batch a plain upload
  stream K5       the same with BMH_PALLAS_SORT=1: the same container
  puts            2048 seeded small files (synth.small_files) through
                  compress_many(uniform=True) at 128 KiB: 64 compact
                  uploads and no plain one; each file's container equals
                  compress_bytes of it
  gets            their containers through decompress_many(uniform=True):
                  bit-exact
  archive 1 MiB   32 MiB of seeded text at 1 MiB blocks, both ways: bit-exact
Then every kernel (K1-K8) is held against its plain version, exactly, on
the arguments each path gave it (microbench.hold), and each must have
launched on some path.  The line before the last is the kernels line
({"kernels": [...]}: per kernel its launches by path, the paths it was
held on and its ms at the main path's arguments); the last is
{"ok": true, "device": {...}}.  Any mismatch raises; no card exits 2.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
BLOCK = 1 << 17
ENCODE = ("sort3", "code_lengths", "mtf_forward", "rle1_encode")


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)

    sys.path.insert(0, str(ROOT))
    import bmh_tpu_torch as bt
    from bmh_tpu_torch.bench import card_line
    from bmh_tpu_torch.models import pipeline
    from bmh_tpu_torch.ops import _build
    from bmh_tpu_torch.tools import microbench
    from bmh_tpu_torch.utils import config, synth

    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    golden = json.loads((ROOT / "tests" / "data" / "torch_golden.json").read_text())
    launches, held = {}, {}

    def run(label, fn, names=tuple(microbench.KERNELS)):
        """fn() on the path `label`: its launches, its kernels' arguments."""
        up = dict(pipeline.UPLOADS)
        _build.reset_launches()
        cap, result = microbench.capture_kernel_inputs(fn, names)
        launches[label] = dict(_build.LAUNCHES)
        held[label] = cap
        uploads = {k: pipeline.UPLOADS[k] - up[k] for k in ("plain", "compact")}
        print(f"[{label}] launches {launches[label]}, uploads {uploads}", flush=True)
        return result, uploads

    def c(stream, block=BLOCK):
        return bt.compress_bytes(stream, block_size=block, device="cuda")

    def both(stream, block=BLOCK):
        blob = c(stream, block)
        return blob, bt.decompress_bytes(blob, device="cuda")

    # the main path: the 9 MiB stream, default knobs, then with K5
    data = synth.smoke_input(args.seed)
    (blob, out), uploads = run("stream", lambda: both(data))
    require(out == data, "the stream's round trip is not bit-exact")
    require(uploads["plain"] > 0 and uploads["compact"] == 0,
            f"the stream's batches did not all take the plain upload: {uploads}")
    if args.seed == golden["seed"]:
        require(hashlib.sha256(data).hexdigest() == golden["input_sha256"],
                "the stream differs from the one the golden digest was made from")
        require(hashlib.sha256(blob).hexdigest() == golden["container_sha256"]
                and len(blob) == golden["container_bytes"],
                "the stream's container differs from bmh_tpu's recorded one")
    config.DEFAULT.pallas_sort = True
    try:
        (blob_k5, out), _ = run("stream K5", lambda: both(data), ("sort3",))
    finally:
        config.DEFAULT.pallas_sort = False
    require(blob_k5 == blob and out == data, "BMH_PALLAS_SORT=1 changed the stream")

    # puts and gets: small files 32 to a batch in the 128 KiB bucket
    files = synth.small_files(args.seed)
    blobs, uploads = run("puts", lambda: bt.compress_many(
        files, block_size=BLOCK, uniform=True, device="cuda"), ENCODE)
    require(uploads == {"plain": 0, "compact": 64},
            f"2048 small files did not take 64 compact uploads: {uploads}")
    require(all(b == c(f) for f, b in zip(files, blobs)),
            "a file's container in a batch differs from compress_bytes of it")
    outs, _ = run("gets", lambda: bt.decompress_many(blobs, uniform=True, device="cuda"),
                  microbench.DECODE)
    require(outs == files, "the small files' round trip is not bit-exact")

    # the CLI's default 1 MiB block, one full batch each way
    text = synth.smoke_input(args.seed, text_bytes=32 << 20, random_bytes=0)
    (_, out), _ = run("archive 1 MiB", lambda: both(text, 1 << 20))
    require(out == text, "the 1 MiB-block round trip is not bit-exact")

    # every kernel against its plain version where each path called it
    for label, cap in held.items():
        try:
            microbench.hold(cap)
        except RuntimeError as e:
            require(False, f"{label}: {e}")
    t = microbench.Timer(reps=10, warm=3)
    rows = []
    for name, (k, module, _, _) in microbench.KERNELS.items():
        by_run = {label: n[name] for label, n in launches.items()}
        require(sum(by_run.values()) > 0, f"{k} {name} was launched on no path")
        paths = [label for label, cap in held.items() if name in cap]
        main_args = held["stream K5" if name == "sort3" else "stream"][name]
        rows.append({"name": name, "kernel": k, "route": "cuda",
                     "source": f"bmh_tpu_torch/csrc/{_build.SOURCES[name]}",
                     "wrapper": f"bmh_tpu_torch/ops/{module}.py", "equal": True,
                     "launches": sum(by_run.values()), "launches_by_run": by_run,
                     "held_on": paths,
                     "ms": t(microbench.kernel_and_plain(name, main_args)[0]),
                     "shapes": [list(a.shape) for a in main_args if torch.is_tensor(a)]})
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
