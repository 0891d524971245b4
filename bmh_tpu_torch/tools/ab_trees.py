"""Paired end-to-end rates of checkouts of the port on one card.

    python bmh_tpu_torch/tools/ab_trees.py --arm parent=DIR --arm change=. \\
        [--arm parts=.:sync_copies,mask_compact] [--turns 10] [--out FILE]

An arm is a checkout of the repository (the directory that holds its
`bmh_tpu_torch/` and `csrc/bmh_io.cpp`, the host library's source: a turn
without that library fails), optionally with swaps.  A turn is one fresh
process that imports that checkout's package, makes the seeded 9 MiB
stream with its `utils/synth.smoke_input`, and times `compress_bytes` and
`decompress_bytes` at 128 KiB blocks with default knobs, with
BMH_PALLAS_SORT=1 and with BMH_LF2=0: one warm round trip, then MB/s of
input as the median of 3 (host clock; both calls end on host bytes).  Each
checkout builds its kernels once, before the turns.  Turns go round the
arms in order, then in reverse order (A B B A for two arms), `--turns`
times for each arm.  Every turn must round-trip bit-exactly, and every
arm must write the same container.

Printed, for each arm, row and direction: the median, quartiles and range
of the per-turn rates, and the median over rounds of the rate over the
first arm's rate in the same round; then the card's name and power limit.

Swaps put back one part of the dispatch layer's default path the way the
port ran before it (for checkouts that have the layer):
  serial        BMH_INFLIGHT=1, one batch at a time
  sync_copies   uploads and the final device->host copy by plain .to() and
                .cpu(), without pinned memory
  mask_compact  decoded rows compacted by a boolean mask (waits for the card)
  no_annotate   no annotate() ranges around dispatches
  inline        each dispatch called as it is, without making its card
                current around it
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROWS = (("default", False, True), ("pallas_sort", True, True),
        ("lf2_off", False, False))
BLOCK = 1 << 17
SWAPS = ("serial", "sync_copies", "mask_compact", "no_annotate", "inline")


def _import_tree(root: str):
    sys.path.insert(0, str(Path(root).resolve()))
    import bmh_tpu_torch as bt

    pkg = Path(bt.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise SystemExit(f"ab_trees: imported {pkg}, not the package of {root}")
    return bt


def _apply_swaps(swaps: list[str]) -> None:
    import contextlib

    import numpy as np
    import torch
    from bmh_tpu_torch.models import pipeline
    from bmh_tpu_torch.utils import config

    for swap in swaps:
        if swap == "serial":
            config.DEFAULT.inflight = 1
        elif swap == "sync_copies":
            class SyncCopy:
                def __init__(self, t):
                    self.host = t.cpu()

                def wait(self):
                    return self.host.numpy()

            pipeline._put = lambda x, device: torch.from_numpy(
                np.ascontiguousarray(x)).to(device)
            pipeline._HostCopy = SyncCopy
        elif swap == "mask_compact":
            def compact(data, totals, ns):
                n = torch.from_numpy(ns).to(data.device)
                pos = torch.arange(data.shape[1], device=data.device)[None, :]
                return torch.cat([data[pos < n[:, None]],
                                  totals.contiguous().view(torch.uint8)])

            pipeline._compact_rows = compact
        elif swap == "no_annotate":
            pipeline.annotate = lambda name: contextlib.nullcontext()
        elif swap == "inline":
            pipeline._dispatch_on = lambda device, label, fn: fn(device)
        else:
            raise SystemExit(f"ab_trees: unknown swap {swap!r}")


def turn(root: str, swaps: list[str], seed: int) -> dict:
    """One turn in this process: the rates of every row, as a dict."""
    import hashlib

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_trees: no CUDA device")
    bt = _import_tree(root)
    from bmh_tpu_torch.utils import config, nativeio
    from bmh_tpu_torch.utils.synth import smoke_input

    if nativeio._load() is None:
        # the pure-Python RLE1 and zlib's CRC would time another host path
        raise SystemExit(f"ab_trees: {root} has no host library (csrc/bmh_io.cpp)")

    _apply_swaps(swaps)
    data = smoke_input(seed)
    mb = len(data) / 1e6
    out = {"rows": {}}
    for label, sort3, lf2 in ROWS:
        config.DEFAULT.pallas_sort = sort3
        config.DEFAULT.lf2 = lf2
        blob = bt.compress_bytes(data, block_size=BLOCK, device="cuda")
        if bt.decompress_bytes(blob, device="cuda") != data:
            raise SystemExit(f"ab_trees: {root} {label}: round trip not bit-exact")
        c, d = [], []
        for _ in range(3):
            t = time.perf_counter()
            bt.compress_bytes(data, block_size=BLOCK, device="cuda")
            c.append(time.perf_counter() - t)
            t = time.perf_counter()
            bt.decompress_bytes(blob, device="cuda")
            d.append(time.perf_counter() - t)
        out["rows"][label] = {"compress": mb / statistics.median(c),
                              "decompress": mb / statistics.median(d)}
        out["sha256"] = hashlib.sha256(blob).hexdigest()
    return out


def _child(root: str, args: list[str]) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()), *args],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise SystemExit(f"ab_trees: turn in {root} failed ({r.returncode}):\n"
                         f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    return r.stdout.strip().splitlines()[-1]


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def _summary(xs: list[float]) -> dict:
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return {"median": q2, "q1": q1, "q3": q3, "min": min(xs), "max": max(xs)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arm", action="append", default=[],
                    help="NAME=DIR or NAME=DIR:swap,swap")
    ap.add_argument("--turns", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--swaps", default="", help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    a = ap.parse_args()

    if a.build:
        _import_tree(a.build)
        from bmh_tpu_torch.ops import _build
        from bmh_tpu_torch.utils import nativeio

        _build.build_all()
        nativeio._load()
        print("built")
        return
    if a.turn:
        print(json.dumps(turn(a.turn, [s for s in a.swaps.split(",") if s], a.seed)))
        return

    arms = []
    for spec in a.arm:
        name, _, rest = spec.partition("=")
        root, _, swaps = rest.partition(":")
        swaps = [s for s in swaps.split(",") if s]
        if not name or not root or any(s not in SWAPS for s in swaps):
            ap.error(f"bad --arm {spec!r}")
        arms.append((name, str(Path(root).resolve()), swaps))
    if len(arms) < 2 or a.turns < 2:
        ap.error("needs two arms or more and two turns or more")
    for root in sorted({root for _, root, _ in arms}):
        t = time.perf_counter()
        _child(root, ["--build", root])
        print(f"[ab] built {root} in {time.perf_counter() - t:.1f} s", flush=True)

    rates: dict = {name: [] for name, _, _ in arms}
    shas = set()
    for rnd in range(a.turns):
        for name, root, swaps in (arms if rnd % 2 == 0 else arms[::-1]):
            t = time.perf_counter()
            res = json.loads(_child(root, ["--turn", root, "--swaps", ",".join(swaps),
                                           "--seed", str(a.seed)]))
            shas.add(res["sha256"])
            rates[name].append(res["rows"])
            print(f"[ab] round {rnd} {name}: {json.dumps(res['rows'])} "
                  f"({time.perf_counter() - t:.1f} s)", flush=True)
    if len(shas) != 1:
        raise SystemExit(f"ab_trees: the arms wrote different containers: {shas}")

    first = arms[0][0]
    lines = []
    for name, root, swaps in arms:
        for label, _, _ in ROWS:
            for side in ("compress", "decompress"):
                xs = [r[label][side] for r in rates[name]]
                ratio = [x / r[label][side] for x, r in zip(xs, rates[first])]
                lines.append({"arm": name, "tree": root, "swaps": swaps, "row": label,
                              "direction": side, "turns": len(xs),
                              "mb_s": _summary(xs),
                              f"over_{first}_median": statistics.median(ratio),
                              "per_turn": xs})
    card = _card()
    text = "\n".join(json.dumps(line) for line in lines)
    print(text)
    print(card)
    if a.out:
        Path(a.out).write_text(text + "\n" + json.dumps({"card": card}) + "\n")


if __name__ == "__main__":
    main()
