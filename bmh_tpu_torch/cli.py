"""Command line of the port, with bmh_tpu/cli.py's verbs and output lines:

    python -m bmh_tpu_torch compress   <in> <out> [--block-size N] [--resumable]
    python -m bmh_tpu_torch decompress <in> <out>
    python -m bmh_tpu_torch bench      [--corpus DIR] [--files a,b] [--block-size N]
    python -m bmh_tpu_torch verify     <a> <b>
    python -m bmh_tpu_torch info       <in.bzt>

Every codec verb takes --backend torch|oracle (default torch) and --device
(default cuda: the hand-written kernels; cpu runs their plain versions; the
oracle takes no device).  `bench` round-trips the Calgary corpus (found
through --corpus or BMH_CORPUS_DIR) with a bit-exact check and `$$`
metrics per file, then one JSON line.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import api
from .utils import container, nativeio
from .utils import corpus as corpus_mod
from .utils.metrics import json_line, metrics_line, timer
from .utils.tracing import StageTimer


def cmd_compress(args) -> int:
    with timer() as tbox:
        if args.resumable:
            from .utils.stream import compress_file_resumable

            info = compress_file_resumable(args.input, args.output,
                                           block_size=args.block_size,
                                           backend=args.backend, device=args.device)
            info["initial_data_size"] = os.path.getsize(args.input)
        else:
            info = api.compress_file(args.input, args.output,
                                     block_size=args.block_size,
                                     backend=args.backend, device=args.device)
    print(metrics_line(args.output, info["initial_data_size"], info["encoded_file_size"],
                       header_size=info.get("header_size"), seconds=tbox["seconds"]))
    return 0


def cmd_decompress(args) -> int:
    t0 = time.perf_counter()
    info = api.decompress_file(args.input, args.output, backend=args.backend,
                               device=args.device)
    dt = time.perf_counter() - t0
    print(metrics_line(args.output, info["decoded_size"], info["encoded_file_size"],
                       seconds=dt))
    return 0


def cmd_bench(args) -> int:
    d = args.corpus or (str(corpus_mod.corpus_dir()) if corpus_mod.corpus_dir() else None)
    if d is None:
        print("no corpus found; set --corpus or BMH_CORPUS_DIR", file=sys.stderr)
        return 1
    files = args.files.split(",") if args.files else corpus_mod.CALGARY_FILES
    total_in = total_out = 0
    t_start = time.perf_counter()
    failures = 0
    stages = StageTimer()
    for i, name in enumerate(files, 1):
        with open(os.path.join(d, name), "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        with stages.stage("compress"):
            blob = api.compress_bytes(data, block_size=args.block_size,
                                      backend=args.backend, device=args.device)
        t1 = time.perf_counter()
        with stages.stage("decompress"):
            back = api.decompress_bytes(blob, backend=args.backend, device=args.device)
        t2 = time.perf_counter()
        ok = back == data
        failures += 0 if ok else 1
        total_in += len(data)
        total_out += len(blob)
        print(f"{i}/{len(files)} "
              + metrics_line(name, len(data), len(blob),
                             header_size=container.header_bytes(blob), seconds=t1 - t0)
              + f" $$ decode_s: {t2 - t1:.3f} $$ " + ("success" if ok else "fail"))
    wall = time.perf_counter() - t_start
    rate = total_out / total_in if total_in else 0.0
    print(f"TOTAL $$ in: {total_in} $$ out: {total_out} $$ rate: {rate:.4f} "
          f"$$ wall_s: {wall:.2f} $$ roundtrip_MB_per_s: {2 * total_in / wall / 1e6:.3f}")
    print(stages.report())
    print(json_line(files=len(files), bytes_in=total_in, bytes_out=total_out,
                    rate=round(rate, 4), wall_s=round(wall, 3),
                    failures=failures))
    return 1 if failures else 0


def cmd_verify(args) -> int:
    """Bit-exact file compare."""
    equal = nativeio.compare_files(args.a, args.b)
    if equal is None:  # no native library: compare in Python
        with open(args.a, "rb") as f1, open(args.b, "rb") as f2:
            equal = f1.read() == f2.read()
    print("success" if equal else "fail")
    return 0 if equal else 1


def cmd_info(args) -> int:
    with open(args.input, "rb") as f:
        buf = f.read()
    block_size, total_size, raw_blocks = container.unpack_file(buf)
    print(f"block_size: {block_size} $$ n_blocks: {len(raw_blocks)} "
          f"$$ total_size: {total_size} $$ file_bytes: {len(buf)}")
    for i, raw in enumerate(raw_blocks):
        orig_len, shift, lens, present, cps, rle_len, payload, _pre = container.unpack_block(raw)
        ncp = "periodic" if cps is None else len(cps)
        print(f"block {i}: orig_len {orig_len} $$ shift {shift} "
              f"$$ symbols {int(np.count_nonzero(present))} "
              f"$$ max_code_len {int(lens.max())} $$ rle_len {rle_len} $$ checkpoints {ncp} "
              f"$$ payload {len(payload)} B")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bmh_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--backend", default="torch", choices=["torch", "oracle"])
        sp.add_argument("--device", default="cuda",
                        help="cuda (every visible card), cuda:N or cpu")

    c = sub.add_parser("compress", help="compress a file to .bzt")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--block-size", type=int, default=container.DEFAULT_BLOCK_SIZE)
    c.add_argument("--resumable", action="store_true",
                   help="streaming layout with per-block checkpoints; "
                        "re-running resumes a crashed compression")
    common(c)
    c.set_defaults(fn=cmd_compress)

    dc = sub.add_parser("decompress", help="decompress a .bzt file")
    dc.add_argument("input")
    dc.add_argument("output")
    common(dc)
    dc.set_defaults(fn=cmd_decompress)

    b = sub.add_parser("bench", help="Calgary benchmark: round-trip + verify")
    b.add_argument("--corpus", default=None)
    b.add_argument("--files", default=None, help="comma-separated subset")
    b.add_argument("--block-size", type=int, default=container.DEFAULT_BLOCK_SIZE)
    common(b)
    b.set_defaults(fn=cmd_bench)

    v = sub.add_parser("verify", help="bit-exact comparison of two files")
    v.add_argument("a")
    v.add_argument("b")
    v.set_defaults(fn=cmd_verify)

    inf = sub.add_parser("info", help="dump .bzt container metadata")
    inf.add_argument("input")
    inf.set_defaults(fn=cmd_info)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
