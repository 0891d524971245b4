"""Record bmh_tpu's container digests for the card tests' input streams.

    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py [--seed 0]
        [--cases main,blocks_1mib,blocks_100000,stride_64,blocks_2mib,
                 records_1mib,small_files_64,zero_pages_4mib]

Compresses bmh_tpu_torch.utils.synth.smoke_input(seed) (and the other
seeded workloads of utils/synth.py) with bmh_tpu (the reference package,
on the CPU) and writes the input's and the containers' SHA-256 and sizes
to tests/data/torch_golden.json, which
tests/test_torch_gpu.py::test_card_containers_equal_bmh_tpus_golden holds
the port's containers to on the GPU:

  main           the whole stream at 128 KiB blocks (top-level keys);
  blocks_1mib    its first 2 MiB at 1 MiB blocks;
  blocks_100000  its first 2 MiB at 100000-byte blocks (no power of two);
  stride_64      its first 2 MiB at 128 KiB blocks, BMH_CURSOR_STRIDE=64;
  blocks_2mib    the whole stream at 2 MiB blocks, bmh_tpu's largest
                 (MAX_BLOCK_SIZE), run with BMH_MAX_DISPATCH=1 so that
                 bmh_tpu holds one block at a time (the container does not
                 depend on the dispatch size);
  records_1mib   the first MiB of synth.record_stream (a 1024-byte record
                 repeated: periodic blocks) at 128 KiB blocks;
  small_files_64 the first 64 files of synth.small_files through
                 compress_many(uniform=True) at 128 KiB, BMH_MAX_DISPATCH=8:
                 the digest and size of the 64 containers back to back;
  zero_pages_4mib the first 4 MiB of synth.zero_pages at 1 MiB blocks,
                 BMH_MAX_DISPATCH=1.

Each case runs in a process of its own, because bmh_tpu reads the cursor
stride when it is imported; --cases picks the ones to redo, and the file
keeps the others.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = Path(__file__).resolve().parent / "torch_golden.json"
BLOCK = 1 << 17
HEAD = 2 << 20
# case -> (input bytes, or None for the whole stream; block size; stride;
# further environment of the case's process; the synth generator)
CASES = {
    "main": (None, BLOCK, 4096, {}, "smoke_input"),
    "blocks_1mib": (HEAD, 1 << 20, 4096, {}, "smoke_input"),
    "blocks_100000": (HEAD, 100000, 4096, {}, "smoke_input"),
    "stride_64": (HEAD, BLOCK, 64, {}, "smoke_input"),
    "blocks_2mib": (None, 1 << 21, 4096, {"BMH_MAX_DISPATCH": "1"}, "smoke_input"),
    "records_1mib": (1 << 20, BLOCK, 4096, {}, "record_stream"),
    "small_files_64": (64, BLOCK, 4096, {"BMH_MAX_DISPATCH": "8"}, "small_files"),
    "zero_pages_4mib": (4 << 20, 1 << 20, 4096, {"BMH_MAX_DISPATCH": "1"},
                        "zero_pages"),
}


def run_case(name: str, seed: int) -> dict:
    """Compress one case with bmh_tpu in this process and return its record."""
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import bmh_tpu
    from bmh_tpu import api
    from bmh_tpu_torch.utils import synth

    size, block, stride, _, source = CASES[name]
    if source == "small_files":  # `size` files, their containers back to back
        files = synth.small_files(seed)[:size]
        blobs = api.compress_many(files, block_size=block, uniform=True)
        assert [bmh_tpu.decompress_bytes(b) for b in blobs] == files
        data, blob = b"".join(files), b"".join(blobs)
    else:
        data = getattr(synth, source)(seed)[:size]
        blob = bmh_tpu.compress_bytes(data, block_size=block)
        assert bmh_tpu.decompress_bytes(blob) == data
    return {
        "source": source,
        "input_bytes": len(data),
        "input_sha256": hashlib.sha256(data).hexdigest(),
        "block_size": block,
        "cursor_stride": stride,
        "container_bytes": len(blob),
        "container_sha256": hashlib.sha256(blob).hexdigest(),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--one", help=argparse.SUPPRESS)  # a child's single case
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_case(args.one, args.seed)))
        return
    rec = json.loads(OUT.read_text()) if OUT.exists() else {}
    if rec.get("seed", args.seed) != args.seed:
        rec = {}
    for name in args.cases.split(","):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   BMH_CURSOR_STRIDE=str(CASES[name][2]), **CASES[name][3])
        out = subprocess.run([sys.executable, __file__, "--seed", str(args.seed),
                              "--one", name], env=env, check=True,
                             capture_output=True, text=True).stdout
        case = json.loads(out.strip().splitlines()[-1])
        if name == "main":
            case.pop("cursor_stride")
            case.pop("source")
            rec.update(case)
        else:
            rec.setdefault("cases", {})[name] = case
        print(name, json.dumps(case), flush=True)
    rec["seed"] = args.seed
    rec["made_by"] = "tests/data/make_torch_golden.py (bmh_tpu on the CPU)"
    OUT.write_text(json.dumps(rec, indent=1) + "\n")


if __name__ == "__main__":
    main()
