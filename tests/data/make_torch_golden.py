"""Record bmh_tpu's container digest for chip_smoke.py's input stream.

    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py [--seed 0]

Compresses bmh_tpu_torch.utils.synth.smoke_input(seed) with bmh_tpu (the reference
package, on the CPU) at 128 KiB blocks and writes the input's and the
container's SHA-256 and sizes to tests/data/torch_golden.json, which
chip_smoke.py holds the port's container to on the GPU.
"""

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import bmh_tpu  # noqa: E402
from bmh_tpu_torch.utils.synth import smoke_input  # noqa: E402


BLOCK = 1 << 17


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    data = smoke_input(args.seed)
    blob = bmh_tpu.compress_bytes(data, block_size=BLOCK)
    assert bmh_tpu.decompress_bytes(blob) == data
    rec = {
        "seed": args.seed,
        "input_bytes": len(data),
        "input_sha256": hashlib.sha256(data).hexdigest(),
        "block_size": BLOCK,
        "container_bytes": len(blob),
        "container_sha256": hashlib.sha256(blob).hexdigest(),
        "made_by": "tests/data/make_torch_golden.py (bmh_tpu on the CPU)",
    }
    out = Path(__file__).resolve().parent / "torch_golden.json"
    out.write_text(json.dumps(rec, indent=1) + "\n")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
