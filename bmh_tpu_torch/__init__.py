"""bmh_tpu_torch — the BWT->MTF->Huffman block codec on PyTorch and CUDA.

A port of bmh_tpu (JAX on a TPU) to an NVIDIA H100: the same `.bzt`
container byte for byte and the same API, with every Pallas kernel on the
main path rewritten by hand in CUDA C++ for sm_90a (ops/*_kernel.py,
csrc/*.cu).  Entry points run on "cuda" unless the caller passes
device="cpu", which runs the kernels' plain PyTorch versions.
"""

from .api import (
    DEFAULT_BLOCK_SIZE,
    compress_bytes,
    compress_file,
    compress_many,
    decompress_bytes,
    decompress_file,
    decompress_many,
    full_pipeline,
    get_backend,
)

__version__ = "0.5.0"

__all__ = [
    "compress_bytes",
    "decompress_bytes",
    "compress_many",
    "decompress_many",
    "compress_file",
    "decompress_file",
    "full_pipeline",
    "get_backend",
    "DEFAULT_BLOCK_SIZE",
    "__version__",
]
