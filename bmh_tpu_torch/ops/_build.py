"""Build and load the hand-written CUDA kernels (csrc/*.cu) with nvcc + ctypes.

Each source compiles on its own into a shared library with a plain C
interface under bmh_tpu_torch/build/, at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

The library's file name carries a hash of the source and the flags, so an
edited source never loads a stale build.  Every C entry point launches on
the stream it is given and returns cudaGetLastError(); `check` raises on a
non-zero code.

LAUNCHES counts, per kernel, the launches its wrapper made: each wrapper
adds one (`count_launch`) where it launches its kernel, and nowhere else.
A caller may launch from several threads, so the counts and the first
build of a library each take a lock, and every launch goes through
`on_device`, which makes the tensor's card current (a new thread starts on
card 0) and hands over that card's current stream.

A launch made while models/programs.py captures a CUDA graph runs no
kernel then: `recording()` diverts this thread's counts into the graph's
own tally, and every replay of the graph adds that tally to LAUNCHES
(`add_launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> source file
SOURCES = {
    "gap_decode_phase_a": "gap_decode.cu",
    "gap_decode_phase_b": "gap_decode.cu",
    "imtf_chunks": "imtf.cu",
    "ibwt_walk": "ibwt_walk.cu",
    "sort3": "sort3.cu",
    "code_lengths": "code_lengths.cu",
    "mtf_forward": "mtf_forward.cu",
    "rle1_encode": "rle1_encode.cu",
}
LAUNCHES = {name: 0 for name in SOURCES}
_libs: dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
_count_lock = threading.Lock()
_local = threading.local()


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1
        return
    with _count_lock:
        LAUNCHES[name] += 1


def add_launches(tally: dict) -> None:
    """A replayed graph's launches, as its capture recorded them."""
    with _count_lock:
        for name, k in tally.items():
            LAUNCHES[name] += k


@contextmanager
def recording():
    """Counts this thread's launches into the yielded dict instead of
    LAUNCHES (a capture: the kernels run only when the graph replays)."""
    tally: dict = {}
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _so_path(src: str) -> Path:
    h = hashlib.sha256((CSRC / src).read_bytes() + " ".join(FLAGS).encode())
    return BUILD / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def _compile(src: str) -> None:
    """Build `src`'s library unless it exists: nvcc into a temporary file,
    renamed into place once whole."""
    so = _so_path(src)
    if so.exists():
        return
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}")
    os.replace(tmp, so)


def lib(src: str) -> ctypes.CDLL:
    """The loaded library of one source, building it on first use (one
    thread builds; the others wait for it).  Two processes that both miss
    the library build it twice, each into its own temporary file, and the
    rename leaves one whole library."""
    lib_ = _libs.get(src)
    if lib_ is None:
        with _build_lock:
            if src not in _libs:
                _compile(src)
                _libs[src] = ctypes.CDLL(str(_so_path(src)))
            lib_ = _libs[src]
    return lib_


@contextmanager
def on_device(t):
    """Around one launch: t's card is the current device, and the handle of
    its current stream is yielded for the C entry point."""
    with torch.cuda.device(t.device):
        yield torch.cuda.current_stream(t.device).cuda_stream


def on_card(t, name: str) -> bool:
    """True for a CUDA tensor (the wrapper launches its kernel), False for
    a CPU tensor (it runs the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: unsupported device {t.device}")


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {code})")
