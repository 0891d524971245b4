"""ctypes bindings to the shared host library (csrc/bmh_io.cpp): RLE1, CRC32
and a file compare.

The source is shared with bmh_tpu and read only; this package compiles its
own copy into bmh_tpu_torch/build/ at first use.  Every binding keeps the
pure-Python fallback of bmh_tpu/utils/nativeio.py, so the codec works where
no C++ compiler exists — the library is a host-path accelerator.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import zlib
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "bmh_io.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "build"
_SO = _BUILD / "libbmh_io.so"
_lib: ctypes.CDLL | None = None
_tried = False


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SO.exists():
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None or not _SRC.exists():
            return None
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run([cxx, "-O3", "-std=c++17", "-fPIC", "-shared",
                            "-o", str(tmp), str(_SRC)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    lib.bmh_compare_files.restype = ctypes.c_int
    lib.bmh_compare_files.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.bmh_crc32.restype = ctypes.c_uint32
    lib.bmh_crc32.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    for fn in (lib.bmh_rle1_encode, lib.bmh_rle1_decode):
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
                       ctypes.c_uint64]
    _lib = lib
    return _lib


def crc32(buf: bytes) -> int:
    """IEEE CRC32; native when built, zlib otherwise (same value)."""
    lib = _load()
    if lib is None:
        return zlib.crc32(buf) & 0xFFFFFFFF
    view = np.ascontiguousarray(np.frombuffer(buf, dtype=np.uint8))
    return int(lib.bmh_crc32(view.ctypes.data, view.size))


def compare_files(p1: str, p2: str) -> bool | None:
    """Whether two files hold the same bytes; None without the library
    (callers then compare in Python)."""
    lib = _load()
    if lib is None:
        return None
    r = lib.bmh_compare_files(str(p1).encode(), str(p2).encode())
    if r < 0:
        raise OSError(f"cannot compare {p1} vs {p2}")
    return bool(r)


def _rle1_encode_py(a: np.ndarray) -> np.ndarray:
    """Python specification of bmh_rle1_encode (fallback + test judge)."""
    out = bytearray()
    i, n = 0, a.size
    while i < n:
        j = i + 1
        while j < n and a[j] == a[i]:
            j += 1
        run = j - i
        v = int(a[i])
        while run >= 4:
            take = min(run, 255)
            out.extend([v, v, v, v, take - 4])
            run -= take
        out.extend([v] * run)
        i = j
    return np.frombuffer(bytes(out), dtype=np.uint8)


def _rle1_decode_py(a: np.ndarray) -> np.ndarray:
    out = bytearray()
    i, n = 0, a.size
    while i < n:
        v = int(a[i])
        if i + 3 < n and a[i + 1] == v and a[i + 2] == v and a[i + 3] == v:
            if i + 4 >= n:
                raise ValueError("truncated RLE1 chunk")
            out.extend([v] * (4 + int(a[i + 4])))
            i += 5
        else:
            out.append(v)
            i += 1
    return np.frombuffer(bytes(out), dtype=np.uint8)


def rle1_encode(a: np.ndarray) -> np.ndarray:
    """RLE1 pre-BWT run collapse; native C when built, Python spec else."""
    a = np.ascontiguousarray(a, dtype=np.uint8)
    lib = _load()
    if lib is None:
        return _rle1_encode_py(a)
    cap = a.size + 8
    out = np.empty(cap, dtype=np.uint8)
    m = lib.bmh_rle1_encode(a.ctypes.data, a.size, out.ctypes.data, cap)
    if m >= a.size:
        # not strictly smaller: hand back the input (callers apply RLE1
        # only when it shrinks)
        return a
    return out[:m]


def rle1_decode(a: np.ndarray, expect: int) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.uint8)
    lib = _load()
    if lib is None:
        out = _rle1_decode_py(a)
    else:
        buf = np.empty(expect, dtype=np.uint8)
        m = lib.bmh_rle1_decode(a.ctypes.data, a.size, buf.ctypes.data, expect)
        if m > expect:
            raise ValueError("corrupt RLE1 block (overflow)")
        out = buf[:m]
    if out.size != expect:
        raise ValueError(f"RLE1 decoded {out.size} bytes, expected {expect}")
    return out
