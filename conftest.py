"""Builds bmh_tpu's host library once, before pytest-xdist starts its workers.

tests/test_native.py decides while it is collected whether
csrc/build/libbmh_io.so loads, and bmh_tpu/utils/nativeio.py builds the
library at its first use by running `make`, whose linker writes the file in
place.  Six workers that collect at once each run that build: one worker
loads the file while another worker's linker rewrites it, finds no library,
and if it is the worker that runs test_native.py, all of that file's tests
skip.  Here the controller builds the library first, by the Makefile's own
rule and flags, into a temporary directory under a lock, and renames it
into place; the workers then only load it.
"""

import fcntl
import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # a worker: the controller built it
        return
    so = CSRC / "build" / "libbmh_io.so"
    if so.exists():
        return
    so.parent.mkdir(exist_ok=True)
    with open(so.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # another run built it while this one waited
            return
        with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
            try:
                subprocess.run(["make", "-C", str(CSRC), f"BUILD={tmp}"], check=True,
                               capture_output=True, timeout=300)
            except (OSError, subprocess.SubprocessError):
                return  # no toolchain: nativeio falls back to Python
            os.replace(Path(tmp) / "libbmh_io.so", so)
