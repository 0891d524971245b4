"""Structured metrics: the reference codec's `$$`-delimited fields plus
throughput, character for character as bmh_tpu/utils/metrics.py prints them
(downstream tooling parses these lines)."""

from __future__ import annotations

import json
import time
from contextlib import contextmanager


def metrics_line(file_name: str, initial_data_size: int, encoded_file_size: int,
                 header_size: int | None = None, seconds: float | None = None) -> str:
    parts = []
    if header_size is not None:
        parts.append(f"header size: {int(header_size)}")
    parts += [
        f"file_name: {file_name}",
        f"initial_data_size: {initial_data_size}",
        f"encoded_file_size: {encoded_file_size}",
        f"bits_avg: {8.0 * encoded_file_size / initial_data_size:g}" if initial_data_size else "bits_avg: 0",
        f"compress_rate = {encoded_file_size / initial_data_size:g}" if initial_data_size else "compress_rate = 0",
    ]
    if seconds is not None:
        mbps = initial_data_size / seconds / 1e6 if seconds > 0 else float("inf")
        parts.append(f"seconds: {seconds:.3f}")
        parts.append(f"MB_per_s: {mbps:.3f}")
    return " $$ ".join(parts)


@contextmanager
def timer():
    """Yields a dict that holds the block's wall seconds under "seconds"
    once the block ends."""
    box = {}
    t0 = time.perf_counter()
    try:
        yield box
    finally:
        box["seconds"] = time.perf_counter() - t0


def json_line(**kw) -> str:
    return json.dumps(kw)
