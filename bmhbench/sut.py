"""The system under test: bmh_tpu_torch's API as a configuration drives it.

`Port(config)` sets the program's knobs from the configuration, imports
the program and offers `compress(items)` / `decompress(items)` for one
request: the configuration's `entry` "bytes" calls compress_bytes /
decompress_bytes for each item, "many" one compress_many /
decompress_many of all of them (with `uniform`).  `instrument()` records,
around the calls made inside it, the benchmark's own spans around the
program's backend and the program's counters."""

from __future__ import annotations

import os
import time
from contextlib import ExitStack, contextmanager

from . import profiling, spec

# configuration key -> the program's knob (bmh_tpu_torch/utils/config.py)
KNOBS = {"max_dispatch": "BMH_MAX_DISPATCH", "inflight": "BMH_INFLIGHT",
         "cursor_stride": "BMH_CURSOR_STRIDE"}
CACHE = spec.ROOT / ".bench_cache"


def _fixed_caches() -> None:
    """Build and kernel caches inside the checkout, at fixed paths (the
    program's own kernels build into bmh_tpu_torch/build/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)


class Port:
    name = "port"
    warm_up = True  # set-up runs the pool once: builds, warm-ups, captures

    def __init__(self, config: dict, device: str | None = None):
        for var in [v for v in os.environ if v.startswith("BMH_")]:
            del os.environ[var]
        for key, var in KNOBS.items():
            os.environ[var] = str(config[key])
        _fixed_caches()
        from bmh_tpu_torch import api
        from bmh_tpu_torch.utils import config as knobs

        for key in KNOBS:  # the program may have been imported before
            setattr(knobs.DEFAULT, key, int(config[key]))
        self.api = api
        self.device = device or config["device"]
        self.block_size = int(config["block_size"])
        self.entry = config["entry"]
        self.uniform = bool(config.get("uniform", False))
        if self.entry not in ("bytes", "many"):
            raise ValueError(f"unknown entry {self.entry!r}")

    def compress(self, items: list[bytes]) -> list[bytes]:
        if self.entry == "bytes":
            return [self.api.compress_bytes(d, self.block_size, device=self.device)
                    for d in items]
        return self.api.compress_many(items, self.block_size, uniform=self.uniform,
                                      device=self.device)

    def decompress(self, items: list[bytes]) -> list[bytes]:
        if self.entry == "bytes":
            return [self.api.decompress_bytes(b, device=self.device) for b in items]
        return self.api.decompress_many(items, uniform=self.uniform, device=self.device)

    def on_card(self) -> bool:
        return str(self.device).startswith("cuda")

    def sync(self) -> None:
        if self.on_card():
            import torch

            torch.cuda.synchronize()

    def counters(self) -> dict:
        from bmh_tpu_torch.models import pipeline, programs

        return {**{f"uploads.{k}": v for k, v in pipeline.UPLOADS.items()},
                **{f"programs.{k}": v for k, v in programs.STATS.items()}}

    @contextmanager
    def instrument(self, syncs: bool = True):
        """Yields a dict that holds, once the block ends: `backend_s` (host
        seconds inside the backend's compress_blocks / decompress_blocks,
        each call also a profiler span "bench.backend"), the program's
        counters' deltas under `delta`, and with `syncs` on a card the
        host's waits (profiling.count_syncs)."""
        import torch
        from bmh_tpu_torch.models.pipeline import TorchBackend

        rec = {"backend_s": 0.0}
        originals = {n: getattr(TorchBackend, n)
                     for n in ("compress_blocks", "decompress_blocks")}

        def timed(fn):
            def call(*args, **kwargs):
                t = time.perf_counter()
                try:
                    with torch.profiler.record_function("bench.backend"):
                        return fn(*args, **kwargs)
                finally:
                    rec["backend_s"] += time.perf_counter() - t
            return call

        before = self.counters()
        with ExitStack() as stack:
            if syncs and self.on_card():
                stack.enter_context(profiling.count_syncs(rec))
            for n, fn in originals.items():
                setattr(TorchBackend, n, timed(fn))
            try:
                yield rec
            finally:
                for n, fn in originals.items():
                    setattr(TorchBackend, n, fn)
        after = self.counters()
        rec["delta"] = {k: after[k] - before[k] for k in after}


def make(name: str, config: dict, device: str | None = None):
    if name == "port":
        return Port(config, device)
    if name == "control":
        from .control import Control

        return Control(config)
    raise ValueError(f"unknown system under test {name!r}")
