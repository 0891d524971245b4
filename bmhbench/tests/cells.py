"""Cells of BENCHMARK.json cut to a size that the CPU runs."""

from __future__ import annotations

from bmhbench import spec


def tiny(bench: dict, cell: str) -> tuple[dict, dict]:
    """The cell's configuration and mix, cut to a size the CPU runs in a
    second or two: 8 KiB blocks, two requests of at most four items."""
    wl = spec.workload(bench, cell)
    config = spec.config(bench, wl["config"])
    mix = spec.traffic(wl["traffic"])
    config.update(block_size=8192, device="cpu")
    if config["data"]["generator"] == "zipf_text":
        config["data"].update(text_bytes=20000)
    else:
        config["data"].update(block_size=1024)
    mix.update(pool_requests=2, check_blocks=4,
               items_per_request=min(int(mix["items_per_request"]), 4))
    return config, mix
