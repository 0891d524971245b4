"""The archive deployment on the CPU: the CLI's default 1 MiB blocks
through compress_bytes / decompress_bytes, and the stage marks of the
compress programs run eagerly.

A 1.5 MB stream of the benchmark's stand-in text is one block in the 2^20
bucket and a tail in the 2^19 bucket: both compress programs (the
sparse/adaptive one, and the full-rounds one that a run-dominated batch
takes) must write the plain reference's container (bmhbench/reference.py)
byte for byte, and decode it.  Run eagerly, each compress batch opens the
four stage spans (RLE1 included: the program takes the raw blocks) once
and counts no stage time: only a card's replays are timed."""

import numpy as np
import pytest

import bmh_tpu_torch as bt
from bmh_tpu_torch.models import pipeline, programs
from bmh_tpu_torch.utils import config, tracing
from bmhbench import reference
from bmhbench.generators import zipf_text

MIB = 1 << 20
STAGES = ("stage.rle1", "stage.bwt", "stage.mtf", "stage.entropy")


@pytest.fixture(scope="module")
def archive():
    data = zipf_text.make(2**32 + 20, 1, text_bytes=1_500_000)[0]
    return data, reference.compress(data, MIB, 4096)


@pytest.mark.parametrize("hard", [False, True], ids=["sparse", "full_rounds"])
def test_1mib_blocks_equal_the_reference(archive, monkeypatch, hard):
    data, want = archive
    assert -(-len(data) // MIB) == 2 and pipeline._bucket(len(data) - MIB) == MIB // 2
    if hard:
        monkeypatch.setattr(pipeline, "_looks_pathological", lambda blk: True)
    blob = bt.compress_bytes(data, MIB, device="cpu")
    assert blob == want
    assert bt.decompress_bytes(blob, device="cpu") == data


def test_eager_compress_opens_each_stage_span_once_a_batch(monkeypatch):
    monkeypatch.setattr(config.DEFAULT, "max_dispatch", 1)
    rng = np.random.default_rng(20)
    data = bytes(rng.integers(97, 105, 3 * 8192 - 100, dtype=np.uint8))
    programs.reset_stats()
    with tracing.recording() as rec:
        blob = bt.compress_bytes(data, 8192, device="cpu")
    assert bt.decompress_bytes(blob, device="cpu") == data
    counts = rec.counts()
    assert [counts.get(s) for s in STAGES] == [counts["programs.run"]] * 4 == [3] * 4
    by_id = {s[0]: s for s in rec.spans}
    for s in rec.spans:
        if s[4] in STAGES:
            assert s[3] == "device programs" and by_id[s[1]][4] == "programs.run"
    assert all(programs.STATS[f"stage_ms.{s}"] == 0.0 for s in programs.STAGES)
