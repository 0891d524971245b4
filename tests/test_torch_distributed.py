"""The port's process layer and tracing hooks on the CPU, held against
bmh_tpu: compress_stream / decompress_stream in one process and in two
gloo processes, the block validation bmh_tpu's decompress_stream lacks,
and utils/tracing (annotate, device_trace, the bench verb's span report,
busy_ms; the recorder itself in tests/test_torch_tracing.py)."""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import bmh_tpu
import bmh_tpu_torch as bt
from bmh_tpu_torch.parallel import distributed as tdist
from bmh_tpu_torch.utils import container as tcont
from bmh_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
BS = 8192


def _text(rng, n):
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9))) for _ in range(300)]
    return b" ".join(words[i] for i in rng.integers(0, 300, n // 3))[:n]


STREAM = _text(np.random.default_rng(707), 3 * BS) + b"\x00" * 3


@pytest.fixture(scope="module")
def stream_ref():
    return bmh_tpu.compress_bytes(STREAM, block_size=BS)


# --- distributed ---------------------------------------------------------------

def test_single_process_streams(stream_ref):
    be = bt.get_backend("torch", "cpu")
    assert tdist.process_info() == (0, 1)
    tdist.initialize(num_processes=1)  # a no-op
    blob = tdist.compress_stream(STREAM, BS, be)
    assert blob == stream_ref
    assert tdist.decompress_stream(blob, be) == STREAM
    assert bt.decompress_bytes(blob, device="cpu") == STREAM
    with pytest.raises(ValueError, match="block_size"):
        tdist.compress_stream(STREAM, 0, be)


def test_decompress_stream_validates_blocks(stream_ref):
    """The fault bmh_tpu's decompress_stream has: it decodes blocks that
    api._validate_block_info rejects.  The port validates each one."""
    bs, total, raws = tcont.unpack_file(stream_ref)
    (orig_len, shift, lens, present, cps, rle_len, payload,
     pre_len) = tcont.unpack_block(raws[1])
    raws[1] = tcont.pack_block(orig_len, shift, lens, present, payload, cps=cps,
                               rle_len=pre_len + 5, pre_len=pre_len)
    bad = tcont.pack_file(raws, bs, total, stride=tcont.file_stride(stream_ref))
    with pytest.raises(ValueError, match="rle_len"):
        tdist.decompress_stream(bad, bt.get_backend("torch", "cpu"))


_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {root!r})
    import numpy as np
    import torch.distributed as dist
    import bmh_tpu_torch as bt
    from bmh_tpu_torch.parallel import distributed as d

    rank = int(sys.argv[1])
    d.initialize(coordinator_address="localhost:{port}", num_processes=2,
                 process_id=rank)
    assert d.process_info() == (rank, 2)
    assert d.GATHER_CHUNK_BLOCKS == 3
    data = open({src!r}, "rb").read()
    be = bt.get_backend("torch", "cpu")
    blob = d.compress_stream(data, 2048, be)
    if rank == 0:
        open({blob_path!r}, "wb").write(blob)
    else:
        assert blob is None
    dist.barrier()
    shared = open({blob_path!r}, "rb").read()
    back = d.decompress_stream(shared, be)
    if rank == 0:
        assert back == data
    else:
        assert back is None
    dist.destroy_process_group()
    print("DIST_OK", rank)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_round_trip(tmp_path):
    """Two processes on gloo, block stripes over 2 KiB blocks of about
    40 KB, gathered three block slots a process at a time: rank 0's
    container equals bmh_tpu's, and both ranks decode it."""
    rng = np.random.default_rng(4040)
    data = _text(rng, 40000) + bytes(rng.integers(0, 256, 1000, dtype=np.uint8))
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    script = _WORKER.format(root=str(ROOT), port=_free_port(), src=str(src),
                            blob_path=str(tmp_path / "c.bzt"))
    env = dict(os.environ, BMH_GATHER_CHUNK_BLOCKS="3", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"DIST_OK {r}" in out, out
    blob = (tmp_path / "c.bzt").read_bytes()
    assert blob == bmh_tpu.compress_bytes(data, block_size=2048)
    assert len(tcont.unpack_file(blob)[2]) == 21  # 4 gather rounds


# --- tracing -------------------------------------------------------------------

def test_annotate_names_show_in_profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with tracing.annotate("bmh_test_region"):
            torch.ones(4).sum()
        blob = bt.compress_bytes(STREAM[:BS], block_size=BS, device="cpu")
        bt.decompress_bytes(blob, device="cpu")
    names = {e.name for e in prof.events()}
    assert "bmh_test_region" in names
    assert "compress_dispatch_b2" in names and "compress_assemble" in names
    assert {"api.parse", "pipeline.stage", "programs.run"} <= names


def test_device_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    with tracing.device_trace(str(tmp_path / "t")) as path:
        with tracing.annotate("bmh_traced"):
            torch.arange(10).cumsum(0)
    assert path.exists() and path.parent == tmp_path / "t"
    assert "bmh_traced" in path.read_text()
    monkeypatch.delenv("BMH_TRACE_DIR", raising=False)
    with tracing.device_trace() as none:
        assert none is None
    monkeypatch.setenv("BMH_TRACE_DIR", str(tmp_path / "env"))
    with tracing.device_trace() as p2:
        pass
    assert p2.exists() and p2.parent == tmp_path / "env"


def test_bench_reports_self_time_by_span(tmp_path, capsys):
    """The bench verb runs under tracing.recording() and prints the
    recorder's self time by span name, the most first, before its JSON
    line."""
    from bmh_tpu_torch import cli

    (tmp_path / "a").write_bytes(STREAM[:BS])
    (tmp_path / "b").write_bytes(STREAM[BS:3 * BS])
    assert cli.main(["bench", "--corpus", str(tmp_path), "--files", "a,b",
                     "--block-size", str(BS), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("TOTAL")) + 1
    report = lines[start:-1]
    rows = {}
    for ln in report:
        name, _, rest = ln.partition(": ")
        count, _, ms = rest.partition(" spans, self ")
        rows[name] = (int(count), float(ms.removesuffix(" ms")))
    assert rows["api.compress"][0] == rows["api.decompress"][0] == 2
    assert {"api.parse", "pipeline.stage", "programs.run", "programs.wait"} <= set(rows)
    selfs = [ms for _, ms in rows.values()]
    assert selfs == sorted(selfs, reverse=True) and min(selfs) >= 0
    assert tracing._recorder is None  # the verb's recorder is closed


def test_busy_ms_is_the_union_of_spans():
    spans = [("a", 0, 1000), ("b", 500, 1500), ("c", 3000, 3500), ("d", 3100, 3200)]
    assert tracing.busy_ms(spans) == 2.0
    assert tracing.busy_ms([]) == 0.0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        with tracing.annotate("bmh_cpu_only"):
            torch.ones(8).cumsum(0)
    assert tracing.device_activity(p) == []  # nothing ran on a card
