"""The port's resumable stream writer on the CPU, held against bmh_tpu's:
the same bytes fresh and after a torn final block, bmh_tpu's streaming
containers decoded by the port, and the resume under another cursor
stride, which bmh_tpu turns into a container nothing decodes."""

import numpy as np
import pytest

import bmh_tpu
from bmh_tpu.utils import stream as jstream

import bmh_tpu_torch as bt
from bmh_tpu_torch.utils import config, container
from bmh_tpu_torch.utils import stream as tstream

BS = 8192


def _data(n=30000):
    rng = np.random.default_rng(2718)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9))) for _ in range(250)]
    text = b" ".join(words[i] for i in rng.integers(0, 250, n // 3))
    return text[: n - 2000] + bytes(rng.integers(0, 256, 2000, dtype=np.uint8))


DATA = _data()  # 4 blocks: 3 of 8 KiB and a ragged fourth


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """bmh_tpu's resumable container of DATA."""
    d = tmp_path_factory.mktemp("stream")
    (d / "in.bin").write_bytes(DATA)
    info = jstream.compress_file_resumable(str(d / "in.bin"), str(d / "ref.bzt"),
                                           block_size=BS)
    assert info == {"blocks": 4, "resumed_from": 0,
                    "encoded_file_size": (d / "ref.bzt").stat().st_size}
    return d


def _resumable(src, out, **kw):
    return tstream.compress_file_resumable(str(src), str(out), block_size=BS,
                                           device="cpu", **kw)


def test_fresh_run_writes_bmh_tpus_bytes(ref, tmp_path):
    out = tmp_path / "out.bzt"
    info = _resumable(ref / "in.bin", out)
    assert info == {"blocks": 4, "resumed_from": 0,
                    "encoded_file_size": out.stat().st_size}
    assert out.read_bytes() == (ref / "ref.bzt").read_bytes()
    assert bt.decompress_bytes(out.read_bytes(), device="cpu") == DATA


@pytest.mark.parametrize("tear", [7, 1, 0])
def test_resume_after_a_torn_block_writes_bmh_tpus_bytes(ref, tmp_path, tear):
    """A file cut inside block 4 (tear bytes short), or right after block 3,
    resumes from block 3 and ends as bmh_tpu's fresh run."""
    full = (ref / "ref.bzt").read_bytes()
    _, _, raws = container.unpack_file(full)
    end3 = container.FILE_HEADER.size + sum(4 + len(r) for r in raws[:3])
    out = tmp_path / "out.bzt"
    out.write_bytes(full[: len(full) - tear] if tear else full[:end3])
    assert _resumable(ref / "in.bin", out)["resumed_from"] == 3
    assert out.read_bytes() == full


def test_resume_after_a_crash_before_finalize(ref, tmp_path):
    """Two blocks appended, no finalize (what a crash leaves): the run
    resumes from 2 and writes bmh_tpu's bytes."""
    out = tmp_path / "out.bzt"
    blocks = container.split_blocks(np.frombuffer(DATA, np.uint8), BS)
    sc = tstream.StreamCompressor.create(str(out), BS)
    be = bt.get_backend("torch", "cpu")
    for blk in blocks[:2]:
        (pre,), (raw_len,) = bt.api._rle1_blocks([blk])
        sc.append(bt.api._pack_block(be.compress_blocks([pre], sc.stride)[0], raw_len))
    sc.close()
    assert _resumable(ref / "in.bin", out, backend="torch")["resumed_from"] == 2
    assert out.read_bytes() == (ref / "ref.bzt").read_bytes()


def test_bmh_tpu_resumable_container_decodes(ref):
    blob = (ref / "ref.bzt").read_bytes()
    assert bt.decompress_bytes(blob, device="cpu") == DATA
    assert bt.decompress_many([blob, blob], uniform=True, device="cpu") == [DATA, DATA]


def test_resume_under_another_stride_starts_afresh(ref, tmp_path, monkeypatch):
    """Fault of bmh_tpu's writer, repaired: blocks encoded at stride 1024
    then a resume at 2048.  The port records 1024, sees the mismatch and
    starts afresh, so the file decodes and equals a fresh run at 2048."""
    out = tmp_path / "out.bzt"
    monkeypatch.setattr(config.DEFAULT, "cursor_stride", 1024)
    _resumable(ref / "in.bin", out)
    assert container.file_stride(out.read_bytes()) == 1024
    out.write_bytes(out.read_bytes()[:-9])
    sc = tstream.StreamCompressor.resume(str(out))
    sc.close()
    assert (sc.stride, sc.blocks_done) == (1024, 3)

    monkeypatch.setattr(config.DEFAULT, "cursor_stride", 2048)
    info = _resumable(ref / "in.bin", out)
    assert info["resumed_from"] == 0
    blob = out.read_bytes()
    assert container.file_stride(blob) == 2048
    assert bt.decompress_bytes(blob, device="cpu") == DATA
    fresh = tmp_path / "fresh.bzt"
    _resumable(ref / "in.bin", fresh)
    assert blob == fresh.read_bytes()


def test_resume_refuses_other_files(tmp_path, ref):
    bad = tmp_path / "plain.bzt"
    bad.write_bytes(bmh_tpu.compress_bytes(DATA[:3000], backend="oracle"))
    with pytest.raises(ValueError, match="not a streaming"):
        tstream.StreamCompressor.resume(str(bad))
    (tmp_path / "short.bzt").write_bytes(b"BZT1")
    with pytest.raises(ValueError, match="missing header"):
        tstream.StreamCompressor.resume(str(tmp_path / "short.bzt"))
    # a non-streaming file in the way is replaced by a fresh run
    assert _resumable(ref / "in.bin", bad)["resumed_from"] == 0
    assert bad.read_bytes() == (ref / "ref.bzt").read_bytes()


def test_oracle_backend_resumable(ref, tmp_path):
    out = tmp_path / "o.bzt"
    info = _resumable(ref / "in.bin", out, backend="oracle")
    assert info["blocks"] == 4
    assert bt.decompress_bytes(out.read_bytes(), backend="oracle") == DATA
    assert bt.decompress_bytes(out.read_bytes(), device="cpu") == DATA
