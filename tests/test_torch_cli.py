"""The port's command line and its host helpers (metrics, corpus, debug
printers, bench) on the CPU, held against bmh_tpu's on the same inputs."""

import json

import numpy as np
import pytest

import bmh_tpu
from bmh_tpu import cli as jcli
from bmh_tpu.models import oracle as joracle
from bmh_tpu.utils import corpus as jcorpus
from bmh_tpu.utils import debug as jdebug
from bmh_tpu.utils import metrics as jmetrics

import bmh_tpu_torch as bt
from bmh_tpu_torch import bench as tbench
from bmh_tpu_torch import cli as tcli
from bmh_tpu_torch.utils import corpus as tcorpus
from bmh_tpu_torch.utils import debug as tdebug
from bmh_tpu_torch.utils import metrics as tmetrics
from bmh_tpu_torch.utils import nativeio

BS = 8192


def _text(rng, n):
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9))) for _ in range(300)]
    return b" ".join(words[i] for i in rng.integers(0, 300, n // 3))[:n]


TEXT = _text(np.random.default_rng(808), 24000)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The ~24 KB text, and bmh_tpu's CLI container of it at 8 KiB blocks."""
    d = tmp_path_factory.mktemp("cli")
    (d / "in.txt").write_bytes(TEXT)
    assert jcli.main(["compress", str(d / "in.txt"), str(d / "ref.bzt"),
                      "--block-size", str(BS)]) == 0
    return d


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_compress_writes_bmh_tpus_bytes(files, capsys):
    assert tcli.main(["compress", str(files / "in.txt"), str(files / "port.bzt"),
                      "--block-size", str(BS), "--device", "cpu"]) == 0
    line = _lines(capsys)[-1]
    assert (files / "port.bzt").read_bytes() == (files / "ref.bzt").read_bytes()
    assert line.startswith("header size: ") and f"initial_data_size: {len(TEXT)}" in line


def test_oracle_backend_verb(files, capsys):
    """--backend oracle takes no card: the default --device is not used."""
    out = files / "oracle.bzt"
    assert tcli.main(["compress", str(files / "in.txt"), str(out),
                      "--block-size", str(BS), "--backend", "oracle"]) == 0
    assert tcli.main(["decompress", str(out), str(files / "oracle.out"),
                      "--backend", "oracle"]) == 0
    assert (files / "oracle.out").read_bytes() == TEXT


def test_decompress_verify_info_lines(files, capsys):
    ref = files / "ref.bzt"
    assert tcli.main(["decompress", str(ref), str(files / "dec.out"),
                      "--device", "cpu"]) == 0
    assert tcli.main(["verify", str(files / "in.txt"), str(files / "dec.out")]) == 0
    assert _lines(capsys)[-1] == "success"
    assert tcli.main(["info", str(ref)]) == 0
    port_info = _lines(capsys)
    assert jcli.main(["info", str(ref)]) == 0
    assert port_info == _lines(capsys)
    assert port_info[0].startswith("block_size: 8192 $$ n_blocks: 3 ")


def test_verify_fails_on_differing_files(tmp_path, capsys):
    a, b = tmp_path / "a", tmp_path / "b"
    a.write_bytes(b"xyz")
    b.write_bytes(b"xyw")
    assert tcli.main(["verify", str(a), str(b)]) == 1
    assert _lines(capsys)[-1] == "fail"
    assert nativeio.compare_files(a, a) in (True, None)


def test_truncated_container_errors():
    blob = bt.compress_bytes(TEXT[:1000], device="cpu")
    with pytest.raises(ValueError, match="truncated|bad magic"):
        bt.decompress_bytes(blob[:10], device="cpu")
    with pytest.raises(ValueError, match="truncated"):
        bt.decompress_bytes(blob[:-5], device="cpu")
    with pytest.raises(ValueError, match="bad magic"):
        bt.decompress_bytes(b"XXXX" + blob[4:], device="cpu")


def test_bench_verb_over_a_small_corpus(tmp_path, capsys):
    (tmp_path / "a").write_bytes(TEXT[:9000])
    (tmp_path / "b").write_bytes(bytes(range(256)) * 20)
    assert tcli.main(["bench", "--corpus", str(tmp_path), "--files", "a,b",
                      "--block-size", str(BS), "--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert lines[0].startswith("1/2 header size: ") and lines[0].endswith("success")
    rec = json.loads(lines[-1])
    assert rec["failures"] == 0 and rec["files"] == 2
    assert rec["bytes_in"] == 9000 + 5120


def test_bench_verb_without_a_corpus(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BMH_CORPUS_DIR", str(tmp_path / "absent"))
    assert tcli.main(["bench"]) == 1
    assert jcli.main(["bench"]) == 1
    err = capsys.readouterr().err.splitlines()
    assert err == ["no corpus found; set --corpus or BMH_CORPUS_DIR"] * 2


def test_cli_default_device_needs_a_card(files):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["decompress", str(files / "ref.bzt"), str(files / "x.out")])


def test_version_and_module_entry():
    assert bt.__version__ == bmh_tpu.__version__ == "0.5.0"
    parser = tcli.build_parser()
    args = parser.parse_args(["compress", "a", "b"])
    assert (args.backend, args.device, args.block_size) == ("torch", "cuda", 1 << 20)


# --- metrics, corpus, debug ----------------------------------------------------

@pytest.mark.parametrize("args", [
    ("f.bin", 1000, 321, 40, 0.5), ("f.bin", 1000, 321, None, None),
    ("empty", 0, 24, 24, 0.0), ("x", 12345, 6789, None, 1e-9)])
def test_metrics_lines_equal(args):
    name, n_in, n_out, header, seconds = args
    assert tmetrics.metrics_line(name, n_in, n_out, header_size=header, seconds=seconds) \
        == jmetrics.metrics_line(name, n_in, n_out, header_size=header, seconds=seconds)
    kw = dict(files=2, bytes_in=n_in, rate=0.25, failures=0)
    assert tmetrics.json_line(**kw) == jmetrics.json_line(**kw)
    with tmetrics.timer() as box:
        pass
    assert box["seconds"] >= 0


def test_corpus_lookup_equal(tmp_path, monkeypatch):
    assert tcorpus.CALGARY_FILES == jcorpus.CALGARY_FILES
    assert tcorpus.REFERENCE_SIZES == jcorpus.REFERENCE_SIZES
    (tmp_path / "paper1").write_bytes(b"paper one")
    for where in (tmp_path, tmp_path / "absent"):
        monkeypatch.setenv("BMH_CORPUS_DIR", str(where))
        assert tcorpus.corpus_dir() == jcorpus.corpus_dir()
        for name in ("paper1", "book1"):
            assert tcorpus.corpus_path(name) == jcorpus.corpus_path(name)
            assert tcorpus.read_corpus_file(name) == jcorpus.read_corpus_file(name)
    assert tcorpus.read_corpus_file("book1") is None


def test_debug_strings_equal():
    rng = np.random.default_rng(99)
    data = bytes(rng.integers(0, 256, 200, dtype=np.uint8))
    blob = bmh_tpu.compress_bytes(TEXT[:20000], block_size=BS, backend="oracle")
    assert tdebug.describe_container(blob) == jdebug.describe_container(blob)
    assert tdebug.format_bytes(data) == jdebug.format_bytes(data)
    assert tdebug.format_bitstream(data, 40) == jdebug.format_bitstream(data, 40)
    assert [tdebug.char_to_bin(b) for b in (0, 1, 160, 511)] == \
        [jdebug.char_to_bin(b) for b in (0, 1, 160, 511)]
    syms = joracle.rle0(joracle.mtf(joracle.bwt(np.frombuffer(TEXT[:5000], np.uint8))[1]))
    lens = joracle.huffman_code_lengths(joracle.histogram(syms, 257))
    assert tdebug.format_code_table(lens) == jdebug.format_code_table(lens)
    assert tdebug.format_code_table(np.zeros(257, np.uint8)) == "  (empty code table)"


# --- the bench module ----------------------------------------------------------

def test_bench_run_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("BMH_CORPUS_DIR", str(tmp_path / "absent"))
    assert tbench.run(device="cpu")["error"] == "corpus not found"
    (tmp_path / "a").write_bytes(TEXT[:12000])
    (tmp_path / "b").write_bytes(b"ab" * 3000)
    monkeypatch.setenv("BMH_CORPUS_DIR", str(tmp_path))
    rec = tbench.run(block_size=BS, files=["a", "b"], device="cpu")
    assert rec["bit_exact"] is True and rec["block_size"] == BS
    assert len(rec["passes_s"]) == 5 and rec["median_MBps"] > 0
    want = sum(len(bt.compress_bytes((tmp_path / n).read_bytes(), block_size=BS,
                                     device="cpu")) for n in "ab")
    assert rec["compressed_bytes"] == want
    # the card's fields exist, not measured off the card
    assert rec["device"] == "cpu" and rec["device_ms"] is None and rec["card"] is None
    json.dumps(rec)


def test_bench_synthetic_stream_without_a_corpus(monkeypatch):
    monkeypatch.delenv("BMH_CORPUS_DIR", raising=False)
    s = tbench._enwik_like_stream(5000, np.random.default_rng(42))
    arr = np.frombuffer(s, np.uint8)
    assert len(s) == 5000 and arr.min() >= 32 and arr.max() < 96


def test_bench_default_device_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.run_synthetic(total_mb=1)
