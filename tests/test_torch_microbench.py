"""bmh_tpu_torch.tools.microbench on the CPU: its case list, its argument
parsing, that it names every formulation bmh_tpu's two microbench tools
time, and that it refuses to run without a card (it has no CPU fallback).
Its numbers come only from a card:
python -m bmh_tpu_torch.tools.microbench [case ...] there."""

import re
from pathlib import Path

import pytest
import torch

from bmh_tpu_torch.tools import microbench

ROOT = Path(__file__).resolve().parents[1]
# bmh_tpu's result names that the twin times under another name
RENAMED = {"cumsum_4M_u32": "cumsum_4M"}


def test_case_list():
    assert microbench.CASES == ("bitpack", "sort", "lf", "prims", "radix",
                                "compose", "place", "hist", "ibwt", "sparse",
                                "code_lengths", "mtf_forward", "rle1", "decode")
    assert set(microbench.BENCHES) == set(microbench.CASES)
    assert all(callable(f) for f in microbench.BENCHES.values())


def test_covers_every_formulation_of_bmh_tpu_tools():
    """Every result name of tools/microbench.py and tools/microbench_r5.py
    appears in the twin, and the twin's sparse case runs the same five
    two-tier shapes."""
    src = (ROOT / "bmh_tpu_torch" / "tools" / "microbench.py").read_text()
    tools = [(ROOT / "tools" / t).read_text() for t in ("microbench.py", "microbench_r5.py")]
    names = {n for text in tools
             for pair in re.findall(r'res\["(\w+)"\]|"(ibwt_lf\d)"', text)
             for n in pair if n}
    names -= {"platform", "null_dispatch"}
    assert len(names) == 23
    assert not [n for n in sorted(names) if RENAMED.get(n, n) not in src]
    shapes = "(2, 4), (1, 4), (2, 8), (1, 2), (3, 8)"
    assert shapes in tools[1] and shapes in src and 'f"sparse_t1={t1}_t2d={t2d}"' in src


def test_arguments_and_refusals(monkeypatch):
    with pytest.raises(ValueError, match="unknown cases"):
        microbench.run(["sort", "nope"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        microbench.main(["sort", "hist", "--reps", "3", "--warm", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        microbench.run()
    with pytest.raises(SystemExit):
        microbench.main(["--reps", "x"])
