"""Calgary corpus discovery (bmh_tpu/utils/corpus.py's copy).

The corpus is not part of the repository: it is found through
$BMH_CORPUS_DIR alone.  Every lookup returns None where the variable is
unset or the directory or the file is absent.
"""

from __future__ import annotations

import os
from pathlib import Path

CALGARY_FILES = [
    "bib", "book1", "book2", "geo", "news", "obj1", "obj2",
    "paper1", "paper2", "pic", "progc", "progl", "progp", "trans",
]

# the reference codec's compressed size of each file (header + tree +
# payload), from its README
REFERENCE_SIZES = {
    "bib": 33205, "book1": 267163, "book2": 186994, "geo": 69563,
    "news": 133517, "obj1": 11785, "obj2": 88733, "paper1": 18224,
    "paper2": 28136, "pic": 101508, "progc": 13699, "progl": 18745,
    "progp": 12826, "trans": 22400,
}


def corpus_dir() -> Path | None:
    d = os.environ.get("BMH_CORPUS_DIR")
    if not d:
        return None
    path = Path(d)
    return path if path.is_dir() else None


def corpus_path(name: str) -> Path | None:
    d = corpus_dir()
    if d is None:
        return None
    p = d / name
    return p if p.is_file() else None


def read_corpus_file(name: str) -> bytes | None:
    p = corpus_path(name)
    return p.read_bytes() if p else None
