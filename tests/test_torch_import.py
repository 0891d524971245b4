"""bmh_tpu_torch and chip_smoke.py import neither jax nor bmh_tpu.

The check runs in a subprocess: this test process already imported jax
(tests/conftest.py)."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "bmh_tpu")


def test_import_leaves_jax_out():
    code = ("import sys, bmh_tpu_torch, bmh_tpu_torch.models.pipeline, "
            "bmh_tpu_torch.parallel.distributed, bmh_tpu_torch.utils.tracing, "
            "bmh_tpu_torch.tools.profile_stages, bmh_tpu_torch.tools.ab_trees, "
            "bmh_tpu_torch.cli, bmh_tpu_torch.bench, bmh_tpu_torch.utils.stream, "
            "bmh_tpu_torch.models.oracle, bmh_tpu_torch.parallel.mesh, "
            "bmh_tpu_torch.parallel.dataparallel, bmh_tpu_torch.utils.debug, "
            "bmh_tpu_torch.utils.metrics, bmh_tpu_torch.utils.corpus, "
            "bmh_tpu_torch.tools.microbench, bmh_tpu_torch.models.programs, "
            "bmh_tpu_torch.ops.control; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_name_no_jax_import():
    files = sorted((ROOT / "bmh_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"bmh_tpu_torch/parallel/distributed.py",
            "bmh_tpu_torch/utils/tracing.py", "bmh_tpu_torch/cli.py",
            "bmh_tpu_torch/__main__.py", "bmh_tpu_torch/bench.py",
            "bmh_tpu_torch/utils/stream.py", "bmh_tpu_torch/models/oracle.py",
            "bmh_tpu_torch/parallel/mesh.py", "bmh_tpu_torch/parallel/dataparallel.py",
            "bmh_tpu_torch/utils/debug.py", "bmh_tpu_torch/utils/metrics.py",
            "bmh_tpu_torch/utils/corpus.py", "bmh_tpu_torch/tools/microbench.py",
            "bmh_tpu_torch/models/programs.py", "bmh_tpu_torch/ops/control.py"} <= names
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad
