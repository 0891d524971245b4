"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference side imports nothing of the program.  Module names are compared
by their top-level name, whole: bmh_tpu_torch is not bmh_tpu."""

import ast
import subprocess
import sys

from bmhbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "bmh_tpu"}
# the modules that judge the program, which may not use it
REFERENCE_SIDE = ("reference.py", "control.py", "check.py", "work.py", "traffic.py",
                  "generators")


def _imports(path):
    """Top-level names of every module a file imports (relative imports are
    of its own package and left out)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.partition(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                yield arg.value.partition(".")[0]


def _sources(root):
    return [p for p in root.rglob("*.py") if "tests" not in p.relative_to(root).parts]


def test_benchmark_and_program_import_no_jax():
    for root in (spec.HERE, spec.ROOT / "bmh_tpu_torch"):
        for path in _sources(root):
            assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_side_imports_nothing_of_the_program():
    for path in _sources(spec.HERE):
        rel = path.relative_to(spec.HERE).parts
        if rel[0] in REFERENCE_SIDE:
            assert "bmh_tpu_torch" not in set(_imports(path)), path


def test_a_run_loads_no_jax():
    code = ("from bmhbench import run, sut, spec\n"
            "bench = spec.load()\n"
            "s = sut.make('port', spec.config(bench, 'stream-128k'), 'cpu')\n"
            "s.compress([b'abc' * 1000])\n"
            "print(run.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "bmh_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "bmh_tpu.models", sys)
    assert run.loaded_forbidden() == ["bmh_tpu"]
