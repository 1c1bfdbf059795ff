"""Nothing the benchmark runs imports JAX or the JAX package ``repro``
(compared by whole top-level name: ``repro_torch`` is the port), and the
plain references import nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

from perfbench import harness

PB = harness.HERE


def _imports(path: Path):
    """Top-level names of every module a file imports, wherever in it."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    bad = {str(p.relative_to(PB)): sorted(set(_imports(p))
                                          & set(harness.FORBIDDEN))
           for p in PB.rglob("*.py")}
    assert not {k: v for k, v in bad.items() if v}


def test_references_import_nothing_of_the_port():
    refs = sorted((PB / "reference").glob("*.py"))
    assert refs
    for p in refs:
        assert "repro_torch" not in set(_imports(p)), p


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_like.x", sys)
    assert not {"repro_torch_like", "jaxlib_like.x"} \
        & set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in harness.forbidden_modules()


def test_a_run_loads_neither(tmp_path):
    """Both tiny cells run in a fresh process, which then holds the port
    and none of JAX, jaxlib, flax or repro."""
    script = f"""
import sys
sys.path[:0] = [{str(PB.parent)!r}, {str(PB.parent / 'src')!r}]
from perfbench import harness, testing
root = testing.make_tiny_root({str(tmp_path)!r})
for cell in ("tiny-fl", "tiny-prefill"):
    harness.run_cell(cell, 11, 0.0, False, "cpu", root)
assert "repro_torch" in sys.modules
print("FOUND", harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                      "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
