"""The port's boundary: it runs without JAX and without the JAX package.

A subprocess with ``sys.modules["jax"] = None`` and
``sys.modules["repro"] = None`` (any import of either then fails) imports
every module of ``repro_torch`` and ``chip_smoke.py``'s imports; a source
scan finds no ``jax`` / ``repro.`` import in the port, the script or
``sparse_update_bench.py``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def test_every_module_imports_without_jax_or_repro():
    mods = list(_modules())
    assert "repro_torch.kernels.consensus_update.consensus_update" in mods
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        f"sys.path.insert(0, {str(ROOT / 'src')!r})",
        f"sys.path.insert(0, {str(ROOT)!r})",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "bad = [m for m in sys.modules if sys.modules[m] is not None",
        "       and (m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))]",
        "assert not bad, bad",
        "print('ok', len(sys.modules))",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py", ROOT / "sparse_update_bench.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_repro(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax"), (path, name)
