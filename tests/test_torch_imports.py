"""The port imports nothing of JAX or of the JAX package (AST scan).

``src/repro_torch`` and ``chip_smoke.py`` run on a machine without JAX, and
the port keeps its own copies of what it needs from ``src/repro``.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_files_found():
    assert len(FILES) > 20
    assert (ROOT / "chip_smoke.py") in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import torch\nfrom repro.core import plan\nimport jax.numpy as jnp\n")
    assert [m for m in _imports(probe) if m.split(".")[0] in FORBIDDEN] == ["repro.core", "jax.numpy"]
