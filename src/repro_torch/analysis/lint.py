"""Pass 3 — layering rules over the port's own tree.

The port's counterpart of ``repro/analysis/lint.py`` (run by
``tests/test_torch_analysis.py`` and as ``python -m
repro_torch.analysis.lint``), over ``src/repro_torch``, with the port's
three counterparts of the JAX package's rules:

  * ``permute-site``  — ``world.permute`` (``ctx.world.permute``, any
                        ``<...>.world.permute``) only in ``core/overlap.py``,
                        the one schedule executor; every other layer goes
                        through plans.  ``benchmarks/`` is allowed: its
                        ring in ``paper_mlp.py`` is the non-overlapped
                        baseline the paper compares with (the JAX package's
                        lint covers ``src/repro`` only, and its benchmarks
                        live outside it).  A tensor's ``.permute`` is not a
                        collective and is not matched;
  * ``flag-site``     — the raw acquire / release at either scope
                        (``ld.acquire``, ``st.release``: ``.gpu`` and the
                        peer route's ``.sys``), the system-scope fence
                        (``__threadfence_system``) and their wrappers
                        (``tl_ld_acquire``, ``tl_st_release``, ``tl_fence``,
                        the bounded spin ``tl_spin``) only in
                        ``kernels/csrc/tile_sync.cuh``, the header of the
                        paper's tile primitives; the primitives themselves
                        (``producer_tile_notify``, ``consumer_tile_wait``,
                        ``peer_tile_notify``, ``peer_tile_wait``, each with
                        its ``_thread`` / ``_synced`` forms, and the peer
                        route's ``peer_entry_notify`` / ``peer_entry_wait``
                        and epochs ``tl_enter_epoch`` / ``tl_exit_epoch``)
                        only there and in the two fused kernels that include
                        it (``ag_gemm.cu``, ``gemm_rs.cu``), whose protocol
                        ``analysis.protocol`` models; a text rule over the
                        CUDA sources;
  * ``raw-library``   — ``ctypes.CDLL`` only in ``kernels/build.py`` and
                        ``build.library()`` only under ``kernels/``: kernels
                        launch through their wrappers, so the route choice
                        and the launch counts stay in one place (the
                        counterpart of ``raw-pallas-call``).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import re
from pathlib import Path
from typing import List, Optional, Sequence

__all__ = ["Violation", "lint_source", "lint_file", "lint_tree", "main"]

FLAG_RAW = ("tl_ld_acquire", "tl_st_release", "tl_fence", "tl_spin", "ld.acquire", "st.release",
            "__threadfence_system")  # fmt: skip
FLAG_PRIMITIVES = ("producer_tile_notify", "consumer_tile_wait", "peer_tile_notify", "peer_tile_wait",
                   "peer_entry_notify", "peer_entry_wait", "tl_enter_epoch", "tl_exit_epoch")  # fmt: skip
_FLAG_RAW_RE = re.compile(r"(?<![\w.])(" + "|".join(re.escape(p) for p in FLAG_RAW) + r")(?!\w)")
_FLAG_PRIMITIVE_RE = re.compile(
    r"(?<![\w.])((?:" + "|".join(re.escape(p) for p in FLAG_PRIMITIVES) + r")(?:_thread|_synced)?)(?!\w)"
)
CUDA_SUFFIXES = (".cu", ".cuh")

# rule -> relative paths (or directory prefixes ending in "/") allowed to match
_ALLOWED = {
    "permute-site": ("core/overlap.py", "benchmarks/"),
    "flag-site": ("kernels/csrc/tile_sync.cuh",),
    "flag-primitive": ("kernels/csrc/tile_sync.cuh", "kernels/csrc/ag_gemm.cu", "kernels/csrc/gemm_rs.cu"),
    "raw-cdll": ("kernels/build.py",),
    "raw-library": ("kernels/",),
}


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str  # relative to the repro_torch package root
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _allowed(rule: str, relpath: str) -> bool:
    return any(
        relpath == entry or (entry.endswith("/") and relpath.startswith(entry)) for entry in _ALLOWED[rule]
    )


def _is_world(node) -> bool:
    return (isinstance(node, ast.Name) and node.id == "world") or (
        isinstance(node, ast.Attribute) and node.attr == "world"
    )


def _lint_cuda(source: str, relpath: str) -> List[Violation]:
    rules = [(_FLAG_RAW_RE, "flag-site", "outside tile_sync.cuh: use the tile primitives")]
    rules.append((_FLAG_PRIMITIVE_RE, "flag-primitive", "outside tile_sync.cuh and the fused kernels that include it"))
    return [
        Violation(relpath, n, "flag-site", f"{m.group(1)} {why}")
        for regex, allow, why in rules
        if not _allowed(allow, relpath)
        for n, line in enumerate(source.splitlines(), 1)
        for m in regex.finditer(line)
    ]


def lint_source(source: str, relpath: str) -> List[Violation]:
    """Lint one file's source; ``relpath`` is relative to ``src/repro_torch``
    (a ``.cu`` / ``.cuh`` path gets the text rule, a ``.py`` the AST rules)."""
    if relpath.endswith(CUDA_SUFFIXES):
        return _lint_cuda(source, relpath)
    violations: List[Violation] = []
    for node in ast.walk(ast.parse(source, filename=relpath)):
        if not isinstance(node, ast.Attribute):
            continue
        base = node.value.id if isinstance(node.value, ast.Name) else None
        if node.attr == "permute" and _is_world(node.value) and not _allowed("permute-site", relpath):
            violations.append(
                Violation(relpath, node.lineno, "permute-site",
                          "world.permute outside core/overlap.py: route collectives through the plan executor")
            )  # fmt: skip
        elif node.attr == "CDLL" and base == "ctypes" and not _allowed("raw-cdll", relpath):
            violations.append(
                Violation(relpath, node.lineno, "raw-library", "ctypes.CDLL outside kernels/build.py")
            )
        elif node.attr == "library" and base == "build" and not _allowed("raw-library", relpath):
            violations.append(
                Violation(relpath, node.lineno, "raw-library",
                          "build.library() outside kernels/: launch through the kernel's wrapper")
            )  # fmt: skip
    return violations


def lint_file(path: Path, root: Path) -> List[Violation]:
    return lint_source(path.read_text(), path.relative_to(root).as_posix())


def lint_tree(root: Optional[Path] = None) -> List[Violation]:
    """Lint every module and CUDA source under ``src/repro_torch`` (the default root)."""
    root = root or Path(__file__).resolve().parents[1]
    paths = sorted(p for p in root.rglob("*") if p.suffix in (".py",) + CUDA_SUFFIXES and p.is_file())
    violations: List[Violation] = []
    for path in paths:
        violations.extend(lint_file(path, root))
    return violations


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Layering lint of the port: world.permute / flag primitive / kernel library call sites.",
    )
    p.add_argument("root", nargs="?", default=None, help="package root (default: src/repro_torch)")
    args = p.parse_args(argv)
    violations = lint_tree(Path(args.root) if args.root else None)
    for v in violations:
        print(v)
    print(f"{len(violations)} violation(s)")
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
