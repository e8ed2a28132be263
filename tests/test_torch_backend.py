"""The port's backend probes, launch surface and compatibility surface
(``repro_torch.backend.features`` / ``lowering``, ``repro_torch.compat``)
against the JAX package's (``repro.backend``, ``repro.compat``), on the CPU.

``features`` probes once at import by ``hasattr`` / ``find_spec`` / path
checks and does not initialise CUDA; ``describe()`` reports every probe;
``lowering`` re-exports ``kernels/build``'s launch surface under the
reference's map; ``compat``'s tree functions give ``jax.tree_util``'s
leaves, structure and maps on trees holding ``None`` and unsorted dicts
(torch's pytree counts ``None`` as a leaf and keeps insertion order).
Exact equality throughout.
"""

import ast
import subprocess
import sys
from collections import OrderedDict, namedtuple
from pathlib import Path

import jax
import pytest
import torch

from repro_torch import compat
from repro_torch.backend import describe, features, lowering
from repro_torch.kernels import build
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

ROOT = Path(__file__).resolve().parents[1]
Pair = namedtuple("Pair", "x y")
TREES = {
    "list_none": [1, None, {"a": 2}],
    "nested": {"b": 1, "a": (None, 3), "c": [4, {"z": None, "y": 5}]},
    "none": None,
    "namedtuple": Pair(1, None),
    "empty": [[], {}, (None,)],
    "ordered": OrderedDict([("z", 1), ("a", [2, None])]),
    "tensors": {"w": torch.ones(2), "masks": [None, {"m": torch.zeros(3)}]},
}


def test_describe_reports_every_probe():
    info = describe()
    for key in ("torch_version", "has_cuda", "nvcc", "nvcc_version", "cutlass_include", "has_triton", "has_float8",
                "has_cuda_graphs", "has_flop_counter", "device"):  # fmt: skip
        assert key in info, key
    assert info["torch_version"] == torch.__version__ and info["has_cuda"] == torch.cuda.is_available()
    assert info["has_float8"] == hasattr(torch, "float8_e4m3fn")
    assert info["has_cuda_graphs"] == (hasattr(torch.cuda, "CUDAGraph") and hasattr(torch.cuda, "graph"))
    if not torch.cuda.is_available():
        assert info["device"] is None


def test_import_does_not_initialise_cuda():
    code = "import torch, repro_torch.backend.features, repro_torch.kernels; print(torch.cuda.is_initialized())"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})  # fmt: skip
    assert out.stdout.strip() == "False"


def test_probes_compare_no_versions():
    """Feature probes, never a version comparison (the reference's rule)."""
    tree = ast.parse((ROOT / "src" / "repro_torch" / "backend" / "features.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            names = {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
            attrs = {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}
            assert not ({"TORCH_VERSION"} & names or {"__version__"} & attrs), ast.dump(node)


def test_nvcc_probe_is_the_build_compiler(monkeypatch):
    monkeypatch.setattr(features, "NVCC", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        features.nvcc()
    monkeypatch.setattr(features, "NVCC", "toolkit/bin/nvcc")
    assert features.nvcc() == "toolkit/bin/nvcc"
    assert not hasattr(build, "_nvcc")  # one probe, in features


@pytest.mark.parametrize("name", lowering.__all__)
def test_lowering_reexports_the_build_surface(name):
    assert getattr(lowering, name) is getattr(build, name)


def test_lowering_names_every_reference_function():
    from repro.backend import lowering as jlow

    doc = lowering.__doc__
    for name in jlow.__all__:
        assert name in doc, name


@pytest.mark.parametrize("case", sorted(TREES))
def test_compat_trees_match_jax(case):
    tree = TREES[case]
    leaves, treedef = compat.tree_flatten(tree)
    j_leaves, j_def = jax.tree_util.tree_flatten(tree)
    assert len(leaves) == len(j_leaves) and all(a is b for a, b in zip(leaves, j_leaves))
    assert compat.tree_leaves(tree) == leaves
    back = compat.tree_unflatten(treedef, leaves)
    assert repr(back) == repr(jax.tree_util.tree_unflatten(j_def, j_leaves))
    mapped = compat.tree_map(lambda v: v * 2, tree)
    assert repr(mapped) == repr(jax.tree_util.tree_map(lambda v: v * 2, tree))


def test_compat_tree_map_over_several_trees():
    a, b = {"y": 1, "x": [2, None]}, {"x": [20, None], "y": 10}
    assert compat.tree_map(lambda u, v: u + v, a, b) == jax.tree_util.tree_map(lambda u, v: u + v, a, b)
    with pytest.raises(ValueError):
        compat.tree_map(lambda u, v: u + v, [1, None], [2, 3])
    with pytest.raises(ValueError):
        jax.tree_util.tree_map(lambda u, v: u + v, [1, None], [2, 3])


def test_compat_on_the_ports_grad_masks():
    """The port's grad_masks trees hold None subtrees (a Mamba mixer, an MLP)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext

    import dataclasses

    pc = ParallelContext(world=compat.World(4, "cpu"))
    padded = dataclasses.replace(get_config("smollm-360m"), n_layers=2)  # 15 heads over 4 ranks: padded
    masks = {"smollm": lm.grad_masks(padded, pc), "mamba2": lm.grad_masks(reduce_config(get_config("mamba2-2.7b")), pc)}
    assert None in masks["mamba2"]["layers"]
    leaves = compat.tree_leaves(masks)
    assert leaves and all(torch.is_tensor(v) for v in leaves)
    assert [id(v) for v in leaves] == [id(v) for v in jax.tree_util.tree_leaves(masks)]


def test_compat_mesh_constructor():
    from repro_torch.backend.mesh import World
    from repro_torch.launch.mesh import make_dev_mesh

    assert compat.make_dev_mesh is make_dev_mesh and compat.World is World
    mesh = compat.make_dev_mesh(4)
    assert mesh.world("cpu").size == 4
    assert not hasattr(compat, "shard_map")  # a World runs every rank: nothing to map


# --- chip_smoke.py's device-time readout: a profiler that records nothing is not a failure --------------


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _SilentProfile:
    """A torch.profiler session that records no device event."""

    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return []


class _Event:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def test_device_ms_reports_a_missing_readout(monkeypatch, capsys):
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(torch.profiler, "profile", _SilentProfile)
    calls = []
    assert cs.device_ms(lambda: calls.append(1), "matmul[probe]", iters=2) is None
    out = capsys.readouterr().out
    assert "matmul[probe]" in out and f"{cs.PROFILER_SESSIONS} sessions" in out and "device n/a" in out
    assert len(calls) == 1 + 2 * cs.PROFILER_SESSIONS
    assert cs._dev(None) == "n/a" and cs._dev(0.25) == "0.2500"


def test_a_case_records_null_device_time_and_still_checks(monkeypatch, capsys):
    """The case runs on: its device fields null, its checks against the plain
    version and kernels/ref still held (and still failing the run)."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.profiler, "profile", _SilentProfile)
    x, w = torch.randn(16, 8), torch.randn(8, 12)
    rec = cs._case("matmul[probe]", torch.float32, lambda: x @ w, lambda: x @ w, lambda: x @ w, 1, 1, 2,
                   ref=lambda: x @ w)  # fmt: skip
    assert rec["device_ms"] is None and rec["library_device_ms"] is None and rec["ok"] and rec["ref_max_abs_err"] == 0
    assert "(device n/a)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="kernels/ref"):
        cs._case("matmul[probe]", torch.float32, lambda: x @ w, lambda: x @ w, None, 1, 1, 2, True,
                 ref=lambda: x @ w + 1)  # fmt: skip
