"""The port's Fig. 10 benchmark functions (``repro_torch.benchmarks.paper_attn``)
against ``repro.core.overlap`` on the CPU.

Sequence-parallel causal attention in both modes at a reduced shape (S 128
and 256, 4 heads of 32), W = 4 and 8 ranks: the JAX side runs
``ring_attention`` / ``ag_attention_baseline`` under ``shard_map`` on a
``model`` mesh of W CPU devices with the sequence sharded, as
``benchmarks/fig10_attention.py`` does; the port's "overlap" mode runs the
fused backend (the flash wrapper's plain version on CPU tensors).  float32
to 1e-4; bfloat16 overlap against non-overlap to 2e-2 of max |non-overlap|.
Also the row's fields, the overlap-ratio formula and the bounds at the
published shapes, and the device policy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import make_mesh, shard_map
from repro.core import overlap as jov
from repro_torch.backend.mesh import World
from repro_torch.benchmarks import paper_attn
from repro_torch.configs.paper import PAPER_ATTN
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

HEADS, HD = 4, 32
F32 = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", params=[(4, 128), (8, 256)], ids=["W4-S128", "W8-S256"])
def setup(request):
    w, s = request.param
    rng = np.random.default_rng(w)
    qkv = [rng.standard_normal((1, HEADS, s, HD)).astype(np.float32) for _ in range(3)]
    return w, s, make_mesh((w,), ("model",)), World(w, "cpu"), qkv


def _port(w, a):
    """[1, H, S, D] global -> [W, 1, H, S/W, D] (the sequence sharded)."""
    b, h, s, d = a.shape
    return torch.from_numpy(a.reshape(b, h, w, s // w, d).transpose(2, 0, 1, 3, 4).copy())


@pytest.mark.parametrize("mode", ["overlap", "non-overlap"])
def test_attention_matches_reference(setup, mode):
    w, s, mesh, world, qkv = setup
    fn = jov.ring_attention if mode == "overlap" else jov.ag_attention_baseline
    spec = P(None, None, "model", None)
    ref = jax.jit(shard_map(lambda *a: fn(*a, axis="model", causal=True), mesh, in_specs=(spec,) * 3, out_specs=spec))
    want = np.asarray(ref(*(jnp.asarray(a) for a in qkv)))
    out = paper_attn.attention(mode, world)(*(_port(w, a) for a in qkv))
    assert out.shape == (w, 1, HEADS, s // w, HD)
    np.testing.assert_allclose(out.permute(1, 2, 0, 3, 4).reshape(1, HEADS, s, HD).numpy(), want, **F32)


def test_bf16_overlap_against_non_overlap(setup):
    w, _, _, world, qkv = setup
    args = [_port(w, a).bfloat16() for a in qkv]
    out = paper_attn.attention("overlap", world)(*args)
    ref = paper_attn.attention("non-overlap", world)(*args)
    assert out.dtype == ref.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= paper_attn.TOL * ref.float().abs().max().item()


def test_operands_row_fields_and_bounds():
    world = World(4, "cpu")
    q, k, v = paper_attn.attn_operands(world, 256, HEADS, HD, torch.float32)
    assert q.shape == k.shape == v.shape == (4, 1, HEADS, 64, HD)
    # the row from its medians: speedup, the paper's ratio (comp + comm - overlap) / comm
    ms = {"overlap": 5.0, "non-overlap": 6.0, "comm": 2.0, "comp": 4.0, "library": 3.0}
    row = paper_attn.row_fields("Attn-1", 16384, 32, 128, 8, ms)
    assert row["speedup"] == 1.2 and row["overlap_ratio"] == 0.5
    assert (row["overlap_ms"], row["nonoverlap_ms"], row["comm_ms"], row["comp_ms"], row["library_ms"]) == (
        5.0, 6.0, 2.0, 4.0, 3.0)  # fmt: skip
    assert row["shape"] == [16384, 32, 128] and row["world"] == 8 and row["figure"] == "fig10"
    # the causal FLOPs 2 S^2 H D at the bf16 peak bound every published row:
    # Attn-1 16k 2.223 ms ... Attn-2 128k 284.6 ms
    bounds = {}
    for name, (h, d, seqs) in PAPER_ATTN.items():
        for s in seqs:
            r = paper_attn.row_fields(name, s, h, d, 8, ms)
            assert r["bound_by"] == "operations"
            bounds[(name, s)] = r["bound_ms"]
    assert round(bounds[("Attn-1", 16384)], 3) == 2.223 and round(bounds[("Attn-2", 131072)], 1) == 284.6
    assert paper_attn.attn_flops(16384, 32, 128) == 2 * 16384**2 * 32 * 128
    with pytest.raises(ValueError):
        paper_attn.attention("fused", world)


def test_measurements_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the policy under test is the CUDA-less one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_attn.fig10_row("Attn-1", 16384, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_attn.main([])
