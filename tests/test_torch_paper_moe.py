"""The port's Fig. 9 benchmark functions (``repro_torch.benchmarks.paper_moe``)
against ``repro.core.moe_overlap`` on the CPU.

The TP-MoE layer (the float32 router, then AG + GroupGEMM + TopkReduce +
RS) in both modes at a reduced MoE shape (S 64, H 32, I 16, E 8, top-2; and
E 16, top-5 so that each rank hosts more than one expert), W = 4 and 8
ranks.  The JAX side routes each shard and runs ``ag_moe`` /
``ag_moe_baseline`` under ``shard_map`` on a ``model`` mesh of W CPU
devices, as ``benchmarks/fig9_moe.py`` does; the port's "overlap" mode runs
the fused backend (the grouped kernel's plain version on CPU tensors).
float32 to 1e-5; bfloat16 overlap against non-overlap to 2e-2 of
max |non-overlap|.  Also the bound arithmetic and row tiles at the
published shapes, and the device policy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import make_mesh, shard_map
from repro.core import moe_overlap as jmoe
from repro_torch.backend.mesh import World
from repro_torch.benchmarks import paper_moe
from repro_torch.benchmarks.common import bound_ms
from repro_torch.configs.paper import PAPER_MOE
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

S, H, I = 64, 32, 16
F32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", params=[(4, 8, 2), (8, 8, 2), (4, 16, 5)], ids=["W4-E8-k2", "W8-E8-k2", "W4-E16-k5"])
def setup(request):
    w, e, k = request.param
    rng = np.random.default_rng(w + e + k)
    arrs = {
        "x": rng.standard_normal((S, H)).astype(np.float32),
        "wr": (rng.standard_normal((H, e)) / np.sqrt(H)).astype(np.float32),
        "w_gu": (rng.standard_normal((e, H, 2 * I)) / np.sqrt(H)).astype(np.float32),
        "w_down": (rng.standard_normal((e, I, H)) / np.sqrt(I)).astype(np.float32),
    }
    return w, e, k, make_mesh((w,), ("model",)), World(w, "cpu"), arrs


def _port_operands(w, a):
    x = torch.from_numpy(a["x"].reshape(w, S // w, H).copy())
    e = a["w_gu"].shape[0]
    w_gu = torch.from_numpy(a["w_gu"].reshape((w, e // w) + a["w_gu"].shape[1:]).copy())
    w_down = torch.from_numpy(a["w_down"].reshape((w, e // w) + a["w_down"].shape[1:]).copy())
    return x, torch.from_numpy(a["wr"]), w_gu, w_down


def _jax_moe(mesh, a, e, k, overlapped):
    wr = jnp.asarray(a["wr"])

    def f(xs, wgu, wdn):
        ids, wts, _ = jmoe.moe_router(xs, wr, num_experts=e, top_k=k)
        g = jmoe.ag_moe if overlapped else jmoe.ag_moe_baseline
        return g(xs, ids, wts, wgu, wdn, axis="model", capacity_factor=paper_moe.CAPACITY)

    row, w3 = P("model", None), P("model", None, None)
    fn = jax.jit(shard_map(f, mesh, in_specs=(row, w3, w3), out_specs=row))
    return np.asarray(fn(jnp.asarray(a["x"]), jnp.asarray(a["w_gu"]), jnp.asarray(a["w_down"])))


@pytest.mark.parametrize("mode", ["overlap", "non-overlap"])
def test_moe_layer_matches_reference(setup, mode):
    w, e, k, mesh, world, a = setup
    ref = _jax_moe(mesh, a, e, k, mode == "overlap")
    out = paper_moe.moe_layer(mode, world, e, k)(*_port_operands(w, a))
    assert out.shape == (w, S // w, H)
    np.testing.assert_allclose(out.reshape(S, H).numpy(), ref, **F32)


def test_bf16_overlap_against_non_overlap(setup):
    w, e, k, _, world, a = setup
    x, wr, w_gu, w_down = _port_operands(w, a)
    args = (x.bfloat16(), wr, w_gu.bfloat16(), w_down.bfloat16())
    out = paper_moe.moe_layer("overlap", world, e, k)(*args)
    ref = paper_moe.moe_layer("non-overlap", world, e, k)(*args)
    assert out.dtype == ref.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= paper_moe.TOL * ref.float().abs().max().item()


def test_operands_bounds_and_row_tiles():
    world = World(4, "cpu")
    x, wr, w_gu, w_down = paper_moe.moe_operands(world, S, H, I, 8, torch.float32)
    assert x.shape == (4, 16, 32) and wr.shape == (32, 8) and w_gu.shape == (4, 2, 32, 32) and w_down.shape == (4, 2, 16, 32)
    assert wr.dtype == torch.float32
    # the routed tokens' FLOPs at the bf16 peak: 0.313 ms (MoE-1 / MoE-2) to 2.085 ms (MoE-6)
    bounds = {}
    for name, (s, h, i, e, k) in PAPER_MOE.items():
        nbytes = 2 * (s * h + e * 3 * h * i + s * h)
        bounds[name] = bound_ms(paper_moe.moe_flops(s, h, i, k), nbytes, torch.bfloat16)
        assert bounds[name][1] == "operations"
    assert round(bounds["MoE-1"][0], 3) == round(bounds["MoE-2"][0], 3) == 0.313
    assert round(bounds["MoE-6"][0], 3) == 2.085
    # capacities 88-648; row tiles, the largest divisors <= 128: 82-108, none a multiple of 64
    tiles = [paper_moe.row_tile(w, s, k, e) for w in (8, 4) for s, h, i, e, k in PAPER_MOE.values()]
    assert min(c for c, _ in tiles) == 88 and max(c for c, _ in tiles) == 648
    assert min(b for _, b in tiles) == 82 and max(b for _, b in tiles) == 108
    assert paper_moe.row_tile(8, 8192, 2, 8) == (328, 82) and all(b % 64 for _, b in tiles)
    with pytest.raises(ValueError):
        paper_moe.moe_layer("fused", world, 8, 2)


def test_measurements_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the policy under test is the CUDA-less one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_moe.fig9_row("MoE-1", 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_moe.main([])
