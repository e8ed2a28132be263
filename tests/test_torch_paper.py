"""The port's paper benchmark functions (``repro_torch.benchmarks.paper_mlp``)
against ``repro.core.overlap`` on the CPU.

Fig. 8's ``full_mlp`` (AG+GEMM -> SiLU-mul -> GEMM+RS) in both modes and
Tab. 2's five cases (AG+GEMM non-overlap / decompose / TileLink, GEMM+RS
non-overlap / TileLink) at a reduced MLP-1 (S 64, H 32, I 80: the paper
shape over 128, I rounded down to a multiple of 16 as
``benchmarks/fig8_mlp.py`` reduces it), W = 4 and 8 ranks.  The JAX side
runs ``ag_matmul`` / ``matmul_rs`` and their baselines under ``shard_map`` on
a ``model`` mesh of W CPU devices; the port's "overlap" mode runs the fused
kernels' plain versions (CPU tensors).  float32 to 1e-5; the bfloat16
baselines are held against their float32 results to 2e-2 of max |f32|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import make_mesh, shard_map
from repro.configs import paper as jpaper
from repro.core import overlap as jov
from repro_torch.backend.mesh import World
from repro_torch.benchmarks import paper_mlp
from repro_torch.benchmarks.common import bound_ms
from repro_torch.configs import paper
from repro_torch.core import BlockChannel, compile_overlap
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

S, H, I = 64, 32, 80
F32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", params=[4, 8])
def setup(request):
    w = request.param
    rng = np.random.default_rng(w)
    arrs = {
        "x": rng.standard_normal((S, H)).astype(np.float32),
        "w1": (rng.standard_normal((H, 2 * I)) / np.sqrt(H)).astype(np.float32),
        "w2": (rng.standard_normal((I, H)) / np.sqrt(I)).astype(np.float32),
        "w1_tab2": (rng.standard_normal((H, I)) / np.sqrt(H)).astype(np.float32),
        "xr": rng.standard_normal((S, I)).astype(np.float32),
    }
    return w, make_mesh((w,), ("model",)), World(w, "cpu"), arrs


def _rows(a, w):  # global [M, K] sharded by rows -> [W, M/W, K]
    return torch.from_numpy(a.reshape(w, a.shape[0] // w, a.shape[1]).copy())


def _cols(a, w):  # global [K, N] sharded by columns -> [W, K, N/W]
    return torch.from_numpy(a.reshape(a.shape[0], w, a.shape[1] // w).transpose(1, 0, 2).copy())


def _smap(mesh, fn, in_specs, out_specs, *args):
    return np.asarray(jax.jit(shard_map(fn, mesh, in_specs=in_specs, out_specs=out_specs))(*map(jnp.asarray, args)))


def _jax_full_mlp(mode):
    ag, rs = (jov.ag_matmul, jov.matmul_rs) if mode == "overlap" else (jov.ag_matmul_baseline, jov.matmul_rs_baseline)

    def f(x, w1, w2):
        h = ag(x, w1, axis="model")
        f_loc = h.shape[-1] // 2
        return rs(jax.nn.silu(h[..., :f_loc]) * h[..., f_loc:], w2, axis="model")

    return f


def test_paper_shapes_are_the_reference_shapes():
    assert paper.PAPER_MLP == jpaper.PAPER_MLP
    assert paper.PAPER_MOE == jpaper.PAPER_MOE
    assert paper.PAPER_ATTN == jpaper.PAPER_ATTN


@pytest.mark.parametrize("mode", ["overlap", "non-overlap"])
def test_full_mlp_matches_reference(setup, mode):
    w, mesh, world, a = setup
    specs = (P("model", None), P(None, "model"), P("model", None))
    ref = _smap(mesh, _jax_full_mlp(mode), specs, P("model", None), a["x"], a["w1"], a["w2"])
    out = paper_mlp.full_mlp(mode, world)(_rows(a["x"], w), _cols(a["w1"], w), _rows(a["w2"], w))
    assert out.shape == (w, S // w, H)
    np.testing.assert_allclose(out.reshape(S, H).numpy(), ref, **F32)


@pytest.mark.parametrize("case", ["AG+GEMM/non-overlap", "AG+GEMM/decompose", "AG+GEMM/tilelink"])
def test_tab2_ag_gemm_matches_reference(setup, case):
    w, mesh, world, a = setup
    jfn = jov.ag_matmul if case.endswith("tilelink") else jov.ag_matmul_baseline
    ref = _smap(mesh, lambda x, wt: jfn(x, wt, axis="model"), (P("model", None), P(None, "model")),
                P(None, "model"), a["x"], a["w1_tab2"])  # fmt: skip
    out = paper_mlp.tab2_fns(world)[case](_rows(a["x"], w), _cols(a["w1_tab2"], w))
    assert out.shape == (w, S, I // w)
    np.testing.assert_allclose(out.permute(1, 0, 2).reshape(S, I).numpy(), ref, **F32)


@pytest.mark.parametrize("case", ["GEMM+RS/non-overlap", "GEMM+RS/tilelink"])
def test_tab2_gemm_rs_matches_reference(setup, case):
    w, mesh, world, a = setup
    jfn = jov.matmul_rs if case.endswith("tilelink") else jov.matmul_rs_baseline
    ref = _smap(mesh, lambda x, wt: jfn(x, wt, axis="model"), (P(None, "model"), P("model", None)),
                P("model", None), a["xr"], a["w2"])  # fmt: skip
    out = paper_mlp.tab2_fns(world)[case](_cols(a["xr"], w), _rows(a["w2"], w))
    assert out.shape == (w, S // w, H)
    np.testing.assert_allclose(out.reshape(S, H).numpy(), ref, **F32)


def test_bf16_baselines_against_f32(setup):
    """The baselines keep one semantics in bf16: bf16 operands, float32
    accumulation (float32 partials before the reduce), one rounding."""
    w, _, world, a = setup
    ch = BlockChannel(axis="model")
    for kind, x, wt in (("ag_matmul", _rows(a["x"], w), _cols(a["w1_tab2"], w)),
                        ("matmul_rs", _cols(a["xr"], w), _rows(a["w2"], w))):  # fmt: skip
        fn = compile_overlap(kind, ch, world=world, overlapped=False)
        xb, wb = x.bfloat16(), wt.bfloat16()
        out, ref = fn(xb, wb), fn(xb.float(), wb.float())
        assert out.dtype == torch.bfloat16
        err = (out.float() - ref).abs().max().item()
        assert err <= 2e-2 * ref.abs().max().item(), (kind, err)


def test_bf16_full_mlp_overlap_against_non_overlap(setup):
    w, _, world, a = setup
    args = [t.bfloat16() for t in (_rows(a["x"], w), _cols(a["w1"], w), _rows(a["w2"], w))]
    out = paper_mlp.full_mlp("overlap", world)(*args)
    ref = paper_mlp.full_mlp("non-overlap", world)(*args)
    assert (out.float() - ref.float()).abs().max().item() <= paper_mlp.TOL * ref.float().abs().max().item()


def test_operands_and_bounds():
    world = World(8, "cpu")
    x, w1, w2 = paper_mlp.mlp_operands(world, 64, 32, 80, torch.float32)
    assert x.shape == (8, 8, 32) and w1.shape == (8, 32, 20) and w2.shape == (8, 10, 32)
    # MLP-6's 6 S H I FLOPs at the bf16 peak: about 12 ms, bound by operations
    ms, by = bound_ms(6 * 8192 * 8192 * 29568, 2 * 8192 * 8192 * 4, torch.bfloat16)
    assert by == "operations" and 11.9 < ms < 12.1
    with pytest.raises(ValueError):
        paper_mlp.full_mlp("fused", world)


def test_measurements_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the policy under test is the CUDA-less one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_mlp.fig8_row("MLP-1", 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_mlp.tab2_rows(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_mlp.main([])
