"""The Hopper kernels against their plain versions, on the card; the
serving engine's captured step against the same step run eagerly (for
deepseek-moe-16b with the streamed MoE decode in the graph); the paper's
TP-MLP (fused kernels) against its tensor-core baselines; the eager expert
GEMM of the MoE baseline on tensor cores; the train path's autograd
Functions (the fused collectives', flash attention's at head dims up to
128, 80 and 256 and at non-causal Sq != Sk, the grouped GEMM's at the MoE backward shapes, the tensor-core
expert GEMM's, the SSD intra-chunk term's at the train tile) and reduced
MoE, mamba2, zamba2, seamless-m4t (encoder-decoder) and paligemma (image
prefix, head dim 256) models' gradients and one zamba2 shared block, fused
against eager; the fused GEMM kernels with packed weights (int8, and int4
with zero points, dequantized inside both routes) and ``gemm_rs`` with a
bf16 wire under float32 accumulation, against their plain versions.

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips (from a fixture) on a host without one.  The file imports neither JAX
nor the JAX package, so it runs on the GPU machine, where there is no JAX:

  python -m pytest --noconftest -m cuda -p no:cacheprovider tests/test_torch_cuda.py

Shapes are small and deliberately ragged (non-power-of-two tiles, partial
edge tiles, leading batch dims, GQA, sq < sk, random expert tables, SSD
tiles with T prime and decays that underflow; for the bf16 (wgmma)
kernels, widths that are multiples of 8 but ragged against their 128 x 128
tile, more items than SMs, and 20 launches held bitwise equal).  Tolerances: float32 1e-4 of
max |plain| (summation order only); bfloat16 2e-2 of max |plain| (both
versions round outputs to bf16).
"""

import dataclasses
import importlib
import itertools

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.backend.mesh import World
from repro_torch.benchmarks import paper_mlp
from repro_torch.benchmarks.common import fp32_reductions
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import BlockChannel, CommSpec, CompSpec, compile_overlap
from repro_torch.core import moe_overlap
from repro_torch.kernels import build
from repro_torch.kernels import mamba_ssd
from repro_torch.kernels.ag_gemm import launch_items as ag_items
from repro_torch.kernels.gemm_rs import launch_items as rs_items
from repro_torch.kernels.grouped_matmul import group_tile_table
from repro_torch.kernels.grouped_matmul import work_items as gemm_items
from repro_torch.models import lm
from repro_torch.nn import layers
from repro_torch.parallel.context import ParallelContext
from repro_torch.serving import Request, ServeEngine
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")  # the module; the package exports the function
pytestmark = [pytest.mark.cuda, pytest.mark.usefixtures("torch_threads")]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ORDERS = ("ring", "bidir_ring", "all2all")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with `pytest --noconftest -m cuda tests/test_torch_cuda.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(dev, dtype, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _close(out, ref, dtype):
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * max(ref.float().abs().max().item(), 1e-6), err


def _gemm_launch(last, route, row_tiles, bm, n):
    assert last["route"] == route
    if route == "wgmma":
        items = len(gemm_items(row_tiles, bm, n))
        assert last["items"] == items and last["grid"] == min(items, 132)


# float32 (FMA route): any width and block tile.  bfloat16 (wgmma route):
# the same raggedness against the 128 x 128 tile (a partial m-tile, a last
# n-tile narrower than one 64-column box, K below one 64-deep block) with
# widths that are multiples of 8 (16-byte TMA rows); the M = 4 decode head
# at granite's head width (one warpgroup idle); more items (153) than SMs
MATMUL_CASES = [
    (torch.float32, 50, 300, 37, (64, 120, 32)), (torch.float32, 4, 960, 960, (128, 128, 128)),
    (torch.float32, 130, 129, 5, (7, 9, 1)),
    (torch.bfloat16, 50, 304, 40, (64, 120, 32)), (torch.bfloat16, 4, 960, 960, (128, 128, 128)),
    (torch.bfloat16, 130, 136, 8, (7, 9, 1)), (torch.bfloat16, 4, 49160, 960, (128, 128, 128)),
    (torch.bfloat16, 1030, 2056, 72, (128, 128, 128)),
]  # fmt: skip


@pytest.mark.parametrize("dtype,m,n,k,tile", MATMUL_CASES)
def test_matmul_kernel(dev, dtype, m, n, k, tile):
    x, w = _rand(dev, dtype, m, k), _rand(dev, dtype, k, n, seed=1, scale=k**-0.5)
    before = K.matmul.launches
    out = K.matmul(x, w, tile=tile)
    assert K.matmul.launches == before + 1
    _gemm_launch(K.matmul.last_launch, build.ROUTES[dtype], 1, m, n)
    _close(out, K.matmul_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2))))
def test_ag_gemm_kernel(dev, dtype, order, nch):
    """K = 33, n_loc = 70: the float32 (FMA) route takes any width; the
    bfloat16 (wgmma) route needs multiples of 8 for TMA and raises."""
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order), comp=CompSpec(tile=(128, 40, 128)))
    x, w = _rand(dev, dtype, 4, 3, 10, 33), _rand(dev, dtype, 4, 33, 70, seed=1, scale=33**-0.5)
    before = K.ag_gemm.launches
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="multiple of 8"):
            K.ag_gemm(x, w, channel=ch)
        assert K.ag_gemm.launches == before
        return
    out = K.ag_gemm(x, w, channel=ch)
    assert K.ag_gemm.launches == before + 1 and out.shape == (4, 3, 40, 70)
    assert K.ag_gemm.last_launch["route"] == "fma"
    _close(out, K.ag_gemm_plain(x, w, channel=ch), dtype)


@pytest.mark.parametrize("dtype,accum", [(torch.float32, "float32"), (torch.bfloat16, "float32"), (torch.bfloat16, "bfloat16")])
@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2))))
def test_gemm_rs_kernel(dev, dtype, accum, order, nch):
    """k_loc = 20, N = 50: the float32 route takes any width; the bfloat16
    route needs multiples of 8 for TMA and raises."""
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order), comp=CompSpec(accum_dtype=accum))
    x, w = _rand(dev, dtype, 4, 2, 12, 20), _rand(dev, dtype, 4, 20, 50, seed=1, scale=80**-0.5)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="multiple of 8"):
            K.gemm_rs(x, w, channel=ch)
        return
    out = K.gemm_rs(x, w, channel=ch)
    assert out.shape == (4, 2, 3, 50) and K.gemm_rs.last_launch["route"] == "fma"
    _close(out, K.gemm_rs_plain(x, w, channel=ch), dtype)


# bf16 (wgmma) route: widths multiples of 8 but ragged against the 128 x 128
# tile, and one shape with more items (256) than SMs, so blocks loop
AG_BF16 = [((4, 3, 10, 40), (4, 40, 72)), ((4, 2, 2, 24, 64), (4, 64, 136)), ((4, 4, 64, 256), (4, 256, 1024))]
RS_BF16 = [((4, 2, 12, 24), (4, 24, 56)), ((4, 3, 20, 136), (4, 136, 200)), ((4, 4, 256, 256), (4, 256, 1024))]


@pytest.mark.parametrize("xs,ws", AG_BF16)
@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2))))
def test_ag_gemm_bf16_kernel(dev, xs, ws, order, nch):
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    x, w = _rand(dev, torch.bfloat16, *xs), _rand(dev, torch.bfloat16, *ws, seed=1, scale=ws[1] ** -0.5)
    before = K.ag_gemm.launches
    out = K.ag_gemm(x, w, channel=ch)
    last = K.ag_gemm.last_launch
    assert K.ag_gemm.launches == before + 1 and last["route"] == "wgmma"
    assert last["items"] == len(ag_items(x, w, ch)) and last["grid"] == min(last["items"], 132)
    _close(out, K.ag_gemm_plain(x, w, channel=ch), torch.bfloat16)


@pytest.mark.parametrize("xs,ws", RS_BF16)
@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2))))
def test_gemm_rs_bf16_kernel(dev, xs, ws, accum, order, nch):
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order), comp=CompSpec(accum_dtype=accum))
    x, w = _rand(dev, torch.bfloat16, *xs), _rand(dev, torch.bfloat16, *ws, seed=1, scale=(4 * ws[1]) ** -0.5)
    before = K.gemm_rs.launches
    out = K.gemm_rs(x, w, channel=ch)
    last = K.gemm_rs.last_launch
    assert K.gemm_rs.launches == before + 1 and last["route"] == "wgmma"
    assert last["items"] == len(rs_items(x, w, ch)) and last["grid"] == min(last["items"], 132)
    _close(out, K.gemm_rs_plain(x, w, channel=ch), torch.bfloat16)


@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2))))
def test_bf16_fused_kernels_are_deterministic(dev, order, nch):
    """20 launches of each bf16 kernel (256 items on 132 blocks) are bitwise
    equal to the first: a missing fence between the flag protocol and TMA
    would show as a stale tile now and then."""
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    x, w = _rand(dev, torch.bfloat16, *AG_BF16[-1][0]), _rand(dev, torch.bfloat16, *AG_BF16[-1][1], seed=1, scale=0.06)
    first = K.ag_gemm(x, w, channel=ch)
    for _ in range(19):
        assert torch.equal(K.ag_gemm(x, w, channel=ch), first)
    x, w = _rand(dev, torch.bfloat16, *RS_BF16[-1][0]), _rand(dev, torch.bfloat16, *RS_BF16[-1][1], seed=1, scale=0.03)
    first = K.gemm_rs(x, w, channel=ch)
    for _ in range(19):
        assert torch.equal(K.gemm_rs(x, w, channel=ch), first)


def _smollm_tp() -> dict:
    """smollm-360m's four TP GEMMs at W = 4, 4 x 256 tokens: (kernel, x shape, w shape)."""
    from repro_torch.nn.attention import layout

    cfg = get_config("smollm-360m")
    lay, d, f_loc = layout(cfg, 4), cfg.d_model, cfg.d_ff // 4
    n_qkv, n_o = (lay.h_loc + 2 * lay.kv_loc) * cfg.hd, lay.h_loc * cfg.hd
    return {
        "qkv": ("ag_gemm", (4, 4, 64, d), (4, d, n_qkv)),
        "o_proj": ("gemm_rs", (4, 4, 256, n_o), (4, n_o, d)),
        "gate_up": ("ag_gemm", (4, 4, 64, d), (4, d, 2 * f_loc)),
        "down": ("gemm_rs", (4, 4, 256, f_loc), (4, f_loc, d)),
    }


SMOLLM_TP = _smollm_tp()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("proj", list(SMOLLM_TP))
@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2))))
def test_fused_launch_verified_at_its_grid(dev, proj, order, nch, dtype):
    """The static verifier proves each launch at the grid G the card gave it
    (``analysis.verify_launch``: the bf16 items on G persistent blocks, the
    float32 route's (n-tile, channel, rank) grid), and its output holds
    against the plain version."""
    from repro_torch import analysis

    kind, xs, ws = SMOLLM_TP[proj]
    fn, plain = (K.ag_gemm, K.ag_gemm_plain) if kind == "ag_gemm" else (K.gemm_rs, K.gemm_rs_plain)
    fan = ws[1] if kind == "ag_gemm" else 4 * ws[1]
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    x, w = _rand(dev, dtype, *xs), _rand(dev, dtype, *ws, seed=1, scale=fan**-0.5)
    out = fn(x, w, channel=ch)
    grid = fn.last_launch["grid"]
    report = analysis.verify_launch(kind, x, w, ch, grid)
    assert report.passes == (f"launch[{build.ROUTES[dtype]}, G={grid}]",) and report.events > 0
    _close(out, plain(x, w, channel=ch), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "bh,bhkv,sq,sk,d,causal,window",
    [(4, 2, 100, 100, 64, True, None), (3, 1, 37, 130, 32, True, None), (2, 2, 70, 70, 16, True, 20),
     (2, 1, 64, 64, 128, False, None), (2, 2, 65, 65, 64, False, 33), (4, 2, 100, 100, 80, True, None),
     (3, 3, 1, 77, 80, False, 30), (2, 1, 70, 70, 256, True, None), (2, 2, 64, 130, 256, False, 40)],
)  # fmt: skip
def test_flash_attention_kernel(dev, dtype, bh, bhkv, sq, sk, d, causal, window):
    q, k, v = _rand(dev, dtype, bh, sq, d), _rand(dev, dtype, bhkv, sk, d, seed=1), _rand(dev, dtype, bhkv, sk, d, seed=2)
    before = K.flash_attention.launches
    out = K.flash_attention(q, k, v, causal=causal, window=window)
    assert K.flash_attention.launches == before + 1
    _close(out, K.flash_attention_plain(q, k, v, causal=causal, window=window), dtype)


# the wgmma route (bf16, D 64 / 80 / 128): GQA rep 1, 2, 3; causal, window and
# non-causal; Sq < Sk down to Sq = 1; S not a multiple of 64; granite's
# path shape (384 CTAs, more than SMs); D 80 (zamba2: the 128-wide
# pipeline on 80 columns, TMA zero-filling the rest) at ragged shapes and
# at zamba2's serve shape (W B h_loc = 128 heads of 256); D 256 (paligemma:
# the 256-wide pipeline) at ragged shapes, MQA, and at paligemma's serve
# shape (32 query heads of 512 against 16 KV heads); seamless-m4t's
# cross-attention (non-causal, 256 queries against 512 keys)
FLASH_WGMMA = [
    (4, 4, 100, 100, 64, True, None), (4, 2, 64, 64, 128, True, None), (6, 2, 130, 130, 64, True, 40),
    (3, 1, 37, 130, 64, False, None), (6, 2, 1, 200, 128, True, None), (3, 1, 1, 77, 64, False, 30),
    (4, 4, 65, 65, 128, False, 33), (96, 32, 256, 256, 64, True, None), (4, 2, 100, 100, 80, True, None),
    (6, 2, 1, 200, 80, True, None), (3, 1, 37, 130, 80, False, 33), (128, 128, 256, 256, 80, True, None),
    (4, 1, 100, 100, 256, True, None), (6, 2, 1, 200, 256, True, None), (3, 1, 37, 130, 256, False, None),
    (4, 4, 65, 65, 256, False, 33), (32, 16, 512, 512, 256, True, None), (64, 64, 256, 512, 64, False, None),
]  # fmt: skip


@pytest.mark.parametrize("bh,bhkv,sq,sk,d,causal,window", FLASH_WGMMA)
def test_flash_attention_wgmma_kernel(dev, bh, bhkv, sq, sk, d, causal, window):
    """Held to the f32 plain version on the same bf16 inputs (2e-2 of its
    max) and to the tiled twin that replays the route's schedule."""
    bf = torch.bfloat16
    q, k, v = _rand(dev, bf, bh, sq, d), _rand(dev, bf, bhkv, sk, d, seed=1), _rand(dev, bf, bhkv, sk, d, seed=2)
    before = K.flash_attention.launches
    out = K.flash_attention(q, k, v, causal=causal, window=window)
    last = K.flash_attention.last_launch
    assert K.flash_attention.launches == before + 1 and last["route"] == "wgmma"
    assert last["grid"] == -(-sq // 64) * bh
    assert last["items"] == bh * sum(fa_mod.kv_tiles(q0, sq, sk, causal, window)[1] for q0 in range(0, sq, 64))
    assert torch.isfinite(out).all()
    _close(out, K.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal, window=window), bf)
    _close(out, fa_mod.flash_attention_tiled(q, k, v, causal=causal, window=window), bf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", fa_mod.HEAD_DIMS)
def test_flash_attention_route_table(dev, dtype, d):
    """Each (dtype, head dim) launches the route of the table: bf16 at 64, 80,
    128 and 256 the wgmma kernel, everything else the FMA kernel."""
    q, k, v = (_rand(dev, dtype, 2, 70, d, seed=s) for s in range(3))
    out = K.flash_attention(q, k, v, causal=True)
    want = "wgmma" if dtype == torch.bfloat16 and d in (64, 80, 128, 256) else "fma"
    assert fa_mod.route(dtype, d) == want and K.flash_attention.last_launch["route"] == want
    _close(out, K.flash_attention_plain(q, k, v, causal=True), dtype)


@pytest.mark.parametrize("bh,bhkv,d", [(64, 32, 64), (128, 128, 80), (32, 16, 256)])
def test_flash_attention_wgmma_is_deterministic(dev, bh, bhkv, d):
    """20 launches at smollm's path shape (256 CTAs), zamba2's (D 80, 512
    CTAs) and at paligemma's head dim (D 256, MQA) are bitwise equal."""
    bf = torch.bfloat16
    q, k, v = _rand(dev, bf, bh, 256, d), _rand(dev, bf, bhkv, 256, d, seed=1), _rand(dev, bf, bhkv, 256, d, seed=2)
    first = K.flash_attention(q, k, v, causal=True)
    for _ in range(19):
        assert torch.equal(K.flash_attention(q, k, v, causal=True), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_d80_statistics_and_grads(dev, dtype):
    """Head dim 80 under autograd (zamba2's shared attention in training):
    ``flash_attention_lse``'s o and lse against the plain version's state,
    and the Function's output and gradients against float32 autograd
    through the plain attention; o / gradients 1e-4 (f32) or 2e-2 (bf16) of
    max, lse absolutely."""
    q, k, v = _rand(dev, dtype, 8, 130, 80), _rand(dev, dtype, 4, 130, 80, seed=1), _rand(dev, dtype, 4, 130, 80, seed=2)
    o, lse = fa_mod.flash_attention_lse(q, k, v, causal=True)
    o_p, lse_p = fa_mod.flash_attention_lse(*(t.float().cpu() for t in (q, k, v)), causal=True)
    _close(o, o_p.to(dev), dtype)
    assert (lse - lse_p.to(dev)).abs().max().item() <= TOL[dtype]
    do = _rand(dev, dtype, *q.shape, seed=3)
    got = _grads(lambda *a: K.flash_attention(*a, causal=True), (q, k, v), do)
    ref = _grads(lambda *a: K.flash_attention_plain(*a, causal=True), (q.float(), k.float(), v.float()), do.float())
    for a, b in zip(got, ref):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_d256_statistics_and_grads(dev, dtype):
    """Head dim 256 under autograd (paligemma in training, MQA: 4 query heads
    per KV head), as the D 80 test: ``flash_attention_lse``'s o and lse
    against the plain version's state, the Function's output and gradients
    against float32 autograd through the plain attention."""
    q, k, v = _rand(dev, dtype, 8, 130, 256), _rand(dev, dtype, 2, 130, 256, seed=1), _rand(dev, dtype, 2, 130, 256, seed=2)
    o, lse = fa_mod.flash_attention_lse(q, k, v, causal=True)
    o_p, lse_p = fa_mod.flash_attention_lse(*(t.float().cpu() for t in (q, k, v)), causal=True)
    _close(o, o_p.to(dev), dtype)
    assert (lse - lse_p.to(dev)).abs().max().item() <= TOL[dtype]
    do = _rand(dev, dtype, *q.shape, seed=3)
    got = _grads(lambda *a: K.flash_attention(*a, causal=True), (q, k, v), do)
    ref = _grads(lambda *a: K.flash_attention_plain(*a, causal=True), (q.float(), k.float(), v.float()), do.float())
    for a, b in zip(got, ref):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(256, 512), (100, 37), (1024, 1024)])
def test_flash_attention_cross_and_encoder_shapes(dev, dtype, sq, sk):
    """seamless-m4t's non-causal attention at head dim 64: the
    cross-attention's Sq != Sk (ragged both ways) and an encoder's long
    square block; the output and, under autograd, every gradient against
    the plain version."""
    q, k, v = _rand(dev, dtype, 8, sq, 64), _rand(dev, dtype, 8, sk, 64, seed=1), _rand(dev, dtype, 8, sk, 64, seed=2)
    out = K.flash_attention(q, k, v, causal=False)
    assert K.flash_attention.last_launch["route"] == fa_mod.route(dtype, 64)
    _close(out, K.flash_attention_plain(q.float(), k.float(), v.float(), causal=False), dtype)
    do = _rand(dev, dtype, *q.shape, seed=3)
    got = _grads(lambda *a: K.flash_attention(*a, causal=False), (q, k, v), do)
    ref = _grads(lambda *a: K.flash_attention_plain(*a, causal=False), (q.float(), k.float(), v.float()), do.float())
    for a, b in zip(got, ref):
        _close(a, b, dtype)


# ring tiles (flash_attention_ranked): W = 4 ranks in one launch with
# per-rank query / key offsets and KV head offsets, the state carried in and
# out; (dtype, D, sq form, causal, window, s_loc, Hk, kv_select).  s_loc 80 is
# ragged against the 64-row tile; sharded q with causal + window 48 leaves
# whole rows of visited tiles masked across launches
RING_CASES = [
    (torch.float32, 64, "shard", True, 48, 80, 2, False), (torch.float32, 32, "gather", True, None, 80, 8, True),
    (torch.bfloat16, 64, "shard", True, 48, 80, 8, True), (torch.bfloat16, 128, "gather", True, None, 80, 2, False),
    (torch.bfloat16, 64, "shard", False, None, 128, 4, True), (torch.bfloat16, 32, "shard", True, None, 80, 2, False),
    (torch.bfloat16, 128, "gather", False, 48, 64, 1, True), (torch.bfloat16, 80, "shard", True, 48, 80, 8, True),
    (torch.float32, 80, "gather", True, None, 80, 2, False),
]  # fmt: skip


def _ring_operands(dev, dtype, d, form, s_loc, hk, world=4, b=2, h=8):
    sq = s_loc if form == "shard" else world * s_loc
    return (
        _rand(dev, dtype, world, b, h, sq, d), _rand(dev, dtype, world, b, hk, s_loc, d, seed=1),
        _rand(dev, dtype, world, b, hk, s_loc, d, seed=2),
    )  # fmt: skip


@pytest.mark.parametrize("dtype,d,form,causal,window,s_loc,hk,ksel", RING_CASES)
def test_flash_attention_ring_tile_kernel(dev, dtype, d, form, causal, window, s_loc, hk, ksel):
    """One ring step's launch (state in, state out, then a final launch)
    against its plain version on the same inputs: the tiled twin on the
    wgmma route, chunked_attention on the FMA route."""
    world = 4
    q, k, v = _ring_operands(dev, dtype, d, form, s_loc, hk)
    h, sq = q.shape[2], q.shape[3]
    q_off = tuple(r * s_loc for r in range(world)) if form == "shard" else (0,) * world
    need = max(1, hk // world) if ksel else hk
    starts = tuple((r // max(1, world // hk)) * need for r in range(world)) if ksel else None
    wgmma = fa_mod.route(dtype, d) == "wgmma"
    kw = dict(q_off=q_off, kv_start=starts, kv_need=need, causal=causal, window=window)
    # two KV tiles of every rank: the rank's own, then its left neighbour's
    tiles = [(r, (r - 1) % world) for r in range(world)]
    srcs = [[t[i] for t in tiles] for i in range(2)]
    kt = [k[torch.tensor(s_, device=dev)] for s_ in srcs]
    vt = [v[torch.tensor(s_, device=dev)] for s_ in srcs]
    before = K.flash_attention.launches
    st = fa_mod.flash_attention_ranked(q, kt[0], vt[0], k_off=tuple(x * s_loc for x in srcs[0]), final=False, **kw)
    out = fa_mod.flash_attention_ranked(q, kt[1], vt[1], k_off=tuple(x * s_loc for x in srcs[1]), state=st, **kw)
    assert K.flash_attention.launches == before + 2
    assert K.flash_attention.last_launch["route"] == ("wgmma" if wgmma else "fma")
    assert out.shape == q.shape and torch.isfinite(out).all()
    ref_in = [t.float() for t in (q, kt[0], vt[0])]
    pst = fa_mod.flash_attention_ranked_plain(
        *ref_in, k_off=tuple(x * s_loc for x in srcs[0]), final=False, tiled=wgmma, **kw
    )  # fmt: skip
    ref = fa_mod.flash_attention_ranked_plain(
        ref_in[0], kt[1].float(), vt[1].float(), k_off=tuple(x * s_loc for x in srcs[1]), state=pst, tiled=wgmma, **kw
    )  # fmt: skip
    # rows that met a visible key (the others hold masked keys only, as in both plain versions)
    qp = torch.tensor(q_off, device=dev)[:, None] + torch.arange(sq, device=dev)
    vis = torch.zeros((world, sq), dtype=torch.bool, device=dev)
    for i in range(2):
        kp = torch.tensor([x * s_loc for x in srcs[i]], device=dev)[:, None] + torch.arange(s_loc, device=dev)
        ok = torch.ones((world, sq, s_loc), dtype=torch.bool, device=dev)
        if causal:
            ok = qp[:, :, None] >= kp[:, None, :]
        if window:
            ok = ok & (qp[:, :, None] - kp[:, None, :] < window)
        vis |= ok.any(-1)
    sel = vis[:, None, None, :, None].expand_as(out)
    _close(out[sel], ref[sel], dtype)


@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2))))
@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 64), (torch.bfloat16, 128)])
def test_fused_ring_attention_matches_eager(dev, order, nch, dtype, d):
    """compile_overlap("ag_attention", backend="fused") on the card against
    the eager f32 oracle on the same inputs: steps x channels launches."""
    world = World(4, dev)
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    for form, causal, window, ksel, hk in (("shard", True, 48, True, 8), ("gather", True, None, False, 2)):
        q, k, v = _ring_operands(dev, dtype, d, form, 80, hk)
        kw = dict(causal=causal, window=window, kv_select=ksel)
        before = K.flash_attention.launches
        out = compile_overlap("ag_attention", ch, world=world, backend="fused")(q, k, v, **kw)
        assert K.flash_attention.launches == before + 4 * nch
        ref = compile_overlap("ag_attention", ch, world=world)(q.float(), k.float(), v.float(), **kw)
        assert torch.isfinite(out).all()
        _close(out, ref, dtype)


def test_ring_tile_wgmma_is_deterministic(dev):
    """20 launches of a carried ring step on the wgmma route are bitwise equal."""
    q, k, v = _ring_operands(dev, torch.bfloat16, 128, "shard", 256, 4)
    kw = dict(q_off=(0, 256, 512, 768), k_off=(0, 0, 256, 512), causal=True)
    st0 = fa_mod.flash_attention_ranked(q, k, v, final=False, **kw)
    first = fa_mod.flash_attention_ranked(q, k, v, state=fa_mod.FlashState(*(t.clone() for t in st0)), **kw)
    for _ in range(19):
        again = fa_mod.flash_attention_ranked(q, k, v, state=fa_mod.FlashState(*(t.clone() for t in st0)), **kw)
        assert torch.equal(again, first)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 128)])
def test_ag_attention_baseline_on_card_against_f32_oracle(dev, dtype, d):
    """The baseline's CUDA route (one flash launch over the gathered KV)
    against its dense f32 form on the CPU, 2e-2 of max |oracle|."""
    world = World(4, dev)
    for form, ksel, hk in (("shard", True, 8), ("gather", False, 2)):
        q, k, v = _ring_operands(dev, dtype, d, form, 80, hk)
        before = K.flash_attention.launches
        out = compile_overlap("ag_attention", BlockChannel(axis="model"), world=world, overlapped=False)(
            q, k, v, causal=True, kv_select=ksel
        )  # fmt: skip
        assert K.flash_attention.launches == before + 1
        ref = compile_overlap("ag_attention", BlockChannel(axis="model"), world=World(4, "cpu"), overlapped=False)(
            *(t.float().cpu() for t in (q, k, v)), causal=True, kv_select=ksel
        )  # fmt: skip
        err = (out.float().cpu() - ref).abs().max().item()
        assert err <= 2e-2 * ref.abs().max().item(), err


@pytest.mark.parametrize("n_kv", [1, 2, 4, 8])
def test_apply_seq_ring_fused_matches_eager_on_card(dev, n_kv):
    """The layer form on the card: fused (bf16 AG+GEMM, ring of flash
    launches, GEMM+RS) in float32 against eager, and against apply_seq."""
    import dataclasses

    from repro_torch.convert import shard_attention
    from repro_torch.nn import attention

    cfg = dataclasses.replace(reduce_config(get_config("smollm-360m")), n_heads=8, n_kv_heads=n_kv)
    world = World(4, dev)
    params = shard_attention(attention.init(cfg, 4, torch.Generator(device=dev).manual_seed(0), torch.float32, dev), world)
    x = _rand(dev, torch.float32, 4, 2, 48, cfg.d_model, scale=0.5)
    fused, eager = ParallelContext(world=world), ParallelContext(world=world, backend="eager")
    before = K.flash_attention.launches
    y_f = attention.apply_seq_ring(params, x, fused, cfg)
    assert K.flash_attention.launches == before + 4
    y_e = attention.apply_seq_ring(params, x, eager, cfg)
    y_s = attention.apply_seq(params, x, eager, cfg)
    _close(y_f, y_e, torch.float32)
    torch.testing.assert_close(y_e, y_s, atol=2e-4, rtol=2e-3)


# (table, bm, K, N) over 5 experts.  float32: ragged K and N.  bfloat16:
# the same raggedness with widths that are multiples of 8, plus a row tile
# of 200 rows (two m-tiles, the second of 72 rows), entries -1 and 7 (empty
# tiles) in a non-monotone table, and 40 tiles of 96 rows x 12 n-tiles (480
# items, more than SMs; granite's down-projection shape)
GROUPED_F32 = [((4, 0, 4), 40, 37, 300), ((1, -1, 2, 0, 3, 3, 1, 0, 2, 4, 0, 1), 8, 64, 130), ((2, 0), 96, 33, 128),
               ((3, 3, 1), 48, 1536, 1024)]  # fmt: skip
GROUPED_BF16 = [((4, 0, 4), 40, 40, 304), ((1, -1, 2, 0, 3, 3, 1, 0, 2, 4, 0, 1), 8, 64, 136), ((2, 0), 96, 40, 128),
                ((3, 3, 1), 48, 1536, 1024), ((4, 1, -1, 0, 7, 2), 200, 72, 264),
                (tuple((3 * i) % 6 - 1 for i in range(40)), 96, 512, 1536)]  # fmt: skip
GROUPED_CASES = [(torch.float32, torch.float32) + c for c in GROUPED_F32] + [
    (torch.bfloat16, od) + c for od in (torch.bfloat16, torch.float32) for c in GROUPED_BF16
]


@pytest.mark.parametrize("dtype,out_dtype,table,bm,k,n", GROUPED_CASES)
def test_grouped_matmul_kernel(dev, dtype, out_dtype, table, bm, k, n):
    """Random, non-monotone tables; -1 (or E and above) marks an empty tile;
    bm > 64 walks two sub-tiles (float32) or both warpgroups (bfloat16)."""
    te = torch.tensor(table, dtype=torch.int32, device=dev)
    x, w = _rand(dev, dtype, len(table) * bm, k), _rand(dev, dtype, 5, k, n, seed=1, scale=k**-0.5)
    before = K.grouped_matmul.launches
    out = K.grouped_matmul(x, w, te, out_dtype=out_dtype)
    assert K.grouped_matmul.launches == before + 1 and out.dtype == out_dtype and out.shape == (x.shape[0], n)
    _gemm_launch(K.grouped_matmul.last_launch, build.ROUTES[dtype], len(table), bm, n)
    _close(out, K.grouped_matmul_plain(x, w, te, out_dtype), dtype)


@pytest.mark.parametrize("k,n,out_dtype", [(2048, 2816, torch.float32), (1408, 2048, torch.bfloat16)])
def test_grouped_matmul_at_deepseek_expert_shapes(dev, k, n, out_dtype):
    """deepseek-moe-16b's expert GEMMs in one prefill ring step at W = 4: 64
    groups (4 ranks x 16 experts) of 4 x 8 = 32 rows, gate|up [2048, 2816]
    into float32 and down [1408, 2048] into bf16."""
    te = group_tile_table(64, 32, dev)
    x, w = _rand(dev, torch.bfloat16, 64 * 32, k), _rand(dev, torch.bfloat16, 64, k, n, seed=1, scale=k**-0.5)
    out = K.grouped_matmul(x, w, te, out_dtype=out_dtype)
    assert out.dtype == out_dtype and out.shape == (64 * 32, n)
    _gemm_launch(K.grouped_matmul.last_launch, "wgmma", 64, 32, n)
    _close(out, K.grouped_matmul_plain(x, w, te, out_dtype), torch.bfloat16)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_bf16_gemm_kernels_are_deterministic(dev, out_dtype):
    """20 launches of the bf16 plain and grouped GEMMs (153 and 480 items on
    132 blocks) are bitwise equal to the first."""
    x, w = _rand(dev, torch.bfloat16, 1030, 72), _rand(dev, torch.bfloat16, 72, 2056, seed=1, scale=72**-0.5)
    first = K.matmul(x, w)
    for _ in range(19):
        assert torch.equal(K.matmul(x, w), first)
    table, bm, k, n = GROUPED_BF16[-1]
    te = torch.tensor(table, dtype=torch.int32, device=dev)
    x, w = _rand(dev, torch.bfloat16, len(table) * bm, k), _rand(dev, torch.bfloat16, 5, k, n, seed=1, scale=k**-0.5)
    first = K.grouped_matmul(x, w, te, out_dtype=out_dtype)
    for _ in range(19):
        assert torch.equal(K.grouped_matmul(x, w, te, out_dtype=out_dtype), first)


def _ssd_intra_inputs(dev, dtype, t, q, p, spread, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    cum = -(torch.randn((t, q), generator=g, device=dev).abs() * spread).cumsum(1)
    cb = torch.randn((t, q, q), generator=g, device=dev) * 0.3
    xdt = torch.randn((t, q, p), generator=g, device=dev) * 0.5
    return cum.to(dtype), cb.to(dtype), xdt.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q,p", list(itertools.product((16, 64), (16, 64))) + [(37, 23)])
@pytest.mark.parametrize("spread", [1.0, 60.0])
def test_ssd_intra_chunk_kernel(dev, dtype, q, p, spread):
    """T = 37 tiles (a multiple of nothing); spread 60 drives the decays
    below the diagonal to 0 and the masked upper triangle far above any
    float's range."""
    cum, cb, xdt = _ssd_intra_inputs(dev, dtype, 37, q, p, spread)
    before = K.ssd_intra_chunk.launches
    out = K.ssd_intra_chunk(cum, cb, xdt)
    assert K.ssd_intra_chunk.launches == before + 1 and out.dtype == dtype and out.shape == xdt.shape
    assert torch.isfinite(out).all()
    _close(out, K.ssd_intra_chunk_plain(cum, cb, xdt), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 37, 1280, 3001])
def test_ssd_intra_chunk_persistent_grid(dev, dtype, t):
    """The mamba2 path's tile (Q = P = 64, bulk staging) at T = 1 up to
    T = 3001 (more tiles than the persistent grid has blocks)."""
    cum, cb, xdt = _ssd_intra_inputs(dev, dtype, t, 64, 64, 1.0, seed=t)
    out = K.ssd_intra_chunk(cum, cb, xdt)
    last = K.ssd_intra_chunk.last_launch
    assert last["route"] == "bulk" and 1 <= last["grid"] <= t and last["items"] == t
    if t == 3001:
        assert last["grid"] < t
    assert torch.isfinite(out).all()
    _close(out, K.ssd_intra_chunk_plain(cum, cb, xdt), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spread", [1.0, 60.0])
def test_ssd_intra_chunk_register_staging(dev, dtype, spread):
    """Ragged (Q, P) = (37, 23) takes the register staging path; spread 60
    stays finite."""
    cum, cb, xdt = _ssd_intra_inputs(dev, dtype, 301, 37, 23, spread)
    out = K.ssd_intra_chunk(cum, cb, xdt)
    assert K.ssd_intra_chunk.last_launch["route"] == "registers" and not mamba_ssd.bulk_staged(37, 23, dtype)
    assert torch.isfinite(out).all()
    _close(out, K.ssd_intra_chunk_plain(cum, cb, xdt), dtype)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    bf = torch.bfloat16
    for xs, ws in (((4, 2, 8, 33), (4, 33, 64)), ((4, 2, 8, 32), (4, 32, 70))):  # K = 33, then n = 70
        with pytest.raises(ValueError, match="multiple of 8"):
            K.ag_gemm(_rand(dev, bf, *xs), _rand(dev, bf, *ws))
    for xs, ws in (((4, 2, 8, 33), (4, 33, 64)), ((4, 2, 8, 32), (4, 32, 70))):
        with pytest.raises(ValueError, match="multiple of 8"):
            K.gemm_rs(_rand(dev, bf, *xs), _rand(dev, bf, *ws))
    with pytest.raises(ValueError, match="aligned"):  # a view 2 bytes past an aligned base
        K.ag_gemm(_rand(dev, bf, 4 * 2 * 8 * 32 + 1)[1:].view(4, 2, 8, 32), _rand(dev, bf, 4, 32, 64))
    # the bf16 plain and grouped GEMMs: K = 33, then N = 70, then a misaligned base; nothing launches
    te = torch.tensor([1, -1], dtype=torch.int32, device=dev)
    before = (K.matmul.launches, K.grouped_matmul.launches)
    for xs, ws in (((16, 33), (33, 64)), ((16, 32), (32, 70))):
        with pytest.raises(ValueError, match="multiple of 8"):
            K.matmul(_rand(dev, bf, *xs), _rand(dev, bf, *ws))
        with pytest.raises(ValueError, match="multiple of 8"):
            K.grouped_matmul(_rand(dev, bf, *xs), _rand(dev, bf, 2, *ws), te)
    with pytest.raises(ValueError, match="aligned"):
        K.matmul(_rand(dev, bf, 16 * 32 + 1)[1:].view(16, 32), _rand(dev, bf, 32, 64))
    with pytest.raises(ValueError, match="aligned"):
        K.grouped_matmul(_rand(dev, bf, 16 * 32 + 1)[1:].view(16, 32), _rand(dev, bf, 2, 32, 64), te)
    assert (K.matmul.launches, K.grouped_matmul.launches) == before
    x = _rand(dev, torch.float32, 8, 16)
    with pytest.raises(TypeError):
        K.matmul(x.half(), x.t().contiguous().half())
    with pytest.raises(ValueError):
        K.matmul(x.t(), x)  # not contiguous
    with pytest.raises(TypeError):
        K.matmul(x, x.t().contiguous().bfloat16())
    with pytest.raises(ValueError):
        K.matmul(x, x.cpu().t().contiguous())
    q = _rand(dev, torch.float32, 2, 8, 48)
    with pytest.raises(ValueError):
        K.flash_attention(q, q, q)  # head dim 48 is not instantiated
    w3 = _rand(dev, torch.float32, 2, 16, 8)
    with pytest.raises(ValueError):
        K.grouped_matmul(x, w3, torch.zeros(2, dtype=torch.int64, device=dev))  # the table must be int32
    with pytest.raises(ValueError):
        K.grouped_matmul(x, w3, torch.zeros(2, dtype=torch.int32, device=dev), out_dtype=torch.bfloat16)
    cum, cb, xdt = _ssd_intra_inputs(dev, torch.float32, 2, 80, 16, 1.0)
    with pytest.raises(ValueError):
        K.ssd_intra_chunk(cum, cb, xdt)  # Q = 80 > 64
    cum, cb, xdt = _ssd_intra_inputs(dev, torch.float32, 2, 16, 16, 1.0)
    with pytest.raises(TypeError):
        K.ssd_intra_chunk(cum, cb, xdt.bfloat16())


def test_fused_prefill_matches_eager_on_card(dev):
    cfg = reduce_config(get_config("smollm-360m"))
    world = World(4, dev)
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    pf, pe = ParallelContext(world=world), ParallelContext(world=world, backend="eager")
    assert pf.backend == "fused"
    K.reset_launch_counts()
    lf, cf = lm.prefill(params, cfg, pf, toks, max_len=20)
    assert K.launch_counts() == {
        "matmul": 1, "ag_gemm": 4, "gemm_rs": 4, "flash_attention": 2, "grouped_matmul": 0, "ssd_intra_chunk": 0
    }  # fmt: skip
    le, ce = lm.prefill(params, cfg, pe, toks, max_len=20)
    torch.testing.assert_close(lf, le, atol=2e-3, rtol=2e-3)
    for a, b in zip(cf, ce):
        torch.testing.assert_close(a["k"], b["k"], atol=1e-4, rtol=1e-4)


def test_fused_moe_prefill_matches_eager_on_card(dev):
    """Reduced granite-moe-3b-a800m: the expert GEMMs on the grouped kernel,
    two launches per layer and ring step."""
    cfg = reduce_config(get_config("granite-moe-3b-a800m"))
    world = World(4, dev)
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    K.reset_launch_counts()
    lf, af = lm.forward(params, cfg, ParallelContext(world=world), toks)
    le, ae = lm.forward(params, cfg, ParallelContext(world=world, backend="eager"), toks)
    assert K.launch_counts() == {
        "matmul": 1, "ag_gemm": 2, "gemm_rs": 2, "flash_attention": 2, "grouped_matmul": 16, "ssd_intra_chunk": 0
    }  # fmt: skip
    torch.testing.assert_close(lf, le, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(af, ae, atol=1e-6, rtol=1e-5)


def test_fused_mamba_prefill_matches_eager_on_card(dev):
    """Reduced mamba2-2.7b (chunk 16, headdim 16, S = 20: a ragged last
    chunk): in/out projections on the fused ring kernels, the SSD
    intra-chunk term on its kernel; the caches agree too."""
    cfg = reduce_config(get_config("mamba2-2.7b"))
    world = World(4, dev)
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    K.reset_launch_counts()
    lf, cf = lm.prefill(params, cfg, ParallelContext(world=world), toks, max_len=24)
    assert K.launch_counts() == {
        "matmul": 1, "ag_gemm": 2, "gemm_rs": 2, "flash_attention": 0, "grouped_matmul": 0, "ssd_intra_chunk": 2
    }  # fmt: skip
    le, ce = lm.prefill(params, cfg, ParallelContext(world=world, backend="eager"), toks, max_len=24)
    torch.testing.assert_close(lf, le, atol=2e-3, rtol=2e-3)
    for a, b in zip(cf, ce):
        torch.testing.assert_close(a["ssm"], b["ssm"], atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(a["conv"], b["conv"], atol=1e-4, rtol=1e-4)


def test_fused_deepseek_prefill_matches_eager_on_card(dev):
    """Reduced deepseek-moe-16b: the dense first layer and the shared-expert
    MLPs on the fused AG+GEMM / GEMM+RS pair, the routed experts on the
    grouped kernel."""
    cfg = reduce_config(get_config("deepseek-moe-16b"))
    world = World(4, dev)
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    K.reset_launch_counts()
    lf, af = lm.forward(params, cfg, ParallelContext(world=world), toks)
    assert K.launch_counts() == {
        "matmul": 1, "ag_gemm": 6, "gemm_rs": 6, "flash_attention": 3, "grouped_matmul": 16, "ssd_intra_chunk": 0
    }  # fmt: skip
    le, ae = lm.forward(params, cfg, ParallelContext(world=world, backend="eager"), toks)
    torch.testing.assert_close(lf, le, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(af, ae, atol=1e-6, rtol=1e-5)


# ---- the serving engine: captured step against the same step run eagerly ----


def _engine_requests(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [
        Request(tokens=rng.integers(0, vocab, size=int(rng.integers(3, 21))), max_new_tokens=int(rng.integers(2, 10)),
                temperature=0.8 if i % 3 == 1 else 0.0, top_k=8 if i % 3 == 1 else 0, seed=100 + i)
        for i in range(n)
    ]  # fmt: skip


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m", "deepseek-moe-16b", "mamba2-2.7b"])
def test_captured_engine_matches_eager_engine_bitwise(dev, arch, dtype):
    """Reduced configs: the two captured graphs give the eager step's tokens
    bit for bit (greedy and sampled requests, slots reused), with 2 captures
    for the engine's lifetime and one host sync per step; deepseek-moe-16b
    replays the streamed MoE decode (``moe_decode_stream``) in its graphs."""
    cfg = reduce_config(get_config(arch))
    world = World(4, dev)
    pc = ParallelContext(world=world, moe_decode_stream=arch == "deepseek-moe-16b")
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), dtype)
    reqs = _engine_requests(cfg.vocab_size, 7, seed=1)
    outs, engines = {}, {}
    for capture in (True, False):
        eng = ServeEngine(cfg, pc, params, max_len=32, n_slots=3, prefill_chunk=8, decode_block=6, capture=capture)
        handles = [eng.submit(r) for r in reqs]
        outs[capture] = [eng.drain()[h].tolist() for h in handles]
        engines[capture] = eng
    assert outs[True] == outs[False]
    assert [len(o) for o in outs[True]] == [r.max_new_tokens for r in reqs]
    cap, eager = engines[True], engines[False]
    assert cap.stats["graph_captures"] == 2 and eager.stats["graph_captures"] == 0
    for eng in (cap, eager):
        assert eng.stats["host_syncs"] == eng.stats["steps"] > 0
    # the LM head: one launch per forward and per decode iteration, counted by
    # the wrapper on the eager engine and by the engine's replays when captured
    assert cap.stats["launches"]["matmul"] == eager.stats["launches"]["matmul"] > cap.stats["steps"]


def test_captured_engine_matches_per_token_decoding(dev):
    """float32, greedy: the captured engine's tokens against ``lm.decode_step``
    one token at a time (the reduced smollm-360m)."""
    cfg = reduce_config(get_config("smollm-360m"))
    world = World(4, dev)
    pc = ParallelContext(world=world)
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.float32)
    reqs = [r for r in _engine_requests(cfg.vocab_size, 6, seed=2) if r.temperature == 0]
    eng = ServeEngine(cfg, pc, params, max_len=32, n_slots=2, prefill_chunk=8, decode_block=6)
    handles = [eng.submit(r) for r in reqs]
    outs = eng.drain()
    for r, h in zip(reqs, handles):
        caches = lm.init_caches(cfg, pc, 1, 32, torch.float32)
        seq = list(r.tokens) + outs[h].tolist()
        for t in range(len(seq) - 1):
            lg, caches = lm.decode_step(params, caches, cfg, pc, torch.tensor([[seq[t]]], device=dev), t)
            if t >= len(r.tokens) - 1:
                row = lg[0, 0]
                assert row.max().item() - row[seq[t + 1]].item() < 1e-3  # the argmax, or a near tie


# ---- the paper's TP-MLP: fused against the tensor-core baselines -----------


@pytest.mark.parametrize("world_size", [4, 8])
def test_paper_mlp_fused_matches_baseline(dev, world_size):
    """A reduced paper shape (S 1024, H 512, I 1408) in bf16: Fig. 8's
    full_mlp and Tab. 2's cases, each against its non-overlap result."""
    world = World(world_size, dev)
    x, w1, w2 = paper_mlp.mlp_operands(world, 1024, 512, 1408, torch.bfloat16)
    xr = _rand(dev, torch.bfloat16, world_size, 1024, 1408 // world_size, seed=3)
    fns = paper_mlp.tab2_fns(world)
    with fp32_reductions():
        K.reset_launch_counts()
        out = paper_mlp.full_mlp("overlap", world)(x, w1, w2)
        assert K.launch_counts()["ag_gemm"] == 1 and K.launch_counts()["gemm_rs"] == 1
        _close(out, paper_mlp.full_mlp("non-overlap", world)(x, w1, w2), torch.bfloat16)
        for case, fn in fns.items():
            a, b = (x, w1[..., : 1408 // world_size].contiguous()) if case.startswith("AG") else (xr, w2)
            _close(fn(a, b), fns[case.split("/")[0] + "/non-overlap"](a, b), torch.bfloat16)


def test_bf16_baselines_run_on_tensor_cores_against_f32(dev):
    """bf16 operands, float32 accumulation (float32 partials before the
    reduce), one rounding: within 2e-2 of the float32 baseline's max."""
    world = World(4, dev)
    ch = BlockChannel(axis="model")
    for kind, xs, ws in (("ag_matmul", (4, 2, 48, 256), (4, 256, 136)), ("matmul_rs", (4, 2, 192, 96), (4, 96, 264))):
        x, w = _rand(dev, torch.bfloat16, *xs, seed=4), _rand(dev, torch.bfloat16, *ws, scale=0.1, seed=5)
        fn = compile_overlap(kind, ch, world=world, overlapped=False)
        with fp32_reductions():
            out = fn(x, w)
        assert out.dtype == torch.bfloat16
        _close(out, fn(x.float(), w.float()), torch.bfloat16)


def test_eager_bf16_expert_gemm_runs_on_tensor_cores(dev):
    """The MoE baseline's expert GEMM (``core/moe_overlap._expert_gemm``, eager)
    on a bf16 operand pair: within 2e-2 of a float32-accumulated oracle, and
    faster than any float32 GEMM could be at the card's float32 peak (67
    TFLOP/s without TF32, which the fixture keeps off), so it ran on the
    tensor cores; the float32 route stays the float32 product."""
    a = _rand(dev, torch.bfloat16, 4, 16, 512, 2048, seed=6)  # [W, E_loc, rows, K]
    w = _rand(dev, torch.bfloat16, 4, 16, 2048, 2816, seed=7, scale=2048**-0.5)
    oracle = torch.matmul(a.float(), w.float())
    with fp32_reductions():
        for out_dtype in (torch.float32, torch.bfloat16):
            out = moe_overlap._expert_gemm(a, w, out_dtype, None, False)
            assert out.dtype == out_dtype and out.shape == (4, 16, 512, 2816)
            _close(out, oracle, torch.bfloat16)
        flops = 2 * a.numel() * w.shape[-1]
        f32_floor_ms = flops / 67e12 * 1e3
        fn = lambda: moe_overlap._expert_gemm(a, w, torch.float32, None, False)  # noqa: E731
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(10):
            fn()
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1) / 10
    assert ms < f32_floor_ms / 2, (ms, f32_floor_ms)
    assert torch.equal(moe_overlap._expert_gemm(a.float(), w.float(), torch.float32, None, False), oracle)


# ---- the RS -> AG seam and the expert-parallel MoE pair -----------------------


@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2, 4))))
def test_eager_seam_equals_unfused_pair_bitwise_on_card(dev, order, nch):
    """float32: the seam runs the unfused pair's products (the same GEMM
    shapes) and glue in its order, so the two agree bitwise on the card too;
    ``pc.matmul_rs_ag`` on the fused backend is that eager seam."""
    world = World(4, dev)
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    x, w1 = _rand(dev, torch.float32, 4, 2, 256, 64, seed=1), _rand(dev, torch.float32, 4, 64, 96, scale=0.1, seed=2)
    w2, res = _rand(dev, torch.float32, 4, 96, 40, scale=0.1, seed=3), _rand(dev, torch.float32, 4, 2, 64, 96, seed=4)
    ln = _rand(dev, torch.float32, 96, scale=0.1, seed=5)
    glue = lambda y: layers.rms_norm(y, ln)  # noqa: E731
    y, g = compile_overlap(["matmul_rs", "ag_matmul"], ch, world=world)(x, w1, w2, residual=res, glue=glue)
    y_u = res + compile_overlap("matmul_rs", ch, world=world)(x, w1)
    g_u = compile_overlap("ag_matmul", ch, world=world)(glue(y_u), w2)
    assert torch.equal(y, y_u) and torch.equal(g, g_u)
    y2, g2 = ParallelContext(world=world, channel=ch).matmul_rs_ag(x, w1, w2, residual=res, glue=glue)
    assert torch.equal(y2, y) and torch.equal(g2, g)


def _a2a_operands(dev, dtype, world, d=64, f=48, e=16, m_loc=32, batch=2):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((world, batch, m_loc, d), generator=g, device=dev)
    wr = torch.randn((d, e), generator=g, device=dev)
    ids, wts, _ = moe_overlap.moe_router(x, wr, num_experts=e, top_k=2)
    wgu = torch.randn((world, e // world, d, 2 * f), generator=g, device=dev) * d**-0.5
    wdn = torch.randn((world, e // world, f, d), generator=g, device=dev) * f**-0.5
    return x.to(dtype), ids, wts, wgu.to(dtype), wdn.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2))))
def test_fused_a2a_moe_matches_eager_on_card(dev, dtype, order, nch):
    """The a2a pair on "fused" (each landed tile's expert GEMMs on the
    grouped kernel, 2 launches per step and channel) against "eager" and
    the baseline, on the same routing."""
    world = World(4, dev)
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    args = _a2a_operands(dev, dtype, 4)
    K.reset_launch_counts()
    out = compile_overlap(["a2a_dispatch", "combine_rs"], ch, world=world, backend="fused")(*args, capacity_factor=0.5)
    assert K.launch_counts()["grouped_matmul"] == 2 * 4 * nch
    with fp32_reductions():
        eager = compile_overlap(["a2a_dispatch", "combine_rs"], ch, world=world)(*args, capacity_factor=0.5)
        base = compile_overlap(["a2a_dispatch", "combine_rs"], ch, world=world, overlapped=False)(
            *args, capacity_factor=0.5
        )
    assert out.dtype == dtype and out.shape == args[0].shape
    _close(out, eager, dtype)
    _close(base, eager, dtype)


def test_fused_ep_prefill_matches_eager_on_card(dev):
    """Reduced deepseek-moe-16b with ``ep_axis``: the routed experts through
    the a2a pair on the grouped kernel (2 x W launches per MoE layer), the
    dense first layer and the shared MLPs on the fused pair; and forward
    with ``fuse_seams`` on both backends."""
    cfg = reduce_config(get_config("deepseek-moe-16b"))
    world = World(4, dev)
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    pf = ParallelContext(world=world, ep_axis="model")
    K.reset_launch_counts()
    lf, _ = lm.prefill(params, cfg, pf, toks, max_len=20)
    assert K.launch_counts()["grouped_matmul"] == 2 * 4 * (cfg.n_layers - cfg.moe.first_k_dense)
    le, _ = lm.prefill(params, cfg, ParallelContext(world=world, backend="eager", ep_axis="model"), toks, max_len=20)
    torch.testing.assert_close(lf, le, atol=2e-3, rtol=2e-3)
    lt, _ = lm.prefill(params, cfg, ParallelContext(world=world), toks, max_len=20)
    torch.testing.assert_close(lf, lt, atol=2e-3, rtol=2e-3)
    for backend in ("eager", "fused"):
        pc = ParallelContext(world=world, backend=backend)
        ls, _ = lm.forward(params, cfg, dataclasses.replace(pc, fuse_seams=True), toks)
        lu, _ = lm.forward(params, cfg, pc, toks)
        if backend == "eager":
            assert torch.equal(ls, lu)
        else:
            torch.testing.assert_close(ls, lu, atol=2e-3, rtol=2e-3)


# --- training: the backward of the fused kernels (smollm-360m's shapes, W = 4, 8 x 256 tokens) ---

# (kind, forward x, forward w): the backward's input gradient runs the other fused kernel at
# gemm_rs [4, 8, 256, 512] x [4, 512, 960] (qkv), [4, 8, 256, 1280] x [4, 1280, 960] (gate/up),
# ag_gemm [4, 8, 64, 960] x [4, 960, 256] (o-proj), [4, 8, 64, 960] x [4, 960, 640] (down)
TRAIN_SHAPES = {
    "qkv": ("ag_matmul", (4, 8, 64, 960), (4, 960, 512)),
    "gate_up": ("ag_matmul", (4, 8, 64, 960), (4, 960, 1280)),
    "o_proj": ("matmul_rs", (4, 8, 256, 256), (4, 256, 960)),
    "down": ("matmul_rs", (4, 8, 256, 640), (4, 640, 960)),
}


def _fn_grads(fn, x, w, dy):
    x, w = x.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    out = fn(x, w)
    out.backward(dy)
    return [out.detach(), x.grad, w.grad]


@pytest.mark.parametrize("tag", sorted(TRAIN_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_function_grads_at_train_shapes(dev, tag, dtype):
    """The kind's autograd Function on the card (dx through the other fused
    kernel, dw from the gathered rows) against torch.autograd through the
    eager executor in float32 on the same values."""
    kind, xs, ws = TRAIN_SHAPES[tag]
    world = World(4, dev)
    x, w = _rand(dev, dtype, *xs), _rand(dev, dtype, *ws, scale=ws[1] ** -0.5, seed=1)
    fused = compile_overlap(kind, BlockChannel(axis="model"), world=world, backend="fused")
    eager = compile_overlap(kind, BlockChannel(axis="model"), world=world, backend="eager")
    y = fused(x, w)
    dy = _rand(dev, dtype, *y.shape, seed=2)
    K.reset_launch_counts()
    got = _fn_grads(fused, x, w, dy)
    other = "gemm_rs" if kind == "ag_matmul" else "ag_gemm"
    own = "ag_gemm" if kind == "ag_matmul" else "gemm_rs"
    assert K.launch_counts()[own] == 1 and K.launch_counts()[other] == 1
    ref = _fn_grads(eager, x.float(), w.float(), dy.float())
    for a, b in zip(got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        _close(a, b, dtype)


@pytest.mark.parametrize("tag", sorted(TRAIN_SHAPES))
def test_fused_backward_bitwise_bf16(dev, tag):
    """bf16: 20 forward + backward launches give bitwise equal gradients."""
    kind, xs, ws = TRAIN_SHAPES[tag]
    x, w = _rand(dev, torch.bfloat16, *xs), _rand(dev, torch.bfloat16, *ws, scale=ws[1] ** -0.5, seed=1)
    fused = compile_overlap(kind, BlockChannel(axis="model"), world=World(4, dev), backend="fused")
    dy = _rand(dev, torch.bfloat16, *fused(x, w).shape, seed=2)
    first = _fn_grads(fused, x, w, dy)
    for _ in range(19):
        assert all(torch.equal(a, b) for a, b in zip(_fn_grads(fused, x, w, dy), first))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_grads_on_card(dev, dtype):
    """Flash attention's Function at smollm's train shape (q [128, 256, 64],
    kv [64, 256, 64], causal): the kernel forward with its statistics, the
    backward from the saved log-sum-exp, against autograd through the plain
    version in float32."""
    q = _rand(dev, dtype, 128, 256, 64)
    k, v = _rand(dev, dtype, 64, 256, 64, seed=1), _rand(dev, dtype, 64, 256, 64, seed=2)
    do = _rand(dev, dtype, 128, 256, 64, seed=3)

    def grads(fn, *args):
        args = [a.detach().clone().requires_grad_(True) for a in args]
        out = fn(*args)
        out.backward(do.to(out.dtype))
        return [out.detach()] + [a.grad for a in args]

    K.reset_launch_counts()
    got = grads(lambda *a: K.flash_attention(*a, causal=True), q, k, v)
    assert K.launch_counts()["flash_attention"] == 1
    ref = grads(lambda *a: K.flash_attention_plain(*a, causal=True), q.float(), k.float(), v.float())
    for a, b in zip(got, ref):
        assert a.dtype == dtype
        _close(a, b, dtype)


def test_every_smollm_leaf_gets_a_gradient_on_the_fused_backend(dev):
    """smollm-360m at its published size (bf16, W = 4, 2 x 256 tokens): one
    forward and backward on the fused backend; every trainable leaf gets a
    finite, nonzero gradient (none silently stops at a kernel) and the
    kernels launch as the train step's contract says."""
    from repro_torch.training.steps import loss_and_grads
    from repro_torch.training.optimizer import tree_leaves

    cfg = get_config("smollm-360m")
    world = World(4, dev)
    pc = ParallelContext(world=world)
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (2, 257), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    K.reset_launch_counts()
    loss, _, _, grads = loss_and_grads(lm, cfg, pc, params, {"inputs": toks[:, :-1], "labels": toks[:, 1:]})
    assert K.launch_counts() == {"matmul": 1, "ag_gemm": 4 * cfg.n_layers, "gemm_rs": 4 * cfg.n_layers,
                                 "flash_attention": cfg.n_layers, "grouped_matmul": 0, "ssd_intra_chunk": 0}  # fmt: skip
    leaves = tree_leaves(grads)
    assert len(leaves) == 2 + 6 * cfg.n_layers and torch.isfinite(loss)
    for g in leaves:
        assert g is not None and g.dtype == torch.bfloat16 and torch.isfinite(g).all() and g.abs().max() > 0


def test_remat_dots_equals_none_on_card(dev):
    """Reduced smollm-360m (bf16, W = 4): remat_policy="dots" (each layer
    recomputed in the backward, its kernels launched again) gives the
    gradients of "none" bitwise; "none" launches the train step's count."""
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.steps import loss_and_grads

    cfg = reduce_config(get_config("smollm-360m"))
    world = World(4, dev)
    pc = ParallelContext(world=world)
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for policy in ("none", "dots"):
        K.reset_launch_counts()
        out[policy] = loss_and_grads(lm, cfg, pc, params, batch, remat_policy=policy)
        out[policy + "_counts"] = K.launch_counts()
    assert out["none_counts"]["ag_gemm"] == out["none_counts"]["gemm_rs"] == 4 * cfg.n_layers
    assert out["dots_counts"]["ag_gemm"] == 6 * cfg.n_layers  # the recomputed forward's two AG+GEMMs a layer
    assert torch.equal(out["none"][0], out["dots"][0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out["none"][3]), tree_leaves(out["dots"][3])))


# --- the dense configs of the e2e figure: new shapes of kernels #2-#4, and the baseline mode's gradients ---

# W = 4 per-rank widths at the published sizes, 1 x 512 tokens: qwen2-72b's gate|up AG+GEMM
# [4, 1, 128, 8192] x [4, 8192, 14784], gemma3-27b's down GEMM+RS [4, 1, 512, 5376] x [4, 5376, 5376]
E2E_SHAPES = {
    "qwen2_gate_up": ("ag_gemm", (4, 1, 128, 8192), (4, 8192, 14784)),
    "gemma3_down": ("gemm_rs", (4, 1, 512, 5376), (4, 5376, 5376)),
}


@pytest.mark.parametrize("tag", sorted(E2E_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_at_the_e2e_shapes(dev, tag, dtype):
    name, xs, ws = E2E_SHAPES[tag]
    fan_in = ws[1] * (4 if name == "gemm_rs" else 1)  # GEMM+RS sums over the 4 ranks too
    x, w = _rand(dev, dtype, *xs), _rand(dev, dtype, *ws, scale=fan_in**-0.5, seed=1)
    kernel, plain = getattr(K, name), getattr(K, name + "_plain")
    _close(kernel(x, w), plain(x.float(), w.float()), dtype)
    assert getattr(K, name).last_launch["route"] == ("wgmma" if dtype == torch.bfloat16 else "fma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_windowed_d128_at_4096(dev, dtype):
    """gemma3-27b's local layer at W = 4, 1 x 4096 tokens: q [32, 4096, 128],
    kv [16, 4096, 128], causal, window 1024; the KV tiles outside the window
    are skipped (items), the output against the plain version."""
    q = _rand(dev, dtype, 32, 4096, 128)
    k, v = _rand(dev, dtype, 16, 4096, 128, seed=1), _rand(dev, dtype, 16, 4096, 128, seed=2)
    K.flash_attention(q, k, v, causal=True)
    items_full = K.flash_attention.last_launch["items"]
    out = K.flash_attention(q, k, v, causal=True, window=1024)
    _close(out, K.flash_attention_plain(q.float(), k.float(), v.float(), causal=True, window=1024), dtype)
    full = sum(fa_mod.kv_tiles(q0, 4096, 4096, True, None)[1] for q0 in range(0, 4096, fa_mod.TILE))
    win = sum(fa_mod.kv_tiles(q0, 4096, 4096, True, 1024)[1] for q0 in range(0, 4096, fa_mod.TILE))
    assert win < full / 2 and K.flash_attention.last_launch["items"] * full == items_full * win


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_baseline_mode_grads_on_card(dev, dtype):
    """ParallelContext(mode="baseline") on the fused backend: the baselines'
    autograd Functions (a bf16 GEMM is torch.bmm with out_dtype=float32,
    which has no derivative) against float32 autograd through the eager
    executor, at qwen2-72b's qkv (AG) and o-proj (RS) per-rank widths;
    no fused collective launches."""
    world = World(4, dev)
    pc = ParallelContext(world=world, mode="baseline")
    assert pc.fused
    for kind, xs, ws in (
        ("ag_matmul", (4, 1, 64, 8192), (4, 8192, 2560)),
        ("matmul_rs", (4, 1, 256, 2048), (4, 2048, 8192)),
    ):
        x, w = _rand(dev, dtype, *xs), _rand(dev, dtype, *ws, scale=ws[1] ** -0.5, seed=1)
        y = getattr(pc, kind)(x, w)
        dy = _rand(dev, dtype, *y.shape, seed=2)
        K.reset_launch_counts()
        with fp32_reductions():
            got = _fn_grads(getattr(pc, kind), x, w, dy)
        assert not any(K.launch_counts().values())
        eager = compile_overlap(kind, BlockChannel(axis="model"), world=world, backend="eager")
        ref = _fn_grads(eager, x.float(), w.float(), dy.float())
        for a, b in zip(got, ref):
            assert a.dtype == dtype and a.shape == b.shape
            _close(a, b, dtype)


def test_baseline_train_step_on_card_matches_overlap(dev):
    """Reduced qwen2-72b (its QKV bias non-zero) and gemma3-27b (window 16),
    2 layers each, bf16, W = 4: one forward and backward in the baseline mode launches
    flash attention and the head but no fused collective, and its loss and
    gradients agree with the overlap mode's (2e-2 of each leaf's max)."""
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.steps import loss_and_grads

    for arch in ("qwen2-72b", "gemma3-27b"):
        cfg = dataclasses.replace(reduce_config(get_config(arch)), local_window=16, n_layers=2)
        world = World(4, dev)
        params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
        for layer in params["layers"] if cfg.qkv_bias else []:
            layer["mixer"]["bqkv"] = _rand(dev, torch.bfloat16, *layer["mixer"]["bqkv"].shape, scale=0.5)
        gen = torch.Generator(device=dev).manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen, device=dev)
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        out = {}
        for mode in ("baseline", "overlap"):
            K.reset_launch_counts()
            with fp32_reductions():
                out[mode] = loss_and_grads(lm, cfg, ParallelContext(world=world, mode=mode), params, batch)
            counts = K.launch_counts()
            n = cfg.n_layers if mode == "overlap" else 0
            assert (counts["ag_gemm"], counts["gemm_rs"], counts["flash_attention"], counts["matmul"]) == (
                4 * n, 4 * n, cfg.n_layers, 1)
        torch.testing.assert_close(out["baseline"][0], out["overlap"][0], atol=2e-2, rtol=2e-2)
        for a, b in zip(tree_leaves(out["baseline"][3]), tree_leaves(out["overlap"][3])):
            _close(a, b, torch.bfloat16)


# --- MoE training: the grouped GEMM's autograd Function at the backward shapes, the tensor-core expert GEMM's ---

# (groups, rows a group, K, N): granite-moe-3b-a800m's gate|up [1536 -> 1024] and down [512 -> 1536] at 40
# groups (4 ranks x 10 experts) of 192 rows (8 x 256 tokens) and 264 rows (1 x 4096); deepseek-moe-16b's
# [2048 -> 2816] and [1408 -> 2048] at 64 groups of 64 and 128 rows.  dx runs the kernel on w^T [G, N, K].
MOE_BACKWARD = {
    f"{arch}_{tag}_{rows}": (groups, rows, k, n)
    for arch, groups, rows_, shapes in (
        ("granite", 40, (192, 264), (("gate_up", 1536, 1024), ("down", 512, 1536))),
        ("deepseek", 64, (64, 128), (("gate_up", 2048, 2816), ("down", 1408, 2048))),
    )
    for rows in rows_
    for tag, k, n in shapes
}


def _grouped_grads(x, w, table, rows, dy, out_dtype):
    x, w = x.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    out = K.grouped_matmul(x, w, table, out_dtype=out_dtype, group_rows=rows)
    out.backward(dy)
    return [out.detach(), x.grad, w.grad]


@pytest.mark.parametrize("tag", sorted(MOE_BACKWARD))
def test_grouped_function_grads_at_moe_backward_shapes(dev, tag):
    """``_GroupedMatmul`` in bf16 (gate|up stores float32, so its dy is
    float32 and reaches the kernel in bf16): the output, dx (the kernel on
    w^T, one launch) and dw (one tensor-core product per group) against
    autograd through the plain version in float32, 2e-2 of max; three
    forward + backward runs bitwise equal."""
    groups, rows, k, n = MOE_BACKWARD[tag]
    out_dtype = torch.float32 if "gate_up" in tag else torch.bfloat16
    table = group_tile_table(groups, rows, dev)
    x = _rand(dev, torch.bfloat16, groups * rows, k)
    w = _rand(dev, torch.bfloat16, groups, k, n, seed=1, scale=k**-0.5)
    dy = _rand(dev, out_dtype, groups * rows, n, seed=2)
    K.reset_launch_counts()
    with fp32_reductions():
        got = _grouped_grads(x, w, table, rows, dy, out_dtype)
        assert K.launch_counts()["grouped_matmul"] == 2 and K.grouped_matmul.last_launch["route"] == "wgmma"
        x32, w32 = x.float().requires_grad_(True), w.float().requires_grad_(True)
        ref = K.grouped_matmul_plain(x32, w32, table)
        ref.backward(dy.float())
        for a, b, dt in zip(got, (ref.detach(), x32.grad, w32.grad), (out_dtype, torch.bfloat16, torch.bfloat16)):
            assert a.dtype == dt
            _close(a, b, torch.bfloat16)
        for _ in range(2):
            assert all(torch.equal(a, b) for a, b in zip(_grouped_grads(x, w, table, rows, dy, out_dtype), got))


def test_grouped_function_general_table_on_card(dev):
    """A random, non-monotone table with empty tiles (-1 and E), no
    ``group_rows``: dw summed by the table (deterministic), zero dx rows on
    the empty tiles; float32 and bf16 against float32 autograd of the plain
    version."""
    te = torch.tensor([2, -1, 0, 4, 5, 1, 2, 3, 0, 4], dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        x, w = _rand(dev, dtype, 10 * 48, 136), _rand(dev, dtype, 5, 136, 200, seed=1, scale=136**-0.5)
        dy = _rand(dev, dtype, 10 * 48, 200, seed=2)
        got = _grouped_grads(x, w, te, None, dy, dtype)
        x32, w32 = x.float().requires_grad_(True), w.float().requires_grad_(True)
        ref = K.grouped_matmul_plain(x32, w32, te)
        ref.backward(dy.float())
        for a, b in zip(got, (ref.detach(), x32.grad, w32.grad)):
            _close(a, b, dtype)
        assert not got[1][48:96].any()  # the -1 tile: zero dx rows
        assert all(torch.equal(a, b) for a, b in zip(_grouped_grads(x, w, te, None, dy, dtype), got))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_expert_bmm_function_grads(dev, out_dtype):
    """The MoE baselines' tensor-core expert GEMM under autograd
    (``moe_overlap._ExpertBmm``: ``torch.bmm(out_dtype=float32)`` has no
    derivative), bf16 at granite's gate|up: the output and both gradients
    against float32 autograd, 2e-2 of max; the forward bitwise the call
    without grad."""
    a = _rand(dev, torch.bfloat16, 4, 10, 264, 1536, seed=6)
    w = _rand(dev, torch.bfloat16, 4, 10, 1536, 1024, seed=7, scale=1536**-0.5)
    dy = _rand(dev, out_dtype, 4, 10, 264, 1024, seed=8)
    with fp32_reductions():
        got = _fn_grads(lambda a_, w_: moe_overlap._expert_gemm(a_, w_, out_dtype, None, False), a, w, dy)
        with torch.no_grad():
            assert torch.equal(got[0], moe_overlap._expert_gemm(a, w, out_dtype, None, False))
    ref = _fn_grads(lambda a_, w_: torch.matmul(a_, w_), a.float(), w.float(), dy.float())
    for g, r, dt in zip(got, ref, (out_dtype, torch.bfloat16, torch.bfloat16)):
        assert g.dtype == dt
        _close(g, r, torch.bfloat16)


@pytest.mark.parametrize("ep", [None, "model"])
def test_moe_train_grads_fused_match_eager_on_card(dev, ep):
    """Reduced granite-moe-3b-a800m and deepseek-moe-16b in float32, W = 4,
    2 x 64 tokens, TP double ring or EP a2a: every leaf's gradient on the
    fused backend (grouped kernel forward and dx) within 1e-4 of its max
    |eager|, 4 x W grouped launches per MoE layer."""
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.steps import loss_and_grads

    for arch in ("granite-moe-3b-a800m", "deepseek-moe-16b"):
        cfg = reduce_config(get_config(arch))
        world = World(4, dev)
        params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.float32)
        toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        out = {}
        for backend in ("fused", "eager"):
            K.reset_launch_counts()
            out[backend] = loss_and_grads(lm, cfg, ParallelContext(world=world, backend=backend, ep_axis=ep), params, batch)
            out[backend + "_counts"] = K.launch_counts()
        moe = sum(d.ffn_kind == "moe" for d in lm.layer_plan(cfg))
        assert out["fused_counts"]["grouped_matmul"] == 4 * 4 * moe and not any(out["eager_counts"].values())
        torch.testing.assert_close(out["fused"][0], out["eager"][0], atol=1e-5, rtol=1e-5)
        for a, b in zip(tree_leaves(out["fused"][3]), tree_leaves(out["eager"][3])):
            _close(a, b, torch.float32)


def _grads(fn, args, dy):
    """[fn's output, each argument's gradient] of ``fn(*args)`` against ``dy``."""
    args = [a.detach().clone().requires_grad_(True) for a in args]
    out = fn(*args)
    out.backward(dy)
    return [out.detach()] + [a.grad for a in args]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_chunk_function_grads(dev, dtype):
    """``_SsdIntraChunk`` on the card at the train path's tile (Q = P = 64,
    T = 2560 as mamba2-2.7b's 8 x 256 tokens give it): the kernel's forward
    (one launch) and the float32 torch-ops backward against float32
    autograd over the einsum form (decay masked before exp), 1e-4 (f32) or
    2e-2 (bf16) of max."""
    cum, cb, xdt = _ssd_intra_inputs(dev, dtype, 2560, 64, 64, 1.0, seed=4)
    dy = _rand(dev, dtype, *xdt.shape, seed=5)
    before = K.ssd_intra_chunk.launches
    got = _grads(K.ssd_intra_chunk, (cum, cb, xdt), dy)
    assert K.ssd_intra_chunk.launches == before + 1

    def einsum_form(c, b, x):
        tril = torch.ones((64, 64), dtype=torch.bool, device=dev).tril()
        decay = torch.exp(torch.where(tril, c[:, :, None] - c[:, None, :], float("-inf")))
        return torch.einsum("tij,tij,tjp->tip", b, decay, x)

    ref = _grads(einsum_form, (cum.float(), cb.float(), xdt.float()), dy.float())
    for a, b in zip(got, ref):
        assert a.dtype == dtype
        _close(a, b, dtype)


def _zamba2(dev):
    """Reduced zamba2-2.7b at its published head dim of 80 on the card."""
    cfg = dataclasses.replace(reduce_config(get_config("zamba2-2.7b")), head_dim=80)
    world = World(4, dev)
    return cfg, world, lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.float32)


def test_zamba2_shared_layer_fused_matches_eager_on_card(dev):
    """One shared attention block of reduced zamba2-2.7b (head dim 80, the
    shared mixer, its own GELU MLP) in float32, 2 x 64 tokens: the output
    and every gradient (the shared mixer's, the MLP's, the input's) on the
    fused backend (AG+GEMM / GEMM+RS both passes, flash at D 80) against the
    eager backend, 1e-4 of max; 4 / 4 / 1 launches."""
    cfg, world, params = _zamba2(dev)
    d = lm.layer_plan(cfg)[5]
    assert d.shared
    x = _rand(dev, torch.float32, 4, 2, 16, cfg.d_model, seed=3)
    dy = _rand(dev, torch.float32, *x.shape, seed=4)
    leaves = [params["shared_attn"][k] for k in ("ln", "wqkv", "wo")] + [params["layers"][5]["ffn"][k]
                                                                          for k in ("ln", "w_gu", "w_down")]  # fmt: skip

    def layer(backend):
        pc = ParallelContext(world=world, backend=backend)

        def fn(x_, *ws):
            shared = dict(zip(("ln", "wqkv", "wo"), ws[:3]))
            return d.apply_seq({"ffn": dict(zip(("ln", "w_gu", "w_down"), ws[3:]))}, x_, pc, cfg, shared)[0]

        return fn

    K.reset_launch_counts()
    got = _grads(layer("fused"), (x, *leaves), dy)
    counts = K.launch_counts()
    assert (counts["ag_gemm"], counts["gemm_rs"], counts["flash_attention"]) == (4, 4, 1), counts
    ref = _grads(layer("eager"), (x, *leaves), dy)
    for a, b in zip(got, ref):
        _close(a, b, torch.float32)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_train_grads_fused_match_eager_on_card(dev, arch):
    """Reduced mamba2-2.7b and zamba2-2.7b (head dim 80) in float32, W = 4,
    2 x 64 tokens, layers recomputed (remat "dots"): the loss within 1e-5
    and every leaf's gradient on the fused backend within 2e-3 of its max
    |eager| (the whole-model gradient bound of ``chip_smoke.py``: twelve
    float32 layers sum in another order); the launches of
    paper_e2e.expected_launches (the SSD kernel twice a Mamba layer, flash
    twice a shared block)."""
    from repro_torch.benchmarks.paper_e2e import expected_launches
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.steps import loss_and_grads

    if arch == "zamba2-2.7b":
        cfg, world, params = _zamba2(dev)
    else:
        cfg, world = reduce_config(get_config(arch)), World(4, dev)
        params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for backend in ("fused", "eager"):
        K.reset_launch_counts()
        pc = ParallelContext(world=world, backend=backend)
        out[backend] = loss_and_grads(lm, cfg, pc, params, batch, remat_policy="dots")
        out[backend + "_counts"] = K.launch_counts()
    assert out["fused_counts"] == expected_launches(cfg, "overlap", "dots") and not any(out["eager_counts"].values())
    torch.testing.assert_close(out["fused"][0], out["eager"][0], atol=1e-5, rtol=1e-5)
    for a, b in zip(tree_leaves(out["fused"][3]), tree_leaves(out["eager"][3])):
        torch.cuda.synchronize()
        assert (a - b).abs().max().item() <= 2e-3 * b.abs().max().item()


def _mm_grads(dev, arch):
    """Reduced seamless-m4t-medium (2 + 2 layers) or paligemma-3b (head dim
    256 as published, MQA at rep 4) in float32, W = 4, its train batch of 2
    rows from a seed (enc-dec: 64 decoder tokens, 128 frames; VLM: 32
    patches + 32 tokens): the loss and every leaf's gradient on both
    backends, with the fused launches."""
    from repro_torch.models import encdec, frontends
    from repro_torch.training.steps import loss_and_grads

    cfg = reduce_config(get_config(arch))
    if not cfg.encoder_layers:
        cfg = dataclasses.replace(cfg, head_dim=256)
    mod = encdec if cfg.encoder_layers else lm
    world = World(4, dev)
    params = mod.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.float32)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen, device=dev)
    if cfg.encoder_layers:
        emb = frontends.stub_frame_embeddings(gen, 2, 128, cfg.d_model, torch.float32, dev)
        batch = {"inputs": toks[:, :64], "labels": toks[:, 1:], "embeds": emb}
    else:
        emb = frontends.stub_patch_embeddings(gen, 2, 64, cfg.d_model, torch.float32, dev)
        batch = {"inputs": toks[:, :32], "labels": toks[:, 1:], "embeds": emb}
    out = {}
    for backend in ("fused", "eager"):
        K.reset_launch_counts()
        pc = ParallelContext(world=world, backend=backend)
        out[backend] = loss_and_grads(mod, cfg, pc, params, batch)
        out[backend + "_counts"] = K.launch_counts()
    return cfg, out


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "paligemma-3b"])
def test_multimodal_train_grads_fused_match_eager_on_card(dev, arch):
    """The encoder-decoder (non-causal encoder, cross-attention with Sq !=
    Sk, the encoder stream's kv gather on AG+GEMM) and the VLM (an image
    prefix, flash at head dim 256) in float32: the loss within 1e-5 and
    every leaf's gradient within 2e-3 of its max |eager| (the whole-model
    bound of ``chip_smoke.py``); every fused kernel launched once a
    forward use and once a transpose (enc-dec: 2 AG+GEMM, 2 GEMM+RS and 1
    flash an encoder layer, 4, 3 and 2 a decoder layer)."""
    from repro_torch.benchmarks.paper_e2e import expected_launches
    from repro_torch.training.optimizer import tree_leaves

    cfg, out = _mm_grads(dev, arch)
    if cfg.encoder_layers:
        e, d = cfg.encoder_layers, cfg.n_layers
        ag, rs = 2 * e + 4 * d, 2 * e + 3 * d
        want = {"matmul": 1, "ag_gemm": ag + rs, "gemm_rs": ag + rs, "flash_attention": e + 2 * d,
                "grouped_matmul": 0, "ssd_intra_chunk": 0}  # fmt: skip
    else:
        want = expected_launches(cfg, "overlap")
    assert out["fused_counts"] == want and not any(out["eager_counts"].values())
    torch.testing.assert_close(out["fused"][0], out["eager"][0], atol=1e-5, rtol=1e-5)
    for a, b in zip(tree_leaves(out["fused"][3]), tree_leaves(out["eager"][3])):
        torch.cuda.synchronize()
        assert (a - b).abs().max().item() <= 2e-3 * b.abs().max().item()


# ---- packed weights and the wire dtype (core/quant) -------------------------------------------

QUANT_PACKS = [("int8", False), ("int4", True)]


def _packed(dev, k, n, wdtype, zp, seed=1):
    from repro_torch.core.quant import QuantSpec, pack_weight

    w = _rand(dev, torch.float32, 4, k, n, scale=k**-0.5, seed=seed) + 0.01 * seed  # an offset: zero points matter
    return pack_weight(w, QuantSpec(weight_dtype=wdtype, zero_point=zp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdtype,zp", QUANT_PACKS)
@pytest.mark.parametrize("order,nch", [("ring", 1), ("bidir_ring", 2), ("all2all", 2)])
def test_packed_ag_gemm_kernel(dev, dtype, wdtype, zp, order, nch):
    """AG+GEMM with a PackedWeight on both routes, one launch, against its
    plain version (which replays the route's dequant formula); bf16 bitwise
    over 20 launches.  Ragged: 3 batch rows, 40 rows a rank, n = 208."""
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    x = _rand(dev, dtype, 4, 3, 40, 136)
    pw = _packed(dev, 136, 208, wdtype, zp)
    before = (K.ag_gemm.launches, K.ag_gemm.packed_launches)
    out = K.ag_gemm(x, pw, channel=ch)
    assert (K.ag_gemm.launches, K.ag_gemm.packed_launches) == (before[0] + 1, before[1] + 1)
    assert K.ag_gemm.last_launch["packed"]
    _close(out, K.ag_gemm_plain(x, pw, channel=ch), dtype)
    if dtype == torch.bfloat16:
        assert all(torch.equal(K.ag_gemm(x, pw, channel=ch), out) for _ in range(19))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdtype,zp", QUANT_PACKS)
@pytest.mark.parametrize("order,nch", [("ring", 1), ("bidir_ring", 2), ("all2all", 2)])
def test_packed_gemm_rs_kernel(dev, dtype, wdtype, zp, order, nch):
    """GEMM+RS with a PackedWeight on both routes against its plain version;
    C = 2 over N = 208 starts channel 1 off the 16-column boxes (a lead of 8)."""
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    x = _rand(dev, dtype, 4, 3, 160, 72)
    pw = _packed(dev, 72, 208, wdtype, zp)
    out = K.gemm_rs(x, pw, channel=ch)
    assert K.gemm_rs.last_launch["packed"]
    _close(out, K.gemm_rs_plain(x, pw, channel=ch), dtype)
    if dtype == torch.bfloat16:
        assert all(torch.equal(K.gemm_rs(x, pw, channel=ch), out) for _ in range(19))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order,nch", [("ring", 1), ("bidir_ring", 2)])
def test_gemm_rs_bf16_wire_kernel(dev, dtype, order, nch):
    """A bf16 wire under float32 accumulation: the recv slots in bf16, the
    plain version's split path; bf16 bitwise over 20 launches; and the
    float32 wire is bitwise the identity."""
    from repro_torch.core.quant import QuantSpec

    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    x, w = _rand(dev, dtype, 4, 2, 128, 96), _rand(dev, dtype, 4, 96, 160, scale=0.1, seed=2)
    wire = ch.with_(quant=QuantSpec(wire_dtype="bfloat16"))
    out = K.gemm_rs(x, w, channel=wire)
    assert K.gemm_rs.last_launch["wire"] == "bfloat16"
    _close(out, K.gemm_rs_plain(x, w, channel=wire), dtype)
    if dtype == torch.bfloat16:
        assert all(torch.equal(K.gemm_rs(x, w, channel=wire), out) for _ in range(19))
    f32 = ch.with_(quant=QuantSpec(wire_dtype="float32"))
    assert torch.equal(K.gemm_rs(x, w, channel=f32), K.gemm_rs(x, w, channel=ch))


def test_packed_kernels_raise_on_what_they_do_not_take(dev):
    """Shapes and operands the packed routes cannot take raise ValueError (no
    fallback): int8 rows of the bf16 route a multiple of 16 codes, the codes
    int8 and contiguous, scale / zero [W, n]; a quantized wire raises."""
    from repro_torch.core.quant import PackedWeight, QuantSpec

    x = _rand(dev, torch.bfloat16, 4, 1, 32, 64)
    odd = _packed(dev, 64, 72, "int8", False)  # 72 codes a row: not 16-byte TMA rows
    with pytest.raises(ValueError, match="16"):
        K.ag_gemm(x, odd)
    K.ag_gemm(x.float(), odd)  # the float32 route takes it
    with pytest.raises(ValueError, match="16"):
        K.gemm_rs(_rand(dev, torch.bfloat16, 4, 1, 32, 64), _packed(dev, 64, 72, "int8", False))
    good = _packed(dev, 64, 96, "int8", False)
    bad = PackedWeight(good.q.float(), good.scale, None, "int8")
    with pytest.raises(ValueError, match="int8"):
        K.ag_gemm(x, bad)
    with pytest.raises(ValueError, match="scale"):
        K.ag_gemm(x, PackedWeight(good.q, good.scale[:, :8].contiguous(), None, "int8"))
    with pytest.raises(NotImplementedError):
        K.gemm_rs(_rand(dev, torch.bfloat16, 4, 1, 32, 64), good,
                  channel=BlockChannel(axis="model", quant=QuantSpec(wire_dtype="int8")))


def test_packed_mlp_block_on_card(dev):
    """``nn/ffn.apply_seq`` on the fused backend with packed int8 weights
    against the eager backend with the same packing, float32: 1e-4."""
    from repro_torch.convert import shard_mlp
    from repro_torch.core.quant import QuantSpec, pack_weight
    from repro_torch.nn import ffn

    cfg = reduce_config(get_config("smollm-360m"))
    world = World(4, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    p = shard_mlp(ffn.init(cfg, g, torch.float32, dev), world)
    p = {"ln": p["ln"], **{k: pack_weight(p[k], QuantSpec(weight_dtype="int8")) for k in ("w_gu", "w_down")}}
    x = _rand(dev, torch.float32, 4, 2, 16, cfg.d_model)
    with torch.no_grad():
        fused = ffn.apply_seq(p, x, ParallelContext(world=world, backend="fused"), cfg)
        eager = ffn.apply_seq(p, x, ParallelContext(world=world, backend="eager"), cfg)
    _close(fused, eager, torch.float32)


# ---- the tuner on the card: candidates on the fused kernels, capture, cache ----------

# per-rank signatures: (lead, m_loc, K, n_loc) for AG+GEMM, (lead, M, k_loc, N) for GEMM+RS
TUNE_CASES = [("ag_matmul", (2, 96, 128, 320)), ("matmul_rs", (2, 256, 64, 320)), ("matmul_rs", (-8, 1, 64, 96))]


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    from repro_torch.tune import cache

    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune"))
    cache.clear_memo()
    yield tmp_path / "tune"
    cache.clear_memo()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,sig", TUNE_CASES)
def test_tuner_candidates_match_plain(dev, tune_cache, kind, sig, dtype):
    """Every candidate the measured ranker times on the fused backend (the
    JOINT space: the float32 route's n tiles, every order and C) launches
    its kernel, and its output holds against the plain version (f32 1e-4,
    bf16 2e-2 of max); the ranker measures with CUDA events."""
    from repro_torch import tune
    from repro_torch.tune import measure

    world = World(4, dev)
    target = tune.Target("fused", dev, dtype)
    cands = tune.enumerate_candidates(kind, extent=tune.chunk_extent(kind, sig), space=tune.JOINT_SPACE, sig=sig,
                                      world=4, target=target)  # fmt: skip
    assert len(cands) > 1
    case = measure.CaseTimer(kind, world, sig, backend="fused", dtype=dtype)
    plain = K.ag_gemm_plain if kind == "ag_matmul" else K.gemm_rs_plain
    wrapper = K.ag_gemm if kind == "ag_matmul" else K.gemm_rs
    for cand in cands:
        ch = cand.channel("model")
        before = wrapper.launches
        out = case.run(ch)
        assert wrapper.launches == before + 1
        _close(out, plain(*case.args, channel=ch), dtype)
        med, iqr = case.time(ch, repeats=3, warmup=1)
        assert 0 < med and 0 <= iqr
    res = tune.autotune(kind, signature=sig, world=world, backend="fused", dtype=dtype, space=tune.JOINT_SPACE)
    assert res.ranker == "measure" and res.candidate in cands and res.sweep["total"] == len(cands)


def test_tuner_cache_hit_and_capture_launch_nothing(dev, tune_cache):
    """A cache hit launches no kernel; resolving inside a CUDA graph capture
    (a new shape: the cost model; a cached one: the hit) launches nothing."""
    from repro_torch import tune

    world = World(4, dev)
    kw = dict(world=world, backend="fused", dtype=torch.bfloat16, space=tune.JOINT_SPACE)
    first = tune.autotune("ag_matmul", signature=(2, 96, 128, 320), **kw)
    assert first.ranker == "measure" and not first.cache_hit
    K.reset_launch_counts()
    hit = tune.autotune("ag_matmul", signature=(2, 96, 128, 320), **kw)
    assert hit.cache_hit and hit.candidate == first.candidate
    assert not any(K.launch_counts().values())
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph):
            new = tune.autotune("matmul_rs", signature=(2, 256, 64, 320), **kw)
            again = tune.autotune("ag_matmul", signature=(2, 96, 128, 320), **kw)
    assert new.ranker == "model" and again.cache_hit
    assert not any(K.launch_counts().values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tuned_engine_captured_matches_eager(dev, tune_cache, dtype):
    """A reduced smollm-360m engine with ``ParallelContext(tune=True)``
    resolves its four decode entries (measured) before the capture; its
    captured tokens equal its eager tokens bit for bit."""
    cfg = reduce_config(get_config("smollm-360m"))
    world = World(4, dev)
    pc = ParallelContext(world=world, tune=True)
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), dtype)
    reqs = _engine_requests(cfg.vocab_size, 6, seed=3)
    outs = {}
    for capture in (True, False):
        eng = ServeEngine(cfg, pc, params, max_len=32, n_slots=4, prefill_chunk=8, decode_block=6, capture=capture)
        assert set(eng.decode_channels) == {"qkv", "attn_out", "ffn_gu", "ffn_down"}
        assert eng.stats["graph_captures"] == (2 if capture else 0)
        handles = [eng.submit(r) for r in reqs]
        outs[capture] = [eng.drain()[h].tolist() for h in handles]
    assert outs[True] == outs[False]


# --- the kernels against kernels/ref, and training with fused seams ------------------------------------------

REF_CASES = ("matmul", "ag_gemm", "gemm_rs", "flash_causal", "flash_window_gqa", "flash_cross", "grouped")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", REF_CASES)
def test_kernel_against_ref(dev, case, dtype):
    """Each kernel against its float32 oracle in ``kernels/ref`` (no schedule),
    at ragged shapes; the same TOL as against the plain versions."""
    from repro_torch.kernels import ref

    r = lambda *shape, seed=0, scale=1.0: _rand(dev, dtype, *shape, seed=seed, scale=scale)  # noqa: E731
    if case == "matmul":
        x, w = r(200, 136), r(136, 264, seed=1, scale=0.1)
        got, want = K.matmul(x, w), ref.matmul_ref(x, w)
    elif case == "ag_gemm":
        x, w = r(4, 2, 72, 136), r(4, 136, 200, seed=1, scale=0.1)
        got, want = K.ag_gemm(x, w, channel=BlockChannel(axis="model", num_channels=2)), ref.ag_gemm_ref(x, w)
    elif case == "gemm_rs":
        x, w = r(4, 2, 144, 88), r(4, 88, 240, seed=1, scale=0.1)
        got, want = K.gemm_rs(x, w, channel=BlockChannel(axis="model", num_channels=2)), ref.gemm_rs_ref(x, w)
    elif case.startswith("flash"):
        bh, bhkv, sq, sk, kw = {
            "flash_causal": (8, 8, 200, 200, dict(causal=True)),
            "flash_window_gqa": (8, 2, 256, 256, dict(causal=True, window=70)),
            "flash_cross": (4, 4, 96, 160, dict(causal=False)),
        }[case]  # fmt: skip
        q, k, v = r(bh, sq, 64), r(bhkv, sk, 64, seed=1), r(bhkv, sk, 64, seed=2)
        got, want = K.flash_attention(q, k, v, **kw), ref.flash_attention_ref(q, k, v, **kw)
    else:
        table = torch.tensor([3, 0, 2, 2, 1, 3], dtype=torch.int32, device=dev)  # non-monotone, repeats
        x, w = r(6 * 64, 136), r(4, 136, 200, seed=1, scale=0.1)
        got, want = K.grouped_matmul(x, w, table), ref.grouped_matmul_ref(x, w, table, 64)
    _close(got, want, dtype)


def test_ssd_chunked_against_ssd_ref(dev):
    """``ssd_chunked`` with the intra-chunk kernel against the sequential
    ``ssd_ref`` (groups 2, an initial state, a ragged last chunk), float32."""
    from repro_torch.kernels import ref

    f32 = torch.float32
    x, b, c = _rand(dev, f32, 2, 150, 8, 64), _rand(dev, f32, 2, 150, 2, 32, seed=1), _rand(dev, f32, 2, 150, 2, 32, seed=2)
    dt = torch.nn.functional.softplus(_rand(dev, f32, 2, 150, 8, seed=3))
    a_log, h0 = _rand(dev, f32, 8, seed=4, scale=0.5), _rand(dev, f32, 2, 8, 32, 64, seed=5, scale=0.1)
    K.reset_launch_counts()
    got = mamba_ssd.ssd_chunked(x, dt, a_log, b, c, chunk=64, h_init=h0, intra="kernel")
    assert K.launch_counts()["ssd_intra_chunk"] == 1
    _close(got, ref.ssd_ref(x, dt, a_log, b, c, chunk=64, d_init=h0), f32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seamed_train_step_on_card(dev, dtype):
    """smollm-360m's width at 2 layers (W = 4, 2 x 256 tokens): the seamed
    loss and gradients on the fused backend against the eager backend's
    seamed ones (float32 2e-3 of each leaf's max; bf16 against the float32
    eager gradients, 5e-2), the launches paper_e2e.expected_launches gives,
    and one seamed make_train_step step."""
    from repro_torch.benchmarks import paper_e2e
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.steps import loss_and_grads

    cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=2)
    world = World(4, dev)
    seam = ParallelContext(world=world, fuse_seams=True)
    seam_eager = ParallelContext(world=world, backend="eager", fuse_seams=True)
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), dtype)
    toks = torch.randint(0, cfg.vocab_size, (2, 257), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    K.reset_launch_counts()
    loss, _, _, grads = loss_and_grads(lm, cfg, seam, params, batch)
    assert K.launch_counts() == paper_e2e.expected_launches(cfg, "overlap", "none", fuse_seams=True)
    p32 = params if dtype == torch.float32 else _f32_tree(params)
    loss_e, _, _, grads_e = loss_and_grads(lm, cfg, seam_eager, p32, batch)
    rtol = 2e-3 if dtype == torch.float32 else 5e-2
    assert abs(loss.item() - loss_e.item()) <= rtol * abs(loss_e.item())
    for a, b in zip(tree_leaves(grads), tree_leaves(grads_e)):
        assert (a.float() - b).abs().max().item() <= rtol * b.abs().max().item()
    step = make_train_step(lm, cfg, seam, AdamWConfig(), grad_masks=lm.grad_masks(cfg, seam))
    _, _, metrics = step(params, init_opt_state(lm.trainable(params, cfg)), batch)
    assert torch.isfinite(metrics["loss"])


def _f32_tree(tree):
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_f32_tree(v) for v in tree]
    return tree.float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_use_gather_on_card(dev, dtype):
    """ZeRO-3's use-time gather (``parallel/sharding.use_gather``) over the
    in-process World of 2 data replicas, on CUDA tensors: each replica's
    gathered leaves and the blocks' gradients bitwise equal to autograd
    through a plain gather (``torch.cat`` of the blocks) of the same blocks
    (a float32 and a ``dtype`` bucket; a leaf with no data dim untouched)."""
    from repro_torch.parallel.sharding import Spec, data_dim, place_data, use_gather

    axes, n = ("pod", "data"), 2
    data = World(n, dev)
    specs = {"wqkv": Spec("model", axes, None), "wo": Spec("model", None, axes), "bc": Spec(axes, None),
             "ln": Spec(None), "f32": Spec("model", axes)}  # fmt: skip
    shapes = {"wqkv": (4, 96, 40), "wo": (4, 24, 96), "bc": (96, 16), "ln": (96,), "f32": (4, 32)}
    whole = {k: _rand(dev, torch.float32 if k == "f32" else dtype, *shapes[k], seed=i) for i, k in enumerate(specs)}
    blocks = {k: place_data(v, specs[k], data, axes).requires_grad_(True) for k, v in whole.items()}
    plain = {k: b.detach().clone().requires_grad_(True) for k, b in blocks.items()}
    out = use_gather(blocks, specs, data, axes)
    ref = {}
    for k, b in plain.items():
        d = data_dim(specs[k], axes)
        ref[k] = b if d is None else torch.cat(list(b.unbind(0)), dim=d).unsqueeze(0).expand((n,) + whole[k].shape)
    cot = {k: _rand(dev, out[k].dtype, *out[k].shape, seed=10 + i) for i, k in enumerate(specs)}
    got = torch.autograd.grad(sum((out[k].float() * cot[k].float()).sum() for k in specs), list(blocks.values()))
    want = torch.autograd.grad(sum((ref[k].float() * cot[k].float()).sum() for k in specs), list(plain.values()))
    torch.cuda.synchronize()
    assert out["ln"] is blocks["ln"]
    for k in specs:
        assert out[k].device.type == "cuda" and torch.equal(out[k], ref[k]), k
    for k, g, w in zip(specs, got, want):
        assert g.dtype == blocks[k].dtype and torch.equal(g, w), k


# ---- the peer route: split receive pools on one card, and the TP world over cards

PEER_SHAPES = {"ag_gemm": ((4, 2, 40, 64), (4, 64, 136)), "gemm_rs": ((4, 2, 160, 72), (4, 72, 96))}


def _peer_operands(kind, dtype, device):
    """Seeded operands of every rank (made on the CPU: every card draws the same)."""
    xs, ws = PEER_SHAPES[kind]
    g = torch.Generator().manual_seed(5)
    x = torch.randn(xs, generator=g).to(dtype)
    w = (torch.randn(ws, generator=g) * (ws[0] * ws[1]) ** -0.5).to(dtype)
    return x.to(device), w.to(device)


@pytest.mark.parametrize("kind", list(PEER_SHAPES))
@pytest.mark.parametrize("order,nch", [(o, c) for o in ORDERS for c in (1, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_peer_route_split_pool_equals_the_one_allocation_route(dev, kind, order, nch, dtype):
    """Every rank's receive region its own cudaMalloc (system scope, epochs):
    two calls on one pool, never zeroed, each bitwise the one-allocation
    route; the second against the plain version."""
    x, w = _peer_operands(kind, dtype, dev)
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    fn = getattr(K, kind)
    one = fn(x, w, channel=ch)
    assert fn.last_launch["pool"] == "one"
    outs = [fn(x, w, channel=ch, split=True) for _ in range(2)]
    torch.cuda.synchronize()
    assert fn.last_launch["pool"] == "split"
    assert all(torch.equal(o, one) for o in outs)
    _close(outs[1], getattr(K, f"{kind}_plain")(x, w, channel=ch), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_peer_route_return_gathered_outlives_the_next_call(dev, dtype):
    """``return_gathered`` on the split pool (the training backward's
    operand): out and gathered bitwise the one-allocation route's, and call
    1's gathered operand (copied out of the pool on the launch's stream)
    unchanged after call 2, on other operands, overwrote the slots."""
    x1, w = _peer_operands("ag_gemm", dtype, dev)
    x2 = x1.flip(-1).contiguous()
    out1, g1 = K.ag_gemm(x1, w, return_gathered=True, split=True)
    kept = g1.clone()
    out2, g2 = K.ag_gemm(x2, w, return_gathered=True, split=True)
    torch.cuda.synchronize()
    assert K.ag_gemm.last_launch["pool"] == "split"
    for x, out, g in ((x1, out1, g1), (x2, out2, g2)):
        one_out, one_g = K.ag_gemm(x, w, return_gathered=True)
        assert torch.equal(out, one_out) and torch.equal(g, one_g)
        rows = x.transpose(0, 1).reshape(x.shape[1], -1, x.shape[-1])  # every rank's rows, rank-major
        assert torch.equal(g, rows.expand(x.shape[0], -1, -1, -1))
    assert torch.equal(g1, kept) and not torch.equal(g1, g2)


def _forced_logits(params, cfg, pc, job):
    """A reduced smollm's f32 prefill logits and its logits over ``job["forced"]``
    decode steps, each fed the given token (teacher-forced, so both worlds
    decode the same context)."""
    dev = pc.device
    prompts = torch.as_tensor(job["prompts"], device=dev)
    with torch.no_grad():
        lg, caches = lm.prefill(params, cfg, pc, prompts, max_len=job["max_len"])
        rows = [lg]
        for i, tok in enumerate(job["forced"]):
            step, caches = lm.decode_step(params, caches, cfg, pc, torch.full((prompts.shape[0], 1), tok, device=dev),
                                          prompts.shape[1] + i)  # fmt: skip
            rows.append(step)
    return [r.cpu() for r in rows]


def _tp_cards_worker(tp, job):
    """One process of the TP world over cards: its ranks' fused outputs
    (two calls each), a reduced smollm's f32 prefill and teacher-forced decode logits."""
    dev, lo, hi = tp.device, tp.rank0, tp.rank0 + tp.held
    out = {"fused": {}}
    for kind in PEER_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w = _peer_operands(kind, dtype, dev)
            x, w = x[lo:hi].contiguous(), w[lo:hi].contiguous()
            a, b = getattr(K, kind)(x, w, world=tp), getattr(K, kind)(x, w, world=tp)
            out["fused"][(kind, dtype)] = (a.cpu(), torch.equal(a, b), getattr(K, kind).last_launch["pool"])
    cfg = job["cfg"]
    params = lm.init(cfg, tp, torch.Generator(device=dev).manual_seed(0), torch.float32)
    out["logits"] = _forced_logits(params, cfg, ParallelContext(world=tp), job)
    return out


def _tp_train_cards_worker(tp, job):
    """One process of the TP world over cards training a reduced smollm in
    f32 on the fused backend: one step's loss and gradients
    (``tp_procs_grads``), then two ``make_train_step`` steps' metrics."""
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.steps import tp_procs_grads

    cfg, dev = job["cfg"], tp.device
    pc = ParallelContext(world=tp)
    params = lm.init(cfg, tp, torch.Generator(device=dev).manual_seed(0), torch.float32)
    loss, _, _, grads, _ = tp_procs_grads(lm, cfg, pc, params, job["batch"], grad_masks=lm.grad_masks(cfg, pc))
    step = make_train_step(lm, cfg, pc, AdamWConfig(lr=1e-3, warmup_steps=1), grad_masks=lm.grad_masks(cfg, pc))
    opt, metrics = init_opt_state(lm.trainable(params, cfg)), []
    for _ in range(2):
        params, opt, m = step(params, opt, job["batch"])
        metrics.append(float(m["loss"]))
    return {"loss": loss.cpu(), "grads": [g.cpu() for g in tree_leaves(grads)],
            "roles": tree_leaves(lm.proc_roles(grads, cfg)), "metrics": metrics}  # fmt: skip


def test_tp_training_across_cards(dev):
    """W = 4 over two processes, one card each: a reduced smollm's f32 step
    on the fused backend (the AG+GEMM / GEMM+RS backward on the peer route,
    the norms summed over the processes): the loss within 2e-3 + 2e-3 |ref|
    of the same W emulated on card 0, each gradient within 1e-5 of its
    leaf's max (the process's ranks), and the two steps' losses equal on
    both processes.  Skips, from inside, with fewer than two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the TP world over processes puts one on each card")
    from repro_torch.launch import serve
    from repro_torch.training.optimizer import apply_masks, tree_leaves
    from repro_torch.training.steps import loss_and_grads

    cfg = dataclasses.replace(reduce_config(get_config("smollm-360m")), vocab_size=512)
    toks = np.random.default_rng(1).integers(0, 512, (2, 64))
    job = {"cfg": cfg, "batch": {"inputs": toks, "labels": toks}}
    got = serve.run_tp(_tp_train_cards_worker, 4, 2, dev, args=(job,))
    one = World(4, dev)
    pc = ParallelContext(world=one)
    params = lm.init(cfg, one, torch.Generator(device=dev).manual_seed(0), torch.float32)
    loss, _, _, grads = loss_and_grads(lm, cfg, pc, params, job["batch"])
    want = [g.cpu() for g in tree_leaves(apply_masks(lm.sync_grads(grads, cfg, pc), lm.grad_masks(cfg, pc)))]
    for p, g in enumerate(got):
        assert abs(g["loss"].item() - loss.item()) <= 2e-3 + 2e-3 * abs(loss.item())
        for a, b, role in zip(g["grads"], want, g["roles"]):
            b = b[2 * p : 2 * p + 2] if role == "held" else b
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item() + 1e-12, role
        assert g["metrics"] == got[0]["metrics"]


def test_tp_world_across_cards(dev):
    """W = 4 over two processes, one card each (NCCL; the fused kernels push
    into the peer card over NVLink): each process's fused outputs bitwise the
    same W emulated on card 0, both calls; a reduced smollm's f32 prefill and
    teacher-forced decode logits within 2e-3 + 2e-3 |ref| of the emulated
    ones (the decode's per-rank cuBLAS products round by the width a card
    holds).  Skips, from inside, with fewer than two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the TP world over processes puts one on each card")
    from repro_torch.launch import serve

    cfg = dataclasses.replace(reduce_config(get_config("smollm-360m")), vocab_size=512)
    job = {"cfg": cfg, "prompts": np.random.default_rng(0).integers(0, 512, (2, 16)), "max_len": 24,
           "forced": [5, 77, 300, 11]}  # fmt: skip
    got = serve.run_tp(_tp_cards_worker, 4, 2, dev, args=(job,))
    one = World(4, dev)
    for kind in PEER_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            want = getattr(K, kind)(*_peer_operands(kind, dtype, dev)).cpu()
            for p, g in enumerate(got):
                out, twice, pool = g["fused"][(kind, dtype)]
                assert pool == "procs" and twice and torch.equal(out, want[2 * p : 2 * p + 2]), (kind, dtype, p)
    params = lm.init(cfg, one, torch.Generator(device=dev).manual_seed(0), torch.float32)
    refs = _forced_logits(params, cfg, ParallelContext(world=one), job)
    for g in got:
        for lg, ref in zip(g["logits"], refs):
            assert bool(((lg - ref).abs() <= 2e-3 + 2e-3 * ref.abs()).all())


def _tp_moe_cards_worker(tp, job):
    """One process of the TP world over cards on MoE, float32: its held
    ranks' ``ag_moe`` / ``a2a_moe`` outputs on the grouped kernel (two calls
    each) and their grouped launches, a reduced deepseek's prefill logits
    in TP and EP (both routes of its MoE layers on the fused backend), and
    its teacher-forced decode logits in both MoE decode forms (gathered and
    streamed)."""
    dev, lo, hi = tp.device, tp.rank0, tp.rank0 + tp.held
    args = [torch.as_tensor(a, device=dev)[lo:hi].contiguous() for a in job["ops"]]
    out = {"ops": {}}
    for kind in ("ag_moe", ("a2a_dispatch", "combine_rs")):
        fn = compile_overlap(list(kind) if isinstance(kind, tuple) else kind, BlockChannel(axis="model"), world=tp,
                             backend="fused")  # fmt: skip
        before = K.grouped_matmul.launches
        a, b = fn(*args), fn(*args)
        out["ops"][str(kind)] = (a.cpu(), torch.equal(a, b), K.grouped_matmul.launches - before)
    cfg = job["cfg"]
    params = lm.init(cfg, tp, torch.Generator(device=dev).manual_seed(0), torch.float32)
    prompts = torch.as_tensor(job["prompts"], device=dev)
    with torch.no_grad():
        out["logits"] = {ep: lm.prefill(params, cfg, ParallelContext(world=tp, ep_axis=ep), prompts, max_len=16)[0]
                         .cpu() for ep in (None, "model")}  # fmt: skip
    out["decode"] = {stream: _forced_logits(params, cfg, ParallelContext(world=tp, moe_decode_stream=stream), job)
                     for stream in (False, True)}  # fmt: skip
    return out


def test_moe_across_cards(dev):
    """W = 4 over two processes (four with four cards), one card each, f32:
    each process's ``ag_moe`` (the double ring) and ``a2a_moe`` (the
    dispatch / combine pair) outputs on the grouped kernel within 1e-5 of
    the max of the same W emulated on card 0 (the dispatch and combine are
    batched products over the ranks a card holds, whose cuBLAS kernel may
    differ with that count), each call twice bitwise, with 2 grouped
    launches a ring step; a reduced deepseek's (4 layers) prefill logits in
    TP and EP, and its teacher-forced decode logits in both MoE decode forms
    (``nn/moe.apply_decode`` over the held ranks), within 2e-3 + 2e-3 |ref|
    of the emulated world's.  Skips, from inside, with fewer than two
    cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the TP world over processes puts one on each card")
    from repro_torch.launch import serve

    procs = 4 if torch.cuda.device_count() >= 4 else 2
    rng = np.random.default_rng(2)
    w_, m, d, e, k, f = 4, 64, 128, 16, 2, 96
    x = rng.standard_normal((w_, m, d)).astype(np.float32)
    ids, wts, _ = moe_overlap.moe_router(torch.from_numpy(x), torch.from_numpy(rng.standard_normal((d, e))
                                                                               .astype(np.float32)),
                                         num_experts=e, top_k=k)  # fmt: skip
    ops = (x, ids.numpy(), wts.numpy(), (rng.standard_normal((w_, e // w_, d, 2 * f)) * d**-0.5).astype(np.float32),
           (rng.standard_normal((w_, e // w_, f, d)) * f**-0.5).astype(np.float32))  # fmt: skip
    cfg = dataclasses.replace(reduce_config(get_config("deepseek-moe-16b")), vocab_size=512, n_layers=4)
    job = {"ops": ops, "cfg": cfg, "prompts": rng.integers(0, 512, (2, 16)), "max_len": 24, "forced": [5, 77, 300, 11]}
    got = serve.run_tp(_tp_moe_cards_worker, w_, procs, dev, args=(job,))
    one = World(w_, dev)
    args = [torch.as_tensor(a, device=dev) for a in ops]
    held = w_ // procs
    for kind in ("ag_moe", ("a2a_dispatch", "combine_rs")):
        fn = compile_overlap(list(kind) if isinstance(kind, tuple) else kind, BlockChannel(axis="model"), world=one,
                             backend="fused")  # fmt: skip
        want = fn(*args).cpu()
        for p, g in enumerate(got):
            out, twice, launches = g["ops"][str(kind)]
            ref = want[p * held : (p + 1) * held]
            assert twice and launches == 2 * 2 * w_, (kind, p, twice, launches)
            assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item(), (kind, p)
    params = lm.init(cfg, one, torch.Generator(device=dev).manual_seed(0), torch.float32)
    prompts = torch.as_tensor(job["prompts"], device=dev)
    with torch.no_grad():
        for ep in (None, "model"):
            want = lm.prefill(params, cfg, ParallelContext(world=one, ep_axis=ep), prompts, max_len=16)[0].cpu()
            assert all(bool(((g["logits"][ep] - want).abs() <= 2e-3 + 2e-3 * want.abs()).all()) for g in got), ep
    for stream in (False, True):
        refs = _forced_logits(params, cfg, ParallelContext(world=one, moe_decode_stream=stream), job)
        for g in got:
            for lg, ref in zip(g["decode"][stream], refs):
                assert bool(((lg - ref).abs() <= 2e-3 + 2e-3 * ref.abs()).all()), stream
