"""The Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips (from a fixture) on a host without one.  The file imports neither JAX
nor the JAX package, so it runs on the GPU machine, where there is no JAX:

  python -m pytest --noconftest -m cuda -p no:cacheprovider tests/test_torch_cuda.py

Shapes are small and deliberately ragged (non-power-of-two tiles, partial
edge tiles, leading batch dims, GQA, sq < sk).  Tolerances: float32 1e-4 of
max |plain| (summation order only); bfloat16 2e-2 of max |plain| (both
versions round outputs to bf16).
"""

import itertools

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import BlockChannel, CommSpec, CompSpec
from repro_torch.models import lm
from repro_torch.parallel.context import ParallelContext

pytestmark = pytest.mark.cuda
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k,tile", [(50, 300, 37, (64, 120, 32)), (4, 960, 960, (128, 128, 128)), (130, 129, 5, (7, 9, 1))])
def test_matmul_kernel(dev, dtype, m, n, k, tile):
    x, w = _rand(dev, dtype, m, k), _rand(dev, dtype, k, n, seed=1, scale=k**-0.5)
    before = K.matmul.launches
    out = K.matmul(x, w, tile=tile)
    assert K.matmul.launches == before + 1
    _close(out, K.matmul_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2))))
def test_ag_gemm_kernel(dev, dtype, order, nch):
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order), comp=CompSpec(tile=(128, 40, 128)))
    x, w = _rand(dev, dtype, 4, 3, 10, 33), _rand(dev, dtype, 4, 33, 70, seed=1, scale=33**-0.5)
    before = K.ag_gemm.launches
    out = K.ag_gemm(x, w, channel=ch)
    assert K.ag_gemm.launches == before + 1 and out.shape == (4, 3, 40, 70)
    _close(out, K.ag_gemm_plain(x, w, channel=ch), dtype)


@pytest.mark.parametrize("dtype,accum", [(torch.float32, "float32"), (torch.bfloat16, "float32"), (torch.bfloat16, "bfloat16")])
@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2))))
def test_gemm_rs_kernel(dev, dtype, accum, order, nch):
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order), comp=CompSpec(accum_dtype=accum))
    x, w = _rand(dev, dtype, 4, 2, 12, 20), _rand(dev, dtype, 4, 20, 50, seed=1, scale=80**-0.5)
    out = K.gemm_rs(x, w, channel=ch)
    assert out.shape == (4, 2, 3, 50)
    _close(out, K.gemm_rs_plain(x, w, channel=ch), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "bh,bhkv,sq,sk,d,causal,window",
    [(4, 2, 100, 100, 64, True, None), (3, 1, 37, 130, 32, True, None), (2, 2, 70, 70, 16, True, 20),
     (2, 1, 64, 64, 128, False, None), (2, 2, 65, 65, 64, False, 33)],
)  # fmt: skip
def test_flash_attention_kernel(dev, dtype, bh, bhkv, sq, sk, d, causal, window):
    q, k, v = _rand(dev, dtype, bh, sq, d), _rand(dev, dtype, bhkv, sk, d, seed=1), _rand(dev, dtype, bhkv, sk, d, seed=2)
    before = K.flash_attention.launches
    out = K.flash_attention(q, k, v, causal=causal, window=window)
    assert K.flash_attention.launches == before + 1
    _close(out, K.flash_attention_plain(q, k, v, causal=causal, window=window), dtype)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
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


def test_fused_prefill_matches_eager_on_card(dev):
    cfg = reduce_config(get_config("smollm-360m"))
    world = World(4, dev)
    params = lm.init(cfg, world, torch.Generator(device=dev).manual_seed(0), torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    pf, pe = ParallelContext(world=world), ParallelContext(world=world, backend="eager")
    assert pf.backend == "fused"
    K.reset_launch_counts()
    lf, cf = lm.prefill(params, cfg, pf, toks, max_len=20)
    assert K.launch_counts() == {"matmul": 1, "ag_gemm": 4, "gemm_rs": 4, "flash_attention": 2}
    le, ce = lm.prefill(params, cfg, pe, toks, max_len=20)
    torch.testing.assert_close(lf, le, atol=2e-3, rtol=2e-3)
    for a, b in zip(cf, ce):
        torch.testing.assert_close(a["k"], b["k"], atol=1e-4, rtol=1e-4)
