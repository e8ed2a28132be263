"""The port's overlap ops against the JAX package's ``compile_overlap``.

Port side: the eager executor (``backend="eager"``) and the fused backend,
whose kernel wrappers run their plain versions (the schedule replayed with
the kernels' tables, slots and step order) on CPU tensors.  JAX side: the
``xla`` backend on a 4-device mesh, and the fused kernels' oracles in
``repro/kernels/ref.py``.  Inputs come from a numpy seed.

Tolerances: float32 paths agree to summation order (atol 1e-4, rtol 1e-4 at
unit-scale values); bfloat16 is held against a float32 oracle on the same
bf16-rounded inputs (atol 8e-2, rtol 3e-2, the bf16 bound of
``tests/test_plan.py``).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import make_mesh, shard_map
from repro.core import BlockChannel as JChannel
from repro.core import CommSpec as JComm
from repro.core import CompSpec as JComp
from repro.core import compile_overlap as j_compile
from repro.kernels import ref as jref
from repro_torch.backend.mesh import World
from repro_torch.core import BlockChannel, CommSpec, CompSpec, compile_overlap, unsupported_error
from repro_torch.core.comp_tiles import largest_divisor
from repro_torch import kernels
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

R = 4
ORDERS = ("ring", "bidir_ring", "all2all")
SWEEP = list(itertools.product(ORDERS, (1, 2)))
F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=8e-2, rtol=3e-2)


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh((R,), ("model",))


@pytest.fixture(scope="module")
def world():
    return World(R, "cpu")


def _chans(order, nch, accum="float32"):
    j = JChannel(axis="model", num_channels=nch, comm=JComm(order=order), comp=JComp(accum_dtype=accum))
    t = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order), comp=CompSpec(accum_dtype=accum))
    return j, t


def _ag_inputs(seed, b=2, m_loc=8, k=16, n_loc=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, R * m_loc, k)).astype(np.float32)  # global, rows sharded
    w = rng.standard_normal((k, R * n_loc)).astype(np.float32)  # global, columns sharded
    return x, w


def _ag_port(x, w):
    """Global -> rank-stacked: x [W, B, m_loc, K], w [W, K, n_loc]."""
    b, s, k = x.shape
    xt = torch.from_numpy(x).reshape(b, R, s // R, k).permute(1, 0, 2, 3).contiguous()
    wt = torch.from_numpy(w).reshape(k, R, -1).permute(1, 0, 2).contiguous()
    return xt, wt


def _ag_unport(out):
    """[W, B, S, n_loc] -> global [B, S, W*n_loc]."""
    w_, b, s, n = out.shape
    return out.permute(1, 2, 0, 3).reshape(b, s, w_ * n).float().numpy()


def _rs_inputs(seed, b=2, m=R * 8, k_loc=8, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, m, R * k_loc)).astype(np.float32)  # global, columns sharded
    w = rng.standard_normal((R * k_loc, n)).astype(np.float32)  # global, rows sharded
    return x, w


def _rs_port(x, w):
    b, m, kk = x.shape
    xt = torch.from_numpy(x).reshape(b, m, R, kk // R).permute(2, 0, 1, 3).contiguous()
    wt = torch.from_numpy(w).reshape(R, kk // R, -1).contiguous()
    return xt, wt


def _rs_unport(out):
    """[W, B, m_loc, N] -> global [B, W*m_loc, N]."""
    w_, b, m, n = out.shape
    return out.permute(1, 0, 2, 3).reshape(b, w_ * m, n).float().numpy()


def _jax_ag(mesh, ch, x, w, **kw):
    fn = j_compile("ag_matmul", ch, **kw)
    lead = (None,) * (x.ndim - 2)
    sm = shard_map(fn, mesh, in_specs=(P(*lead, "model", None), P(None, "model")), out_specs=P(*lead, None, "model"))
    return np.asarray(jax.jit(sm)(jnp.asarray(x), jnp.asarray(w)))


def _jax_rs(mesh, ch, x, w, **kw):
    fn = j_compile("matmul_rs", ch, **kw)
    lead = (None,) * (x.ndim - 2)
    sm = shard_map(fn, mesh, in_specs=(P(*lead, None, "model"), P("model", None)), out_specs=P(*lead, "model", None))
    return np.asarray(jax.jit(sm)(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("order,nch", SWEEP)
def test_ag_matmul_matches_reference(mesh4, world, order, nch):
    x, w = _ag_inputs(1)
    jch, tch = _chans(order, nch)
    ref = _jax_ag(mesh4, jch, x, w)
    xt, wt = _ag_port(x, w)
    for backend in ("eager", "fused"):
        out = compile_overlap("ag_matmul", tch, world=world, backend=backend)(xt, wt)
        assert out.shape == (R, 2, R * 8, 12)
        np.testing.assert_allclose(_ag_unport(out), ref, **F32)


@pytest.mark.parametrize("order,nch", SWEEP)
def test_matmul_rs_matches_reference(mesh4, world, order, nch):
    x, w = _rs_inputs(2)
    jch, tch = _chans(order, nch)
    ref = _jax_rs(mesh4, jch, x, w)
    xt, wt = _rs_port(x, w)
    for backend in ("eager", "fused"):
        out = compile_overlap("matmul_rs", tch, world=world, backend=backend)(xt, wt)
        assert out.shape == (R, 2, 8, 16)
        np.testing.assert_allclose(_rs_unport(out), ref, **F32)


@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2, 4))))
def test_fused_plain_matches_kernel_oracles(order, nch):
    """The fused kernels' plain versions (2-D shards, as the JAX fused kernels
    take them) against the JAX package's oracles ``ref.ag_gemm_ref`` /
    ``ref.gemm_rs_ref``, whose per-rank layout is the port's."""
    _, tch = _chans(order, nch)
    rng = np.random.default_rng(11)
    xs = rng.standard_normal((R, 8, 16)).astype(np.float32)
    ws = rng.standard_normal((R, 16, 12)).astype(np.float32)
    out = kernels.ag_gemm(torch.from_numpy(xs), torch.from_numpy(ws), channel=tch)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref.ag_gemm_ref(xs, ws)), **F32)
    xs = rng.standard_normal((R, 4 * R, 8)).astype(np.float32)
    ws = rng.standard_normal((R, 8, 16)).astype(np.float32)
    out = kernels.gemm_rs(torch.from_numpy(xs), torch.from_numpy(ws), channel=tch)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref.gemm_rs_ref(xs, ws)), **F32)


def test_baselines_match_reference(mesh4, world):
    jch, tch = _chans("ring", 1)
    x, w = _ag_inputs(5)
    ref = _jax_ag(mesh4, jch, x, w, overlapped=False)
    xt, wt = _ag_port(x, w)
    out = compile_overlap("ag_matmul", tch, world=world, overlapped=False)(xt, wt)
    np.testing.assert_allclose(_ag_unport(out), ref, **F32)
    x, w = _rs_inputs(6)
    ref = _jax_rs(mesh4, jch, x, w, overlapped=False)
    xt, wt = _rs_port(x, w)
    out = compile_overlap("matmul_rs", tch, world=world, overlapped=False)(xt, wt)
    np.testing.assert_allclose(_rs_unport(out), ref, **F32)


@pytest.mark.parametrize("order,accum", [("ring", "float32"), ("bidir_ring", "bfloat16"), ("all2all", "bfloat16")])
def test_bf16_against_f32_oracle(world, order, accum):
    _, tch = _chans(order, 2, accum)
    x, w = _ag_inputs(7)
    xb, wb = (torch.from_numpy(a).bfloat16() for a in (x, w))
    oracle = torch.matmul(xb.float(), wb.float()).numpy()  # every rank's AG(x) @ its column block
    xt, wt = _ag_port(xb.float().numpy(), wb.float().numpy())
    for backend in ("eager", "fused"):
        out = compile_overlap("ag_matmul", tch, world=world, backend=backend)(xt.bfloat16(), wt.bfloat16())
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(_ag_unport(out), oracle, **BF16)
    x, w = _rs_inputs(8)
    xb, wb = (torch.from_numpy(a).bfloat16() for a in (x, w))
    oracle = torch.matmul(xb.float(), wb.float()).numpy()
    xt, wt = _rs_port(xb.float().numpy(), wb.float().numpy())
    for backend in ("eager", "fused"):
        out = compile_overlap("matmul_rs", tch, world=world, backend=backend)(xt.bfloat16(), wt.bfloat16())
        np.testing.assert_allclose(_rs_unport(out), oracle, **BF16)


def test_comp_tile_is_honored(world):
    """A non-default CompSpec tile routes the eager GEMM through blocked_dot."""
    x, w = _ag_inputs(9)
    xt, wt = _ag_port(x, w)
    plain = compile_overlap("ag_matmul", _chans("ring", 1)[1], world=world)(xt, wt)
    ch = BlockChannel(axis="model", comp=CompSpec(tile=(4, 6, 8)))
    tiled = compile_overlap("ag_matmul", ch, world=world)(xt, wt)
    np.testing.assert_allclose(tiled.numpy(), plain.numpy(), **F32)


def test_unsupported_pairs_raise_structured(world):
    ch = BlockChannel(axis="model")
    kinds = ("a2a_dispatch", "combine_rs", "conv")
    cases = [(kind, backend, True) for kind in kinds for backend in ("eager", "fused")]
    cases += [("ag_matmul", "fused", False), ("matmul_rs", "fused", False), ("ag_moe", "fused", False)]
    cases += [("ag_attention", "fused", False)]
    for kind, backend, overlapped in cases:
        with pytest.raises(NotImplementedError) as err:
            compile_overlap(kind, ch, world=world, backend=backend, overlapped=overlapped)
        assert str(err.value) == str(unsupported_error(kind, backend, overlapped))
    with pytest.raises(ValueError):
        compile_overlap("ag_matmul", ch, world=world, backend="xla")


def test_cpu_tensors_never_launch(world):
    """On the CPU the fused backend runs plain versions: no launch is counted."""
    kernels.reset_launch_counts()
    x, w = _ag_inputs(10)
    xt, wt = _ag_port(x, w)
    compile_overlap("ag_matmul", _chans("ring", 1)[1], world=world, backend="fused")(xt, wt)
    assert kernels.launch_counts() == {name: 0 for name in kernels.WRAPPERS}


@pytest.mark.parametrize("order,nch", [("ring", 1), ("bidir_ring", 2), ("all2all", 1)])
def test_ag_matmul_ragged_width_matches_reference(mesh4, world, order, nch):
    """A Mamba in-projection width: n_loc = 2 di_loc + h_loc = 132 at the
    reduced mamba2 size (2580 at full size), not a multiple of 128, so the
    kernel's n tile clamps to a divisor (66; 86 at full size)."""
    x, w = _ag_inputs(12, b=2, m_loc=8, k=16, n_loc=132)
    jch, tch = _chans(order, nch)
    ref = _jax_ag(mesh4, jch, x, w)
    xt, wt = _ag_port(x, w)
    plain = kernels.ag_gemm_plain(xt, wt, channel=tch)
    np.testing.assert_allclose(_ag_unport(plain), ref, **F32)
    for backend in ("eager", "fused"):
        out = compile_overlap("ag_matmul", tch, world=world, backend=backend)(xt, wt)
        assert out.shape == (R, 2, R * 8, 132)
        np.testing.assert_allclose(_ag_unport(out), ref, **F32)
    for n_loc, bn in ((132, 66), (2580, 86)):
        assert largest_divisor(n_loc, tch.comp.tile[1]) == bn


@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2, 4))))
def test_psum_scatter_ring_matches_reference(mesh4, world, order, nch):
    """The ``psum_scatter`` plan kind: a ring reduce-scatter of precomputed
    partials, each rank's [B, M, N] partial to its [B, M / W, N] segment of
    the sum, against the JAX package's ``psum_scatter_ring``."""
    from repro.core.overlap import psum_scatter_ring as j_psum_scatter_ring
    from repro_torch.core.overlap import psum_scatter_ring

    rng = np.random.default_rng(13)
    x = rng.standard_normal((R, 2, R * 6, 16)).astype(np.float32)  # rank r's partial at x[r]
    jch, tch = _chans(order, nch)

    def fn(xs):
        return j_psum_scatter_ring(xs[0], axis="model", channel=jch)[None]

    sm = shard_map(fn, mesh4, in_specs=(P("model", None, None, None),), out_specs=P("model", None, None, None))
    ref = np.asarray(jax.jit(sm)(jnp.asarray(x)))
    out = psum_scatter_ring(torch.from_numpy(x), world=world, channel=tch)
    assert out.shape == (R, 2, 6, 16)
    np.testing.assert_allclose(out.numpy(), ref, **F32)
    segs = x.sum(0).reshape(2, R, 6, 16).transpose(1, 0, 2, 3)  # rank r's row segment of the sum
    np.testing.assert_allclose(out.numpy(), segs, **F32)
