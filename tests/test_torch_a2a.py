"""The port's expert-parallel MoE (the ``a2a_dispatch -> combine_rs`` pair)
against the JAX package's, on the CPU.

The pair's plans have the reference's tables (``a2a_dst_tables``,
``src_tables``, the exchange and combine permutations) and pass its static
verifier (``verify_seq_plan``, duck-typed over the port's plans), the
combine edge being the dispatch edge reversed; ``a2a_moe`` and
``a2a_moe_baseline`` on both backends match the reference's in float32
(1e-5), also where tight capacities drop tokens; the overlapped path and the
baseline keep and drop the same (token, k) pairs (their dispatch masks
compared exactly: the float outputs may differ by summation order);
``moe.apply_seq`` and ``lm.prefill`` with ``ep_axis`` match the reference
(1e-5 for a block, 2e-3 for logits).  The JAX side runs on 4-device CPU
meshes, the port on a 4-rank ``World``; inputs come from a numpy seed.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.analysis import verify_seq_plan
from repro.compat import make_mesh, shard_map
from repro.configs import get_config as j_get_config
from repro.core import BlockChannel as JChannel
from repro.core import CommSpec as JComm
from repro.core import compile_overlap as j_compile
from repro.core import plan as jplan
from repro.models import lm as jlm
from repro.nn import moe as j_nn_moe
from repro.parallel.context import ParallelContext as JContext
from repro.parallel.sharding import place
from repro_torch.backend import mesh as t_mesh
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import from_jax_params, shard_rows
from repro_torch.core import BlockChannel, CommSpec, build_seq_plan, compile_overlap, unsupported_error
from repro_torch.core import moe_overlap
from repro_torch.core.plan import build_plan
from repro_torch.models import lm
from repro_torch.nn import moe
from repro_torch.parallel.context import ParallelContext
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

R = 4
ORDERS = ("ring", "bidir_ring", "all2all")
A2A = ("a2a_dispatch", "combine_rs")
F32 = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=2e-3, rtol=2e-3)
E, K_TOP, D, F = 8, 2, 16, 16


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh((R,), ("model",))


@pytest.fixture(scope="module")
def world():
    return World(R, "cpu")


def _chans(order, nch):
    return (
        JChannel(axis="model", num_channels=nch, comm=JComm(order=order)),
        BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order)),
    )


# ---- the plans --------------------------------------------------------------


@pytest.mark.parametrize("order,w,nch", list(itertools.product(ORDERS, (2, 3, 4, 8), (1, 2, 4))))
def test_a2a_seq_plan_equals_reference_and_verifies(order, w, nch):
    jc, tc = _chans(order, nch)
    jseq = jplan.build_seq_plan(A2A, (jc, jc), w, nch)
    tseq = build_seq_plan(A2A, (tc, tc), w, nch)
    assert [p.flow for p in tseq.ops] == [p.flow for p in jseq.ops] == ["a2a", "a2a_rs"]
    for jp, tp in zip(jseq.ops, tseq.ops):
        assert tp.a2a_dst_tables() == jp.a2a_dst_tables()
        assert tp.src_tables() == jp.src_tables()
        for jch, tch in zip(jp.channels, tp.channels):
            for s in range(w):
                assert tch.a2a_perm(s) == jch.a2a_perm(s) and tch.combine_perm(s) == jch.combine_perm(s)
    for ch in tseq.ops[0].channels:
        assert ch.combine_perm(w - 1) == ch.align_perm()
        for s in range(w):  # the combine edge is the dispatch edge reversed
            assert {(d, j) for j, d in ch.a2a_perm(s)} == set(ch.combine_perm(s))
    assert verify_seq_plan(tseq).checks > 0


def test_build_plan_kinds():
    ch = BlockChannel(axis="model")
    assert build_plan("a2a_dispatch", ch, R, 1).flow == "a2a"
    assert build_plan("combine_rs", ch, R, 1).flow == "a2a_rs"
    with pytest.raises(ValueError, match="unknown workload kind"):
        build_plan("psum_scatter_a2a", ch, R, 1)


@pytest.mark.parametrize("order", ORDERS)
def test_permute_index_cache_keeps_results(world, order):
    """``World.permute`` reads a cached index tensor: the same results as a
    fresh ``out[dst] = xs[src]``, and a repeated permute is a cache hit."""
    plan = build_plan("a2a_dispatch", BlockChannel(axis="model", comm=CommSpec(order=order)), R, 1)
    xs = torch.randn((R, 3, 5), generator=torch.Generator().manual_seed(0))
    for s in range(R):
        for pairs in (plan.channels[0].a2a_perm(s), plan.channels[0].combine_perm(s), plan.channels[0].flow_perm(s)
                      if s < R - 1 else plan.channels[0].align_perm()):  # fmt: skip
            want = torch.empty_like(xs)
            for src, dst in pairs:
                want[dst] = xs[src]
            assert torch.equal(world.permute(xs, pairs), want)
            hits = t_mesh._perm_index.cache_info().hits
            assert torch.equal(world.permute(xs.bfloat16(), pairs), want.bfloat16())
            assert t_mesh._perm_index.cache_info().hits == hits + 1


# ---- a2a_moe against the reference --------------------------------------------


def _operands(seed, m_loc=32):
    """Tokens with experts 0 / 1 made hot, so tight capacities overflow in
    every sub-chunk; routing from the JAX router, fed to both sides."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R * m_loc, D)).astype(np.float32) * 0.5
    wr = rng.standard_normal((D, E)).astype(np.float32)
    wr[:, :2] += 10.0
    wgu = (rng.standard_normal((E, D, 2 * F)) * 0.1).astype(np.float32)
    wdn = (rng.standard_normal((E, F, D)) * 0.1).astype(np.float32)
    ids, wts, _ = j_nn_moe.moe_router(jnp.asarray(x), jnp.asarray(wr), num_experts=E, top_k=K_TOP)
    return x, np.asarray(ids), np.asarray(wts), wgu, wdn


def _port_args(world, x, ids, wts, wgu, wdn):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return (world.shard(t(x), 0), world.shard(t(ids).long(), 0), world.shard(t(wts), 0),
            shard_rows(t(wgu), world), shard_rows(t(wdn), world))  # fmt: skip


def _reference(mesh4, jc, overlapped, cf, args):
    fn = j_compile(list(A2A), channel=jc, overlapped=overlapped, capacity_factor=cf)
    sm = shard_map(
        fn, mesh4, in_specs=(P("model", None),) * 3 + (P("model", None, None),) * 2, out_specs=P("model", None)
    )
    return np.asarray(jax.jit(sm)(*args))


@pytest.mark.parametrize("order,nch,cf", list(itertools.product(ORDERS, (1, 2), (1.25, 0.25))))
def test_a2a_moe_matches_reference(mesh4, world, order, nch, cf):
    x, ids, wts, wgu, wdn = _operands(nch)
    jc, tc = _chans(order, nch)
    args = _port_args(world, x, ids, wts, wgu, wdn)
    want = _reference(mesh4, jc, True, cf, (x, ids, wts, wgu, wdn))
    want_b = _reference(mesh4, jc, False, cf, (x, ids, wts, wgu, wdn))
    for backend in ("eager", "fused"):
        got = compile_overlap(list(A2A), tc, world=world, backend=backend)(*args, capacity_factor=cf)
        np.testing.assert_allclose(world.unshard(got, 0).numpy(), want, **F32)
    got_b = compile_overlap(list(A2A), tc, world=world, overlapped=False)(*args, capacity_factor=cf)
    np.testing.assert_allclose(world.unshard(got_b, 0).numpy(), want_b, **F32)
    if cf < 1:  # the tight capacity really dropped tokens
        full = compile_overlap(list(A2A), tc, world=world)(*args, capacity_factor=8.0)
        assert not np.allclose(full.numpy(), world.shard(torch.from_numpy(want), 0).numpy(), atol=1e-3)


def _kept_masks(world, order, nch, cf, args, overlapped):
    """The (token, k) pairs each (rank, origin, sub-chunk) keeps: the
    dispatch tables each path builds, recorded and laid out as
    [rank, origin, sub-chunk, token, k]."""
    calls, tables = [], moe_overlap._dispatch_tables

    def recording(*a, **kw):
        out = tables(*a, **kw)
        calls.append(out.sum((-2, -1)) > 0)  # [W, nb, m_sub, k]: kept
        return out

    moe_overlap._dispatch_tables = recording
    try:
        tc = _chans(order, nch)[1]
        compile_overlap(list(A2A), tc, world=world, overlapped=overlapped)(*args, capacity_factor=cf)
    finally:
        moe_overlap._dispatch_tables = tables
    if not overlapped:  # one call over [rank, origin x sub-chunk] lead rows
        (kept,) = calls
        return kept.reshape(R, R, nch, *kept.shape[2:])
    plan = build_seq_plan(A2A, (tc, tc), R, nch).ops[0]
    out = torch.zeros((R, R, nch) + tuple(calls[0].shape[2:]), dtype=torch.bool)
    for i, kept in enumerate(calls):  # step-major, then channel
        s, c = divmod(i, nch)
        for r, origin in enumerate(plan.channels[c].source_table(s)):
            out[r, origin, c] = kept[r, 0]
    return out


@pytest.mark.parametrize("order,nch,cf", list(itertools.product(ORDERS, (1, 2), (1.25, 0.25))))
def test_kept_and_dropped_sets_equal_baseline(world, order, nch, cf):
    args = _port_args(world, *_operands(10 + nch))
    kept_o = _kept_masks(world, order, nch, cf, args, True)
    kept_b = _kept_masks(world, order, nch, cf, args, False)
    assert torch.equal(kept_o, kept_b)
    routed = (args[1].reshape(R, nch, -1, K_TOP)[None] // (E // R) == torch.arange(R)[:, None, None, None, None])
    assert kept_o.sum() <= routed.sum()
    if cf < 1:
        assert kept_o.sum() < routed.sum()  # tokens really dropped


def test_a2a_lead_dims_are_independent_batch_rows(world):
    """[W, B, m_loc, .] operands: capacity per (rank, batch row), each row the
    same as its own call."""
    rows = [_port_args(world, *_operands(20 + b)) for b in range(2)]
    batched = [torch.stack([r[i] for r in rows], 1) for i in range(3)] + list(rows[0][3:])
    tc = _chans("bidir_ring", 2)[1]
    for overlapped in (True, False):
        fn = compile_overlap(list(A2A), tc, world=world, overlapped=overlapped)
        out = fn(*batched, capacity_factor=0.25)
        for b, r in enumerate(rows):
            assert torch.equal(out[:, b], fn(*r[:3], *batched[3:], capacity_factor=0.25))


def test_a2a_backends_and_errors(world):
    ch = BlockChannel(axis="model")
    with pytest.raises(NotImplementedError) as err:
        compile_overlap(list(A2A), ch, world=world, backend="fused", overlapped=False)
    assert str(err.value) == str(unsupported_error(A2A, "fused", False))
    with pytest.raises(NotImplementedError):
        compile_overlap(["combine_rs", "a2a_dispatch"], ch, world=world)
    args = _port_args(world, *_operands(0))
    plain = compile_overlap(list(A2A), ch, world=world)(*args, capacity_factor=0.25)
    # the tuner resolves "auto" per shape (tests/test_torch_tune.py holds it); the MoE kinds have no wire axis,
    # so quant=True on explicit channels changes nothing
    auto = compile_overlap(list(A2A), "auto", world=world)(*args, capacity_factor=0.25)
    assert auto.shape == plain.shape and torch.isfinite(auto).all()
    assert torch.equal(compile_overlap(list(A2A), ch, world=world, quant=True)(*args, capacity_factor=0.25), plain)
    with pytest.raises(ValueError, match="quant must be"):
        compile_overlap(list(A2A), ch, world=world, quant="int8")  # a QuantSpec, not a dtype name
    with pytest.raises(ValueError, match="ep_axis"):
        ParallelContext(world=world).a2a_moe(*args)
    with pytest.raises(ValueError, match="not the world's axis"):
        ParallelContext(world=world, ep_axis="experts")
    pc = ParallelContext(world=world, ep_axis="model")
    cfg = reduce_config(get_config("deepseek-moe-16b"))
    x = torch.zeros((R, 1, 8, cfg.d_model))
    with pytest.raises(ValueError, match="next_proj"):
        moe.apply_seq({}, x, pc, cfg, next_proj=(lambda y: y, None))
    with pytest.raises(ValueError, match="ep_axis"):
        moe.apply_seq({}, x, ParallelContext(world=world), cfg, ep=True)


# ---- nn/moe and the model ---------------------------------------------------


@pytest.mark.parametrize("num_experts", (8, 6))
@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_moe_block_ep_matches_reference(mesh4, world, num_experts, backend):
    """``moe.apply_seq`` with ``ep_axis`` against the reference's EP block,
    with shared experts (deepseek, reduced) and with padded experts (6 on 4
    ranks pads to 8); the TP path on the same input gives the same output
    (no drops at the reduced capacity)."""
    jcfg, cfg = j_reduce_config(j_get_config("deepseek-moe-16b")), reduce_config(get_config("deepseek-moe-16b"))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, num_experts=num_experts))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=num_experts))
    jp = j_nn_moe.init(jax.random.PRNGKey(0), jcfg, R, jnp.float32)
    jp = dict(jp, ln=jax.random.normal(jax.random.PRNGKey(1), jp["ln"].shape) * 0.1)
    x = np.random.default_rng(3).standard_normal((2, R * 8, cfg.d_model)).astype(np.float32)
    jpc = JContext(mesh=mesh4, ep_axis="model")
    specs = jax.tree_util.tree_map(jpc.manual, j_nn_moe.specs(jcfg, R, None), is_leaf=lambda v: isinstance(v, P))
    sm = jpc.smap(lambda p, xx: j_nn_moe.apply_seq(p, xx, jpc, jcfg), (specs, P(None, "model", None)),
                  (P(None, "model", None), P()))  # fmt: skip
    jy, jaux = jax.jit(sm)(jp, jnp.asarray(x))
    from repro_torch.convert import shard_mlp

    t = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    tp = {"ln": t["ln"], "router": t["router"], "w_gu": shard_rows(t["w_gu"], world),
          "w_down": shard_rows(t["w_down"], world), "shared": shard_mlp(t["shared"], world)}  # fmt: skip
    xs = world.shard(torch.from_numpy(x), 1)
    pc = ParallelContext(world=world, backend=backend, ep_axis="model")
    y, aux = moe.apply_seq(tp, xs, pc, cfg)
    np.testing.assert_allclose(world.unshard(y, 1).numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    y_tp, aux_tp = moe.apply_seq(tp, xs, pc, cfg, ep=False)
    torch.testing.assert_close(y_tp, y, **F32)
    assert torch.equal(aux_tp, aux)


@pytest.fixture(scope="module")
def deepseek(mesh8):
    jcfg = dataclasses.replace(j_reduce_config(j_get_config("deepseek-moe-16b")), vocab_size=256)
    cfg = dataclasses.replace(reduce_config(get_config("deepseek-moe-16b")), vocab_size=256)
    pc8 = JContext(mesh=mesh8)
    jparams = place(jlm.init(jax.random.PRNGKey(2), jcfg, pc8, jnp.float32), mesh8, jlm.specs(jcfg, pc8))
    world = World(R, "cpu")
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, world)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    jpc = JContext(mesh=mesh8, ep_axis="model")
    jl, jc = jax.jit(lambda p, t: jlm.prefill(p, jcfg, jpc, t, max_len=20))(jparams, jnp.asarray(toks))
    return cfg, params, world, toks, np.asarray(jl), jc


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_prefill_with_ep_axis_matches_reference(deepseek, backend):
    cfg, params, world, toks, jl, jc = deepseek
    tokens = torch.from_numpy(toks).long()
    pc = ParallelContext(world=world, backend=backend, ep_axis="model")
    calls, a2a = [0], moe_overlap.a2a_moe

    def counting(*a, **kw):
        calls[0] += 1
        return a2a(*a, **kw)

    moe_overlap.a2a_moe = counting
    try:
        lg, caches = lm.prefill(params, cfg, pc, tokens, max_len=20)
    finally:
        moe_overlap.a2a_moe = a2a
    assert calls[0] == sum(d.ffn_kind == "moe" for d in lm.layer_plan(cfg))  # every MoE layer took the EP path
    np.testing.assert_allclose(lg.numpy(), jl, **LOGITS)
    k0 = np.asarray(jc["prefix"][0]["k"])  # the dense first layer's cache
    got = caches[0]["k"].permute(1, 0, 2, 3, 4).reshape(k0.shape).numpy()
    np.testing.assert_allclose(got, k0, atol=1e-5, rtol=1e-4)
    lg_tp, _ = lm.prefill(params, cfg, ParallelContext(world=world, backend=backend), tokens, max_len=20)
    np.testing.assert_allclose(lg.numpy(), lg_tp.numpy(), **LOGITS)
