"""The port's fused RS -> AG layer seam against the JAX package's, on the CPU.

The seam plan (``build_seq_plan(("matmul_rs", "ag_matmul"))``) has the
reference's tables and passes its static verifier (``verify_seq_plan``,
duck-typed over the port's plans); ``matmul_rs_ag`` and the
``compile_overlap`` list form match the reference in float32 (1e-5); in
float32 the fused seam equals the unfused pair bitwise, in bfloat16 it is
within 2e-2 of max |float32 reference| (the reference's own bf16 pair test is
no usable oracle); a schedule-incompatible seam warns once and runs unfused;
``lm.forward`` with ``fuse_seams`` gives the unfused logits and the
reference's ``forward(fuse_seams=True)`` (2e-3) over the same number of
fused seams.  The JAX side runs on 4-device CPU meshes, the port on a
4-rank ``World``; inputs come from a numpy seed.
"""

import dataclasses
import itertools
import warnings

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
from repro.core import CompSpec as JComp
from repro.core import compile_overlap as j_compile
from repro.core import overlap as j_overlap
from repro.core import plan as jplan
from repro.models import lm as jlm
from repro.parallel.context import ParallelContext as JContext
from repro.parallel.sharding import place
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import from_jax_params, shard_attention, shard_mlp
from repro_torch.core import (
    BlockChannel,
    CommSpec,
    CompSpec,
    SeamFallbackWarning,
    build_seq_plan,
    compile_overlap,
    unsupported_error,
)
from repro_torch.core import overlap as t_overlap
from repro_torch.models import lm
from repro_torch.nn import attention, ffn
from repro_torch.nn.layers import rms_norm
from repro_torch.parallel.context import ParallelContext
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

R = 4
ORDERS = ("ring", "bidir_ring", "all2all")
SEAM = ("matmul_rs", "ag_matmul")
F32 = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=2e-3, rtol=2e-3)
TABLES = ("src_tables", "flow_dst_tables", "rs_seg_tables", "rs_dst_tables")


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


def _glue(y):
    return y * 0.5 + 1.0  # any row-local map


def _seam_inputs(seed, b=2, m=R * 8, k=R * 8, n_mid=16, n2=2 * R * 4):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, m, k)).astype(np.float32),  # x, K sharded
        rng.standard_normal((k, n_mid)).astype(np.float32),  # w1, rows sharded
        rng.standard_normal((n_mid, n2)).astype(np.float32),  # w2, columns sharded
        rng.standard_normal((b, m, n_mid)).astype(np.float32),  # residual, rows sharded
    )


def _port(world, x, w1, w2, res):
    """Global numpy operands -> the port's rank-stacked tensors."""
    t = [torch.from_numpy(a) for a in (x, w1, w2, res)]
    return world.shard(t[0], 2), world.shard(t[1], 0), world.shard(t[2], 1), world.shard(t[3], 1)


# ---- the plan ------------------------------------------------------------------


@pytest.mark.parametrize("order,w,nch", list(itertools.product(ORDERS, (2, 3, 4, 8), (1, 2, 4))))
def test_seam_seq_plan_equals_reference_and_verifies(order, w, nch):
    jc, tc = _chans(order, nch)
    jseq = jplan.build_seq_plan(SEAM, (jc, jc), w, nch)
    tseq = build_seq_plan(SEAM, (tc, tc), w, nch)
    assert build_seq_plan(SEAM, (tc, tc), w, nch) is tseq  # cached
    assert (tseq.axis, tseq.world, tseq.num_channels) == (jseq.axis, jseq.world, jseq.num_channels)
    for jp, tp in zip(jseq.ops, tseq.ops):
        assert (tp.kind, tp.flow) == (jp.kind, jp.flow)
        for name in TABLES:
            assert getattr(tp, name)() == getattr(jp, name)(), name
    # the home segment of the RS pass is the AG pass's step-0 tile
    rs, ag = tseq.ops
    for ch_rs, ch_ag in zip(rs.channels, ag.channels):
        assert [ch_rs.rs_segment(r, w - 1) for r in range(w)] == list(range(w)) == list(ch_ag.source_table(0))
    assert verify_seq_plan(tseq).checks > 0


def test_seq_plan_rejects_illegal_chains():
    from repro_torch.core.plan import SeqPlan, build_plan

    ch = BlockChannel(axis="model")
    ag, rs = build_plan("ag_matmul", ch, R, 1), build_plan("matmul_rs", ch, R, 1)
    with pytest.raises(ValueError, match="must chain"):
        SeqPlan(ops=(ag, rs))
    with pytest.raises(ValueError, match="share axis/world/channel"):
        SeqPlan(ops=(rs, build_plan("ag_matmul", ch, R, 2)))
    with pytest.raises(ValueError, match="exactly 2"):
        SeqPlan(ops=(rs,))


# ---- matmul_rs_ag against the reference ---------------------------------------


@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2, 4))))
def test_matmul_rs_ag_matches_reference(mesh4, world, order, nch):
    x, w1, w2, res = _seam_inputs(nch)
    jc, tc = _chans(order, nch)
    fn = j_compile(list(SEAM), channel=jc)
    sm = shard_map(
        lambda x_, w1_, w2_, r_: fn(x_, w1_, w2_, residual=r_, glue=_glue),
        mesh4,
        in_specs=(P(None, None, "model"), P("model", None), P(None, "model"), P(None, "model", None)),
        out_specs=(P(None, "model", None), P(None, None, "model")),
    )
    jy, jg = jax.jit(sm)(x, w1, w2, res)
    xs, w1s, w2s, rs = _port(world, x, w1, w2, res)
    before = t_overlap.matmul_rs_ag.calls
    y, g = t_overlap.matmul_rs_ag(xs, w1s, w2s, world=world, channel=tc, residual=rs, glue=_glue)
    assert t_overlap.matmul_rs_ag.calls == before + 1
    np.testing.assert_allclose(world.unshard(y, 1).numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(world.unshard(g, 2).numpy(), np.asarray(jg), **F32)
    y2, g2 = compile_overlap(list(SEAM), tc, world=world)(xs, w1s, w2s, residual=rs, glue=_glue)
    assert torch.equal(y, y2) and torch.equal(g, g2)


@pytest.mark.parametrize("order,nch,accum", list(itertools.product(ORDERS, (1, 2, 4), ("float32", "bfloat16"))))
def test_fused_seam_equals_unfused_pair_bitwise(world, order, nch, accum):
    """The seam's float ops are the unfused pair's, in its order: RS output
    cast before the residual add, glue on the whole home segment, the AG
    output in h's dtype."""
    _, tc = _chans(order, nch, accum)
    xs, w1s, w2s, rs = _port(world, *_seam_inputs(10 + nch))
    y, g = compile_overlap(list(SEAM), tc, world=world)(xs, w1s, w2s, residual=rs, glue=_glue)
    y_u = rs + compile_overlap("matmul_rs", tc, world=world)(xs, w1s)
    g_u = compile_overlap("ag_matmul", tc, world=world)(_glue(y_u), w2s)
    assert torch.equal(y, y_u) and torch.equal(g, g_u)
    # without residual and glue too
    y, g = compile_overlap(list(SEAM), tc, world=world)(xs, w1s, w2s)
    y_u = compile_overlap("matmul_rs", tc, world=world)(xs, w1s)
    assert torch.equal(y, y_u) and torch.equal(g, compile_overlap("ag_matmul", tc, world=world)(y_u, w2s))


@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, (1, 2))))
def test_bf16_seam_within_bound_of_f32_reference(world, order, nch):
    """bf16 operands through the seam against the float32 global reference
    ``(residual + x @ w1, glue(.) @ w2)`` on the same bf16-rounded values."""
    _, tc = _chans(order, nch)
    x, w1, w2, res = (torch.from_numpy(a).bfloat16() for a in _seam_inputs(20 + nch))
    y_ref = res.float() + x.float() @ w1.float()
    g_ref = _glue(y_ref) @ w2.float()
    xs, w1s, w2s, rs = world.shard(x, 2), world.shard(w1, 0), world.shard(w2, 1), world.shard(res, 1)
    y, g = compile_overlap(list(SEAM), tc, world=world)(xs, w1s, w2s, residual=rs, glue=_glue)
    assert y.dtype == g.dtype == torch.bfloat16
    for got, want in ((world.unshard(y, 1), y_ref), (world.unshard(g, 2), g_ref)):
        assert (got.float() - want).abs().max().item() <= 2e-2 * want.abs().max().item()


@pytest.mark.parametrize("m_loc,n_mid", [(4, 12), (64, 960)])
def test_seam_incompatible_channels_fall_back_loudly(mesh4, world, m_loc, n_mid):
    """C = 3 divides the RS extent N but clamps to 2 on the AG extent M / W:
    one SeamFallbackWarning per signature, the unfused pair's results, no
    crash; the reference falls back the same way."""
    x, w1, w2, res = _seam_inputs(30 + m_loc, b=1, m=R * m_loc, k=R * 2, n_mid=n_mid, n2=R * 2)
    jc, tc = _chans("ring", 3)
    xs, w1s, w2s, rs = _port(world, x, w1, w2, res)
    fn = compile_overlap(list(SEAM), tc, world=world)
    before = t_overlap.matmul_rs_ag.calls
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        y, g = fn(xs, w1s, w2s, residual=rs, glue=_glue)
        y2, g2 = fn(xs, w1s, w2s, residual=rs, glue=_glue)
    fb = [w for w in caught if issubclass(w.category, SeamFallbackWarning)]
    assert len(fb) == 1 and "effective channel counts diverge" in str(fb[0].message)
    assert t_overlap.matmul_rs_ag.calls == before  # nothing fused
    assert torch.equal(y, y2) and torch.equal(g, g2)
    y_u = rs + compile_overlap("matmul_rs", tc, world=world)(xs, w1s)
    assert torch.equal(y, y_u) and torch.equal(g, compile_overlap("ag_matmul", tc, world=world)(_glue(y_u), w2s))
    with pytest.raises(ValueError, match="diverge"):
        t_overlap.matmul_rs_ag(xs, w1s, w2s, world=world, channel=tc)
    sm = shard_map(
        lambda x_, w1_, w2_, r_: j_compile(list(SEAM), channel=jc)(x_, w1_, w2_, residual=r_, glue=_glue),
        mesh4,
        in_specs=(P(None, None, "model"), P("model", None), P(None, "model"), P(None, "model", None)),
        out_specs=(P(None, "model", None), P(None, None, "model")),
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jy, jg = jax.jit(sm)(x, w1, w2, res)
    # 1e-5 of the largest value: the AG contracts over N = 960 here
    for got, want in ((world.unshard(y, 1).numpy(), np.asarray(jy)), (world.unshard(g, 2).numpy(), np.asarray(jg))):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_seq_form_backends_and_errors(world):
    ch = BlockChannel(axis="model")
    for kw in (dict(backend="fused"), dict(backend="fused", overlapped=False)):
        with pytest.raises(NotImplementedError) as err:
            compile_overlap(list(SEAM), ch, world=world, **kw)
        assert str(err.value) == str(unsupported_error(SEAM, "fused", kw.get("overlapped", True)))
    with pytest.raises(NotImplementedError, match="'ag_matmul', 'matmul_rs'"):
        compile_overlap(["ag_matmul", "matmul_rs"], ch, world=world)  # AG -> RS is no seam
    with pytest.raises(NotImplementedError):
        compile_overlap(list(SEAM), "auto", world=world, backend="fused")  # the seam is eager only, tuned or not
    with pytest.raises(ValueError, match="quant must be"):
        compile_overlap(list(SEAM), ch, world=world, quant="int8")  # a QuantSpec, not a dtype name
    with pytest.raises(ValueError, match="unknown backend"):
        compile_overlap(list(SEAM), ch, world=world, backend="xla")
    # per-op (kind, channel) entries; overlapped=False is the baselines' pair
    xs, w1s, w2s, rs = _port(world, *_seam_inputs(40))
    ch2 = BlockChannel(axis="model", comm=CommSpec(order="all2all"))  # another order, the same C
    y, g = compile_overlap([("matmul_rs", ch), ("ag_matmul", ch2)], world=world)(xs, w1s, w2s, residual=rs)
    assert torch.equal(g, compile_overlap("ag_matmul", ch2, world=world)(y, w2s))
    yb, gb = compile_overlap(list(SEAM), ch, world=world, overlapped=False)(xs, w1s, w2s, residual=rs, glue=_glue)
    y_b = rs + compile_overlap("matmul_rs", ch, world=world, overlapped=False)(xs, w1s)
    assert torch.equal(yb, y_b)
    assert torch.equal(gb, compile_overlap("ag_matmul", ch, world=world, overlapped=False)(_glue(y_b), w2s))
    _, g_o = compile_overlap(list(SEAM), ch, world=world)(xs, w1s, w2s, residual=rs, glue=_glue)
    torch.testing.assert_close(gb, g_o, **F32)


@pytest.mark.parametrize("backend,mode", [("fused", "overlap"), ("eager", "overlap"), ("eager", "baseline")])
def test_context_seam_runs_on_eager(world, backend, mode):
    """``pc.matmul_rs_ag`` compiles on "eager" whatever the backend: on the
    fused backend it is the eager seam, bitwise."""
    xs, w1s, w2s, rs = _port(world, *_seam_inputs(50))
    pc = ParallelContext(world=world, backend=backend, mode=mode)
    y, g = pc.matmul_rs_ag(xs, w1s, w2s, residual=rs, glue=_glue)
    want = compile_overlap(list(SEAM), pc.channel, world=world, overlapped=mode == "overlap")
    y2, g2 = want(xs, w1s, w2s, residual=rs, glue=_glue)
    assert torch.equal(y, y2) and torch.equal(g, g2)


# ---- the nn blocks ----------------------------------------------------------


@pytest.fixture(scope="module")
def blocks(world):
    """Reduced smollm attention + MLP params (norm gains nonzero), rank-stacked."""
    cfg = reduce_config(get_config("smollm-360m"))
    gen = torch.Generator().manual_seed(0)
    ap = attention.init(cfg, R, gen, torch.float32, "cpu")
    fp = ffn.init(cfg, gen, torch.float32, "cpu")
    ap["ln"] = torch.randn(ap["ln"].shape, generator=gen) * 0.1
    fp["ln"] = torch.randn(fp["ln"].shape, generator=gen) * 0.1
    x = torch.randn((R, 2, 8, cfg.d_model), generator=gen)
    return cfg, shard_attention(ap, world), shard_mlp(fp, world), x


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("form", ["apply_seq", "apply_seq_ring"])
def test_attention_next_proj_equals_the_unfused_pair(world, blocks, backend, form):
    """``next_proj`` on both attention forms: ``(y, next_out)`` with ``y``
    the block's output and ``next_out`` the MLP gate/up AG of its norm."""
    cfg, ap, fp, x = blocks
    pc = ParallelContext(world=world, backend=backend)
    fn = getattr(attention, form)
    y, gu = fn(ap, x, pc, cfg, next_proj=ffn.seam_proj(fp, cfg))
    y_u = fn(ap, x, pc, cfg)
    gu_u = ParallelContext(world=world).ag_matmul(rms_norm(y_u, fp["ln"], cfg.norm_eps), fp["w_gu"])
    if backend == "eager":
        assert torch.equal(y, y_u) and torch.equal(gu, gu_u)
    else:  # the seam is eager, the unfused o-proj the fused kernel's plain version
        torch.testing.assert_close(y, y_u, **F32)
        torch.testing.assert_close(gu, gu_u, **F32)
    # the MLP consuming the fused projection is the whole unfused MLP
    torch.testing.assert_close(ffn.apply_seq(fp, y, pc, cfg, gu=gu), ffn.apply_seq(fp, y_u, pc, cfg), **F32)
    if form == "apply_seq":
        y3, gu3, kv = fn(ap, x, pc, cfg, next_proj=ffn.seam_proj(fp, cfg), return_kv=True)
        assert torch.equal(y3, y) and torch.equal(gu3, gu) and set(kv) == {"k", "v"}


def test_mlp_next_proj_feeds_the_next_qkv(world, blocks):
    cfg, ap, fp, x = blocks
    pc = ParallelContext(world=world, backend="eager")
    y, qkv = ffn.apply_seq(fp, x, pc, cfg, next_proj=attention.seam_proj(ap, cfg))
    assert torch.equal(y, ffn.apply_seq(fp, x, pc, cfg))
    assert torch.equal(qkv, pc.ag_matmul(rms_norm(y, ap["ln"], cfg.norm_eps), ap["wqkv"]))
    assert torch.equal(attention.apply_seq(ap, y, pc, cfg, qkv=qkv), attention.apply_seq(ap, y, pc, cfg))


def test_dense_blocks_have_no_expert_parallel_form(world, blocks):
    cfg, ap, fp, x = blocks
    pc = ParallelContext(world=world)
    for fn, p in ((ffn.apply_seq, fp), (attention.apply_seq, ap), (attention.apply_seq_ring, ap)):
        with pytest.raises(ValueError, match="expert-parallel"):
            fn(p, x, pc, cfg, ep=True)


# ---- the model ----------------------------------------------------------------


@pytest.fixture(scope="module", params=["smollm-360m", "deepseek-moe-16b"])
def model(request, mesh8):
    arch = request.param
    jcfg = dataclasses.replace(j_reduce_config(j_get_config(arch)), vocab_size=256)
    cfg = dataclasses.replace(reduce_config(get_config(arch)), vocab_size=256)
    pc8 = JContext(mesh=mesh8)
    jparams = place(jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32), mesh8, jlm.specs(jcfg, pc8))
    world = World(R, "cpu")
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, world)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    # the reference's fused seams, counted as they are traced (unrolled layers)
    seams, fused = [0], j_overlap.matmul_rs_ag

    def counting(*a, **kw):
        seams[0] += 1
        return fused(*a, **kw)

    j_overlap.matmul_rs_ag = counting
    try:
        pcs = JContext(mesh=mesh8, fuse_seams=True)
        jl, jaux = jax.jit(lambda p, t: jlm.forward(p, jcfg, pcs, t, unroll=True))(jparams, jnp.asarray(toks))
    finally:
        j_overlap.matmul_rs_ag = fused
    return cfg, params, world, toks, np.asarray(jl), float(jaux), seams[0]


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_forward_with_fused_seams_matches_reference(model, backend):
    cfg, params, world, toks, jl, jaux, j_seams = model
    tokens = torch.from_numpy(toks).long()
    before = t_overlap.matmul_rs_ag.calls
    lg, aux = lm.forward(params, cfg, ParallelContext(world=world, backend=backend, fuse_seams=True), tokens)
    seams = t_overlap.matmul_rs_ag.calls - before
    # smollm: one intra-layer seam per layer (its pattern period is 1 layer);
    # deepseek: the dense first layer only
    assert seams == j_seams == sum(d.seam_eligible() for d in lm.layer_plan(cfg))
    np.testing.assert_allclose(lg.numpy(), jl, **LOGITS)
    np.testing.assert_allclose(aux.item(), jaux, rtol=1e-5, atol=1e-6)
    lu, aux_u = lm.forward(params, cfg, ParallelContext(world=world, backend=backend), tokens)
    if backend == "eager":
        assert torch.equal(lg, lu) and torch.equal(aux, aux_u)
    else:
        np.testing.assert_allclose(lg.numpy(), lu.numpy(), **F32)


def test_seam_chains_stay_within_the_reference_segments():
    """prefix (first_k_dense) / each pattern period / suffix: a chain never
    crosses them, so an inter-layer seam needs two eligible layers in one
    period."""
    ds = get_config("deepseek-moe-16b")
    assert [(r.start, r.stop) for r in lm.segments(ds)] == [(0, 1)] + [(i, i + 1) for i in range(1, 28)]
    sm = get_config("smollm-360m")
    assert len(lm.segments(sm)) == 32
    two = dataclasses.replace(sm, n_layers=5, pattern=("attn", "attn"))
    assert [(r.start, r.stop) for r in lm.segments(two)] == [(0, 2), (2, 4), (4, 5)]
