"""The port's quantized wires and packed weights against the JAX package.

``repro_torch.core.quant`` (QuantSpec, the codec, ``pack_weight``), the
executors' wire edges (``compile_overlap(quant=)`` on the eager backend, the
seam and the a2a pair), packed weights through ``blocked_dot``, both
executors and the fused kernels' plain versions, ``ParallelContext(quant=)``
through ``nn/ffn.apply_seq`` and ``training/compression`` — each against its
``repro`` counterpart on the CPU (a 4-device mesh of the 8 emulated CPU
devices), inputs from numpy seeds.

The port's values are rank-stacked ``[W, ...]``: a "per_tile" scale is one
per rank, so rank r's codes and scales are held bitwise against the
reference's quantization of rank r's shard.

Tolerances, each with its reason:
  * codes, scales, packings and compression: bitwise (the same float ops);
  * AG flows and packed weights: 1e-5 of max |reference| (the tiles are
    quantized once from identical inputs, so the codes agree and only the
    GEMM's summation order differs);
  * flowing reductions (RS, the seam's RS half, the a2a combine): one code
    step per hop, ``(W - 1) x step``, since a partial that the two sides sum
    in another order may round to the neighbouring code at a hop; a step of
    int8 is ``A / 127`` with A the largest partial any hop can carry (the
    sum of |every rank's partial|), of fp8 e4m3 ``A / 14`` (its spacing of 32
    at 448), of bf16 ``A / 128``;
  * the float32 wire: bitwise equal to the identity wire.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import make_mesh, shard_map
from repro.configs import get_config as j_get_config
from repro.core import BlockChannel as JChannel
from repro.core import CommSpec as JComm
from repro.core import compile_overlap as j_compile
from repro.core import comp_tiles as j_tiles
from repro.core import quant as jq
from repro.nn import ffn as j_ffn
from repro.nn import moe as j_nn_moe
from repro.parallel.context import ParallelContext as JContext
from repro.training import compression as j_comp
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import shard_cols, shard_mlp, shard_packed, shard_rows
from repro_torch.core import BlockChannel, CommSpec, compile_overlap
from repro_torch.core import quant as tq
from repro_torch.core.comp_tiles import blocked_dot
from repro_torch.kernels import ag_gemm, ag_gemm_plain, gemm_rs, gemm_rs_plain
from repro_torch.nn import ffn
from repro_torch.nn.layers import rms_norm
from repro_torch.parallel.context import ParallelContext
from repro_torch.training import compression as t_comp
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

R = 4
ORDER, NCH = "bidir_ring", 2  # two channels in opposite directions: every edge kind
STEP = {"int8": 1 / 127, "float8_e4m3fn": 1 / 14, "bfloat16": 1 / 128, "float32": 0.0}
REL = 1e-5
A2A = ("a2a_dispatch", "combine_rs")
SEAM = ("matmul_rs", "ag_matmul")


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh((R,), ("model",))


@pytest.fixture(scope="module")
def world():
    return World(R, "cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bits(a) -> np.ndarray:
    """Codes as raw bytes (fp8 compared bit for bit)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if "float8" in str(a.dtype) else a


def _chans(quant=None, order=ORDER, nch=NCH):
    j = JChannel(axis="model", num_channels=nch, comm=JComm(order=order))
    t = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    if quant is not None:
        j, t = j.with_(quant=jq.QuantSpec(**quant)), t.with_(quant=tq.QuantSpec(**quant))
    return j, t


def _close(got: torch.Tensor, want, atol: float, what: str = ""):
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err <= atol, (what, err, atol)


# ---- the spec -------------------------------------------------------------------

SPECS = [
    {},
    {"wire_dtype": "int8", "granularity": "per_channel"},
    {"wire_dtype": "float8_e4m3fn"},
    {"wire_dtype": "bfloat16"},
    {"wire_dtype": "float32"},
    {"wire_dtype": "float16"},
    {"weight_dtype": "int4", "zero_point": True},
    {"weight_dtype": "int8"},
    {"wire_dtype": "int4"},
    {"granularity": "per_row"},
    {"weight_dtype": "float16"},
    {"zero_point": True},
]


def _build(mod, kw):
    try:
        return mod.QuantSpec(**kw), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("kw", SPECS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_spec_matches_reference(kw):
    """Validation raises for the same inputs with the same message; the
    derived views and ``scale_slots`` agree for every flow."""
    (j, j_err), (t, t_err) = _build(jq, kw), _build(tq, kw)
    assert t_err == j_err
    if j is None:
        return
    assert t.is_quantized == j.is_quantized
    for accum, t_accum in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        assert t.resolve_wire(t_accum) == j.resolve_wire(accum) == t.resolve_wire(accum)
        assert t.is_identity(t_accum) == j.is_identity(accum)
    for flow in ("ag", "rs", "ag_rs", "a2a", "a2a_rs"):
        for world, nch, steps in ((8, 2, 8), (4, 1, 4), (2, 3, 2)):
            assert t.scale_slots(flow, world, nch, steps) == j.scale_slots(flow, world, nch, steps)
    if t.is_quantized:
        with pytest.raises(ValueError, match="flow"):
            t.scale_slots("sideways", 8, 2, 8)
    for wire in tq.WIRE_DTYPES:
        assert tq.wire_itemsize(wire) == jq.wire_itemsize(wire)


@pytest.mark.parametrize("kind", ["ag_matmul", "matmul_rs", "ag_attention", "ag_moe", "a2a_dispatch", "combine_rs"])
def test_plan_wire_views_match_reference(kind):
    """``TilePlan.flow_dtype`` and ``quant_table_spec`` for every flow, wire
    and accumulation dtype against the reference's plan."""
    from repro.core.plan import build_plan as j_build_plan
    from repro_torch.core.plan import build_plan

    for quant in ({}, {"wire_dtype": "int8"}, {"wire_dtype": "bfloat16"}, {"wire_dtype": "float8_e4m3fn"}):
        for accum in ("float32", "bfloat16"):
            j = JChannel(axis="model", comp=dataclasses.replace(JChannel(axis="model").comp, accum_dtype=accum),
                         quant=jq.QuantSpec(**quant))  # fmt: skip
            t = BlockChannel(axis="model", comp=dataclasses.replace(BlockChannel(axis="model").comp, accum_dtype=accum),
                             quant=tq.QuantSpec(**quant))  # fmt: skip
            jp, tp = j_build_plan(kind, j, 8, 2), build_plan(kind, t, 8, 2)
            assert (tp.flow, tp.flow_dtype, tp.quant_table_spec()) == (jp.flow, jp.flow_dtype, jp.quant_table_spec())


# ---- the codec ------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("granularity", ["per_tile", "per_channel"])
def test_quantize_bitwise_per_rank(wire, granularity):
    """Rank r's codes and scale are the reference's quantization of rank r's
    shard: per_tile scales [W], per_channel [W, n]."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((R, 2, 6, 10)) * np.array([1e-3, 1.0, 1e2, 5.0])[:, None, None, None]).astype(np.float32)
    got = tq.quantize(torch.from_numpy(x), wire, granularity)
    assert tuple(got.scale.shape) == ((R,) if granularity == "per_tile" else (R, 10))
    for r in range(R):
        want = jq.quantize(jnp.asarray(x[r]), wire, granularity)
        np.testing.assert_array_equal(_bits(got.q[r]), _bits(want.q))
        np.testing.assert_array_equal(got.scale[r].numpy(), np.asarray(want.scale))
        np.testing.assert_array_equal(
            tq.dequantize(got, torch.float32)[r].numpy(), np.asarray(jq.dequantize(want, jnp.float32))
        )


@pytest.mark.parametrize("wdtype,zp", [("int8", False), ("int4", True), ("int8", True), ("int4", False)])
def test_pack_weight_bitwise_per_rank(wdtype, zp):
    """``pack_weight`` of a rank-stacked [W, k, n] weight reduces over k only:
    rank r's codes / scale / zero are the reference's packing of w[r]; a
    plain [k, n] weight packs as the reference's; dequantization agrees."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((R, 24, 16)) + rng.uniform(-1, 2, (R, 1, 16))).astype(np.float32)
    spec_t, spec_j = tq.QuantSpec(weight_dtype=wdtype, zero_point=zp), jq.QuantSpec(weight_dtype=wdtype, zero_point=zp)
    got = tq.pack_weight(torch.from_numpy(w), spec_t)
    assert got.q.dtype == torch.int8 and tuple(got.scale.shape) == (R, 16) and got.dtype == wdtype
    for r in range(R):
        want = jq.pack_weight(jnp.asarray(w[r]), spec_j)
        np.testing.assert_array_equal(got.q[r].numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale[r].numpy(), np.asarray(want.scale))
        assert (got.zero is None) == (want.zero is None)
        if zp:
            np.testing.assert_array_equal(got.zero[r].numpy(), np.asarray(want.zero))
    plain = tq.pack_weight(torch.from_numpy(w[0]), spec_t)
    np.testing.assert_array_equal(plain.q.numpy(), got.q[0].numpy())
    deq_t = tq.dequantize_weight(got.q, got.scale, got.zero)
    deq_j = jq.dequantize_weight(*(jnp.asarray(np.array(a)) if a is not None else None
                                   for a in (got.q[1], got.scale[1], got.zero[1] if zp else None)))  # fmt: skip
    np.testing.assert_array_equal(deq_t[1].numpy(), np.asarray(deq_j))
    with pytest.raises(ValueError, match="weight_dtype"):
        tq.pack_weight(torch.from_numpy(w), tq.QuantSpec())


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (7, 1e-3), (42, 1e3)])
@pytest.mark.parametrize("granularity", ["per_tile", "per_channel"])
def test_quantize_roundtrip_bound(seed, scale, granularity):
    """|x - deq(quant(x))| <= scale / 2 elementwise (absmax maps to +/-127 exactly)."""
    x = torch.from_numpy((np.random.RandomState(seed).randn(R, 16, 24) * scale).astype(np.float32))
    payload = tq.quantize(x, "int8", granularity)
    bound = 0.5 * tq._scale_view(payload.scale, x.dim())
    assert ((tq.dequantize(payload, torch.float32) - x).abs() <= bound + 1e-6 * scale).all()


def test_per_channel_beats_per_tile_on_skewed_columns():
    x = np.random.RandomState(0).randn(R, 64, 8).astype(np.float32)
    x[..., 0] *= 1000.0  # one hot column blows up the shared per-tile scale
    xt = torch.from_numpy(x)
    err = {g: (tq.dequantize(tq.quantize(xt, "int8", g), torch.float32) - xt).abs()[..., 1:].max().item()
           for g in ("per_tile", "per_channel")}  # fmt: skip
    assert err["per_channel"] < err["per_tile"] / 10.0


def test_encode_tree_identity_and_passthrough():
    """The inherited wire returns the same objects (the bitwise path); int8
    payloads replace float leaves and routing tables pass through; a float
    wire is a cast; decode returns the accumulation dtype."""
    x = torch.ones((R, 4, 4))
    ids = torch.arange(R * 4).reshape(R, 4)
    tree = (x, ids, x * 0.5)
    assert tq.encode_tree(tree, tq.QuantSpec(), torch.float32) is tree
    assert tq.encode_tree(tree, tq.QuantSpec(wire_dtype="float32"), "float32") is tree
    enc = tq.encode_tree(tree, tq.QuantSpec(wire_dtype="int8"), torch.float32)
    assert isinstance(enc[0], tq.WirePayload) and isinstance(enc[2], tq.WirePayload) and enc[1] is ids
    dec = tq.decode_tree(enc, tq.QuantSpec(wire_dtype="int8"), torch.float32)
    assert dec[0].dtype == torch.float32 and dec[1] is ids and torch.equal(dec[2], x * 0.5)
    bf = tq.encode_tree(tree, tq.QuantSpec(wire_dtype="bfloat16"), torch.float32)
    assert bf[0].dtype == torch.bfloat16 and bf[1] is ids
    assert tq.decode_tree(bf, tq.QuantSpec(wire_dtype="bfloat16"), torch.float32)[0].dtype == torch.float32


# ---- gradient compression -----------------------------------------------------------


def test_compression_matches_reference(mesh4):
    """The codec is re-exported; ``compress_with_feedback`` gives the
    reference's codes and scale bitwise, its error to one rounding, and keeps
    the error-feedback contract; ``psum_compressed``
    over the world's axis equals the reference's over the mesh axis."""
    assert t_comp.quantize_int8 is tq.quantize_int8 and t_comp.dequantize_int8 is tq.dequantize_int8
    rng = np.random.default_rng(4)
    g = (rng.standard_normal((R, 33, 7)) * np.array([1e-3, 1.0, 3.0, 1e3])[:, None, None]).astype(np.float32)
    err = (rng.standard_normal((R, 33, 7)) * 1e-3).astype(np.float32)
    q, s, new = t_comp.compress_with_feedback(torch.from_numpy(g[1]), torch.from_numpy(err[1]))
    jq_, js, jn = j_comp.compress_with_feedback(jnp.asarray(g[1]), jnp.asarray(err[1]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # new_err = g32 - q * scale: XLA may fuse the product into the subtraction, so one rounding apart
    np.testing.assert_allclose(new.numpy(), np.asarray(jn), rtol=0, atol=2.0**-22 * np.abs(g[1] + err[1]).max())
    assert (new.abs() <= s * 0.5 + 1e-6).all()
    world = World(R, "cpu")
    mean, new_err = t_comp.psum_compressed(torch.from_numpy(g), torch.from_numpy(err), world)
    sm = shard_map(lambda g_, e_: j_comp.psum_compressed(g_[0], e_[0], "model"), mesh4,
                   in_specs=(P("model"), P("model")), out_specs=(P(), P("model")))  # fmt: skip
    j_mean, j_err = jax.jit(sm)(jnp.asarray(g), jnp.asarray(err))
    np.testing.assert_array_equal(mean[2].numpy(), np.asarray(j_mean))  # int32 sums, one max scale: exact
    ulp = np.abs(g + err).max(axis=(1, 2))[:, None, None] * 2.0**-22  # two roundings of the gradient's size
    assert (np.abs(new_err.numpy() - np.asarray(j_err).reshape(new_err.shape)) <= ulp).all()
    assert torch.equal(mean[0], mean[3])  # replicated over the ranks


# ---- quantized wires through the executors ------------------------------------------


def _ag_operands(seed, b=2, m_loc=8, k=16, n_loc=12):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, R * m_loc, k)).astype(np.float32), rng.standard_normal((k, R * n_loc)).astype(
        np.float32
    )


def _rs_operands(seed, b=2, m=R * 8, k_loc=8, n=16):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, m, R * k_loc)).astype(np.float32), rng.standard_normal((R * k_loc, n)).astype(
        np.float32
    )


def _jax_op(mesh, kind, ch, x, w, w_spec=None, quant=None):
    """The reference's ``compile_overlap(kind, ch, quant=quant)`` under
    shard_map over the model axis (x, w global; ``w_spec`` a packed weight's
    specs)."""
    lead = (None,) * (x.ndim - 2)
    if kind == "ag_matmul":
        specs = (P(*lead, "model", None), w_spec or P(None, "model")), P(*lead, None, "model")
    else:
        specs = (P(*lead, None, "model"), w_spec or P("model", None)), P(*lead, "model", None)
    sm = shard_map(j_compile(kind, ch, quant=quant), mesh, in_specs=specs[0], out_specs=specs[1])
    return np.asarray(jax.jit(sm)(jnp.asarray(x), w))


def _port_ag(world, x, w):
    return world.shard(torch.from_numpy(x), 1), shard_cols(torch.from_numpy(w), world)


def _port_rs(world, x, w):
    return world.shard(torch.from_numpy(x), 2), shard_rows(torch.from_numpy(w), world)


def _rs_reach(xs: torch.Tensor, ws: torch.Tensor) -> float:
    """A: the largest |partial| any RS hop can carry, max of sum_r |x_r w_r|."""
    return torch.matmul(xs, ws[:, None]).abs().sum(0).max().item()


WIRES = [("int8", "per_tile"), ("int8", "per_channel"), ("float8_e4m3fn", "per_tile"), ("bfloat16", "per_tile"),
         ("float32", "per_tile")]  # fmt: skip


@pytest.mark.parametrize("wire,granularity", WIRES)
@pytest.mark.parametrize("kind", ["ag_matmul", "matmul_rs"])
def test_wire_flows_match_reference(mesh4, world, kind, wire, granularity):
    """``compile_overlap(kind, quant=QuantSpec(wire))`` on the eager backend
    against the reference's on the mesh: AG within 1e-5 of max, RS within one
    code step per hop; the float32 wire equals the identity bitwise."""
    quant = {"wire_dtype": wire, "granularity": granularity}
    jch, tch = _chans()
    x, w = (_ag_operands if kind == "ag_matmul" else _rs_operands)(11)
    xs, ws = (_port_ag if kind == "ag_matmul" else _port_rs)(world, x, w)
    ref = _jax_op(mesh4, kind, jch, x, jnp.asarray(w), quant=jq.QuantSpec(**quant))
    fn = compile_overlap(kind, tch, world=world, quant=tq.QuantSpec(**quant))
    got = fn(xs, ws)
    ident = compile_overlap(kind, tch, world=world)(xs, ws)
    if kind == "ag_matmul":
        got, ident = world.unshard(got, 2), world.unshard(ident, 2)
        _close(got, ref, REL * np.abs(ref).max(), kind)
    else:
        got, ident = world.unshard(got, 1), world.unshard(ident, 1)
        _close(got, ref, (R - 1) * STEP[wire] * _rs_reach(xs, ws) + REL * np.abs(ref).max(), kind)
    if wire == "float32":
        assert torch.equal(got, ident)
    else:
        assert (got - ident).abs().max().item() > 0  # the wire really quantized / rounded


def test_float32_wire_is_bitwise_the_identity(world):
    """A float32 wire over float32 accumulation: encode / decode are the
    identity on every backend, the fused plain versions included."""
    x, w = _rs_operands(12)
    xs, ws = _port_rs(world, x, w)
    xa, wa = _port_ag(world, *_ag_operands(12))
    f32 = tq.QuantSpec(wire_dtype="float32")
    _, tch = _chans()
    for backend in ("eager", "fused"):
        assert torch.equal(compile_overlap("matmul_rs", tch, world=world, backend=backend, quant=f32)(xs, ws),
                           compile_overlap("matmul_rs", tch, world=world, backend=backend)(xs, ws))  # fmt: skip
        assert torch.equal(compile_overlap("ag_matmul", tch, world=world, backend=backend, quant=f32)(xa, wa),
                           compile_overlap("ag_matmul", tch, world=world, backend=backend)(xa, wa))  # fmt: skip


def _glue(y):
    return y * 0.5 + 1.0


def test_seam_with_int8_wire_matches_reference(mesh4, world):
    """The list form's ``quant=`` on the RS -> AG seam: the RS half re-encodes
    per hop, the AG half quantizes its tiles once.  y within one code step a
    hop; the AG output within what that step moves through ``glue`` and
    w2, plus one code step of its own tiles."""
    rng = np.random.default_rng(6)
    x, w1, w2, res = (rng.standard_normal(s).astype(np.float32)
                      for s in ((2, R * 8, R * 8), (R * 8, 16), (16, R * 8), (2, R * 8, 16)))  # fmt: skip
    spec = {"wire_dtype": "int8"}
    jch, tch = _chans()
    fn = j_compile(list(SEAM), channel=jch, quant=jq.QuantSpec(**spec))
    sm = shard_map(lambda x_, w1_, w2_, r_: fn(x_, w1_, w2_, residual=r_, glue=_glue), mesh4,
                   in_specs=(P(None, None, "model"), P("model", None), P(None, "model"), P(None, "model", None)),
                   out_specs=(P(None, "model", None), P(None, None, "model")))  # fmt: skip
    jy, jg = (np.asarray(a) for a in jax.jit(sm)(x, w1, w2, res))
    t = [torch.from_numpy(a) for a in (x, w1, w2, res)]
    xs, w1s, w2s, rs = world.shard(t[0], 2), world.shard(t[1], 0), world.shard(t[2], 1), world.shard(t[3], 1)
    seam = compile_overlap(list(SEAM), tch, world=world, quant=tq.QuantSpec(**spec))
    y, g = seam(xs, w1s, w2s, residual=rs, glue=_glue)
    dy = (R - 1) * STEP["int8"] * _rs_reach(xs, w1s)
    _close(world.unshard(y, 1), jy, dy + REL * np.abs(jy).max(), "seam y")
    h_step = STEP["int8"] * np.abs(_glue(jy)).max()
    dg = (0.5 * dy + 2 * h_step) * np.abs(w2).sum(0).max()  # glue halves dy; a tile code may flip
    _close(world.unshard(g, 2), jg, dg + REL * np.abs(jg).max(), "seam ag")
    y0, _ = compile_overlap(list(SEAM), tch, world=world)(xs, w1s, w2s, residual=rs, glue=_glue)
    assert (y - y0).abs().max().item() > 0


def test_a2a_pair_with_int8_wire_matches_reference(mesh4, world):
    """The expert-parallel pair with an int8 wire: the token tiles and their
    routing weights are quantized once at their origin (the ids pass
    through), each returning partial once for its hop.  Within one code
    step per returned partial of the reference."""
    d, e, f, k, m_loc = 16, 8, 12, 2, 16
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((R * m_loc, d)) * 0.5).astype(np.float32)
    wr = rng.standard_normal((d, e)).astype(np.float32)
    wgu = (rng.standard_normal((e, d, 2 * f)) * 0.1).astype(np.float32)
    wdn = (rng.standard_normal((e, f, d)) * 0.1).astype(np.float32)
    ids, wts, _ = j_nn_moe.moe_router(jnp.asarray(x), jnp.asarray(wr), num_experts=e, top_k=k)
    ids, wts = np.asarray(ids), np.asarray(wts)
    spec = {"wire_dtype": "int8"}
    jch, tch = _chans()
    fn = j_compile(list(A2A), channel=jch, quant=jq.QuantSpec(**spec), capacity_factor=2.0)
    specs = (P("model", None),) * 3 + (P("model", None, None),) * 2
    sm = shard_map(fn, mesh4, in_specs=specs, out_specs=P("model", None))
    ref = np.asarray(jax.jit(sm)(x, ids, wts, wgu, wdn))
    args = (world.shard(_t(x), 0), world.shard(_t(ids).long(), 0), world.shard(_t(wts), 0),
            shard_rows(_t(wgu), world), shard_rows(_t(wdn), world))  # fmt: skip
    got = compile_overlap(list(A2A), tch, world=world, quant=tq.QuantSpec(**spec))(*args, capacity_factor=2.0)
    ident = compile_overlap(list(A2A), tch, world=world)(*args, capacity_factor=2.0)
    reach = ident.abs().max().item() * k  # a returned partial carries at most k of a token's expert outputs
    _close(world.unshard(got, 0), ref, (R - 1) * STEP["int8"] * reach + REL * np.abs(ref).max(), "a2a")
    assert (got - ident).abs().max().item() > 0


def test_ag_moe_with_int8_wire_matches_reference(mesh4, world):
    """The AG+MoE double ring ("ag_rs") with an int8 wire: the token tiles and
    their routing weights quantized once, the reduction riding the tiles
    re-encoded at each of its W - 1 hops and at its ``align_perm`` hop home.
    Within one code step per hop of the reference."""
    d, e, f, k, m_loc = 16, 8, 12, 2, 16
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((R * m_loc, d)) * 0.5).astype(np.float32)
    wr = rng.standard_normal((d, e)).astype(np.float32)
    wgu = (rng.standard_normal((e, d, 2 * f)) * 0.1).astype(np.float32)
    wdn = (rng.standard_normal((e, f, d)) * 0.1).astype(np.float32)
    ids, wts, _ = j_nn_moe.moe_router(jnp.asarray(x), jnp.asarray(wr), num_experts=e, top_k=k)
    ids, wts = np.asarray(ids), np.asarray(wts)
    spec = {"wire_dtype": "int8"}
    jch, tch = _chans()
    fn = j_compile("ag_moe", jch, quant=jq.QuantSpec(**spec), capacity_factor=2.0)
    specs = (P("model", None),) * 3 + (P("model", None, None),) * 2
    ref = np.asarray(jax.jit(shard_map(fn, mesh4, in_specs=specs, out_specs=P("model", None)))(x, ids, wts, wgu, wdn))
    args = (world.shard(_t(x), 0), world.shard(_t(ids).long(), 0), world.shard(_t(wts), 0),
            shard_rows(_t(wgu), world), shard_rows(_t(wdn), world))  # fmt: skip
    got = compile_overlap("ag_moe", tch, world=world, quant=tq.QuantSpec(**spec))(*args, capacity_factor=2.0)
    ident = compile_overlap("ag_moe", tch, world=world)(*args, capacity_factor=2.0)
    reach = ident.abs().max().item() * k  # a token's reduction sums its k experts' outputs
    _close(world.unshard(got, 0), ref, R * STEP["int8"] * reach + REL * np.abs(ref).max(), "ag_moe")
    assert (got - ident).abs().max().item() > 0


# ---- packed weights ---------------------------------------------------------------------


@pytest.mark.parametrize("wdtype,zp", [("int8", False), ("int4", True)])
def test_packed_blocked_dot_matches_reference(wdtype, zp):
    """``blocked_dot`` dequantizes a PackedWeight per block: the reference's
    result within 1e-5 of max, and ``col_slice`` keeps scales with codes."""
    rng = np.random.RandomState(21)
    x, w = rng.randn(32, 48).astype(np.float32), rng.randn(48, 64).astype(np.float32)
    jp = jq.pack_weight(jnp.asarray(w), jq.QuantSpec(weight_dtype=wdtype, zero_point=zp))
    tp = tq.pack_weight(torch.from_numpy(w), tq.QuantSpec(weight_dtype=wdtype, zero_point=zp))
    want = np.asarray(j_tiles.blocked_dot(jnp.asarray(x), jp, (16, 32, 16), accum=jnp.float32))
    for tile in ((16, 32, 16), (32, 64, 48)):
        _close(blocked_dot(torch.from_numpy(x), tp, tile), want, REL * np.abs(want).max())
    lo, hi = 16, 48
    _close(blocked_dot(torch.from_numpy(x), tp.col_slice(lo, hi), (16, 32, 16)), want[:, lo:hi],
           REL * np.abs(want).max())  # fmt: skip


@pytest.mark.parametrize("wdtype,zp", [("int8", False), ("int4", True)])
@pytest.mark.parametrize("kind", ["ag_matmul", "matmul_rs"])
def test_packed_weights_through_both_executors(mesh4, world, kind, wdtype, zp):
    """A weight the reference packs globally, converted by
    ``convert.shard_packed`` (columns for AG, rows with the scales
    replicated for RS), through the eager executor, the fused backend and
    the kernels' plain versions directly: the reference's xla executor on
    the same packing within 1e-5 of max."""
    jch, tch = _chans()
    x, w = (_ag_operands if kind == "ag_matmul" else _rs_operands)(13)
    spec = jq.QuantSpec(weight_dtype=wdtype, zero_point=zp)
    jp = jq.pack_weight(jnp.asarray(w), spec)
    cols = kind == "ag_matmul"
    vec = P("model") if cols else P(None)
    w_spec = jq.PackedWeight(P(None, "model") if cols else P("model", None), vec, vec if zp else None, wdtype)
    ref = _jax_op(mesh4, kind, jch, x, jp, w_spec)
    xs, _ = (_port_ag if cols else _port_rs)(world, x, w)
    tp = shard_packed(jp, world, "cols" if cols else "rows")
    assert tuple(tp.scale.shape) == (R, tp.q.shape[-1])
    unshard = (lambda o: world.unshard(o, 2)) if cols else (lambda o: world.unshard(o, 1))
    plain = ag_gemm_plain if cols else gemm_rs_plain
    outs = [compile_overlap(kind, tch, world=world, backend=b)(xs, tp) for b in ("eager", "fused")]
    outs += [plain(xs, tp, channel=tch), (ag_gemm if cols else gemm_rs)(xs, tp, channel=tch)]
    for out in outs:
        _close(unshard(out), ref, REL * np.abs(ref).max(), kind)
    if cols:  # column-parallel: packing each rank's shard is packing the global weight
        own = tq.pack_weight(shard_cols(torch.from_numpy(w), world), tq.QuantSpec(weight_dtype=wdtype, zero_point=zp))
        assert torch.equal(own.q, tp.q) and torch.equal(own.scale, tp.scale)


def test_plain_versions_replay_each_routes_formula(world):
    """The bf16 route forms ``q - zero`` in bf16 and scales the float32 sum in
    its epilogue; its plain version replays that, within bf16's 2e-2 of the
    float32 route's (the reference's formula)."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((R, 2, 8, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((R, 32, 48)).astype(np.float32) + 0.5)
    tp = tq.pack_weight(w, tq.QuantSpec(weight_dtype="int8", zero_point=True))
    _, tch = _chans()
    for fn in (ag_gemm_plain, gemm_rs_plain):
        f32, bf16 = fn(x, tp, channel=tch), fn(x.bfloat16(), tp, channel=tch)
        assert bf16.dtype == torch.bfloat16
        assert (bf16.float() - f32).abs().max().item() <= 2e-2 * f32.abs().max().item()


def test_gemm_rs_plain_bf16_wire_matches_reference_split(mesh4, world):
    """``gemm_rs``'s wire dtype: a bf16 wire under float32 accumulation keeps
    its recv slots in bf16 (each partial cast at the send edge, added back in
    float32), the reference's split path, held against the reference's xla
    executor on the same wire (one bf16 step per hop); ``ag_gemm`` gathers x
    in its own dtype whatever the wire, so its output is the identity's."""
    quant = {"wire_dtype": "bfloat16"}
    jch, tch = _chans(quant)
    x, w = _rs_operands(15)
    ref = _jax_op(mesh4, "matmul_rs", jch, x, jnp.asarray(w))
    xs, ws = _port_rs(world, x, w)
    got = gemm_rs_plain(xs, ws, channel=tch)
    _close(world.unshard(got, 1), ref, (R - 1) * STEP["bfloat16"] * _rs_reach(xs, ws) + REL * np.abs(ref).max())
    assert (got - gemm_rs_plain(xs, ws, channel=_chans()[1])).abs().max().item() > 0
    xa, wa = _port_ag(world, *_ag_operands(15))
    assert torch.equal(ag_gemm_plain(xa, wa, channel=tch), ag_gemm_plain(xa, wa, channel=_chans()[1]))


# ---- the context and the nn blocks ----------------------------------------------------


def _mlp(seed, d=32, f=64):
    rng = np.random.default_rng(seed)
    return {
        "ln": (rng.standard_normal(d) * 0.1).astype(np.float32),
        "w_gu": (rng.standard_normal((d, 2 * f)) * d**-0.5).astype(np.float32),
        "w_down": (rng.standard_normal((f, d)) * f**-0.5).astype(np.float32),
    }, rng.standard_normal((2, R * 8, d)).astype(np.float32)


def _interleave(w_gu):
    """The JAX package's per-shard gate|up layout from a [gate || up] matrix."""
    d, two_f = w_gu.shape
    f = two_f // 2
    g, u = w_gu[:, :f].reshape(d, R, f // R), w_gu[:, f:].reshape(d, R, f // R)
    return np.concatenate([g, u], axis=-1).reshape(d, two_f)


def test_context_quant_threading(world):
    """``ParallelContext(quant=)`` pins the spec on its channel; True is
    "auto", which opens the tuner's wire axis under ``tune=True`` and
    otherwise leaves the channel's own wire (as the reference's context
    does); anything else raises."""
    pc = ParallelContext(world=world, quant=tq.QuantSpec(wire_dtype="int8"))
    assert pc.channel.quant.wire_dtype == "int8"
    assert dataclasses.replace(pc, quant=tq.QuantSpec(wire_dtype="bfloat16")).channel.quant.wire_dtype == "bfloat16"
    auto = ParallelContext(world=world, quant=True)
    assert auto.quant == "auto" and auto.channel == ParallelContext(world=world).channel
    x, w = _port_rs(world, *_rs_operands(3))
    assert torch.equal(auto.matmul_rs(x, w), ParallelContext(world=world).matmul_rs(x, w))
    with pytest.raises(ValueError, match="quant"):
        ParallelContext(world=world, quant="int8")


@pytest.mark.parametrize("form", ["wire", "packed"])
def test_ffn_apply_seq_quant_matches_reference(mesh4, world, form):
    """``nn/ffn.apply_seq(quant=QuantSpec(wire_dtype="int8"))`` and the same
    block with int8 / int4 PackedWeight leaves against the reference's
    ``apply_seq`` on the mesh: the int8 wire within one code step of the
    down projection's hops carried through, the packed weights within 1e-5
    of max."""
    jcfg, cfg = j_reduce_config(j_get_config("smollm-360m")), reduce_config(get_config("smollm-360m"))
    glob, x = _mlp(16)
    glob["w_gu"] = _interleave(glob["w_gu"])
    jpc = JContext(mesh=mesh4, dp_axes=())
    wire = jq.QuantSpec(wire_dtype="int8") if form == "wire" else None
    jparams = {k: jnp.asarray(v) for k, v in glob.items()}
    specs = {"ln": P(None), "w_gu": P(None, "model"), "w_down": P("model", None)}
    t_params = shard_mlp({k: torch.from_numpy(v) for k, v in glob.items()}, world)
    if form == "packed":
        jparams["w_gu"] = jq.pack_weight(jparams["w_gu"], jq.QuantSpec(weight_dtype="int8"))
        jparams["w_down"] = jq.pack_weight(jparams["w_down"], jq.QuantSpec(weight_dtype="int4", zero_point=True))
        specs["w_gu"] = jq.PackedWeight(P(None, "model"), P("model"), None, "int8")
        specs["w_down"] = jq.PackedWeight(P("model", None), P(None), P(None), "int4")
        t_params["w_gu"] = shard_packed(jparams["w_gu"], world, "cols")
        t_params["w_down"] = shard_packed(jparams["w_down"], world, "rows")
    sm = shard_map(lambda p, x_: j_ffn.apply_seq(p, x_, jpc, jcfg, quant=wire), mesh4,
                   in_specs=(specs, P(None, "model", None)), out_specs=P(None, "model", None))  # fmt: skip
    ref = np.asarray(jax.jit(sm)(jparams, jnp.asarray(x)))
    pc = ParallelContext(world=world)
    t_wire = tq.QuantSpec(wire_dtype="int8") if form == "wire" else None
    got = world.unshard(ffn.apply_seq(t_params, world.shard(torch.from_numpy(x), 1), pc, cfg, quant=t_wire), 1)
    if form == "packed":
        _close(got, ref, REL * np.abs(ref).max(), "packed mlp")
        return
    # the down projection's hops may each land one code apart (its partials reach A); a code of
    # the gathered tiles may flip where the two rms_norms differ in the last bit: 3 x the RS bound
    xs = world.shard(torch.from_numpy(x), 1)
    gu = pc.ag_matmul(rms_norm(xs, t_params["ln"], cfg.norm_eps), t_params["w_gu"])
    reach = _rs_reach(ffn._gate(cfg, gu), t_params["w_down"])
    _close(got, ref, 3 * (R - 1) * STEP["int8"] * reach + REL * np.abs(ref).max(), "int8 mlp")
    plain = world.unshard(ffn.apply_seq(t_params, xs, pc, cfg), 1)
    assert (got - plain).abs().max().item() > 0


# ---- what the fused backend refuses --------------------------------------------------


def test_fused_refusals_and_auto(world):
    """A quantized activation wire on the fused backend raises
    NotImplementedError where the kernel is called (as the reference's
    Pallas kernels do); ``quant="auto"`` / True there resolves to a wire
    the kernel runs (the tuner offers no quantized wire on "fused"); the
    fused forms with eager permutes take the identity wire only; under
    autograd a packed weight raises rather than differentiate through
    codes; a PackedWeight and a float wire compile."""
    int8 = tq.QuantSpec(wire_dtype="int8")
    _, tch = _chans()
    xa, wa = _port_ag(world, *_ag_operands(17))
    for kind, args in (("ag_matmul", (xa, wa)), ("matmul_rs", _port_rs(world, *_rs_operands(17)))):
        with pytest.raises(NotImplementedError, match="quantized activation wires"):
            compile_overlap(kind, tch, world=world, backend="fused", quant=int8)(*args)
        compile_overlap(kind, tch, world=world, backend="fused", quant=tq.QuantSpec(wire_dtype="bfloat16"))(*args)
        for auto in ("auto", True):
            compile_overlap(kind, tch, world=world, backend="fused", quant=auto)(*args)
    with pytest.raises(NotImplementedError):
        compile_overlap("ag_attention", tch, world=world, backend="fused", quant=tq.QuantSpec(wire_dtype="bfloat16"))
    with pytest.raises(ValueError, match="quant"):
        compile_overlap("matmul_rs", tch, world=world, quant="int8")
    x, w = _port_rs(world, *_rs_operands(17))
    with pytest.raises(NotImplementedError, match="quantized activation wires"):
        gemm_rs(x, w, channel=tch.with_(quant=int8))
    with pytest.raises(NotImplementedError, match="quantized activation wires"):
        ag_gemm(xa, wa, channel=tch.with_(quant=int8))
    packed = tq.pack_weight(w, tq.QuantSpec(weight_dtype="int8"))
    fn = compile_overlap("matmul_rs", tch, world=world, backend="fused")
    with pytest.raises(NotImplementedError, match="packed"):
        fn(x.clone().requires_grad_(True), packed)
    with torch.no_grad():
        assert torch.equal(fn(x, packed), gemm_rs_plain(x, packed, channel=tch))
