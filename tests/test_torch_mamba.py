"""The port's Mamba-2 slice against the JAX package's, on the CPU.

Port side: ``repro_torch.kernels.mamba_ssd`` (the SSD intra-chunk wrapper
runs its plain version on CPU tensors), ``nn/mamba`` on a 4-rank ``World``
and the reduced mamba2-2.7b model (d_model 128, d_inner 256, 16 heads — 4
per rank —, d_state 16, headdim 16, chunk 16, 2 layers) with weights from
``convert.from_jax_params``.  JAX side: the Pallas ``ssd_intra_chunk`` in
interpret mode, ``ssd_chunked`` and its sequential oracle ``ref.ssd_ref``,
``nn/mamba`` in ``shard_map`` on a 4-device ``model`` mesh, and the model
on the 8-device mesh of ``tests/conftest.py`` (TP 4).  Inputs come from a
numpy seed.

Tolerances: the intra-chunk term 1e-5 in float32 (one product of <= 64
terms); bfloat16 inputs 2e-2 of max |oracle| against the float32 oracle on
the same bf16-rounded inputs; ``ssd_chunked`` and the Mamba block 1e-4
(float32, summation order); logits 2e-3 as ``tests/test_serving.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import kernels as jk
from repro.compat import make_mesh
from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.nn import mamba as j_mamba
from repro.parallel.context import ParallelContext as JContext
from repro.parallel.sharding import place
from repro_torch import kernels
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import PORT_FIELDS
from repro_torch.convert import F32_LEAVES, from_jax_params, shard_mamba
from repro_torch.kernels import mamba_ssd
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.nn import mamba
from repro_torch.parallel.context import ParallelContext
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

R = 4
ARCH = "mamba2-2.7b"
F32 = dict(atol=1e-4, rtol=1e-4)
LOGITS = dict(atol=2e-3, rtol=2e-3)
B, S0, EXTRA = 2, 16, 4
MAX_LEN = S0 + EXTRA


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh((R,), ("model",))


@pytest.fixture(scope="module")
def world():
    return World(R, "cpu")


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _intra_inputs(seed, t, q, p, spread=1.0):
    rng = np.random.default_rng(seed)
    cum = -np.cumsum(np.abs(rng.standard_normal((t, q))) * spread, axis=1).astype(np.float32)
    return cum, _rand(rng, t, q, q, scale=0.3), _rand(rng, t, q, p, scale=0.5)


def _ssd_inputs(seed, b=2, length=64, h=4, p=8, g=2, n=8):
    rng = np.random.default_rng(seed)
    x = _rand(rng, b, length, h, p, scale=0.5)
    dt = np.log1p(np.exp(_rand(rng, b, length, h))).astype(np.float32)  # softplus: positive
    a_log = _rand(rng, h, scale=0.5)
    return x, dt, a_log, _rand(rng, b, length, g, n, scale=0.3), _rand(rng, b, length, g, n, scale=0.3)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---- the intra-chunk term: plain version against the Pallas kernel ---------


@pytest.mark.parametrize("t,q,p", [(4, 16, 16), (3, 32, 16), (5, 64, 64), (7, 24, 40)])
def test_ssd_intra_plain_matches_pallas_interpret(t, q, p):
    cum, cb, xdt = _intra_inputs(t * q + p, t, q, p)
    want = np.asarray(jk.ssd_intra_chunk(jnp.asarray(cum), jnp.asarray(cb), jnp.asarray(xdt), interpret=True))
    kernels.reset_launch_counts()
    got = mamba_ssd.ssd_intra_chunk(*_t(cum, cb, xdt))  # CPU tensors: the plain version, no launch
    assert kernels.launch_counts()["ssd_intra_chunk"] == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mamba_ssd.ssd_intra_chunk_plain(*_t(cum, cb, xdt)).numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("q,p", [(16, 16), (64, 64)])
def test_ssd_intra_plain_bf16_against_f32_oracle(q, p):
    cum, cb, xdt = (a.bfloat16() for a in _t(*_intra_inputs(q + 3 * p, 6, q, p)))
    got = mamba_ssd.ssd_intra_chunk(cum, cb, xdt)
    assert got.dtype == torch.bfloat16
    oracle = np.asarray(
        jk.ssd_intra_chunk(*(jnp.asarray(a.float().numpy()) for a in (cum, cb, xdt)), interpret=True)
    )
    err = np.abs(got.float().numpy() - oracle).max()
    assert err <= 2e-2 * np.abs(oracle).max(), err


def test_ssd_intra_strongly_negative_cum_is_finite():
    """Decays underflow to 0 below the diagonal; the upper triangle (a large
    positive difference) is masked, never an overflow into the result."""
    cum, cb, xdt = _intra_inputs(9, 3, 64, 32, spread=60.0)
    got = mamba_ssd.ssd_intra_chunk(*_t(cum, cb, xdt))
    want = np.asarray(jk.ssd_intra_chunk(jnp.asarray(cum), jnp.asarray(cb), jnp.asarray(xdt), interpret=True))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_ssd_intra_rejects_bad_shapes():
    cum, cb, xdt = _t(*_intra_inputs(1, 2, 8, 4))
    with pytest.raises(ValueError):
        mamba_ssd.ssd_intra_chunk(cum, cb[:, :4], xdt)
    with pytest.raises(ValueError):
        mamba_ssd.ssd_intra_chunk(cum[0], cb, xdt)
    with pytest.raises(ValueError):
        mamba_ssd.ssd_chunked(*_t(*_ssd_inputs(1)), intra="pallas")


# ---- ssd_chunked against the JAX package's --------------------------------


@pytest.mark.parametrize("intra", mamba_ssd.INTRA_FORMS)
@pytest.mark.parametrize("length,chunk", [(64, 16), (50, 16), (64, 64), (37, 32)])
def test_ssd_chunked_matches_reference(intra, length, chunk):
    """L a multiple of the chunk, and ragged L (padded with dt = 0 steps)."""
    args = _ssd_inputs(length + chunk, length=length)
    jy, jh = jk.ssd_chunked(*(jnp.asarray(a) for a in args), chunk=chunk, return_state=True)
    y, h = mamba_ssd.ssd_chunked(*_t(*args), chunk=chunk, return_state=True, intra=intra)
    assert y.shape == args[0].shape and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32)
    y_only = mamba_ssd.ssd_chunked(*_t(*args), chunk=chunk, intra=intra)
    np.testing.assert_array_equal(y_only.numpy(), y.numpy())
    # the sequential recurrence (JAX oracle)
    np.testing.assert_allclose(y.numpy(), np.asarray(jref.ssd_ref(*(jnp.asarray(a) for a in args))), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("intra", mamba_ssd.INTRA_FORMS)
def test_ssd_chunked_state_continuation(intra):
    """Continuing from a returned state equals the JAX package's continuation
    and the full-length scan (as ``tests/test_kernels.py``)."""
    x, dt, a_log, bm, cm = _ssd_inputs(21, b=1, length=64, h=2, p=8, g=1, n=4)
    _, h1 = mamba_ssd.ssd_chunked(*_t(x, dt, a_log, bm, cm), chunk=16, return_state=True, intra=intra)
    cut = [a[:, :16] for a in (x, dt, bm, cm)]
    y2 = mamba_ssd.ssd_chunked(*_t(cut[0], cut[1], a_log, cut[2], cut[3]), chunk=16, h_init=h1, intra=intra)
    _, jh1 = jk.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, a_log, bm, cm)), chunk=16, return_state=True)
    jy2 = jk.ssd_chunked(*(jnp.asarray(a) for a in (cut[0], cut[1], a_log, cut[2], cut[3])), chunk=16, h_init=jh1)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), **F32)
    full = [np.concatenate([a, c], 1) for a, c in zip((x, dt, bm, cm), cut)]
    y_full = mamba_ssd.ssd_chunked(*_t(full[0], full[1], a_log, full[2], full[3]), chunk=16, intra=intra)
    np.testing.assert_allclose(y2.numpy(), y_full[:, 64:].numpy(), atol=1e-4, rtol=1e-3)


def test_ssd_chunked_bf16_keeps_input_dtype():
    x, dt, a_log, bm, cm = _t(*_ssd_inputs(5))
    y = mamba_ssd.ssd_chunked(x.bfloat16(), dt, a_log, bm.bfloat16(), cm.bfloat16(), chunk=16, intra="kernel")
    want = mamba_ssd.ssd_chunked(x.bfloat16().float(), dt, a_log, bm.bfloat16().float(), cm.bfloat16().float(), chunk=16)
    assert y.dtype == torch.bfloat16
    assert (y.float() - want).abs().max().item() <= 2e-2 * want.abs().max().item()


# ---- nn/mamba against the JAX block in shard_map --------------------------


@pytest.fixture(scope="module")
def block():
    jcfg = j_reduce_config(j_get_config(ARCH))
    cfg = reduce_config(get_config(ARCH))
    jp = j_mamba.init(jax.random.PRNGKey(2), jcfg, R, jnp.float32)
    tp = shard_mamba({k: torch.from_numpy(np.array(v)) for k, v in jp.items()}, World(R, "cpu"))
    return jcfg, cfg, jp, tp


def _specs(jpc):
    return {k: jpc.manual(v) for k, v in j_mamba.specs(None, R, None).items()}


def _cache_specs(jpc):
    return {k: jpc.manual(v) for k, v in j_mamba.cache_specs(None).items()}


def _global_cache(c):
    """Port cache (ssm [W, B, h_loc, N, P], conv [W, B, K-1, di_loc]) -> the
    JAX package's global layout (ssm [B, H, N, P], conv [B, K-1, d_inner])."""
    ssm, conv = c["ssm"], c["conv"]
    return (
        ssm.transpose(0, 1).reshape(ssm.shape[1], -1, *ssm.shape[3:]).numpy(),
        conv.permute(1, 2, 0, 3).reshape(conv.shape[1], conv.shape[2], -1).numpy(),
    )


def _port_cache(jc, world):
    ssm, conv = (torch.from_numpy(np.asarray(jc[k])) for k in ("ssm", "conv"))
    return {"ssm": world.shard(ssm, dim=1), "conv": world.shard(conv, dim=2)}


def test_block_param_layout(block):
    """w_xz | w_dt join per rank with each shard's x | z halves as stored,
    zero-padded to a multiple of 8 columns; the per-head leaves are float32
    whatever the model dtype."""
    jcfg, cfg, jp, tp = block
    d, di_loc, h_loc = cfg.d_model, 2 * cfg.d_model // R, 2 * cfg.d_model // cfg.ssm.headdim // R
    assert tp["w_in"].shape == (R, d, 136) and 2 * di_loc + h_loc == 132 and di_loc == 64 and h_loc == 4
    assert not tp["w_in"][..., 2 * di_loc + h_loc :].any()
    w_xz, w_dt = np.asarray(jp["w_xz"]), np.asarray(jp["w_dt"])
    for r in range(R):
        np.testing.assert_array_equal(tp["w_in"][r, :, : 2 * di_loc].numpy(), w_xz[:, r * 2 * di_loc : (r + 1) * 2 * di_loc])
        dt_cols = tp["w_in"][r, :, 2 * di_loc : 2 * di_loc + h_loc].numpy()
        np.testing.assert_array_equal(dt_cols, w_dt[:, r * h_loc : (r + 1) * h_loc])
    assert tp["conv"].shape == (R, cfg.ssm.d_conv, di_loc) and tp["w_out"].shape == (R, di_loc, d)
    assert tp["w_bc"].shape == (d, 2 * cfg.ssm.n_groups * cfg.ssm.d_state) and tp["ln"].shape == (d,)
    for k in ("dt_bias", "a_log", "d_skip"):
        assert tp[k].shape == (R, h_loc) and tp[k].dtype == torch.float32
    assert set(F32_LEAVES) >= {"dt_bias", "a_log", "d_skip", "router"}


@pytest.mark.parametrize("reduced", [False, True])
def test_in_projection_pad_is_zero_and_dropped(reduced):
    """``convert.shard_mamba`` pads each rank's ``w_in`` with zero columns to a
    multiple of 8 (mamba2-2.7b: 2580 -> 2584 per rank; reduced: 132 -> 136),
    and ``_split`` drops exactly the pad.  Full size runs on the meta device."""
    cfg = get_config(ARCH)
    cfg = reduce_config(cfg) if reduced else cfg
    d, s = cfg.d_model, cfg.ssm
    d_inner = s.expand * d
    heads = d_inner // s.headdim
    dev = "cpu" if reduced else "meta"
    mixer = {"ln": torch.zeros(d, device=dev), "w_xz": torch.ones(d, 2 * d_inner, device=dev),
             "w_dt": torch.ones(d, heads, device=dev), "w_bc": torch.zeros(d, 2 * s.d_state, device=dev),
             "conv": torch.zeros(s.d_conv, d_inner, device=dev), "w_out": torch.zeros(d_inner, d, device=dev),
             **{k: torch.zeros(heads, device=dev) for k in ("dt_bias", "a_log", "d_skip")}}  # fmt: skip
    w_in = shard_mamba(mixer, World(R, "cpu"))["w_in"]
    width, di_loc, h_loc = 2 * d_inner // R + heads // R, d_inner // R, heads // R
    assert w_in.shape == (R, d, -(-width // 8) * 8) and w_in.shape[-1] % 8 == 0
    assert w_in.shape[-1] == (2584 if not reduced else 136)
    x, z, dt = mamba._split(torch.arange(w_in.shape[-1]).expand(2, -1), di_loc, h_loc)
    assert x.shape[-1] == z.shape[-1] == di_loc and dt.shape[-1] == h_loc
    assert dt[0, -1].item() == width - 1  # the last real column; the pad is dropped
    if reduced:
        assert w_in[..., :width].all() and not w_in[..., width:].any()


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("return_state", [False, True])
def test_apply_seq_matches_reference(mesh4, world, block, backend, return_state):
    jcfg, cfg, jp, tp = block
    x = _rand(np.random.default_rng(4), B, R * 9, cfg.d_model)  # S = 36: a ragged last chunk
    jpc = JContext(mesh=mesh4)
    out_specs = (P(None, "model", None), _cache_specs(jpc)) if return_state else P(None, "model", None)
    sm = jpc.smap(lambda p, xx: j_mamba.apply_seq(p, xx, jpc, jcfg, return_state=return_state),
                  (_specs(jpc), P(None, "model", None)), out_specs)  # fmt: skip
    jout = jax.jit(sm)(jp, jnp.asarray(x))
    pc = ParallelContext(world=world, backend=backend)
    kernels.reset_launch_counts()
    out = mamba.apply_seq(tp, world.shard(torch.from_numpy(x), dim=1), pc, cfg, return_state=return_state)
    assert kernels.launch_counts()["ssd_intra_chunk"] == 0  # CPU tensors run the plain versions
    if return_state:
        (jy, jc), (y, c) = jout, out
        got_ssm, got_conv = _global_cache(c)
        assert c["ssm"].dtype == torch.float32
        np.testing.assert_allclose(got_ssm, np.asarray(jc["ssm"]), **F32)
        np.testing.assert_allclose(got_conv, np.asarray(jc["conv"]), **F32)
    else:
        jy, y = jout, out
    np.testing.assert_allclose(world.unshard(y, dim=1).numpy(), np.asarray(jy), **F32)


def test_apply_decode_matches_reference(mesh4, world, block):
    jcfg, cfg, jp, tp = block
    rng = np.random.default_rng(6)
    jc = jax.tree_util.tree_map(lambda a: jnp.asarray(_rand(rng, *a.shape, scale=0.5)), j_mamba.init_cache(jcfg, R, B, jnp.float32))
    jpc = JContext(mesh=mesh4)
    sm = jax.jit(jpc.smap(lambda p, xx, c: j_mamba.apply_decode(p, xx, c, jpc, jcfg),
                          (_specs(jpc), P(None, None, None), _cache_specs(jpc)),
                          (P(None, None, None), _cache_specs(jpc))))  # fmt: skip
    cache = _port_cache(jc, world)
    for i in range(3):
        x = _rand(rng, B, 1, cfg.d_model)
        jy, jc = sm(jp, jnp.asarray(x), jc)
        y, cache = mamba.apply_decode(tp, torch.from_numpy(x), cache, ParallelContext(world=world), cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    got_ssm, got_conv = _global_cache(cache)
    np.testing.assert_allclose(got_ssm, np.asarray(jc["ssm"]), **F32)
    np.testing.assert_allclose(got_conv, np.asarray(jc["conv"]), **F32)


def test_apply_decode_chunk_q_valid(mesh4, world, block):
    """Chunks of C = 3 rows with per-slot ``q_valid``: the real rows and the
    states match the JAX package's; a slot with no real row keeps its states
    bit for bit."""
    jcfg, cfg, jp, tp = block
    rng = np.random.default_rng(7)
    jc = jax.tree_util.tree_map(lambda a: jnp.asarray(_rand(rng, *a.shape, scale=0.5)), j_mamba.init_cache(jcfg, R, B, jnp.float32))
    jpc = JContext(mesh=mesh4)
    sm = jax.jit(jpc.smap(lambda p, xx, c, n: j_mamba.apply_decode_chunk(p, xx, c, jpc, jcfg, q_valid=n),
                          (_specs(jpc), P(None, None, None), _cache_specs(jpc), P(None)),
                          (P(None, None, None), _cache_specs(jpc))))  # fmt: skip
    cache = _port_cache(jc, world)
    pc = ParallelContext(world=world)
    for valid in ([3, 1], [2, 0], [0, 3]):
        x = _rand(rng, B, 3, cfg.d_model)
        before = {k: v.clone() for k, v in cache.items()}
        jy, jc = sm(jp, jnp.asarray(x), jc, jnp.asarray(valid, jnp.int32))
        y, out_cache = mamba.apply_decode_chunk(tp, torch.from_numpy(x), cache, pc, cfg, q_valid=torch.tensor(valid))
        assert out_cache is cache  # updated in place
        for b in range(B):
            np.testing.assert_allclose(y[b, : valid[b]].numpy(), np.asarray(jy)[b, : valid[b]], **F32)
            if valid[b] == 0:
                for k in cache:
                    assert torch.equal(cache[k][:, b], before[k][:, b]), k
        got_ssm, got_conv = _global_cache(cache)
        np.testing.assert_allclose(got_ssm, np.asarray(jc["ssm"]), **F32)
        np.testing.assert_allclose(got_conv, np.asarray(jc["conv"]), **F32)


def test_apply_decode_chunk_without_mask_is_the_recurrence(world, block):
    _, cfg, _, tp = block
    rng = np.random.default_rng(8)
    pc = ParallelContext(world=world)
    x = torch.from_numpy(_rand(rng, B, 2, cfg.d_model))
    c0 = mamba.init_cache(cfg, R, B, torch.float32, "cpu")
    y, c = mamba.apply_decode_chunk(tp, x, {k: v.clone() for k, v in c0.items()}, pc, cfg)
    y0, s = mamba.apply_decode(tp, x[:, :1], c0, pc, cfg)
    y1, s = mamba.apply_decode(tp, x[:, 1:], s, pc, cfg)
    torch.testing.assert_close(y, torch.cat([y0, y1], 1), atol=0, rtol=0)
    for k in c:
        torch.testing.assert_close(c[k], s[k], atol=0, rtol=0)


# ---- the reduced model ----------------------------------------------------


def _configs(vocab):
    jcfg = dataclasses.replace(j_reduce_config(j_get_config(ARCH)), vocab_size=vocab)
    cfg = dataclasses.replace(reduce_config(get_config(ARCH)), vocab_size=vocab)
    return jcfg, cfg


@pytest.fixture(scope="module")
def model(pc8, mesh8):
    jcfg, cfg = _configs(502)
    jparams = place(jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32), mesh8, jlm.specs(jcfg, pc8))
    world = World(R, "cpu")
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, world)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S0 + EXTRA)).astype(np.int32)
    return jcfg, cfg, jparams, params, world, toks


def _jcache(jc, layer):
    return np.asarray(jc["scan"][0]["ssm"][layer]), np.asarray(jc["scan"][0]["conv"][layer])


def _plain(v):
    """A config field as a plain value (a nested config as a dict)."""
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def _reference_fields(cfg):
    """The config's fields that the JAX package's config also has."""
    return [f for f in dataclasses.fields(cfg) if f.name not in PORT_FIELDS]


def test_config_matches_reference():
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    for f in _reference_fields(tc):
        assert _plain(getattr(tc, f.name)) == _plain(getattr(jc, f.name)), f.name
    assert tc.embed_scale == (jc.family == "vlm" or jc.name.startswith("gemma"))
    jr, tr = j_reduce_config(jc), reduce_config(tc)
    for f in _reference_fields(tr):
        assert _plain(getattr(tr, f.name)) == _plain(getattr(jr, f.name)), f.name
    assert (tr.d_model, tr.n_layers, tr.ssm.d_state, tr.ssm.headdim, tr.ssm.chunk) == (128, 2, 16, 16, 16)
    assert [ld.kind for ld in lm.layer_plan(tc)] == ["mamba"] * 64
    assert lm.padded_vocab(tc, R) == 50280


def test_model_param_layout(model):
    jcfg, cfg, jparams, params, world, _ = model
    assert len(params["layers"]) == cfg.n_layers and all(set(p) == {"mixer"} for p in params["layers"])
    low = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, world, torch.bfloat16)
    own = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.bfloat16)
    for tree in (low, own):
        mixer = tree["layers"][0]["mixer"]
        for k, v in mixer.items():
            assert v.dtype == (torch.float32 if k in F32_LEAVES else torch.bfloat16), k
            assert v.shape == params["layers"][0]["mixer"][k].shape, k
    jw = np.asarray(jparams["scan"][0]["mixer"]["w_out"][1])
    np.testing.assert_array_equal(params["layers"][1]["mixer"]["w_out"].reshape(-1, cfg.d_model).numpy(), jw)
    assert torch.equal(params["head"], params["embed"].reshape(-1, cfg.d_model).t())


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_forward_matches_reference(model, pc8, backend):
    jcfg, cfg, jparams, params, world, toks = model
    jl, jaux = jax.jit(lambda p, t: jlm.forward(p, jcfg, pc8, t))(jparams, jnp.asarray(toks))
    tl, aux = lm.forward(params, cfg, ParallelContext(world=world, backend=backend), torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    assert aux.item() == 0.0 and float(jaux) == 0.0


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_prefill_matches_reference(model, pc8, backend):
    jcfg, cfg, jparams, params, world, toks = model
    jl, jc = jax.jit(lambda p, t: jlm.prefill(p, jcfg, pc8, t, max_len=MAX_LEN))(jparams, jnp.asarray(toks[:, :S0]))
    pc = ParallelContext(world=world, backend=backend)
    tl, tc = lm.prefill(params, cfg, pc, torch.from_numpy(toks[:, :S0]).long(), max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    for i in range(cfg.n_layers):
        for got, want in zip(_global_cache(tc[i]), _jcache(jc, i)):
            np.testing.assert_allclose(got, want, **F32)


def test_decode_step_matches_reference(model, pc8):
    jcfg, cfg, jparams, params, world, toks = model
    pc = ParallelContext(world=world)
    _, jc = jax.jit(lambda p, t: jlm.prefill(p, jcfg, pc8, t, max_len=MAX_LEN))(jparams, jnp.asarray(toks[:, :S0]))
    _, tc = lm.prefill(params, cfg, pc, torch.from_numpy(toks[:, :S0]).long(), max_len=MAX_LEN)
    step = jax.jit(lambda p, c, t, n: jlm.decode_step(p, c, jcfg, pc8, t, n))
    for i in range(EXTRA):
        t = toks[:, S0 + i : S0 + i + 1]
        jl, jc = step(jparams, jc, jnp.asarray(t), S0 + i)
        tl, tc = lm.decode_step(params, tc, cfg, pc, torch.from_numpy(t).long(), S0 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    for i in range(cfg.n_layers):
        for got, want in zip(_global_cache(tc[i]), _jcache(jc, i)):
            np.testing.assert_allclose(got, want, **F32)


def test_chunked_decode_with_q_valid_matches_reference(model, pc8):
    """decode_step with C = 4 rows, per-slot lengths and ``q_valid``."""
    jcfg, cfg, jparams, params, world, toks = model
    pc = ParallelContext(world=world)
    jc = jlm.init_caches(jcfg, pc8, B, MAX_LEN, jnp.float32)
    tc = lm.init_caches(cfg, pc, B, MAX_LEN, torch.float32)
    step = jax.jit(lambda p, c, t, n, v: jlm.decode_step(p, c, jcfg, pc8, t, n, q_valid=v))
    lens = np.zeros(B, np.int32)
    for valid in ([4, 2], [3, 4], [1, 0]):
        valid = np.asarray(valid, np.int32)
        chunk = np.stack([toks[b, lens[b] : lens[b] + 4] for b in range(B)])
        jl, jc = step(jparams, jc, jnp.asarray(chunk), jnp.asarray(lens), jnp.asarray(valid))
        tl, tc = lm.decode_step(
            params, tc, cfg, pc, torch.from_numpy(chunk).long(), torch.from_numpy(lens), q_valid=torch.from_numpy(valid)
        )
        for b in range(B):
            np.testing.assert_allclose(tl[b, : valid[b]].numpy(), np.asarray(jl)[b, : valid[b]], **LOGITS)
        lens = lens + valid
    for i in range(cfg.n_layers):
        for got, want in zip(_global_cache(tc[i]), _jcache(jc, i)):
            np.testing.assert_allclose(got, want, **F32)


def _jax_greedy(cfg, pc, params, prompts, n_new):
    """JAX reference: prefill, then per-token decode_step + argmax."""
    s0 = prompts.shape[1]
    lg, caches = jax.jit(lambda p, t: jlm.prefill(p, cfg, pc, t, max_len=s0 + n_new))(params, jnp.asarray(prompts))
    tok = np.asarray(jnp.argmax(lg[:, -1], -1))
    out = [tok]
    step = jax.jit(lambda p, c, t, n: jlm.decode_step(p, c, cfg, pc, t, n))
    for i in range(n_new - 1):
        lg, caches = step(params, caches, jnp.asarray(tok[:, None].astype(np.int32)), s0 + i)
        tok = np.asarray(jnp.argmax(lg[:, 0], -1))
        out.append(tok)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_greedy_matches_jax_per_token_reference(pc8, mesh8, backend):
    NEW = 6
    jcfg, cfg = _configs(128)
    jparams = place(jlm.init(jax.random.PRNGKey(3), jcfg, pc8, jnp.float32), mesh8, jlm.specs(jcfg, pc8))
    prompts = serve.make_prompts(cfg.vocab_size, B, S0, seed=5)
    ref = _jax_greedy(jcfg, pc8, jparams, prompts.astype(np.int32), NEW)
    world = World(R, "cpu")
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, world)
    tokens, timings = serve.greedy(params, cfg, ParallelContext(world=world, backend=backend), torch.from_numpy(prompts), NEW)
    np.testing.assert_array_equal(tokens.numpy(), ref)
    assert timings["decode_steps"] == NEW - 1


def test_serve_cli_on_cpu(capsys):
    r = serve.main(["--arch", ARCH, "--reduce", "--device", "cpu", "--dtype", "bf16",
                    "--batch", "2", "--prompt-len", "20", "--new-tokens", "3"])  # fmt: skip
    assert r["tokens"].shape == (2, 3) and r["backend"] == "eager"
    assert "tokens/s" in capsys.readouterr().out
