"""The port's LM against the JAX package's, on reduced smollm-360m (dense),
granite-moe-3b-a800m (every FFN MoE: 8 experts, top-2) and deepseek-moe-16b
(a dense first layer, then MoE FFNs with 2 shared experts).

Weights come from the JAX ``lm.init`` through ``convert.from_jax_params``
(the MoE router stays float32);
the JAX side runs on the 8-device CPU mesh of ``tests/conftest.py`` (TP 4),
the port on a 4-rank ``World`` on the CPU.  Tolerance: atol / rtol 2e-3 on
logits, as ``tests/test_serving.py``; caches and layer primitives 1e-5 / 1e-4.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.nn import layers as jlayers
from repro.parallel.sharding import place
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import PORT_FIELDS
from repro_torch.convert import from_jax_params
from repro_torch.models import lm
from repro_torch.nn import layers
from repro_torch.parallel.context import ParallelContext
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

TOL = dict(atol=2e-3, rtol=2e-3)
TP = 4
B, S0, EXTRA = 2, 16, 4
MAX_LEN = S0 + EXTRA
ARCHS = ("smollm-360m", "granite-moe-3b-a800m", "deepseek-moe-16b")
# (head dim, padded vocab at TP 4) of each published config
PUBLISHED = {"smollm-360m": (64, 49152), "granite-moe-3b-a800m": (64, 49156), "deepseek-moe-16b": (128, 102400)}


@pytest.fixture(scope="module", params=ARCHS)
def setup(request, pc8, mesh8):
    jcfg = dataclasses.replace(j_reduce_config(j_get_config(request.param)), vocab_size=502)
    cfg = dataclasses.replace(reduce_config(get_config(request.param)), vocab_size=502)
    jparams = place(jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32), mesh8, jlm.specs(jcfg, pc8))
    world = World(TP, "cpu")
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, world)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S0 + EXTRA)).astype(np.int32)
    return jcfg, cfg, jparams, params, world, toks


def _jcache(jc, layer):
    """JAX global cache of ``layer`` [B, TP*kv_loc, L, hd]: the prefix layers, then the scanned ones."""
    n_pre = len(jc["prefix"])
    if layer < n_pre:
        return np.asarray(jc["prefix"][layer]["k"]), np.asarray(jc["prefix"][layer]["v"])
    return np.asarray(jc["scan"][0]["k"][layer - n_pre]), np.asarray(jc["scan"][0]["v"][layer - n_pre])


def _tcache(c):
    """Port cache [W, B, kv_loc, L, hd] -> [B, W*kv_loc, L, hd]."""
    return [a.permute(1, 0, 2, 3, 4).reshape(a.shape[1], -1, a.shape[3], a.shape[4]).numpy() for a in (c["k"], c["v"])]


def _plain(v):
    """A config field as a plain value (a nested config as a dict)."""
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def _reference_fields(cfg):
    """The config's fields that the JAX package's config also has."""
    return [f for f in dataclasses.fields(cfg) if f.name not in PORT_FIELDS]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_port_matches_reference(arch):
    jc, tc = j_get_config(arch), get_config(arch)
    for f in _reference_fields(tc):
        assert _plain(getattr(tc, f.name)) == _plain(getattr(jc, f.name)), f.name
    assert tc.embed_scale == (jc.family == "vlm" or jc.name.startswith("gemma"))
    jr, tr = j_reduce_config(jc), reduce_config(tc)
    for f in _reference_fields(tr):
        assert _plain(getattr(tr, f.name)) == _plain(getattr(jr, f.name)), f.name
    assert [tc.layer_kind(i) for i in range(tc.n_layers)] == [jc.layer_kind(i) for i in range(jc.n_layers)]
    assert (tc.hd, lm.padded_vocab(tc, 4)) == PUBLISHED[arch]


def test_param_layout(setup):
    jcfg, cfg, jparams, params, world, _ = setup
    lay = layers.gqa_layout(cfg.n_heads, cfg.n_kv_heads, TP)
    assert len(params["layers"]) == cfg.n_layers
    i = len(jparams["prefix"])  # the first scanned layer (after deepseek's dense first layer)
    mixer, f = params["layers"][i]["mixer"], params["layers"][i]["ffn"]
    assert mixer["wqkv"].shape == (TP, cfg.d_model, (lay.h_loc + 2 * lay.kv_loc) * cfg.hd)
    assert mixer["wo"].shape == (TP, lay.h_loc * cfg.hd, cfg.d_model)
    if cfg.moe is None:
        assert f["w_gu"].shape == (TP, cfg.d_model, 2 * cfg.d_ff // TP)
        assert f["w_down"].shape == (TP, cfg.d_ff // TP, cfg.d_model)
    else:  # experts sharded over the ranks, the router replicated in float32
        e_loc, fe = cfg.moe.num_experts // TP, cfg.moe.d_expert
        assert f["w_gu"].shape == (TP, e_loc, cfg.d_model, 2 * fe)
        assert f["w_down"].shape == (TP, e_loc, fe, cfg.d_model)
        assert f["router"].shape == (cfg.d_model, cfg.moe.num_experts) and f["router"].dtype == torch.float32
        jw = np.asarray(jparams["scan"][0]["ffn"]["w_gu"][0])
        np.testing.assert_array_equal(f["w_gu"].reshape(-1, cfg.d_model, 2 * fe).numpy(), jw)
        low = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, world, torch.bfloat16)
        assert low["layers"][i]["ffn"]["router"].dtype == torch.float32
        assert low["layers"][i]["ffn"]["w_gu"].dtype == torch.bfloat16
        own = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.bfloat16)
        assert own["layers"][i]["ffn"]["router"].dtype == torch.float32
    cols = lm.padded_vocab(cfg, TP)  # the JAX head's columns; the port pads them to a multiple of 8
    assert params["head"].shape == (cfg.d_model, -(-cols // 8) * 8) and not params["head"][:, cols:].any()
    if cfg.tie_embeddings:
        assert torch.equal(params["head"][:, :cols], params["embed"].reshape(-1, cfg.d_model).t())
    else:
        np.testing.assert_array_equal(params["head"][:, :cols].numpy(), np.asarray(jparams["lm_head"]))
    # the port's own init follows the same layout
    own = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: t.shape, own)
    ) == jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: t.shape, params))
    for a, b in zip(own["layers"][i]["mixer"].values(), mixer.values()):
        assert a.shape == b.shape


@pytest.mark.parametrize("arch", ARCHS)
def test_head_padded_to_a_multiple_of_8(arch, pc8, mesh8):
    """vocab 498 pads to 500 rows over 4 ranks, no multiple of 8: the head is
    stored with 4 zero columns more (504: 16-byte bf16 rows for the tile-GEMM
    kernel's TMA loads), and the prefill logits still equal the JAX package's."""
    jcfg = dataclasses.replace(j_reduce_config(j_get_config(arch)), vocab_size=498)
    cfg = dataclasses.replace(reduce_config(get_config(arch)), vocab_size=498)
    jparams = place(jlm.init(jax.random.PRNGKey(2), jcfg, pc8, jnp.float32), mesh8, jlm.specs(jcfg, pc8))
    world = World(TP, "cpu")
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, world)
    own = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)
    for head in (params["head"], own["head"]):
        assert lm.padded_vocab(cfg, TP) == 500 and head.shape == (cfg.d_model, 504) and head.is_contiguous()
        assert not head[:, 500:].any() and head[:, :500].abs().sum() > 0
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(B, S0)).astype(np.int32)
    jl, _ = jax.jit(lambda p, t: jlm.prefill(p, jcfg, pc8, t, max_len=MAX_LEN))(jparams, jnp.asarray(toks))
    for backend in ("eager", "fused"):
        pc = ParallelContext(world=world, backend=backend)
        tl, _ = lm.prefill(params, cfg, pc, torch.from_numpy(toks).long(), max_len=MAX_LEN)
        assert tl.shape == (B, S0, 498)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_prefill_matches_reference(setup, pc8, backend):
    jcfg, cfg, jparams, params, world, toks = setup
    jl, jc = jax.jit(lambda p, t: jlm.prefill(p, jcfg, pc8, t, max_len=MAX_LEN))(jparams, jnp.asarray(toks[:, :S0]))
    pc = ParallelContext(world=world, backend=backend)
    tl, tc = lm.prefill(params, cfg, pc, torch.from_numpy(toks[:, :S0]).long(), max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(cfg.n_layers):
        for got, want in zip(_tcache(tc[i]), _jcache(jc, i)):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_forward_matches_reference(setup, pc8, backend):
    """Logits and the aux loss (0 for a dense model, the summed per-layer
    load-balance loss for MoE)."""
    jcfg, cfg, jparams, params, world, toks = setup
    jl, jaux = jax.jit(lambda p, t: jlm.forward(p, jcfg, pc8, t))(jparams, jnp.asarray(toks))
    tl, aux = lm.forward(params, cfg, ParallelContext(world=world, backend=backend), torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5, atol=1e-6)
    assert (aux.item() > 0) == (cfg.moe is not None)


def test_decode_matches_reference_per_token(setup, pc8):
    jcfg, cfg, jparams, params, world, toks = setup
    pc = ParallelContext(world=world)
    _, jc = jax.jit(lambda p, t: jlm.prefill(p, jcfg, pc8, t, max_len=MAX_LEN))(jparams, jnp.asarray(toks[:, :S0]))
    _, tc = lm.prefill(params, cfg, pc, torch.from_numpy(toks[:, :S0]).long(), max_len=MAX_LEN)
    step = jax.jit(lambda p, c, t, n: jlm.decode_step(p, c, jcfg, pc8, t, n))
    for i in range(EXTRA):
        t = toks[:, S0 + i : S0 + i + 1]
        jl, jc = step(jparams, jc, jnp.asarray(t), S0 + i)
        tl, tc = lm.decode_step(params, tc, cfg, pc, torch.from_numpy(t).long(), S0 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(cfg.n_layers):
        for got, want in zip(_tcache(tc[i]), _jcache(jc, i)):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_chunked_decode_with_vector_lengths_and_q_valid(setup, pc8):
    """Chunks of C = 4 rows into empty caches, per-slot ``cache_len`` and
    ``q_valid`` vectors (the continuous-batching form of decode_step)."""
    jcfg, cfg, jparams, params, world, toks = setup
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
        for b in range(B):  # rows past q_valid are garbage on both sides
            np.testing.assert_allclose(tl[b, : valid[b]].numpy(), np.asarray(jl)[b, : valid[b]], **TOL)
        lens = lens + valid
    for i in range(cfg.n_layers):
        for got, want in zip(_tcache(tc[i]), _jcache(jc, i)):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("n_heads,n_kv,tp", list(itertools.product((8, 15, 32), (1, 2, 5, 8), (1, 2, 4, 8))))
def test_gqa_layout_matches_reference(n_heads, n_kv, tp):
    assert dataclasses.astuple(layers.gqa_layout(n_heads, n_kv, tp)) == dataclasses.astuple(
        jlayers.gqa_layout(n_heads, n_kv, tp)
    )


@pytest.mark.parametrize("d,eps", [(16, 1e-6), (96, 1e-5)])
def test_rms_norm_matches_reference(d, eps):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    s = (0.1 * rng.standard_normal(d)).astype(np.float32)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(s), eps).numpy()
    np.testing.assert_allclose(got, np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s), eps)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hd,theta,batched", [(16, 1e4, False), (64, 1e4, True), (32, 5e5, True)])
def test_rope_matches_reference(hd, theta, batched):
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    k = rng.standard_normal((2, 7, 1, hd)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 7) if batched else (7,))
    got = layers.rope(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pos), theta)
    want = jlayers.rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), theta)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
