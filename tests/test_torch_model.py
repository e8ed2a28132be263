"""The port's dense LM against the JAX package's, on a reduced smollm-360m.

Weights come from the JAX ``lm.init`` through ``convert.from_jax_params``;
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
from repro_torch.convert import from_jax_params
from repro_torch.models import lm
from repro_torch.nn import layers
from repro_torch.parallel.context import ParallelContext
from utils import reduce_config as j_reduce_config

TOL = dict(atol=2e-3, rtol=2e-3)
TP = 4
B, S0, EXTRA = 2, 16, 4
MAX_LEN = S0 + EXTRA


@pytest.fixture(scope="module")
def setup(pc8, mesh8):
    jcfg = dataclasses.replace(j_reduce_config(j_get_config("smollm-360m")), vocab_size=502)
    cfg = dataclasses.replace(reduce_config(get_config("smollm-360m")), vocab_size=502)
    jparams = place(jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32), mesh8, jlm.specs(jcfg, pc8))
    world = World(TP, "cpu")
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, world)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S0 + EXTRA)).astype(np.int32)
    return jcfg, cfg, jparams, params, world, toks


def _jcache(jc, layer):
    """JAX global cache of ``layer`` [B, TP*kv_loc, L, hd]."""
    return np.asarray(jc["scan"][0]["k"][layer]), np.asarray(jc["scan"][0]["v"][layer])


def _tcache(c):
    """Port cache [W, B, kv_loc, L, hd] -> [B, W*kv_loc, L, hd]."""
    return [a.permute(1, 0, 2, 3, 4).reshape(a.shape[1], -1, a.shape[3], a.shape[4]).numpy() for a in (c["k"], c["v"])]


def test_config_port_matches_reference():
    jc, tc = j_get_config("smollm-360m"), get_config("smollm-360m")
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    jr, tr = j_reduce_config(jc), reduce_config(tc)
    for f in dataclasses.fields(tr):
        assert getattr(tr, f.name) == getattr(jr, f.name), f.name
    assert lm.padded_vocab(tc, 4) == 49152 and tc.hd == 64


def test_param_layout(setup):
    jcfg, cfg, _, params, world, _ = setup
    lay = layers.gqa_layout(cfg.n_heads, cfg.n_kv_heads, TP)
    assert len(params["layers"]) == cfg.n_layers
    mixer, f = params["layers"][0]["mixer"], params["layers"][0]["ffn"]
    assert mixer["wqkv"].shape == (TP, cfg.d_model, (lay.h_loc + 2 * lay.kv_loc) * cfg.hd)
    assert mixer["wo"].shape == (TP, lay.h_loc * cfg.hd, cfg.d_model)
    assert f["w_gu"].shape == (TP, cfg.d_model, 2 * cfg.d_ff // TP)
    assert f["w_down"].shape == (TP, cfg.d_ff // TP, cfg.d_model)
    assert torch.equal(params["head"], params["embed"].reshape(-1, cfg.d_model).t())
    # the port's own init follows the same layout
    own = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: t.shape, own)
    ) == jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: t.shape, params))
    for a, b in zip(own["layers"][0]["mixer"].values(), mixer.values()):
        assert a.shape == b.shape


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


def test_forward_matches_reference(setup, pc8):
    jcfg, cfg, jparams, params, world, toks = setup
    jl, _ = jax.jit(lambda p, t: jlm.forward(p, jcfg, pc8, t))(jparams, jnp.asarray(toks))
    tl = lm.forward(params, cfg, ParallelContext(world=world), torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


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
