"""deepseek-moe-16b's pieces in the port against the JAX package, on the CPU.

A reduced deepseek-moe-16b (``reduce_config``: 8 routed experts top-2, 2
shared experts, the first of 3 layers dense): the MoE block with shared
experts (prefill on both backends; decode with per-(token, k) gathers and
with ``moe_decode_stream``, each against the JAX twin with the same flag,
and stream against gather as ``tests/test_extended.py`` holds them), the
``attn_dense`` layer, ``from_jax_params`` on a pytree with ``prefix`` and
``shared``, greedy tokens with the streamed decode, and the serve CLI's
``--moe-stream``.  Weights come from the JAX ``init``; the JAX side runs on
the 8-device CPU mesh of ``tests/conftest.py`` (TP 4), the port on a 4-rank
``World``.  Tolerances: float32 1e-5 for one block (summation order),
stream against gather 2e-4, greedy tokens exact; the whole model's prefill,
forward and decode logits are held in ``tests/test_torch_model.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.nn import moe as j_nn_moe
from repro.parallel.context import ParallelContext as JContext
from repro.parallel.sharding import place
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import from_jax_params, shard_mlp, shard_rows
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.nn import moe
from repro_torch.parallel.context import ParallelContext
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

ARCH = "deepseek-moe-16b"
R = 4
F32 = dict(atol=1e-5, rtol=1e-5)
STREAM = dict(atol=2e-4, rtol=2e-4)
B, S0, NEW = 2, 16, 5


def _cfgs(vocab=None):
    jcfg, cfg = j_reduce_config(j_get_config(ARCH)), reduce_config(get_config(ARCH))
    if vocab:
        jcfg, cfg = dataclasses.replace(jcfg, vocab_size=vocab), dataclasses.replace(cfg, vocab_size=vocab)
    return jcfg, cfg


@pytest.fixture(scope="module")
def block(mesh8):
    """One MoE block with shared experts: JAX params (``ln`` nonzero) and the
    port's rank-stacked copy."""
    jcfg, cfg = _cfgs()
    jp = j_nn_moe.init(jax.random.PRNGKey(0), jcfg, R, jnp.float32)
    jp = dict(jp, ln=jax.random.normal(jax.random.PRNGKey(1), jp["ln"].shape) * 0.1)
    world = World(R, "cpu")
    t = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    tp = {"ln": t["ln"], "router": t["router"], "w_gu": shard_rows(t["w_gu"], world),
          "w_down": shard_rows(t["w_down"], world), "shared": shard_mlp(t["shared"], world)}  # fmt: skip
    return jcfg, cfg, jp, tp, world


@pytest.fixture(scope="module")
def model(pc8, mesh8):
    jcfg, cfg = _cfgs(vocab=256)
    jparams = place(jlm.init(jax.random.PRNGKey(2), jcfg, pc8, jnp.float32), mesh8, jlm.specs(jcfg, pc8))
    world = World(R, "cpu")
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, world)
    return jcfg, cfg, jparams, params, world


def _smap_moe(mesh8, jcfg, fn, x_spec, out_specs, stream=False):
    jpc = JContext(mesh=mesh8, moe_decode_stream=stream)
    specs = j_nn_moe.specs(jcfg, R, None)
    in_specs = (jax.tree_util.tree_map(jpc.manual, specs, is_leaf=lambda v: isinstance(v, P)), x_spec)
    return jax.jit(jpc.smap(lambda p, xx: fn(p, xx, jpc, jcfg), in_specs, out_specs))


def test_reduced_config_keeps_the_dense_first_layer_and_shared_experts():
    jcfg, cfg = _cfgs()
    m = cfg.moe
    assert (m.num_experts, m.top_k, m.num_shared, m.first_k_dense) == (8, 2, 2, 1)
    assert [cfg.layer_kind(i) for i in range(cfg.n_layers)] == ["attn_dense", "attn", "attn"]
    assert [d.kind for d in lm.layer_plan(cfg)] == ["attn_dense", "attn", "attn"]
    assert [d.ffn_kind for d in lm.layer_plan(cfg)] == ["mlp", "moe", "moe"]
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.hd, full.vocab_size) == (28, 2048, 128, 102400)
    assert (full.moe.num_experts, full.moe.top_k, full.moe.d_expert, full.moe.dense_d_ff) == (64, 6, 1408, 10944)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_moe_with_shared_experts_apply_seq_matches_reference(mesh8, block, backend):
    """Routed experts through the AG+MoE ring, then the shared MLP (AG+GEMM,
    GEMM+RS) on the routed residual, with its own norm."""
    jcfg, cfg, jp, tp, world = block
    x = np.random.default_rng(3).standard_normal((2, R * 8, cfg.d_model)).astype(np.float32)
    sm = _smap_moe(mesh8, jcfg, j_nn_moe.apply_seq, P(None, "model", None), (P(None, "model", None), P()))
    jy, jaux = sm(jp, jnp.asarray(x))
    y, aux = moe.apply_seq(tp, world.shard(torch.from_numpy(x), dim=1), ParallelContext(world=world, backend=backend), cfg)
    np.testing.assert_allclose(world.unshard(y, dim=1).numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    # the shared MLP really ran: the routed part alone is another value
    routed, _ = moe.apply_seq({k: v for k, v in tp.items() if k != "shared"}, world.shard(torch.from_numpy(x), dim=1),
                              ParallelContext(world=world, backend=backend), cfg)  # fmt: skip
    assert not np.allclose(world.unshard(routed, dim=1).numpy(), np.asarray(jy), atol=1e-3)


@pytest.mark.parametrize("stream", [False, True], ids=["gather", "stream"])
def test_moe_with_shared_experts_apply_decode_matches_reference(mesh8, block, stream):
    jcfg, cfg, jp, tp, world = block
    x = np.random.default_rng(4).standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    sm = _smap_moe(mesh8, jcfg, j_nn_moe.apply_decode, P(None, None, None), P(None, None, None), stream=stream)
    want = np.asarray(sm(jp, jnp.asarray(x)))
    pc = ParallelContext(world=world, moe_decode_stream=stream)
    got = moe.apply_decode(tp, torch.from_numpy(x), pc, cfg).numpy()
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("num_experts", [8, 6])
def test_streamed_decode_equals_gathered_decode(block, num_experts):
    """The two decode forms compute one function (6 experts pad to 8: the
    padding experts are never chosen, their one-hot columns stay 0)."""
    _, cfg, _, tp, world = block
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=num_experts))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 3, cfg.d_model)).astype(np.float32))
    outs = [moe.apply_decode(tp, x, ParallelContext(world=world, moe_decode_stream=s), cfg) for s in (False, True)]
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), **STREAM)


def test_streamed_decode_in_bf16_against_the_f32_oracle(block):
    """bf16 weights and tokens, each expert's products rounded to bf16 as the
    JAX package rounds them, held to 2e-2 of max |f32| on the same inputs."""
    _, cfg, _, tp, world = block
    low = dict(jax.tree_util.tree_map(lambda t: t.bfloat16(), tp), router=tp["router"])  # the router stays f32
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 4, cfg.d_model)).astype(np.float32))
    pc = ParallelContext(world=world, moe_decode_stream=True)
    got = moe.apply_decode(low, x.bfloat16(), pc, cfg)
    ref = moe.apply_decode(jax.tree_util.tree_map(lambda t: t.float(), low), x.bfloat16().float(), pc, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert (got.float() - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


def test_from_jax_params_reads_the_prefix_and_the_shared_experts(model):
    jcfg, cfg, jparams, params, world = model
    d, m = cfg.d_model, cfg.moe
    assert len(params["layers"]) == cfg.n_layers == len(jparams["prefix"]) + jparams["scan"][0]["mixer"]["wq"].shape[0]
    dense = params["layers"][0]["ffn"]
    assert set(dense) == {"ln", "w_gu", "w_down"}
    assert dense["w_gu"].shape == (R, d, 2 * m.dense_d_ff // R) and dense["w_down"].shape == (R, m.dense_d_ff // R, d)
    jd = jparams["prefix"][0]["ffn"]
    np.testing.assert_array_equal(dense["w_gu"].permute(1, 0, 2).reshape(d, -1).numpy(), np.asarray(jd["w_gu"]))
    np.testing.assert_array_equal(dense["w_down"].reshape(-1, d).numpy(), np.asarray(jd["w_down"]))
    f_sh = m.num_shared * m.d_expert
    for i in (1, 2):
        shared, js = params["layers"][i]["ffn"]["shared"], jparams["scan"][0]["ffn"]["shared"]
        assert shared["w_gu"].shape == (R, d, 2 * f_sh // R) and shared["w_down"].shape == (R, f_sh // R, d)
        np.testing.assert_array_equal(shared["w_gu"].permute(1, 0, 2).reshape(d, -1).numpy(), np.asarray(js["w_gu"][i - 1]))
        np.testing.assert_array_equal(shared["w_down"].reshape(-1, d).numpy(), np.asarray(js["w_down"][i - 1]))
        np.testing.assert_array_equal(shared["ln"].numpy(), np.asarray(js["ln"][i - 1]))
    # the port's own init follows the same layout, in any dtype, router float32
    own = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.bfloat16)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: t.shape, own)) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: t.shape, params)
    )
    for a, b in zip(jax.tree_util.tree_leaves(own), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape
    assert own["layers"][1]["ffn"]["router"].dtype == torch.float32
    assert own["layers"][1]["ffn"]["shared"]["w_gu"].dtype == torch.bfloat16


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_attn_dense_layer_matches_reference(pc8, model, backend):
    """The first layer: attention, then a dense MLP at dense_d_ff."""
    jcfg, cfg, jparams, params, world = model
    x = np.random.default_rng(7).standard_normal((B, S0, cfg.d_model)).astype(np.float32)
    jd = jlm.layer_plan(jcfg)[0][0]
    assert jd.kind == "attn_dense"
    jy, jaux = jax.jit(lambda p, xx: jd.apply_seq(p, xx, pc8, jcfg))(jparams["prefix"][0], jnp.asarray(x))
    d = lm.layer_plan(cfg)[0]
    pc = ParallelContext(world=world, backend=backend)
    y, aux = d.apply_seq(params["layers"][0], world.shard(torch.from_numpy(x), dim=1), pc, cfg)
    np.testing.assert_allclose(world.unshard(y, dim=1).numpy(), np.asarray(jy), **F32)
    assert float(jaux) == aux.item() == 0.0


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_greedy_with_the_streamed_decode_matches_reference(pc8, model, backend):
    """``serve.greedy`` with ``moe_decode_stream`` on both sides: the prefill,
    then one streamed decode step per token, argmax for argmax."""
    jcfg, cfg, jparams, params, world = model
    jpc = dataclasses.replace(pc8, moe_decode_stream=True)
    prompts = serve.make_prompts(cfg.vocab_size, B, S0, seed=8)
    lg, caches = jax.jit(lambda p, t: jlm.prefill(p, jcfg, jpc, t, max_len=S0 + NEW))(jparams, jnp.asarray(prompts))
    tok = np.asarray(jnp.argmax(lg[:, -1], -1))
    ref = [tok]
    step = jax.jit(lambda p, c, t, n: jlm.decode_step(p, c, jcfg, jpc, t, n))
    for i in range(NEW - 1):
        lg, caches = step(jparams, caches, jnp.asarray(tok[:, None].astype(np.int32)), S0 + i)
        tok = np.asarray(jnp.argmax(lg[:, 0], -1))
        ref.append(tok)
    pc = ParallelContext(world=world, backend=backend, moe_decode_stream=True)
    tokens, timings = serve.greedy(params, cfg, pc, torch.from_numpy(prompts), NEW)
    np.testing.assert_array_equal(tokens.numpy(), np.stack(ref, axis=1))
    assert timings["decode_steps"] == NEW - 1


def test_decode_step_stream_against_gather(model):
    """Whole-model decode logits, streamed against gathered (2e-4, as the JAX
    package's own test holds its two forms)."""
    _, cfg, _, params, world = model
    toks = torch.from_numpy(serve.make_prompts(cfg.vocab_size, B, 3, seed=9))
    logits = []
    for stream in (False, True):
        pc = ParallelContext(world=world, moe_decode_stream=stream)
        caches = lm.init_caches(cfg, pc, B, 8, torch.float32)
        lg, _ = lm.decode_step(params, caches, cfg, pc, toks, 0)
        logits.append(lg.numpy())
    np.testing.assert_allclose(logits[1], logits[0], **STREAM)


def test_serve_cli_streams_the_moe_decode(capsys):
    r = serve.main(["--arch", ARCH, "--reduce", "--device", "cpu", "--dtype", "f32", "--moe-stream",
                    "--batch", "3", "--prompt-len", "8", "--new-tokens", "4", "--slots", "2"])  # fmt: skip
    assert r["tokens"].shape == (3, 4) and r["backend"] == "eager" and (r["tokens"] >= 0).all()
    kw = dict(batch=3, prompt_len=8, new_tokens=4, dtype="f32", device="cpu", reduce=True, slots=2)
    np.testing.assert_array_equal(serve.serve(ARCH, moe_stream=False, **kw)["tokens"], r["tokens"])
    assert "tokens/s" in capsys.readouterr().out
