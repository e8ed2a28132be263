"""The VLM prefix path (paligemma-3b) in the port against the JAX package,
on the CPU, and kernel #4's plain versions at head dim 256.

Reduced config (``reduce_config``: 2 layers, d_model 128, 8 query heads
and one KV head (MQA: at W = 4 the kv weights are stored in 4 copies,
``rep`` 4), GELU MLP of 256, tied embeddings scaled by sqrt(d_model); the
head dim kept at its published 256 by the same override on both sides;
vocab 256), weights from the JAX ``lm.init`` (norm gains drawn from a
numpy seed) through ``convert.from_jax_params``; a stub image prefix of
``vision_prefix_len(32) = 16`` patch embeddings and 16 text tokens from a
numpy seed.  The JAX side runs on the 8-device CPU mesh of
``tests/conftest.py`` (TP 4), each reference function jitted once per
module, the port on a 4-rank ``World``, float32.

Bounds: the embedding (prefix and scale) 1e-6 of max; logits |diff| <= 2e-3
+ 2e-3 |ref| (the serving bound), greedy tokens equal; the loss the
logits' bound and each gradient leaf 2e-3 of its max |ref|; one AdamW
step's updates 1e-2 of each leaf's max update where the gradient is held;
the kv-copy sync 1e-6 and the synced copies bitwise equal; the wgmma
route's replay (``flash_attention_tiled``, P in f32) against
``chunked_attention`` 1e-5 of max, its statistics 1e-5.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.parallel.sharding import place
from repro.training import optimizer as jopt
from repro.training import steps as jsteps
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import _REGISTRY, PORT_FIELDS
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import frontends, lm
from repro_torch.nn import attention
from repro_torch.parallel.context import ParallelContext
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training import optimizer as topt
from repro_torch.training.steps import loss_and_grads
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from test_torch_training import _np, _port_tree, _with_gains, j_compiled, j_value_and_grad
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

fa = importlib.import_module("repro_torch.kernels.flash_attention")  # the module; the package exports the function

ARCH = "paligemma-3b"
TP = 4
B, S, VOCAB, HD = 2, 32, 256, 256
N_IMG = frontends.vision_prefix_len(S)  # 16 patches, then S - N_IMG text tokens
S0, NEW = 8, 5  # greedy: text tokens after the prefix, new tokens
LOGITS = dict(atol=2e-3, rtol=2e-3)
GRAD_REL, UPDATE_RTOL = 2e-3, 1e-2
FLASH_RTOL = 1e-5


def _cfgs(**kw):
    kw = {**dict(vocab_size=VOCAB, head_dim=HD), **kw}
    return (dataclasses.replace(j_reduce_config(j_get_config(ARCH)), **kw),
            dataclasses.replace(reduce_config(get_config(ARCH)), **kw))  # fmt: skip


@pytest.fixture(scope="module")
def model(pc8, mesh8):
    jcfg, cfg = _cfgs()
    np_params = _with_gains(_np(jax.jit(lambda k: jlm.init(k, jcfg, pc8, jnp.float32))(jax.random.PRNGKey(0))))
    jparams = place(jax.tree_util.tree_map(jnp.asarray, np_params), mesh8, jlm.specs(jcfg, pc8))
    world = World(TP, "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, VOCAB, size=(B, S - N_IMG)).astype(np.int32)
    emb = (rng.standard_normal((B, N_IMG, cfg.d_model)) * 0.02).astype(np.float32)
    labels = rng.integers(0, VOCAB, size=(B, S)).astype(np.int32)  # the whole sequence, image prefix included
    return dict(jcfg=jcfg, cfg=cfg, np_params=np_params, jparams=jparams, params=from_jax_params(np_params, cfg, world),
                world=world, toks=toks, emb=emb, batch={"inputs": toks, "labels": labels, "embeds": emb})  # fmt: skip


def _plain(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def test_config_matches_reference():
    """Every field of the published and the reduced config, and, for every
    config both packages register, ``embed_scale`` equal to the reference's
    condition (``family == "vlm"`` or a "gemma" name)."""
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(tc):
        if f.name not in PORT_FIELDS:
            assert _plain(getattr(tc, f.name)) == _plain(getattr(jc, f.name)), f.name
            assert _plain(getattr(reduce_config(tc), f.name)) == _plain(getattr(j_reduce_config(jc), f.name)), f.name
    assert (tc.hd, tc.n_kv_heads, tc.frontend) == (256, 1, "vision") and tc.tie_embeddings
    lay = attention.layout(tc, TP)
    assert (lay.kv_loc, lay.rep, lay.kv_store) == (1, 4, 4)
    shared = sorted(set(_REGISTRY) & set(ARCH_NAMES))
    assert ARCH in shared and "seamless-m4t-medium" in shared and len(shared) >= 10
    for name in shared:
        j = j_get_config(name)
        assert get_config(name).embed_scale == (j.family == "vlm" or j.name.startswith("gemma")), name


def test_frontend_prefix_rule(pc8):
    """The vision prefix of the reference's ``input_specs`` (min(256, S / 2)
    patches, then the text) and the stub's shape."""
    from repro.configs.base import Shape
    from repro.launch.specs import input_specs

    jc = j_get_config(ARCH)
    for s in (32, 512, 4096):
        tree, _ = input_specs(jc, Shape("t", s, 8, "train"), pc8)
        n = frontends.vision_prefix_len(s)
        assert tree["embeds"].shape == (8, n, jc.d_model) and tree["inputs"].shape == (8, s - n)
    assert frontends.vision_prefix_len(512) == 256
    e = frontends.stub_patch_embeddings(torch.Generator().manual_seed(0), 3, 64, 16, torch.float32)
    assert e.shape == (3, 32, 16) and 0 < e.std().item() < 0.05


def test_embed_tokens_scales_the_prefix(model):
    """The prefix cast to the embedding's dtype, the token rows after it, and
    sqrt(d_model) over the whole concatenation (the reference's rule)."""
    cfg = model["cfg"]
    want = jlm.embed_tokens(jax.tree_util.tree_map(jnp.asarray, model["np_params"]), model["jcfg"],
                            jnp.asarray(model["toks"]), jnp.asarray(model["emb"]))  # fmt: skip
    got = lm.embed_tokens(model["params"], cfg, torch.from_numpy(model["toks"]).long(), torch.from_numpy(model["emb"]))
    assert got.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6 * np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got[:, :N_IMG].numpy(), model["emb"] * cfg.d_model**0.5, rtol=1e-6)


@pytest.fixture(scope="module")
def jax_logits(model, pc8):
    jl, _ = jax.jit(lambda p, t, e: jlm.forward(p, model["jcfg"], pc8, t, e))(
        model["jparams"], jnp.asarray(model["toks"]), jnp.asarray(model["emb"])
    )
    return np.asarray(jl)


@pytest.mark.parametrize("backend,remat", [("eager", "none"), ("fused", "none"), ("fused", "dots")])
def test_forward_logits_match_reference(model, jax_logits, backend, remat):
    """Teacher-forced logits over the image prefix and the text (causal over
    both, as the reference: no prefix-LM mask)."""
    pc = ParallelContext(world=model["world"], backend=backend)
    tl, aux = lm.forward(model["params"], model["cfg"], pc, torch.from_numpy(model["toks"]).long(),
                         torch.from_numpy(model["emb"]), remat_policy=remat)  # fmt: skip
    assert tl.shape == (B, S, VOCAB)
    np.testing.assert_allclose(tl.detach().numpy(), jax_logits, **LOGITS)
    assert aux.item() == 0.0


@pytest.fixture(scope="module")
def jax_greedy(model, pc8):
    """The reference: prefill with the image prefix, then per-token
    ``decode_step`` + argmax from position N_IMG + S0."""
    jcfg, jparams = model["jcfg"], model["jparams"]
    start = N_IMG + S0
    lg, caches = jax.jit(lambda p, t, e: jlm.prefill(p, jcfg, pc8, t, e, max_len=start + NEW))(
        jparams, jnp.asarray(model["toks"][:, :S0]), jnp.asarray(model["emb"])
    )
    first = np.asarray(lg)
    tok = np.asarray(jnp.argmax(lg[:, -1], -1))
    out = [tok]
    step = jax.jit(lambda p, c, t, n: jlm.decode_step(p, c, jcfg, pc8, t, n))
    for i in range(NEW - 1):
        lg, caches = step(jparams, caches, jnp.asarray(tok[:, None].astype(np.int32)), start + i)
        tok = np.asarray(jnp.argmax(lg[:, 0], -1))
        out.append(tok)
    return first, np.stack(out, axis=1)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_prefill_and_greedy_decode_match_reference(model, jax_greedy, backend):
    """``lm.prefill(embeds=)``'s logits, then ``serve.greedy(embeds=)``'s
    tokens against the reference's per-token decoding."""
    cfg = model["cfg"]
    prompts, emb = torch.from_numpy(model["toks"][:, :S0]).long(), torch.from_numpy(model["emb"])
    pc = ParallelContext(world=model["world"], backend=backend)
    tl, caches = lm.prefill(model["params"], cfg, pc, prompts, emb, max_len=N_IMG + S0 + NEW)
    np.testing.assert_allclose(tl.numpy(), jax_greedy[0], **LOGITS)
    assert caches[0]["k"].shape == (TP, B, 1, N_IMG + S0 + NEW, HD)
    tokens, timings = serve.greedy(model["params"], cfg, pc, prompts, NEW, embeds=emb)
    np.testing.assert_array_equal(tokens.numpy(), jax_greedy[1])
    assert timings["decode_steps"] == NEW - 1


@pytest.fixture(scope="module")
def jax_vg(model, pc8):
    """The reference's loss and gradients, compiled once for the module."""
    return j_value_and_grad(jlm, model["jcfg"], pc8)


@pytest.fixture(scope="module")
def jax_grads(model, jax_vg):
    (loss, _), g = jax_vg(model["jparams"], model["batch"])
    return float(loss), _port_tree(_np(g), model["cfg"], model["world"])


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_grads_match_reference(model, jax_grads, backend):
    """The loss over the whole sequence (labels on the image prefix too) and
    every leaf's gradient: the tied embedding takes the lookup's and the
    head's, the kv columns their 4 copies' own (before the sync)."""
    pc = ParallelContext(world=model["world"], backend=backend)
    loss, _, _, grads = loss_and_grads(lm, model["cfg"], pc, model["params"], model["batch"])
    j_loss, j_grads = jax_grads
    assert abs(loss.item() - j_loss) <= LOGITS["atol"] + LOGITS["rtol"] * abs(j_loss)
    got, want = topt.tree_leaves(grads), topt.tree_leaves(j_grads)
    assert len(got) == len(want) == 2 + 6 * model["cfg"].n_layers and "head" not in grads
    for i, (a, w) in enumerate(zip(got, want)):
        top = w.abs().max().item()
        assert top > 0 and (a - w).abs().max().item() <= GRAD_REL * top, (i, tuple(a.shape))


def test_train_step_matches_reference(model, jax_grads, pc8):
    """One make_train_step step with ``batch["embeds"]`` (remat "dots"; the
    kv-copy sync at rep 4 included) against the reference's
    ``make_train_step``: the loss, the gradient norm and every leaf's update
    where the gradient is held; after the step the 4 stored copies of the kv
    head are equal."""
    cfg, jcfg, world = model["cfg"], model["jcfg"], model["world"]
    opt_cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, eps=1e-4, weight_decay=1.0)
    jstep = j_compiled(jsteps.make_train_step(jlm, jcfg, pc8, jopt.AdamWConfig(**opt_cfg), remat_policy="none",
                                              grad_masks=jlm.grad_masks(jcfg, pc8), donate=False))  # fmt: skip
    pc = ParallelContext(world=world, backend="fused")
    step = make_train_step(lm, cfg, pc, AdamWConfig(**opt_cfg), remat_policy="dots", grad_masks=lm.grad_masks(cfg, pc))
    jp, _, jm = jstep(model["jparams"], jopt.init_opt_state(model["jparams"]), model["batch"])
    p, _, m = step(model["params"], init_opt_state(lm.trainable(model["params"], cfg)), model["batch"])
    assert abs(m["loss"].item() - float(jm["loss"])) <= LOGITS["atol"] + LOGITS["rtol"] * abs(float(jm["loss"]))
    assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) <= GRAD_REL * float(jm["grad_norm"])
    leaves = zip(*(topt.tree_leaves(t) for t in (lm.trainable(p, cfg), _port_tree(_np(jp), cfg, world),
                                                 lm.trainable(model["params"], cfg), jax_grads[1])))  # fmt: skip
    for i, (new, want, old, g) in enumerate(leaves):
        u, u_ref = new - old, want - old
        sure = g.abs() > GRAD_REL * g.abs().max()
        assert ((u - u_ref).abs() * sure).max().item() <= UPDATE_RTOL * u_ref.abs().max().item(), (i, new.shape)
        assert u.abs().max().item() > 0
    nq = attention.layout(cfg, TP).h_loc * HD
    for layer in p["layers"]:
        kv = layer["mixer"]["wqkv"][..., nq:]
        assert all(torch.equal(kv[r], kv[0]) for r in range(1, TP))


def test_sync_grads_at_rep4(model, pc8):
    """MQA on 4 ranks: lm.sync_grads averages the 4 copies of the kv head's
    gradient as the reference does (a seeded tree), and leaves the 4 copies
    of each kv column bitwise equal and the query columns untouched."""
    jcfg, cfg, world = model["jcfg"], model["cfg"], model["world"]
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32))
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    want = _port_tree(_np(jlm.sync_grads(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, pc8)), cfg, world)
    raw = _port_tree(tree, cfg, world)
    got = lm.sync_grads(raw, cfg, ParallelContext(world=world))
    nq = attention.layout(cfg, TP).h_loc * HD
    for g, w, r in zip(got["layers"], want["layers"], raw["layers"]):
        a, b, c = g["mixer"]["wqkv"], w["mixer"]["wqkv"], r["mixer"]["wqkv"]
        assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item()
        assert torch.equal(a[..., :nq], c[..., :nq]) and not torch.equal(a, c)
        assert all(torch.equal(a[rk, :, nq:], a[0, :, nq:]) for rk in range(1, TP))


# ---- kernel #4's plain versions at head dim 256 -------------------------------


def _qkv(seed, bh, bhkv, sq, sk, d=256):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((bh, sq, d), (bhkv, sk, d), (bhkv, sk, d))]  # fmt: skip


@pytest.mark.parametrize("causal,sq,sk", [(True, 96, 96), (False, 64, 160), (False, 130, 70)])
def test_flash_tiled_at_d256_matches_chunked(causal, sq, sk):
    """The wgmma route's schedule (``flash_attention_tiled``, P kept in f32)
    at head dim 256 against ``chunked_attention``: paligemma's causal MQA
    shape and the cross-attention's Sq != Sk, ragged tiles included; the
    route table sends bf16 D 256 to the wgmma kernel, f32 to the FMA one."""
    q, k, v = _qkv(sq + sk, 8, 2, sq, sk)
    want = fa.chunked_attention(q[None], k[None], v[None], causal=causal, chunk=sk, q_offset=sk - sq)[0]
    got = fa.flash_attention_tiled(q, k, v, causal=causal, p_bf16=False)
    assert (got - want).abs().max().item() <= FLASH_RTOL * want.abs().max().item()
    assert 256 in fa.HEAD_DIMS and fa.route(torch.bfloat16, 256) == "wgmma" and fa.route(torch.float32, 256) == "fma"


def test_flash_statistics_and_function_at_d256():
    """``flash_attention_lse`` (o, lse) and the autograd Function's gradients
    at head dim 256 on the CPU (the plain state) against float32 autograd
    through ``chunked_attention``."""
    q, k, v = _qkv(3, 4, 1, 64, 64)
    o, lse = fa.flash_attention_lse(q, k, v, causal=True)
    s = torch.einsum("hqd,hkd->hqk", q, k.expand(4, -1, -1)) * 256**-0.5
    s = torch.where(torch.ones(64, 64, dtype=torch.bool).tril(), s, -1e30)
    assert (lse - torch.logsumexp(s, -1)).abs().max().item() <= FLASH_RTOL * lse.abs().max().item()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    ref = fa.chunked_attention(*(t[None] for t in ref_leaves), causal=True, chunk=64)[0]
    assert (out - ref).abs().max().item() <= FLASH_RTOL * ref.abs().max().item()
    assert (o - ref).abs().max().item() <= FLASH_RTOL * ref.abs().max().item()
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, leaves, dy)
    want = torch.autograd.grad(ref, ref_leaves, dy)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


def test_train_cli_trains_paligemma_text_only():
    """The train CLI picks ``models/lm`` for the VLM and trains it on text
    (no image prefix), as the reference's trainer."""
    assert train_cli.model_module(get_config(ARCH)) is lm
    run = train_cli.train(ARCH, reduce=True, steps=2, batch=2, seq=16, device="cpu", log_every=100)
    assert len(run["history"]) == 2 and all(np.isfinite(r["loss"]) for r in run["history"])
