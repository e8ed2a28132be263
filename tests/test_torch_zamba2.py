"""zamba2-2.7b (Mamba-2 layers and one shared attention block) in the port
against the JAX package, on the CPU.

Reduced config (``reduce_config``: 12 layers, two periods of five Mamba
layers then the shared attention block, d_model 128, d_state 16, 16 Mamba
heads of 16; 8 / 4 attention heads with the head dim kept at its published
80 by the same override on both sides, GELU MLP of 256; vocab 256), weights
from the JAX ``lm.init`` (norm gains and the Mamba per-head leaves drawn
from a numpy seed) through ``convert.from_jax_params``; the JAX side runs on
the 8-device CPU mesh of ``tests/conftest.py`` (TP 4), the port on a 4-rank
``World``, float32.  The one shared mixer (``params["shared_attn"]``) serves
both occurrences, each with its own MLP and KV cache; its gradient is the
sum over the occurrences.

Bounds: logits |diff| <= 2e-3 + 2e-3 |ref| (the serving bound); greedy
tokens equal; the loss the logits' bound and each gradient leaf within 2e-3
of its max |ref|; the step's updates 1e-2 of each leaf's max update where
the gradient is held; masks and the
kv-copy sync exactly / 1e-6; the W = 4 -> W = 2 restore 1e-4 of max
|logits| (twelve float32 layers whose reduce-scatters sum over 2 ranks
instead of 4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.parallel.sharding import place
from repro.training import optimizer as jopt
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import PORT_FIELDS
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.serving import Request, ServeEngine
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training import optimizer as topt
from repro_torch.training.steps import loss_and_grads
from test_torch_checkpoint import _restore_w4_at_w2
from test_torch_ssm_training import _seeded, assert_loss_and_grads
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from test_torch_training import _assert_trees_close, _np, _port_tree, j_train_step, j_value_and_grad
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

ARCH = "zamba2-2.7b"
TP = 4
B, S, VOCAB, HD = 2, 32, 256, 80
S0, NEW = 16, 5  # greedy: prompt tokens, new tokens
LOGITS = dict(atol=2e-3, rtol=2e-3)
GRAD_REL, UPDATE_RTOL = 2e-3, 1e-2
# the W = 4 -> W = 2 restore: 12 float32 layers sum over other rank counts
RESTORE_RTOL = 1e-4


def _cfgs(**kw):
    kw = {**dict(vocab_size=VOCAB, head_dim=HD), **kw}
    return (dataclasses.replace(j_reduce_config(j_get_config(ARCH)), **kw),
            dataclasses.replace(reduce_config(get_config(ARCH)), **kw))  # fmt: skip


@pytest.fixture(scope="module")
def model(pc8, mesh8):
    jcfg, cfg = _cfgs()
    np_params = _seeded(_np(jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32)))
    jparams = place(jax.tree_util.tree_map(jnp.asarray, np_params), mesh8, jlm.specs(jcfg, pc8))
    world = World(TP, "cpu")
    toks = np.random.default_rng(1).integers(0, VOCAB, size=(B, S)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, np_params=np_params, jparams=jparams, params=from_jax_params(np_params, cfg, world),
                world=world, toks=toks, batch={"inputs": toks, "labels": np.roll(toks, -1, axis=1)})  # fmt: skip


def _plain(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def test_config_matches_reference():
    """Every field of the published and the reduced config; the layer plan
    (45 Mamba layers, 9 shared attention blocks) is the reference's."""
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(tc):
        if f.name not in PORT_FIELDS:
            assert _plain(getattr(tc, f.name)) == _plain(getattr(jc, f.name)), f.name
            assert _plain(getattr(reduce_config(tc), f.name)) == _plain(getattr(j_reduce_config(jc), f.name)), f.name
    assert not tc.embed_scale and tc.hd == HD and tc.act == "gelu"
    plan = lm.layer_plan(tc)
    assert [d.kind for d in plan] == [jc.layer_kind(i) for i in range(jc.n_layers)]
    assert sum(d.shared for d in plan) == 9 and sum(d.kind == "mamba" for d in plan) == 45
    assert all(d.ffn_kind == "mlp" and d.window is None for d in plan if d.shared)


def test_param_layout(model):
    """One shared mixer; a shared_attn layer holds only its MLP; the Mamba
    layers their mixer; the shared mixer's wqkv at head dim 80."""
    cfg, params = model["cfg"], model["params"]
    assert list(params) == ["embed", "head", "final_ln", "shared_attn", "layers"]
    for d, layer in zip(lm.layer_plan(cfg), params["layers"]):
        assert set(layer) == ({"ffn"} if d.shared else {"mixer"}), d.kind
    lay_cols = (cfg.n_heads // TP + 2 * cfg.n_kv_heads // TP) * HD
    assert params["shared_attn"]["wqkv"].shape == (TP, cfg.d_model, lay_cols)
    jw = model["np_params"]["shared_attn"]["wo"]
    np.testing.assert_array_equal(params["shared_attn"]["wo"].reshape(-1, cfg.d_model).numpy(), jw)
    own = lm.init(cfg, model["world"], torch.Generator().manual_seed(0), torch.float32)
    assert topt.tree_map(lambda t: t.shape, own) == topt.tree_map(lambda t: t.shape, params)


@pytest.fixture(scope="module")
def jax_logits(model, pc8):
    jl, _ = jax.jit(lambda p, t: jlm.forward(p, model["jcfg"], pc8, t))(model["jparams"], jnp.asarray(model["toks"]))
    return np.asarray(jl)


@pytest.mark.parametrize("backend,seams", [("eager", False), ("fused", False), ("eager", True)])
def test_forward_logits_match_reference(model, jax_logits, backend, seams):
    """Teacher-forced logits on both backends, and with fused RS -> AG seams
    (each shared block's attention output projection feeds its MLP's
    gate/up; the Mamba layers break the chains)."""
    pc = ParallelContext(world=model["world"], backend=backend, fuse_seams=seams)
    tl, aux = lm.forward(model["params"], model["cfg"], pc, torch.from_numpy(model["toks"]).long())
    np.testing.assert_allclose(tl.numpy(), jax_logits, **LOGITS)
    assert aux.item() == 0.0


@pytest.fixture(scope="module")
def jax_greedy(model, pc8):
    """The reference: prefill logits, then per-token ``decode_step`` + argmax."""
    jcfg, jparams = model["jcfg"], model["jparams"]
    lg, caches = jax.jit(lambda p, t: jlm.prefill(p, jcfg, pc8, t, max_len=S0 + NEW))(
        jparams, jnp.asarray(model["toks"][:, :S0])
    )
    first = np.asarray(lg)
    tok = np.asarray(jnp.argmax(lg[:, -1], -1))
    out = [tok]
    step = jax.jit(lambda p, c, t, n: jlm.decode_step(p, c, jcfg, pc8, t, n))
    for i in range(NEW - 1):
        lg, caches = step(jparams, caches, jnp.asarray(tok[:, None].astype(np.int32)), S0 + i)
        tok = np.asarray(jnp.argmax(lg[:, 0], -1))
        out.append(tok)
    return first, np.stack(out, axis=1)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_prefill_and_greedy_decode_match_reference(model, jax_greedy, backend):
    """Prefill logits, then greedy tokens through ``decode_step``: the two
    shared blocks' KV caches and the ten Mamba states advance together."""
    cfg, world = model["cfg"], model["world"]
    prompts = torch.from_numpy(model["toks"][:, :S0]).long()
    jl, ref = jax_greedy
    pc = ParallelContext(world=world, backend=backend)
    tl, caches = lm.prefill(model["params"], cfg, pc, prompts, max_len=S0 + NEW)
    np.testing.assert_allclose(tl.numpy(), jl, **LOGITS)
    kinds = [set(c) for c in caches]
    assert kinds.count({"k", "v"}) == 2 and kinds.count({"ssm", "conv"}) == 10
    assert all(c["k"].shape[-1] == HD for c in caches if "k" in c)
    tokens, timings = serve.greedy(model["params"], cfg, pc, prompts, NEW)
    np.testing.assert_array_equal(tokens.numpy(), ref)
    assert timings["decode_steps"] == NEW - 1


def test_engine_tokens_match_greedy(model, jax_greedy):
    """The continuous-batching engine (eager on the CPU; prefill chunks of 8
    through ``decode_step``, KV caches and Mamba states in one slot pool) on
    the greedy requests: the reference's greedy tokens, with one slot reused."""
    cfg, world = model["cfg"], model["world"]
    eng = ServeEngine(cfg, ParallelContext(world=world), model["params"], max_len=S0 + NEW, n_slots=1,
                      prefill_chunk=8)  # fmt: skip
    handles = [eng.submit(Request(tokens=row.tolist(), max_new_tokens=NEW)) for row in model["toks"][:, :S0]]
    outs = eng.drain(handles)
    np.testing.assert_array_equal(np.stack([outs[h] for h in handles]), jax_greedy[1])


@pytest.fixture(scope="module")
def jax_vg(model, pc8):
    """The reference's loss and gradients, compiled once for the module."""
    return j_value_and_grad(jlm, model["jcfg"], pc8)


@pytest.fixture(scope="module")
def jax_grads(model, jax_vg):
    (loss, _), g = jax_vg(model["jparams"], model["batch"])
    return float(loss), _port_tree(_np(g), model["cfg"], model["world"])


@pytest.mark.parametrize("backend,remat", [("eager", "none"), ("fused", "none"), ("fused", "dots")])
def test_grads_match_reference(model, jax_grads, backend, remat):
    """The loss and every leaf's gradient (the shared mixer's, summed over
    its two uses; each block's own MLP; the Mamba leaves; the untied head)."""
    pc = ParallelContext(world=model["world"], backend=backend)
    loss, _, _, grads = loss_and_grads(lm, model["cfg"], pc, model["params"], model["batch"], remat_policy=remat)
    assert_loss_and_grads(loss.item(), grads, *jax_grads)
    assert set(grads["shared_attn"]) == {"ln", "wqkv", "wo"}


def test_train_step_matches_reference(model, jax_grads, jax_vg, pc8):
    """One make_train_step step under remat "dots" on the fused backend
    against the reference's (``make_train_step``'s body over the module's
    compiled gradients, ``test_torch_training.j_train_step``): the loss, the
    gradient norm and every leaf's
    update (new - p; weight decay 1.0: the shared mixer sits outside the
    reference's scan, so its norm gain is not decayed, the scanned layers'
    are).  The gradients agree to 2e-3 of each leaf's max, so an update is
    held (1e-2 of the leaf's max update) where the reference gradient
    exceeds that: Adam's first step, lr g / (|g| + eps), turns a smaller
    gradient's rounding into a whole step."""
    cfg, jcfg, world = model["cfg"], model["jcfg"], model["world"]
    opt_cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, eps=1e-4, weight_decay=1.0)
    jstep = j_train_step(jax_vg, jlm, jcfg, pc8, jopt.AdamWConfig(**opt_cfg), grad_masks=jlm.grad_masks(jcfg, pc8))
    pc = ParallelContext(world=world, backend="fused")
    step = make_train_step(lm, cfg, pc, AdamWConfig(**opt_cfg), remat_policy="dots", grad_masks=lm.grad_masks(cfg, pc))
    jp, _, jm = jstep(model["jparams"], jopt.init_opt_state(model["jparams"]), model["batch"])
    p, _, m = step(model["params"], init_opt_state(lm.trainable(model["params"], cfg)), model["batch"])
    assert abs(m["loss"].item() - float(jm["loss"])) <= LOGITS["atol"] + LOGITS["rtol"] * abs(float(jm["loss"]))
    assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) <= GRAD_REL * float(jm["grad_norm"])
    leaves = zip(*(topt.tree_leaves(t) for t in (lm.trainable(p, cfg), _port_tree(_np(jp), cfg, world),
                                                 lm.trainable(model["params"], cfg), jax_grads[1])))  # fmt: skip
    for i, (new, ref, old, g) in enumerate(leaves):
        u, u_ref = new - old, ref - old
        sure = g.abs() > GRAD_REL * g.abs().max()
        assert ((u - u_ref).abs() * sure).max().item() <= UPDATE_RTOL * u_ref.abs().max().item(), (i, new.shape)
        assert u.abs().max().item() > 0  # every leaf moved
    mask = lm.decay_mask(lm.trainable(p, cfg), cfg)
    assert mask["shared_attn"]["ln"] is False and mask["shared_attn"]["wqkv"] is True
    assert mask["layers"][5]["ffn"]["ln"] is True and mask["layers"][0]["mixer"]["a_log"] is True


def test_decay_and_grad_masks_match_reference(pc8):
    """lm.decay_mask against the reference's rule (ndim >= 2 in its own
    layout) leaf by leaf; lm.grad_masks has the shared mixer's entry (None:
    no head is padded) and None for every Mamba layer, as the reference."""
    jcfg, cfg = _cfgs()
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32))
    ref = jax.tree_util.tree_map(lambda s: np.full(s.shape, float(len(s.shape) >= 2), np.float32), shapes)
    port = _port_tree(ref, cfg, World(TP, "cpu"))
    for leaf, dec in zip(topt.tree_leaves(port), topt.tree_leaves(lm.decay_mask(port, cfg))):
        assert leaf.max().item() == float(dec) and torch.all((leaf == float(dec)) | (leaf == 0))
    jm = jlm.grad_masks(jcfg, pc8)
    masks = lm.grad_masks(cfg, ParallelContext(world=World(TP, "cpu")))
    assert "shared_attn" in jm and all(v is None for v in jm["shared_attn"].values())
    assert masks["shared_attn"] is None and all(m is None for m in masks["layers"])


def test_sync_grads_walks_the_shared_mixer(pc8):
    """With 2 kv heads on 4 ranks (two stored copies) lm.sync_grads averages
    the shared mixer's kv copies as the reference does, on a seeded tree."""
    jcfg, cfg = _cfgs(n_kv_heads=2)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32))
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    world = World(TP, "cpu")
    want = _port_tree(_np(jlm.sync_grads(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, pc8)), cfg, world)
    got = lm.sync_grads(_port_tree(tree, cfg, world), cfg, ParallelContext(world=world))
    _assert_trees_close(got, want, 1e-6, 0.0, "synced")
    raw = _port_tree(tree, cfg, world)["shared_attn"]["wqkv"]
    assert not torch.equal(got["shared_attn"]["wqkv"], raw)


def test_restore_onto_another_world_size(tmp_path):
    """Saved at W = 4, restored at W = 2: the Mamba layers' x | z columns and
    the shared mixer's [K || V] columns re-pack; equal logits."""
    _, cfg = _cfgs(vocab_size=128)
    params, restored = _restore_w4_at_w2(tmp_path, cfg, ("w_xz",), RESTORE_RTOL)
    assert restored["params"]["shared_attn"]["wqkv"].shape[0] == 2
    assert params["shared_attn"]["wqkv"].shape[0] == 4


def test_serve_cli_on_cpu(capsys):
    r = serve.main(["--arch", ARCH, "--reduce", "--device", "cpu", "--dtype", "f32", "--batch", "3",
                    "--prompt-len", "8", "--new-tokens", "3", "--slots", "2"])  # fmt: skip
    assert r["tokens"].shape == (3, 3) and r["graph_captures"] == 0
    assert "tokens/s" in capsys.readouterr().out
