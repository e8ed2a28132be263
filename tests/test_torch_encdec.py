"""The encoder-decoder (seamless-m4t-medium) in the port against the JAX
package, on the CPU.

Reduced config (``reduce_config``: 2 encoder + 2 decoder layers, d_model
128, 8 / 4 heads of 16, ReLU MLP of 256, enc_len 32; vocab 256), weights
from the JAX ``encdec.init`` (norm gains drawn from a numpy seed) through
``convert.from_jax_params``; 32 stub encoder frames and 16 decoder tokens
from a numpy seed.  The JAX side runs on the 8-device CPU mesh of
``tests/conftest.py`` (TP 4), each reference function jitted once per
module, the port on a 4-rank ``World``, float32.

Bounds: the layer functions (``encode``, the cross caches, one
cross-attention block) 1e-5 of max |ref|; logits |diff| <= 2e-3 + 2e-3
|ref| (the serving bound), the decode logits against the teacher-forced
forward's within the reference test's 3e-3 (``tests/test_extended.py``);
the loss the logits' bound and each gradient leaf 2e-3 of its max |ref|;
one AdamW step's updates 1e-2 of each leaf's max update where the gradient
is held; conversion, masks and the kv-copy sync exactly / 1e-6; a W = 4 ->
W = 2 restore 1e-4 of max |logits|.

The card's f32 fused-vs-eager step holds a ReLU model's gradients at the
fused pass's ReLU signs (``chip_smoke.relu_masks``); the last test here
shows why: flipping the sign of the one pre-activation nearest zero, which
summation order can flip, leaves the loss within 1e-6 but moves a weight
gradient by far more than 2e-3 of its max.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import encdec as jed
from repro.parallel.sharding import place
from repro.training import optimizer as jopt
from repro.training import steps as jsteps
from repro_torch.backend.mesh import World
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import PORT_FIELDS
from repro_torch.convert import from_jax_params, unshard_params
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import encdec, frontends
from repro_torch.nn import attention
from repro_torch.parallel.context import ParallelContext
from repro_torch.training import AdamWConfig, init_opt_state, make_eval_step, make_train_step
from repro_torch.training import optimizer as topt
from repro_torch.training.steps import loss_and_grads
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from test_torch_training import _assert_trees_close, _np, _with_gains, j_compiled, j_value_and_grad
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

ARCH = "seamless-m4t-medium"
TP = 4
B, SD, SE, VOCAB = 2, 16, 32, 256
LAYER_RTOL = 1e-5
LOGITS = dict(atol=2e-3, rtol=2e-3)
DECODE = dict(atol=3e-3, rtol=3e-3)
GRAD_REL, UPDATE_RTOL = 2e-3, 1e-2
RESTORE_RTOL = 1e-4


def _cfgs(**kw):
    kw = {"vocab_size": VOCAB, **kw}
    return (dataclasses.replace(j_reduce_config(j_get_config(ARCH)), **kw),
            dataclasses.replace(reduce_config(get_config(ARCH)), **kw))  # fmt: skip


def _port(np_tree, cfg, world):
    """A JAX-layout encdec tree (params, grads or moments) in the port's layout."""
    return from_jax_params(np_tree, cfg, world)


def _close(got: torch.Tensor, want, rtol=LAYER_RTOL, what=""):
    want = torch.from_numpy(np.array(want))
    err, top = (got - want).abs().max().item(), want.abs().max().item()
    assert got.shape == want.shape and err <= rtol * top, (what, tuple(got.shape), err, top)


@pytest.fixture(scope="module")
def model(pc8, mesh8):
    jcfg, cfg = _cfgs()
    np_params = _with_gains(_np(jax.jit(lambda k: jed.init(k, jcfg, pc8, jnp.float32))(jax.random.PRNGKey(0))))
    jparams = place(jax.tree_util.tree_map(jnp.asarray, np_params), mesh8, jed.specs(jcfg, pc8))
    world = World(TP, "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, VOCAB, size=(B, SD)).astype(np.int32)
    emb = (rng.standard_normal((B, SE, cfg.d_model)) * 0.5).astype(np.float32)
    batch = {"inputs": toks, "labels": np.roll(toks, -1, axis=1), "embeds": emb}
    return dict(jcfg=jcfg, cfg=cfg, np_params=np_params, jparams=jparams, params=_port(np_params, cfg, world),
                world=world, toks=toks, emb=emb, batch=batch)  # fmt: skip


@pytest.fixture(scope="module")
def ref(model, pc8):
    """The reference's encoder output, teacher-forced logits, cross caches and
    per-token decode logits (each function jitted once)."""
    jcfg, jp = model["jcfg"], model["jparams"]
    toks, emb = jnp.asarray(model["toks"]), jnp.asarray(model["emb"])
    enc = jax.jit(lambda p, e: jed.encode(p, jcfg, pc8, e))(jp, emb)
    logits, _ = jax.jit(lambda p, t, e: jed.forward(p, jcfg, pc8, t, e))(jp, toks, emb)
    cross = jax.jit(lambda p, e: jed.build_cross_caches(p, jcfg, pc8, e))(jp, enc)
    caches = place(jed.init_caches(jcfg, pc8, B, SD, jnp.float32), pc8.mesh, jed.cache_specs(jcfg, pc8))
    caches = {"self": caches["self"], "cross": cross}
    step = jax.jit(lambda p, c, t, n: jed.decode_step(p, c, jcfg, pc8, t, n))
    dec = []
    for i in range(SD):
        lg, caches = step(jp, caches, toks[:, i : i + 1], i)
        dec.append(np.asarray(lg[:, 0]))
    return dict(enc=np.asarray(enc), logits=np.asarray(logits), cross=_np(cross), decode=np.stack(dec, axis=1))


def _plain(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def test_config_matches_reference():
    """Every field of the published and the reduced config (``encoder_layers``
    and ``enc_len`` included: 2 and 32 reduced), as the JAX package's."""
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(tc):
        if f.name not in PORT_FIELDS:
            assert _plain(getattr(tc, f.name)) == _plain(getattr(jc, f.name)), f.name
            assert _plain(getattr(reduce_config(tc), f.name)) == _plain(getattr(j_reduce_config(jc), f.name)), f.name
    assert (tc.encoder_layers, tc.n_layers, tc.enc_len, tc.hd, tc.act) == (12, 12, 4096, 64, "relu")
    assert not tc.embed_scale and not tc.tie_embeddings
    r = reduce_config(tc)
    assert (r.encoder_layers, r.enc_len) == (2, 32)


def test_param_layout_and_unshard_roundtrip(model):
    """``from_jax_params`` unstacks ``enc_scan`` / ``dec_scan`` into layer
    lists, keeps each cross mixer's ``wq`` and ``wkv`` as separate per-rank
    shards, and ``unshard_params`` gives the JAX tree back exactly; the
    port's own init has the same shapes."""
    cfg, params, npp = model["cfg"], model["params"], model["np_params"]
    assert list(params) == ["embed", "head", "enc_ln", "final_ln", "enc_layers", "dec_layers"]
    assert [set(p) for p in params["enc_layers"]] == [{"attn", "ffn"}] * cfg.encoder_layers
    assert [set(p) for p in params["dec_layers"]] == [{"attn", "cross", "ffn"}] * cfg.n_layers
    lay = attention.layout(cfg, TP)
    cross = params["dec_layers"][0]["cross"]
    assert set(cross) == {"ln", "wq", "wkv", "wo"}
    assert cross["wq"].shape == (TP, cfg.d_model, lay.h_loc * cfg.hd) and cross["wq"].is_contiguous()
    assert cross["wkv"].shape == (TP, cfg.d_model, 2 * lay.kv_loc * cfg.hd) and cross["wkv"].is_contiguous()
    glob = unshard_params(params, cfg, model["world"])
    for part, n in (("enc", cfg.encoder_layers), ("dec", cfg.n_layers)):
        for u in range(n):
            want = jax.tree_util.tree_map(lambda a, u=u: a[u], npp[f"{part}_scan"])
            got = glob[f"{part}_layers"][u]
            for blk in want:
                for k, a in want[blk].items():
                    np.testing.assert_array_equal(got[blk][k].numpy(), a, err_msg=f"{part} {u} {blk} {k}")
    for k in ("embed", "lm_head", "enc_ln", "final_ln"):
        np.testing.assert_array_equal(glob[k].numpy(), npp[k], err_msg=k)
    own = encdec.init(cfg, model["world"], torch.Generator().manual_seed(0), torch.float32)
    assert topt.tree_map(lambda t: t.shape, own) == topt.tree_map(lambda t: t.shape, params)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_encode_matches_reference(model, ref, backend):
    pc = ParallelContext(world=model["world"], backend=backend)
    enc = encdec.encode(model["params"], model["cfg"], pc, torch.from_numpy(model["emb"]))
    _close(enc, ref["enc"], what="encode")


@pytest.mark.parametrize("backend,remat", [("eager", "none"), ("fused", "none"), ("fused", "dots")])
def test_forward_logits_match_reference(model, ref, backend, remat):
    pc = ParallelContext(world=model["world"], backend=backend)
    tl, aux = encdec.forward(model["params"], model["cfg"], pc, torch.from_numpy(model["toks"]).long(),
                             torch.from_numpy(model["emb"]), remat_policy=remat)  # fmt: skip
    np.testing.assert_allclose(tl.detach().numpy(), ref["logits"], **LOGITS)
    assert aux.item() == 0.0


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_cross_caches_and_decode_match_reference(model, ref, backend):
    """``build_cross_caches`` (per layer [W, B, kv_loc, Se, hd], the
    reference's [B, W kv_loc, Se, hd] per rank), then ``decode_step`` token
    by token: the reference's decode logits, and the teacher-forced
    forward's (the enc-dec decode property)."""
    cfg, world = model["cfg"], model["world"]
    pc = ParallelContext(world=world, backend=backend)
    enc = torch.from_numpy(ref["enc"])
    cross = encdec.build_cross_caches(model["params"], cfg, pc, enc)
    for i, c in enumerate(cross):
        for n in ("k", "v"):
            got = c[n].permute(1, 0, 2, 3, 4).reshape((B, -1) + c[n].shape[3:])
            _close(got, ref["cross"][n][i], what=f"cross {n} {i}")
    caches = encdec.init_caches(cfg, pc, B, SD, torch.float32)
    assert caches["cross"][0]["k"].shape[3] == cfg.enc_len
    caches["cross"] = cross
    toks = torch.from_numpy(model["toks"]).long()
    out = []
    for i in range(SD):
        lg, caches = encdec.decode_step(model["params"], caches, cfg, pc, toks[:, i : i + 1], i)
        out.append(lg[:, 0])
    dec = torch.stack(out, dim=1).numpy()
    np.testing.assert_allclose(dec, ref["decode"], **LOGITS)
    np.testing.assert_allclose(dec, ref["logits"], **DECODE)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_cross_attention_matches_reference(model, pc8, backend):
    """One cross-attention block alone (queries from 8 decoder rows, keys /
    values from 32 encoder rows) against the reference's ``apply_cross_seq``
    in its shard_map region."""
    jcfg, cfg, world = model["jcfg"], model["cfg"], model["world"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, SE, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[1], model["jparams"]["dec_scan"])["cross"]
    want = jax.jit(lambda p, x_, e_: jed._smap_attn(pc8, jcfg, p, x_, causal=False, extra=(e_,)))(
        jp, jnp.asarray(x), jnp.asarray(enc)
    )
    pc = ParallelContext(world=world, backend=backend)
    got = attention.apply_cross_seq(model["params"]["dec_layers"][1]["cross"], world.shard(torch.from_numpy(x), 1),
                                    world.shard(torch.from_numpy(enc), 1), pc, cfg)  # fmt: skip
    _close(world.unshard(got, 1) - torch.from_numpy(x), np.asarray(want) - x, what="cross block")


@pytest.fixture(scope="module")
def jax_vg(model, pc8):
    """The reference's loss and gradients, compiled once for the module."""
    return j_value_and_grad(jed, model["jcfg"], pc8)


@pytest.fixture(scope="module")
def jax_grads(model, jax_vg):
    (loss, _), g = jax_vg(model["jparams"], model["batch"])
    return float(loss), _port(_np(g), model["cfg"], model["world"])


@pytest.mark.parametrize("backend,remat", [("eager", "none"), ("fused", "none"), ("fused", "dots")])
def test_grads_match_reference(model, jax_grads, backend, remat):
    """The loss and every leaf's gradient (both stacks, the cross mixers'
    separate ``wq`` / ``wkv``, the untied head) against jax.value_and_grad."""
    pc = ParallelContext(world=model["world"], backend=backend)
    loss, _, aux, grads = loss_and_grads(encdec, model["cfg"], pc, model["params"], model["batch"], remat_policy=remat)
    j_loss, j_grads = jax_grads
    assert abs(loss.item() - j_loss) <= LOGITS["atol"] + LOGITS["rtol"] * abs(j_loss) and aux.item() == 0.0
    got, want = topt.tree_leaves(grads), topt.tree_leaves(j_grads)
    assert len(got) == len(want) == 4 + 6 * model["cfg"].encoder_layers + 10 * model["cfg"].n_layers
    for i, (a, w) in enumerate(zip(got, want)):
        top = w.abs().max().item()
        assert top > 0 and (a - w).abs().max().item() <= GRAD_REL * top, (i, tuple(a.shape))


def test_train_step_matches_reference(model, jax_grads, pc8):
    """One make_train_step step with ``batch["embeds"]`` on the fused backend
    (remat "dots") against the reference's ``make_train_step`` (weight decay
    1.0, which the reference applies to every scanned leaf and the
    matrices): the loss, the gradient norm and every leaf's update where the
    gradient is held (as ``test_torch_zamba2.py``'s step)."""
    cfg, jcfg, world = model["cfg"], model["jcfg"], model["world"]
    opt_cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, eps=1e-4, weight_decay=1.0)
    jstep = j_compiled(jsteps.make_train_step(jed, jcfg, pc8, jopt.AdamWConfig(**opt_cfg), remat_policy="none",
                                              grad_masks=jed.grad_masks(jcfg, pc8), donate=False))  # fmt: skip
    pc = ParallelContext(world=world, backend="fused")
    step = make_train_step(encdec, cfg, pc, AdamWConfig(**opt_cfg), remat_policy="dots",
                           grad_masks=encdec.grad_masks(cfg, pc))  # fmt: skip
    jp, _, jm = jstep(model["jparams"], jopt.init_opt_state(model["jparams"]), model["batch"])
    p, _, m = step(model["params"], init_opt_state(model["params"]), model["batch"])
    assert abs(m["loss"].item() - float(jm["loss"])) <= LOGITS["atol"] + LOGITS["rtol"] * abs(float(jm["loss"]))
    assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) <= GRAD_REL * float(jm["grad_norm"])
    leaves = zip(*(topt.tree_leaves(t) for t in (p, _port(_np(jp), cfg, world), model["params"], jax_grads[1])))
    for i, (new, want, old, g) in enumerate(leaves):
        u, u_ref = new - old, want - old
        sure = g.abs() > GRAD_REL * g.abs().max()
        assert ((u - u_ref).abs() * sure).max().item() <= UPDATE_RTOL * u_ref.abs().max().item(), (i, new.shape)
        assert u.abs().max().item() > 0
    ev = make_eval_step(encdec, cfg, pc)(p, model["batch"])
    assert np.isfinite(ev.item())


def test_decay_and_grad_masks_match_reference(pc8):
    """encdec.decay_mask against the reference's rule (ndim >= 2 in its own
    layout: every scanned leaf, the embedding and the head; not enc_ln /
    final_ln) leaf by leaf; no grad masks, as the reference's."""
    jcfg, cfg = _cfgs()
    shapes = jax.eval_shape(lambda: jed.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32))
    ref = jax.tree_util.tree_map(lambda s: np.full(s.shape, float(len(s.shape) >= 2), np.float32), shapes)
    port = _port(ref, cfg, World(TP, "cpu"))
    mask = encdec.decay_mask(port, cfg)
    for leaf, dec in zip(topt.tree_leaves(port), topt.tree_leaves(mask)):
        assert leaf.max().item() == float(dec) and torch.all((leaf == float(dec)) | (leaf == 0))
    assert mask["enc_ln"] is False and mask["dec_layers"][0]["cross"]["ln"] is True
    assert all(m is None for m in jax.tree_util.tree_leaves(jed.grad_masks(jcfg, pc8), is_leaf=lambda v: v is None))
    assert encdec.grad_masks(cfg, ParallelContext(world=World(TP, "cpu"))) is None


def test_sync_grads_matches_reference(pc8):
    """With 2 kv heads on 4 ranks (two stored copies) encdec.sync_grads
    averages the kv copies of every self- and cross-attention block of both
    stacks as the reference does, on a seeded tree."""
    jcfg, cfg = _cfgs(n_kv_heads=2)
    shapes = jax.eval_shape(lambda: jed.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32))
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    world = World(TP, "cpu")
    want = _port(_np(jed.sync_grads(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, pc8)), cfg, world)
    got = encdec.sync_grads(_port(tree, cfg, world), cfg, ParallelContext(world=world))
    _assert_trees_close(got, want, 1e-6, 0.0, "synced")
    raw = _port(tree, cfg, world)
    for part, blk in (("enc_layers", "attn"), ("dec_layers", "attn"), ("dec_layers", "cross")):
        name = "wkv" if blk == "cross" else "wqkv"
        assert not torch.equal(got[part][0][blk][name], raw[part][0][blk][name]), (part, blk)


def test_checkpoint_resume_and_restore_at_another_world_size(model, tmp_path):
    """The enc-dec tree through ``CheckpointManager``: saved at W = 4 with
    its moments, restored bitwise at W = 4 and onto W = 2 (each cross
    mixer's [K || V] columns re-packed), equal logits."""
    cfg = model["cfg"]
    w4, w2 = World(4, "cpu"), World(2, "cpu")
    params = model["params"]
    opt = init_opt_state(params)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, params, opt, cfg=cfg, world=w4)
    back, _ = mgr.restore(3, {"params": params, "opt": opt}, cfg=cfg, world=w4)
    for a, b in zip(topt.tree_leaves(back["params"]), topt.tree_leaves(params)):
        assert torch.equal(a, b)
    like = encdec.init(cfg, w2, torch.Generator().manual_seed(1), torch.float32)
    restored, _ = mgr.restore(3, {"params": like, "opt": init_opt_state(like)}, cfg=cfg, world=w2)
    assert restored["params"]["dec_layers"][0]["cross"]["wkv"].shape[0] == 2
    toks, emb = torch.from_numpy(model["toks"]).long(), torch.from_numpy(model["emb"])
    lg4, _ = encdec.forward(params, cfg, ParallelContext(world=w4), toks, emb)
    lg2, _ = encdec.forward(restored["params"], cfg, ParallelContext(world=w2), toks, emb)
    assert (lg4 - lg2).abs().max().item() <= RESTORE_RTOL * lg4.abs().max().item()


def test_frontend_shapes_follow_the_reference_rule(pc8):
    """The stub frames' count (the reference's ``input_specs``: 512 frames at
    256 decoder tokens, enc_len at long sequences) and shapes."""
    from repro.launch.specs import input_specs  # the JAX package's rule, on abstract shapes
    from repro.configs.base import Shape

    cfg, jc = get_config(ARCH), j_get_config(ARCH)
    assert frontends.encoder_frames(cfg, 256) == 512 and frontends.encoder_frames(cfg, 65536) == cfg.enc_len
    for s in (256, 4096, 65536):
        tree, _ = input_specs(jc, Shape("t", s, 8, "train"), pc8)
        assert tree["embeds"].shape == (8, frontends.encoder_frames(cfg, s), cfg.d_model)
    e = frontends.stub_frame_embeddings(torch.Generator().manual_seed(0), 2, 64, 16, torch.float32)
    assert e.shape == (2, 64, 16) and e.dtype == torch.float32 and 0 < e.std().item() < 0.05


def test_a_relu_sign_flip_moves_the_gradient_not_the_loss(model):
    """The mechanism behind the card's seamless f32 step reading up to
    1.3e-2 against 2e-3 at one seed: the fused and eager passes'
    pre-activations differ by summation order, and a handful of the 8-16 M
    elements of each ReLU lie within that rounding of zero, on opposite
    sides.  ReLU's derivative jumps there: the gate column of that unit
    loses (or gains) its token's whole term, x_t (dy up)_tj, while the
    output, relu(g) ~ 0 either way, does not move.  Here, on the eager pass:
    ``relu_masks`` forcing a pass's own signs reproduces it bitwise; forcing
    them with the last decoder layer's element nearest zero flipped moves
    the loss by under 1e-6 of it and that layer's ``w_gu`` gradient by more
    than GRAD_REL of its max in that unit's gate column, every other
    column by under 1e-5 of it."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", Path(__file__).parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg, params, batch = model["cfg"], model["params"], model["batch"]
    pc = ParallelContext(world=model["world"], backend="eager")

    def run(force=None):
        pre = []
        with cs.relu_masks(pre, force=force):
            loss, _, _, grads = loss_and_grads(encdec, cfg, pc, params, batch)
        return loss, grads, pre

    loss, grads, pre = run()
    assert len(pre) == cfg.encoder_layers + cfg.n_layers  # one ReLU a layer's MLP
    loss_same, grads_same, _ = run(force=pre)
    assert torch.equal(loss_same, loss)
    assert all(torch.equal(a, b) for a, b in zip(topt.tree_leaves(grads_same), topt.tree_leaves(grads)))
    flipped = [t.clone() for t in pre]
    i = flipped[-1].abs().argmin()
    flipped[-1].view(-1)[i] = -flipped[-1].view(-1)[i] if flipped[-1].view(-1)[i] else 1.0
    loss_flip, grads_flip, _ = run(force=flipped)
    assert abs(loss_flip.item() - loss.item()) <= 1e-6 * abs(loss.item())
    g, gf = grads["dec_layers"][-1]["ffn"]["w_gu"], grads_flip["dec_layers"][-1]["ffn"]["w_gu"]  # [W, D, 2 f_loc]
    top = g.abs().max().item()
    cols = (gf - g).abs().amax(dim=1) / top  # [W, 2 f_loc]: each column's move, relative to the leaf's max
    jump = cols.flatten().argmax().item()
    assert cols.flatten()[jump].item() > GRAD_REL  # the flipped unit's gate column: its token's whole term
    assert jump % g.shape[-1] < g.shape[-1] // 2  # a gate column, not an up column
    rest = torch.cat([cols.flatten()[:jump], cols.flatten()[jump + 1 :]])
    assert rest.max().item() <= 1e-5  # the others move only by the flipped output's ~0 change downstream


def test_relu_flips_are_held_to_rounding_of_zero():
    """``chip_smoke.hold_relu_flips``, which lets the card's f32 step force
    the fused pass's ReLU signs on the eager pass: a sign flipped within
    rounding of zero passes; one flipped far from zero on either pass, or
    more flips than RELU_MAX_FLIP_SHARE of a call, fails."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", Path(__file__).parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    a = torch.from_numpy(np.random.default_rng(61).standard_normal(400_000).astype(np.float32))
    top = a.abs().max().item()
    near = a.abs().argsort()[:8]  # the elements nearest zero
    assert a[near[-1]].abs().item() <= cs.RELU_FLIP_REL * top
    b = a.clone()
    b[near[:2]] = -b[near[:2]]  # two rounding flips: 5e-6 of the call at most
    found = cs.relu_flips([a], [b])
    assert found[0][0] == 2 and found[0][1] <= cs.RELU_FLIP_REL and found[0][2] == a.numel()
    cs.hold_relu_flips("two near-zero flips", found)
    assert cs.relu_flips([a], [a]) == [(0, 0.0, a.numel())]
    far = a.clone()
    far[a.abs().argmax()] = -far[a.abs().argmax()]  # a wrong value, not rounding
    with pytest.raises(SystemExit, match="beyond rounding of zero"):
        cs.hold_relu_flips("a flip far from zero", cs.relu_flips([a], [far]))
    many = a.clone()
    many[near] = -many[near]  # eight near-zero flips: more than 1e-5 of 400 000 elements
    assert cs.relu_flips([a], [many])[0][1] <= cs.RELU_FLIP_REL
    with pytest.raises(SystemExit, match="beyond rounding of zero"):
        cs.hold_relu_flips("too many flips", cs.relu_flips([a], [many]))
    with pytest.raises(SystemExit, match="called ReLU"):
        cs.relu_flips([a, a], [a])


def test_cli_refuses_the_encoder_decoder():
    """The serve CLI refuses an enc-dec arch with the reference's message;
    the train CLI picks the model by ``encoder_layers`` and refuses it (its
    SyntheticLM gives no frames)."""
    with pytest.raises(SystemExit, match="decoder-only"):
        serve_cli.main(["--arch", ARCH, "--reduce", "--device", "cpu"])
    assert train_cli.model_module(get_config(ARCH)) is encdec
    with pytest.raises(ValueError, match="encoder frames"):
        train_cli.train(ARCH, reduce=True, steps=1, device="cpu")
