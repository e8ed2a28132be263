"""The port's training path against the JAX package's, on the CPU.

Reduced smollm-360m (2 layers, d_model 128, 8 / 4 heads of 16, vocab 256)
and a variant with 2 kv heads (fewer than the W = 4 ranks: the kv weights
stored in 2 copies, so ``sync_grads`` averages them), weights from the JAX
``lm.init`` (norm gains drawn from a numpy seed, so weight decay acts on
them from the first step) through ``convert.from_jax_params``; JAX
gradients, moments and masks go through the same converter.  The JAX side
runs on the 8-device CPU mesh of ``tests/conftest.py`` (TP 4), the port on a
4-rank ``World``; float32 throughout.

Tolerances: per-leaf gradients 1e-5 + 1e-4 x max |reference leaf| (both
backends: summation order only); three AdamW steps: parameters and moments
1e-5 + 1e-4 |ref|, loss / grad_norm 1e-5 relative, lr 1e-7 relative;
the optimizer on identical numpy trees 1e-6; the autograd Functions
against ``torch.autograd`` through the eager executor 1e-5 of max |eager|;
batches, remat and padded heads exactly.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import MemmapTokens as JMemmap
from repro.data import SyntheticLM as JSynthetic
from repro.models import lm as jlm
from repro.nn.layers import gqa_layout as j_gqa_layout
from repro.parallel.sharding import place
from repro.training import optimizer as jopt
from repro.training import steps as jsteps
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import from_jax_params
from repro_torch.core import BlockChannel, CommSpec, compile_overlap
from repro_torch.data import MemmapTokens, SyntheticLM
from repro_torch.kernels import ag_gemm, matmul
from repro_torch.kernels.flash_attention import chunked_attention, flash_attention
from repro_torch.models import lm
from repro_torch.nn.layers import gqa_layout, sync_kv_grad
from repro_torch.parallel.context import ParallelContext
from repro_torch.training import AdamWConfig, init_opt_state, make_eval_step, make_train_step, softmax_xent
from repro_torch.training.steps import loss_and_grads
from repro_torch.training import optimizer as topt
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

TP = 4
B, S, VOCAB = 4, 32, 256
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
KV = {"kv4": 4, "kv2": 2}  # kv heads of the two reduced configs (rep 1 and rep 2 at TP 4)
ORDERS = ("ring", "bidir_ring", "all2all")


def _cfgs(n_kv: int, **kw):
    base = {**dict(n_layers=2, vocab_size=VOCAB, n_kv_heads=n_kv), **kw}
    return (dataclasses.replace(j_reduce_config(j_get_config("smollm-360m")), **base),
            dataclasses.replace(reduce_config(get_config("smollm-360m")), **base))  # fmt: skip


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with_gains(np_params, seed=3):
    """Norm gains drawn from a numpy seed (the init's are zero)."""
    rng = np.random.default_rng(seed)
    path_leaves, treedef = jax.tree_util.tree_flatten_with_path(np_params)
    out = []
    for path, a in path_leaves:
        name = str(getattr(path[-1], "key", ""))
        out.append((rng.normal(size=a.shape) * 0.1).astype(a.dtype) if name.endswith("ln") else a)
    return jax.tree_util.tree_unflatten(treedef, out)


# XLA's CPU runtime runs each emulated device's collectives on one shared thread
# pool, and its concurrency-optimized schedule lets independent collectives of
# one program (the FSDP all-gathers over "data" beside the ring's permutes over
# "model") start in different orders on different devices.  With every pool
# thread parked in a rendezvous, a device whose turn never comes stalls the
# rest, and after 40 s the rendezvous aborts the process ("Termination timeout
# ... Exiting to ensure a consistent program state").  The reduced seamless
# gradient did so in 4 of 10 runs on an 8-core host.  The memory-ordered
# schedule orders them alike on every device; the numbers are bitwise the same.
# Every reference gradient and train step on the 8-device mesh compiles with it.
J_COMPILE = {"xla_cpu_enable_concurrency_optimized_scheduler": False}


def j_jit(fn, **kw):
    """``jax.jit`` with the reference-oracle compiler options (:data:`J_COMPILE`)."""
    return jax.jit(fn, compiler_options=J_COMPILE, **kw)


def j_compiled(jitted):
    """A ``jax.jit`` function of the JAX package (e.g. ``make_train_step``'s
    step) compiled with :data:`J_COMPILE` at its first call, the executable
    kept for the calls after it (same shapes; donation as the function
    declares)."""
    exe = []

    def call(*args):
        if not exe:
            exe.append(jitted.lower(*args).compile(compiler_options=J_COMPILE))
        return exe[0](*args)

    return call


def j_value_and_grad(jmod, jcfg, jpc, remat_policy: str = "none", aux_weight: float = 0.01):
    """The reference's loss (cross-entropy + ``aux_weight`` x the aux loss,
    ``repro/training/steps.make_train_step``'s ``loss_fn``) under one
    ``jax.jit(jax.value_and_grad(..., has_aux=True))`` of (params, batch):
    ((loss, (ce, aux)), grads), compiled with :data:`J_COMPILE`.  A module
    compiles it once and shares it between its gradient and train-step
    tests."""

    def loss_fn(p, batch):
        logits, aux = jmod.forward(p, jcfg, jpc, batch["inputs"], embeds=batch.get("embeds"),
                                   remat_policy=remat_policy)  # fmt: skip
        ce = jsteps.softmax_xent(logits, batch["labels"], batch.get("mask"))
        return ce + aux_weight * aux, (ce, aux)

    return j_jit(jax.value_and_grad(loss_fn, has_aux=True))


def j_train_step(vg, jmod, jcfg, jpc, opt_cfg, grad_masks=None):
    """The reference's train step, ``repro/training/steps.make_train_step``'s
    body over a shared :func:`j_value_and_grad` ``vg``: the gradients, the
    kv-copy sync (``jmod.sync_grads``), then ``repro/training/optimizer.
    apply_update`` (jitted) with ``grad_masks``.  Returns ``step(params,
    opt_state, batch) -> (params, opt_state, metrics)``."""
    update = j_jit(lambda p, g, o: jopt.apply_update(p, g, o, opt_cfg, grad_masks=grad_masks))

    def step(p, o, batch):
        (loss, (ce, aux)), g = vg(p, batch)
        if hasattr(jmod, "sync_grads"):
            g = jmod.sync_grads(g, jcfg, jpc)
        p, o, om = update(p, g, o)
        return p, o, {"loss": loss, "ce": ce, "aux": aux, **om}

    return step


def _port_tree(np_tree, cfg, world):
    """A JAX-layout tree (params, grads or moments) in the port's trainable layout."""
    return lm.trainable(from_jax_params(np_tree, cfg, world), cfg)


def _assert_trees_close(a, b, atol, rtol, what=""):
    la, lb = topt.tree_leaves(a), topt.tree_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape, (what, i, x.shape, y.shape)
        y = y.float()
        err = (x.float() - y).abs().max().item()
        assert err <= atol + rtol * y.abs().max().item(), (what, i, tuple(x.shape), err)


@pytest.fixture(scope="module", params=sorted(KV))
def model(request, pc8, mesh8):
    jcfg, cfg = _cfgs(KV[request.param])
    np_params = _with_gains(_np(jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32)))
    jparams = place(jax.tree_util.tree_map(jnp.asarray, np_params), mesh8, jlm.specs(jcfg, pc8))
    world = World(TP, "cpu")
    params = from_jax_params(np_params, cfg, world)
    pipe = SyntheticLM(vocab_size=VOCAB, seq_len=S, global_batch=B, seed=1)
    batches = [pipe.host_batch() for _ in range(3)]
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params, world=world, batches=batches)


def _port_grads(params, cfg, pc, batch):
    loss, _, _, grads = loss_and_grads(lm, cfg, pc, params, batch)
    return loss, grads


def _vg(model, pc8):
    """The reference's loss and gradients of ``model`` (:func:`j_value_and_grad`),
    compiled once per model and shared by the gradient and step tests."""
    if "vg" not in model:
        model["vg"] = j_value_and_grad(jlm, model["jcfg"], pc8)
    return model["vg"]


@pytest.fixture(scope="module")
def jax_grads(model, pc8):
    """(loss, the reference's gradients in its own layout) of the first batch."""
    (loss, _), g = _vg(model, pc8)(model["jparams"], model["batches"][0])
    return float(loss), g


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_grads_match_reference(model, jax_grads, backend):
    """Every leaf's gradient (before the kv sync) against jax.value_and_grad."""
    pc = ParallelContext(world=model["world"], backend=backend)
    loss, grads = _port_grads(model["params"], model["cfg"], pc, model["batches"][0])
    j_loss, j_grads = jax_grads[0], _port_tree(_np(jax_grads[1]), model["cfg"], model["world"])
    assert abs(loss.item() - j_loss) <= 1e-5 * abs(j_loss)
    assert len(topt.tree_leaves(grads)) == 3 + 6 * model["cfg"].n_layers - 1  # the tied head is the embedding
    _assert_trees_close(grads, j_grads, **GRAD_TOL, what=backend)


def test_sync_grads_match_reference(model, jax_grads, pc8):
    """lm.sync_grads on the port's layout against the reference's on its own."""
    cfg, world = model["cfg"], model["world"]
    pc = ParallelContext(world=world, backend="eager")
    _, grads = _port_grads(model["params"], cfg, pc, model["batches"][0])
    j_synced = _port_tree(_np(jlm.sync_grads(jax_grads[1], model["jcfg"], pc8)), cfg, world)
    synced = lm.sync_grads(grads, cfg, pc)
    _assert_trees_close(synced, j_synced, **GRAD_TOL, what="synced")
    lay = gqa_layout(cfg.n_heads, cfg.n_kv_heads, TP)
    kv = synced["layers"][0]["mixer"]["wqkv"][..., lay.h_loc * cfg.hd :]
    if lay.rep > 1:  # the copies are equal after the sync, and differed before it
        copies = kv.reshape(lay.kv_pad, lay.rep, *kv.shape[1:])
        assert torch.equal(copies[:, 0], copies[:, 1])
        raw = grads["layers"][0]["mixer"]["wqkv"][..., lay.h_loc * cfg.hd :].reshape(copies.shape)
        assert not torch.equal(raw[:, 0], raw[:, 1])
    else:
        assert synced is grads


@pytest.mark.parametrize("kv", [1, 2, 4])
def test_sync_kv_grad_matches_reference(kv):
    """nn/layers.sync_kv_grad on rank-stacked kv columns against the reference on the global ones."""
    from repro.nn.layers import sync_kv_grad as j_sync

    lay, jlay = gqa_layout(8, kv, TP), j_gqa_layout(8, kv, TP)
    g = np.random.default_rng(kv).normal(size=(5, lay.kv_store * 2 * 3)).astype(np.float32)  # [D, kv_store * 2hd]
    ref = np.asarray(j_sync(jnp.asarray(g), jlay, axis=-1))
    t = torch.from_numpy(g).reshape(5, TP, -1).permute(1, 0, 2)  # shard the columns: [W, D, kv_loc * 2hd]
    out = sync_kv_grad(t, lay).permute(1, 0, 2).reshape(5, -1).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


STEP_OPT = dict(lr=1e-2, warmup_steps=2, total_steps=5, eps=1e-4, weight_decay=1.0)


def _ref_step(model, pc8):
    """The reference's ``make_train_step`` for ``model`` at STEP_OPT, compiled
    once per model and shared by the step tests."""
    if "jstep" not in model:
        jcfg = model["jcfg"]
        jstep = jsteps.make_train_step(jlm, jcfg, pc8, jopt.AdamWConfig(**STEP_OPT),
                                       grad_masks=jlm.grad_masks(jcfg, pc8), donate=False)  # fmt: skip
        model["jstep"] = j_compiled(jstep)
    return model["jstep"]


def test_train_steps_match_reference(model, pc8):
    """Three make_train_step steps: parameters, both moments and the metrics.
    Weight decay 1.0 moves every decayed leaf by lr x p a step, so a leaf
    decayed on one side only (the reference decays the scanned layers'
    norm gains, [L, D] in its layout) shows at once; eps 1e-4 keeps
    AdamW's m / sqrt(v) off near-zero gradients, where a rounding
    difference would move an element by a whole step."""
    cfg, jcfg, world = model["cfg"], model["jcfg"], model["world"]
    jstep = _ref_step(model, pc8)
    pc = ParallelContext(world=world, backend="eager")
    step = make_train_step(lm, cfg, pc, AdamWConfig(**STEP_OPT), grad_masks=lm.grad_masks(cfg, pc))
    jp, jo = model["jparams"], jopt.init_opt_state(model["jparams"])
    p, o = model["params"], init_opt_state(lm.trainable(model["params"], cfg))
    for batch in model["batches"]:
        jp, jo, jm = jstep(jp, jo, batch)
        p, o, m = step(p, o, batch)
        for k in ("loss", "ce", "grad_norm"):
            assert abs(m[k].item() - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
        assert abs(m["lr"].item() - float(jm["lr"])) <= 1e-7 * float(jm["lr"])
    _assert_trees_close(lm.trainable(p, cfg), _port_tree(_np(jp), cfg, world), 1e-5, 1e-4, "params")
    for k in ("mu", "nu"):
        _assert_trees_close(o[k], _port_tree(_np(jo[k]), cfg, world), 1e-5, 1e-4, k)
    assert int(o["step"]) == int(jo["step"]) == 3
    # the tied head's copy is the updated embedding
    assert torch.equal(p["head"][:, :VOCAB], p["embed"].reshape(VOCAB, -1).t())


def test_shared_reference_step_matches_make_train_step(model, pc8):
    """:func:`j_train_step` over :func:`j_value_and_grad` (the reference step
    the other training modules build on their shared compiled gradients)
    against the reference's ``make_train_step`` itself (remat "dots", the
    reference trainer's policy): three steps' metrics, parameters and
    moments within the bounds the port is held to."""
    jcfg = model["jcfg"]
    ref = _ref_step(model, pc8)
    got = j_train_step(_vg(model, pc8), jlm, jcfg, pc8, jopt.AdamWConfig(**STEP_OPT), grad_masks=jlm.grad_masks(jcfg, pc8))
    a = b = (model["jparams"], jopt.init_opt_state(model["jparams"]))
    for batch in model["batches"]:
        *a, ma = ref(*a, batch)
        *b, mb = got(*b, batch)
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert abs(float(ma[k]) - float(mb[k])) <= 1e-5 * abs(float(ma[k])), k
    cfg, world = model["cfg"], model["world"]
    _assert_trees_close(_port_tree(_np(b[0]), cfg, world), _port_tree(_np(a[0]), cfg, world), 1e-5, 1e-4, "params")
    for k in ("mu", "nu"):
        _assert_trees_close(_port_tree(_np(b[1][k]), cfg, world), _port_tree(_np(a[1][k]), cfg, world), 1e-5, 1e-4, k)


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m", "deepseek-moe-16b", "mamba2-2.7b"])
def test_decay_mask_matches_reference_rule(arch, pc8):
    """lm.decay_mask against the reference's rule (ndim >= 2 in its own
    layout, scanned layers stacked), each leaf carried through the converter."""
    jcfg = dataclasses.replace(j_reduce_config(j_get_config(arch)), vocab_size=VOCAB)
    cfg = dataclasses.replace(reduce_config(get_config(arch)), vocab_size=VOCAB)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32))
    ref = jax.tree_util.tree_map(lambda s: np.full(s.shape, float(len(s.shape) >= 2), np.float32), shapes)
    port = _port_tree(ref, cfg, World(TP, "cpu"))
    mask = lm.decay_mask(port, cfg)
    for leaf, dec in zip(topt.tree_leaves(port), topt.tree_leaves(mask)):
        # every entry carries the reference leaf's rule (the zero pads convert adds aside)
        assert leaf.max().item() == float(dec) and torch.all((leaf == float(dec)) | (leaf == 0)), (arch, dec)
    if arch == "deepseek-moe-16b":  # its dense first layer is unscanned: its norms are not decayed
        assert mask["layers"][0]["mixer"]["ln"] is False and mask["layers"][1]["mixer"]["ln"] is True
    assert mask["final_ln"] is False


def test_grad_masks_match_reference(pc8):
    """lm.grad_masks (3 heads padded to 4, 1 kv head in 4 copies) against the reference's, converted."""
    jcfg, cfg = _cfgs(1, n_heads=3)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32))
    jm = jlm.grad_masks(jcfg, pc8)
    assert jm["scan"][0]["mixer"]["wq"] is not None

    def full(shape, m):
        return np.ones(shape.shape, np.float32) if m is None else np.broadcast_to(np.asarray(m), shape.shape[1:])

    ref = {"embed": np.ones(shapes["embed"].shape, np.float32), "final_ln": np.ones(shapes["final_ln"].shape, np.float32),
           "prefix": [], "suffix": [],
           "scan": [jax.tree_util.tree_map(lambda s, m: np.broadcast_to(full(s, m), s.shape), shapes["scan"][0],
                                           jm["scan"][0], is_leaf=lambda v: v is None)]}  # fmt: skip
    world = World(TP, "cpu")
    ref_port = _port_tree(ref, cfg, world)
    pc = ParallelContext(world=world, backend="eager")
    ones = topt.tree_map(torch.ones_like, ref_port)
    masked = topt._prefix_map(lambda g, m: g if m is None else g * m, ones, lm.grad_masks(cfg, pc))
    for a, b in zip(topt.tree_leaves(masked), topt.tree_leaves(ref_port)):
        assert torch.equal(a, b)


def test_padded_heads_stay_zero():
    """smollm's head padding (3 q heads on 4 ranks): padded weights stay exactly zero (3 steps)."""
    _, cfg = _cfgs(1, n_heads=3, n_layers=1, vocab_size=128)
    world = World(TP, "cpu")
    pc = ParallelContext(world=world, backend="fused")
    params = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)
    step = make_train_step(lm, cfg, pc, AdamWConfig(lr=1e-2, total_steps=10), grad_masks=lm.grad_masks(cfg, pc))
    opt = init_opt_state(lm.trainable(params, cfg))
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    for _ in range(3):
        params, opt, _ = step(params, opt, pipe.host_batch())
    lay = gqa_layout(cfg.n_heads, cfg.n_kv_heads, TP)
    wq = params["layers"][0]["mixer"]["wqkv"][..., : lay.h_loc * cfg.hd]  # [W, D, h_loc * hd]
    pad = wq.permute(1, 0, 2).reshape(cfg.d_model, lay.h_pad, cfg.hd)[:, cfg.n_heads :]
    assert pad.numel() and pad.abs().max().item() == 0.0
    assert params["layers"][0]["mixer"]["wo"][-1].abs().max().item() == 0.0  # the last rank holds the pad head


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_remat_none_and_dots_equal(backend):
    """remat_policy="dots" (each layer recomputed in the backward) gives the
    same gradients and parameters as "none", bitwise."""
    _, cfg = _cfgs(2)
    world = World(TP, "cpu")
    pc = ParallelContext(world=world, backend=backend)
    params = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)
    batch = SyntheticLM(vocab_size=VOCAB, seq_len=S, global_batch=B).host_batch()
    out = {}
    for policy in ("none", "dots"):
        step = make_train_step(lm, cfg, pc, AdamWConfig(lr=1e-2), remat_policy=policy)
        out[policy] = step(params, init_opt_state(lm.trainable(params, cfg)), batch)
    for a, b in zip(topt.tree_leaves(out["none"][0]), topt.tree_leaves(out["dots"][0])):
        assert torch.equal(a, b)
    assert torch.equal(out["none"][2]["loss"], out["dots"][2]["loss"])


def test_loss_decreases_on_synthetic_bigrams():
    """The reference's loss-decrease test (tests/test_training.py), on the port."""
    _, cfg = _cfgs(4)
    world = World(TP, "cpu")
    pc = ParallelContext(world=world, backend="eager")
    params = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)
    opt = init_opt_state(lm.trainable(params, cfg))
    step = make_train_step(lm, cfg, pc, AdamWConfig(lr=3e-3, total_steps=40, warmup_steps=5),
                           grad_masks=lm.grad_masks(cfg, pc))  # fmt: skip
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    losses = []
    for _ in range(30):
        params, opt, m = step(params, opt, pipe.host_batch())
        losses.append(float(m["ce"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.2, (first, last)
    ev = make_eval_step(lm, cfg, pc)(params, pipe.host_batch())
    assert np.isfinite(ev.item()) and ev.item() < first


def test_train_step_rejects_unported_models():
    """Every registered config trains (the Mamba and shared-attention layers
    since their slice), and so does the seamed forward (fuse_seams): the
    step builds (tests/test_torch_seam_training.py holds its gradients)."""
    world = World(TP, "cpu")
    for arch in ("mamba2-2.7b", "zamba2-2.7b"):
        cfg = reduce_config(get_config(arch))
        make_train_step(lm, cfg, ParallelContext(world=world), AdamWConfig())
    _, cfg = _cfgs(4)
    assert callable(make_train_step(lm, cfg, ParallelContext(world=world, fuse_seams=True), AdamWConfig()))


# --- the optimizer and the data pipeline on identical inputs ----------------------------------


def _np_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 4), "b": (5,), "c": {"d": (2, 3, 4), "e": [(6,), (2, 2)]}}
    return jax.tree_util.tree_map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                                  is_leaf=lambda v: isinstance(v, tuple))  # fmt: skip


def _j2t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("masked", [False, True])
def test_apply_update_matches_reference(masked):
    """Three AdamW updates on identical numpy trees (ndim >= 2 decay, clipping, masks)."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=0.5)
    params = _np_trees(0)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _j2t(params)
    js, ts = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    jm = {"a": jnp.asarray(mask), "b": None, "c": {"d": None, "e": [None, None]}} if masked else None
    tm = {"a": torch.from_numpy(mask), "b": None, "c": None} if masked else None
    decay = topt.tree_map(lambda p: p.dim() >= 2, tp)  # the reference's rule, on a tree of its own layout
    for i in range(3):
        g = _np_trees(10 + i)
        jp, js, jmet = jopt.apply_update(jp, jax.tree_util.tree_map(jnp.asarray, g), js, jopt.AdamWConfig(**cfg), jm)
        tp, ts, tmet = topt.apply_update(tp, _j2t(g), ts, topt.AdamWConfig(**cfg), tm, decay)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=1e-6)
    for a, b in zip(topt.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    for k in ("mu", "nu"):
        for a, b in zip(topt.tree_leaves(ts[k]), jax.tree_util.tree_leaves(js[k])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def test_global_norm_and_bf16_update_dtype():
    tree = _np_trees(1)
    np.testing.assert_allclose(topt.global_norm(_j2t(tree)).item(),
                               float(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, tree))), rtol=1e-6)  # fmt: skip
    p = {"w": torch.ones((2, 3), dtype=torch.bfloat16)}
    new, st, _ = topt.apply_update(p, {"w": torch.ones((2, 3), dtype=torch.bfloat16)}, topt.init_opt_state(p),
                                   topt.AdamWConfig(), None, {"w": True})  # fmt: skip
    assert new["w"].dtype == torch.bfloat16 and st["mu"]["w"].dtype == torch.float32


@pytest.mark.parametrize("step", [0, 1, 4, 5, 50, 99, 100, 101, 5000, 10_000, 20_000])
def test_schedule_matches_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
    ref = float(jopt.schedule(jopt.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32)))
    np.testing.assert_allclose(topt.schedule(topt.AdamWConfig(**cfg), step).item(), ref, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize(
    "vocab,seq,batch,hosts,seed", [(64, 8, 8, 1, 0), (256, 32, 8, 2, 1), (49152, 16, 4, 4, 7), (4096, 5, 6, 3, 2)]
)
def test_synthetic_batches_bitwise(vocab, seq, batch, hosts, seed):
    """SyntheticLM: every host's batches bitwise the JAX package's, over 3 steps and a restore."""
    for host in range(hosts):
        kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed, n_hosts=hosts, host_id=host)
        a, b = SyntheticLM(**kw), JSynthetic(**kw)
        for _ in range(3):
            ba, bb = a.host_batch(), b.host_batch()
            for k in ("inputs", "labels"):
                assert ba[k].dtype == bb[k].dtype and np.array_equal(ba[k], bb[k])
        assert a.state() == b.state()
        a.restore({"cursor": 1, "seed": seed})
        b.restore({"cursor": 1, "seed": seed})
        assert np.array_equal(a.host_batch()["inputs"], b.host_batch()["inputs"])


def test_memmap_batches_bitwise(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 65535, size=4099, dtype=np.uint16).tofile(path)
    a = MemmapTokens(str(path), seq_len=32, global_batch=6, n_hosts=2, host_id=1)
    b = JMemmap(str(path), seq_len=32, global_batch=6, n_hosts=2, host_id=1)
    for _ in range(30):  # wraps around the file
        ba, bb = a.host_batch(), b.host_batch()
        assert all(np.array_equal(ba[k], bb[k]) for k in ("inputs", "labels"))


# --- the autograd Functions against torch.autograd through the eager executor ---------------


def _grads_of(fn, *args, seed=0):
    args = [a.detach().clone().requires_grad_(True) for a in args]
    out = fn(*args)
    dy = torch.from_numpy(np.random.default_rng(seed).normal(size=out.shape).astype(np.float32))
    out.backward(dy)
    return out.detach(), [a.grad for a in args]


def _assert_grads(fused, eager):
    for a, b in zip([fused[0], *fused[1]], [eager[0], *eager[1]]):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-5 * max(b.abs().max().item(), 1e-6)


@pytest.mark.parametrize("kind,order,nch", list(itertools.product(["ag_matmul", "matmul_rs"], ORDERS, [1, 2])))
def test_fused_collective_grads_match_eager(kind, order, nch):
    """The kind's autograd Function over the fused kernel's plain replay
    (dx through the other fused kernel, dw from the gathered rows) against
    torch.autograd through the eager executor."""
    world = World(TP, "cpu")
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    rng = np.random.default_rng(nch)
    if kind == "ag_matmul":  # x [W, B, m_loc, K], w [W, K, n_loc]
        x, w = rng.normal(size=(TP, 2, 8, 24)), rng.normal(size=(TP, 24, 16))
    else:  # x [W, B, M, k_loc], w [W, k_loc, N]
        x, w = rng.normal(size=(TP, 2, 16, 12)), rng.normal(size=(TP, 12, 20))
    x, w = (torch.from_numpy(a.astype(np.float32)) for a in (x, w))
    fused = _grads_of(compile_overlap(kind, ch, world=world, backend="fused"), x, w)
    eager = _grads_of(compile_overlap(kind, ch, world=world, backend="eager"), x, w)
    _assert_grads(fused, eager)


@pytest.mark.parametrize("order,nch", list(itertools.product(ORDERS, [1, 2])))
def test_ag_gemm_returns_the_gathered_operand(order, nch):
    world = World(TP, "cpu")
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(TP, 3, 8, 16)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(TP, 16, 8)).astype(np.float32))
    out, gathered = ag_gemm(x, w, channel=ch, return_gathered=True)
    assert torch.equal(gathered, world.all_gather(x, 1))
    assert torch.equal(out, ag_gemm(x, w, channel=ch))


@pytest.mark.parametrize(
    "rep,sq,sk,causal,window", [(1, 64, 64, True, None), (2, 64, 64, True, None), (3, 48, 80, True, None),
                                (2, 64, 64, True, 24), (1, 40, 40, False, None)]  # fmt: skip
)
def test_flash_attention_grads_match_eager(rep, sq, sk, causal, window):
    """Flash attention's Function (the forward with its statistics, the
    backward from the saved log-sum-exp) against autograd through the plain
    chunked attention."""
    rng = np.random.default_rng(rep)
    q = torch.from_numpy(rng.normal(size=(2 * rep, sq, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, sk, 16)).astype(np.float32)) for _ in range(2))

    def plain(q_, k_, v_):
        return chunked_attention(q_[None], k_[None], v_[None], causal=causal, window=window, chunk=sk // 2 * 2
                                 if sk % 2 == 0 else sk, q_offset=sk - sq)[0]  # fmt: skip

    fused = _grads_of(lambda *a: flash_attention(*a, causal=causal, window=window), q, k, v)
    _assert_grads(fused, _grads_of(plain, q, k, v))


def test_lm_head_grads_match_eager():
    rng = np.random.default_rng(0)
    x, w = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((12, 16), (16, 40)))
    _assert_grads(_grads_of(matmul, x, w), _grads_of(torch.matmul, x, w))


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(masked):
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4).astype(np.float32) if masked else None
    ref = float(jsteps.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), None if mask is None else jnp.asarray(mask)))
    out = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.item(), ref, rtol=1e-6)
