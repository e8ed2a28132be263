"""qwen2-72b, starcoder2-7b and gemma3-27b in the port against the JAX
package, on the CPU.

Reduced configs (``reduce_config``: d_model 128, 8 / 4 heads of 16, vocab
256), weights from the JAX ``lm.init`` through ``convert.from_jax_params``;
the JAX side runs on the 8-device CPU mesh of ``tests/conftest.py`` (TP
4), the port on a 4-rank ``World``, float32.  What each config adds is made
to show: qwen2's QKV bias gets seeded non-zero values in the JAX tree
before conversion (the reference inits it to zero); gemma3's local window
is 16 on both sides, below every sequence here (64 forward and train
tokens, 32-token prompts), so its windowed masks, its ring decode cache
and its sqrt(d_model) embedding scale all act; starcoder2 runs GELU.

Bounds: logits |diff| <= 2e-3 + 2e-3 |ref| (the serving bound); greedy
tokens equal; each gradient leaf within 2e-3 of its max |ref|;
``apply_seq_ring`` against ``apply_seq`` 1e-5 of max (summation order).
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
from repro.training import steps as jsteps
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import PORT_FIELDS
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.nn import attention
from repro_torch.parallel.context import ParallelContext
from repro_torch.training import optimizer as topt
from repro_torch.training.steps import loss_and_grads
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from test_torch_training import j_jit
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

ARCHS = ("qwen2-72b", "starcoder2-7b", "gemma3-27b")
TP = 4
B, S, VOCAB, WINDOW = 2, 64, 256, 16
S0, NEW = 32, 5  # greedy: prompt tokens, new tokens
LOGITS = dict(atol=2e-3, rtol=2e-3)
GRAD_REL = 2e-3
# (backend, mode, fuse_seams) of the forward cases
FORWARDS = {"eager": ("eager", "overlap", False), "fused": ("fused", "overlap", False),
            "seams": ("eager", "overlap", True), "baseline": ("fused", "baseline", False)}  # fmt: skip


def _cfgs(arch):
    kw = dict(vocab_size=VOCAB)
    if arch.startswith("gemma"):
        kw["local_window"] = WINDOW
    return (dataclasses.replace(j_reduce_config(j_get_config(arch)), **kw),
            dataclasses.replace(reduce_config(get_config(arch)), **kw))  # fmt: skip


def _seeded_biases(np_params, seed=7):
    """The QKV biases (``bq`` / ``bkv``) drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    path_leaves, treedef = jax.tree_util.tree_flatten_with_path(np_params)
    out = []
    for path, a in path_leaves:
        name = str(getattr(path[-1], "key", ""))
        out.append((rng.normal(size=a.shape) * 0.5).astype(a.dtype) if name in ("bq", "bkv") else a)
    return jax.tree_util.tree_unflatten(treedef, out)


@pytest.fixture(scope="module", params=ARCHS)
def model(request, pc8, mesh8):
    jcfg, cfg = _cfgs(request.param)
    np_params = jax.tree_util.tree_map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32))
    if cfg.qkv_bias:
        np_params = _seeded_biases(np_params)
    jparams = place(jax.tree_util.tree_map(jnp.asarray, np_params), mesh8, jlm.specs(jcfg, pc8))
    world = World(TP, "cpu")
    params = from_jax_params(np_params, cfg, world)
    toks = np.random.default_rng(1).integers(0, VOCAB, size=(B, S)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params, world=world, toks=toks)


def _plain(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def _reference_fields(cfg):
    """The config's fields that the JAX package's config also has."""
    return [f for f in dataclasses.fields(cfg) if f.name not in PORT_FIELDS]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_port_matches_reference(arch):
    """Every field of the published and the reduced config; the reduced one
    keeps the window, theta, bias, activation and tying."""
    jc, tc = j_get_config(arch), get_config(arch)
    for f in _reference_fields(tc):
        assert _plain(getattr(tc, f.name)) == _plain(getattr(jc, f.name)), f.name
    assert tc.embed_scale == (jc.family == "vlm" or jc.name.startswith("gemma"))
    jr, tr = j_reduce_config(jc), reduce_config(tc)
    for f in _reference_fields(tr):
        assert _plain(getattr(tr, f.name)) == _plain(getattr(jr, f.name)), f.name
    for name in ("pattern", "local_window", "rope_theta_local", "qkv_bias", "act", "tie_embeddings"):
        assert getattr(tr, name) == getattr(tc, name), name
    assert [d.kind for d in lm.layer_plan(tc)] == [jc.layer_kind(i) for i in range(jc.n_layers)]


def test_reduced_configs_show_what_each_adds(model):
    cfg, params = model["cfg"], model["params"]
    mixer = params["layers"][0]["mixer"]
    assert ("bqkv" in mixer) == cfg.qkv_bias
    if cfg.qkv_bias:  # seeded, so the bias acts; [W, (h_loc + 2 kv_loc) hd], the reference's halves joined
        lay = attention.layout(cfg, TP)
        assert mixer["bqkv"].shape == (TP, (lay.h_loc + 2 * lay.kv_loc) * cfg.hd) and mixer["bqkv"].abs().min() > 0
    windows = {d.window for d in lm.layer_plan(cfg)}
    assert windows == ({None, WINDOW} if cfg.name.startswith("gemma") else {None}) and WINDOW < S0 < S
    # the embedding: gemma's scaled by sqrt(d_model), as the reference's; the others the plain lookup
    toks = model["toks"][:, :8]
    got = lm.embed_tokens(params, cfg, torch.from_numpy(toks).long())
    want = jlm.embed_tokens({"embed": model["jparams"]["embed"]}, model["jcfg"], jnp.asarray(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    raw = params["embed"].reshape(-1, cfg.d_model)[torch.from_numpy(toks).long()]
    scale = cfg.d_model**0.5 if cfg.name.startswith("gemma") else 1.0
    torch.testing.assert_close(got, raw * scale)


@pytest.fixture(scope="module")
def jax_logits(model, pc8):
    jl, _ = jax.jit(lambda p, t: jlm.forward(p, model["jcfg"], pc8, t))(model["jparams"], jnp.asarray(model["toks"]))
    return np.asarray(jl)


@pytest.mark.parametrize("case", sorted(FORWARDS))
def test_forward_logits_match_reference(model, jax_logits, case):
    """Teacher-forced logits on every backend, with fused RS -> AG seams
    (the seam hands qwen2's consumer a pre-bias projection) and in the
    baseline mode."""
    backend, mode, seams = FORWARDS[case]
    pc = ParallelContext(world=model["world"], backend=backend, mode=mode, fuse_seams=seams)
    tl, _ = lm.forward(model["params"], model["cfg"], pc, torch.from_numpy(model["toks"]).long())
    np.testing.assert_allclose(tl.numpy(), jax_logits, **LOGITS)


@pytest.fixture(scope="module")
def jax_greedy(model, pc8):
    """The reference: prefill logits, then per-token ``decode_step`` + argmax."""
    jcfg, jparams = model["jcfg"], model["jparams"]
    prefill = jax.jit(lambda p, t: jlm.prefill(p, jcfg, pc8, t, max_len=S0 + NEW))
    lg, caches = prefill(jparams, jnp.asarray(model["toks"][:, :S0]))
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
    """Prefill logits, then greedy tokens through ``decode_step`` (gemma3's
    local layers decode from a ring cache of 16 slots)."""
    cfg, world = model["cfg"], model["world"]
    prompts = model["toks"][:, :S0]
    jl, ref = jax_greedy
    pc = ParallelContext(world=world, backend=backend)
    tl, caches = lm.prefill(model["params"], cfg, pc, torch.from_numpy(prompts).long(), max_len=S0 + NEW)
    np.testing.assert_allclose(tl.numpy(), jl, **LOGITS)
    if cfg.local_window:
        sizes = {c["k"].shape[3] for c in caches}
        assert sizes == {WINDOW, S0 + NEW}
    tokens, timings = serve.greedy(model["params"], cfg, pc, torch.from_numpy(prompts).long(), NEW)
    np.testing.assert_array_equal(tokens.numpy(), ref)
    assert timings["decode_steps"] == NEW - 1


@pytest.fixture(scope="module")
def jax_grads(model, pc8):
    """(loss, the reference's gradients in the port's trainable layout)."""
    labels = np.roll(model["toks"], -1, axis=1)

    def loss_fn(p, inputs, lab):
        logits, aux = jlm.forward(p, model["jcfg"], pc8, inputs)
        return jsteps.softmax_xent(logits, lab) + 0.01 * aux

    loss, g = j_jit(jax.value_and_grad(loss_fn))(model["jparams"], jnp.asarray(model["toks"]), jnp.asarray(labels))
    tree = from_jax_params(jax.tree_util.tree_map(np.asarray, g), model["cfg"], model["world"])
    return float(loss), lm.trainable(tree, model["cfg"]), labels


@pytest.mark.parametrize("backend,mode", [("eager", "overlap"), ("fused", "overlap"), ("fused", "baseline")])
def test_train_step_loss_and_grads_match_reference(model, jax_grads, backend, mode):
    """One train step's loss and every leaf's gradient (the QKV bias, the
    tied, scaled embedding and the windowed layers included), against
    jax.value_and_grad; the baseline mode differentiates its gather-then-GEMM
    / GEMM-then-reduce-scatter Functions."""
    j_loss, j_grads, labels = jax_grads
    pc = ParallelContext(world=model["world"], backend=backend, mode=mode)
    batch = {"inputs": model["toks"], "labels": labels}
    loss, _, _, grads = loss_and_grads(lm, model["cfg"], pc, model["params"], batch)
    assert abs(loss.item() - j_loss) <= 2e-3 + 2e-3 * abs(j_loss)
    got, want = topt.tree_leaves(grads), topt.tree_leaves(j_grads)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        top = b.abs().max().item()
        assert top > 0, i  # every leaf, bias and norms included, gets a gradient
        assert (a - b).abs().max().item() <= GRAD_REL * top, (i, tuple(a.shape))


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_apply_seq_ring_with_bias_and_window_matches_apply_seq(model, backend):
    """The sequence-parallel layer form (gathered q bias, local K / V bias)
    against ``apply_seq`` on the first layer (gemma3's is windowed)."""
    cfg, world = model["cfg"], model["world"]
    d = lm.layer_plan(cfg)[0]
    p = model["params"]["layers"][0]["mixer"]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((TP, B, S // TP, cfg.d_model)).astype(np.float32))
    pc = ParallelContext(world=world, backend=backend)
    kw = dict(causal=True, window=d.window, rope_theta=d.theta)
    want = attention.apply_seq(p, x, pc, cfg, **kw)
    got = attention.apply_seq_ring(p, x, pc, cfg, **kw)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("arch", ARCHS)
def test_fma_route_tiles_fit_one_block_per_sm(arch):
    """The float32 route of the fused kernels at each published per-rank
    width (W = 4): the n tile widens until the cooperative grid holds one
    block per SM of an H100 (132), a divisor of the width, never narrower
    than the CompSpec's 128 when that fits."""
    from repro_torch.core.comp_tiles import fma_n_tile, largest_divisor

    full = get_config(arch)
    lay = attention.layout(full, TP)
    for n in ((lay.h_loc + 2 * lay.kv_loc) * full.hd, 2 * full.d_ff // TP, full.d_model):
        fits = [d for d in range(largest_divisor(n, 128), n + 1) if n % d == 0 and (n // d) * TP <= 132]
        assert fma_n_tile(n, 128, TP, 132) == fits[0]
    with pytest.raises(ValueError, match="exceed"):
        fma_n_tile(512, 128, 133, 132)
