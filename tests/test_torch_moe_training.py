"""The port's MoE training path against the JAX package's, on the CPU.

Reduced granite-moe-3b-a800m (2 MoE layers) and deepseek-moe-16b (a dense
first layer, then 2 MoE layers with 2 shared experts): d_model 128, 8
experts top-2, vocab 256, W = 4, 4 x 32 tokens, weights from the JAX
``lm.init`` (norm gains drawn from a numpy seed) through
``convert.from_jax_params``; float32 throughout.  Every leaf's gradient of
the loss (cross-entropy + 0.01 x the load-balance loss) on the TP AG+MoE
double ring and on the EP a2a pair (``ep_axis``), on the eager and the
fused backend (the fused one runs the grouped GEMM's autograd Function over
the plain replay), against ``jax.value_and_grad``; three AdamW steps
against the reference's ``make_train_step`` body over the same compiled
gradients (each JAX reference is compiled once per module and shared); ``_GroupedMatmul``'s
gradients against ``jax.vjp`` of ``repro.kernels.ref.grouped_matmul_ref``;
the kept / dropped (token, k) sets of a step at a tight capacity; the
W ring steps of a layer sharing one w^T copy of each expert weight in the
backward (TP and EP); and
``lm.check_trainable``, which admits both models (TP and EP); a bf16
step keeps the float32 router float32, with and without ``donate``.  MoE
checkpoints and the train CLI on a reduced MoE model are in
``tests/test_torch_checkpoint.py``.

Tolerances: gradients 1e-5 + 1e-4 x max |reference leaf| (summation order
only), the loss 1e-5 relative; three steps as ``tests/test_torch_training.py``;
the grouped GEMM's output and gradients 1e-6 of max |reference| (float32
sums of up to 264 products in another order); the
dispatch tables bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import moe_overlap as j_moe_overlap
from repro.kernels.ref import grouped_matmul_ref
from repro.models import lm as jlm
from repro.parallel.context import ParallelContext as JContext
from repro.parallel.sharding import place
from repro.training import optimizer as jopt
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import from_jax_params
from repro_torch.core import moe_overlap
from repro_torch.data import SyntheticLM
from repro_torch.kernels import grouped_matmul
from repro_torch.kernels.grouped_matmul import SharedTranspose, group_tile_table
from repro_torch.models import lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training import optimizer as topt
from repro_torch.training.steps import loss_and_grads
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from test_torch_training import GRAD_TOL, _assert_trees_close, _np, _port_tree, _with_gains, j_train_step, j_value_and_grad
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

TP = 4
B, S, VOCAB = 4, 32, 256
ARCHS = ("granite-moe-3b-a800m", "deepseek-moe-16b")
EP = {"tp": None, "ep": "model"}


def _cfgs(arch: str, capacity_factor=None):
    out = []
    for cfg in (j_reduce_config(j_get_config(arch)), reduce_config(get_config(arch))):
        moe = cfg.moe if capacity_factor is None else dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
        out.append(dataclasses.replace(cfg, vocab_size=VOCAB, moe=moe))
    return out


_SETUPS = {}  # (arch, batch, seq, capacity_factor) -> the model: built once per module


def _setup(arch, mesh8, pc8, batch=B, seq=S, capacity_factor=None):
    key = (arch, batch, seq, capacity_factor)
    if key not in _SETUPS:
        _SETUPS[key] = _build(arch, mesh8, pc8, batch, seq, capacity_factor)
    return _SETUPS[key]


def _build(arch, mesh8, pc8, batch, seq, capacity_factor):
    jcfg, cfg = _cfgs(arch, capacity_factor)
    np_params = _with_gains(_np(jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32)))
    jparams = place(jax.tree_util.tree_map(jnp.asarray, np_params), mesh8, jlm.specs(jcfg, pc8))
    world = World(TP, "cpu")
    pipe = SyntheticLM(vocab_size=VOCAB, seq_len=seq, global_batch=batch, seed=1)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=from_jax_params(np_params, cfg, world), world=world,
                batches=[pipe.host_batch() for _ in range(3)])  # fmt: skip


@pytest.fixture(scope="module", params=ARCHS)
def model(request, mesh8, pc8):
    return _setup(request.param, mesh8, pc8)


def _vg(m, mesh8, ep_axis):
    """The reference's jitted loss and gradients of model ``m`` on the TP
    (``ep_axis`` None) or the EP path, compiled once per module
    (:func:`test_torch_training.j_value_and_grad`)."""
    key = ("vg", ep_axis)
    if key not in m:
        m[key] = j_value_and_grad(jlm, m["jcfg"], JContext(mesh=mesh8, ep_axis=ep_axis))
    return m[key]


def _jax_grads(m, mesh8, ep_axis, batch):
    (loss, _), g = _vg(m, mesh8, ep_axis)(m["jparams"], batch)
    return float(loss), _port_tree(_np(g), m["cfg"], m["world"])


@pytest.fixture(scope="module", params=sorted(EP))
def jax_grads(request, model, mesh8):
    """(ep key, loss, the reference's gradients in the port's layout) of the first batch."""
    return (request.param, *_jax_grads(model, mesh8, EP[request.param], model["batches"][0]))


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_grads_match_reference(model, jax_grads, backend):
    """Every leaf's gradient (the router, every expert's w_gu / w_down, the
    shared and dense MLPs, attention, the embedding) against jax.value_and_grad."""
    ep, j_loss, j_grads = jax_grads
    pc = ParallelContext(world=model["world"], backend=backend, ep_axis=EP[ep])
    loss, _, aux, grads = loss_and_grads(lm, model["cfg"], pc, model["params"], model["batches"][0])
    assert abs(loss.item() - j_loss) <= 1e-5 * abs(j_loss) and aux.item() > 0
    _assert_trees_close(grads, j_grads, **GRAD_TOL, what=f"{backend}/{ep}")
    for layer, d in zip(grads["layers"], lm.layer_plan(model["cfg"])):
        if d.ffn_kind == "moe":  # every routed-expert leaf and the router got a gradient
            assert all(layer["ffn"][k].abs().max().item() > 0 for k in ("router", "w_gu", "w_down"))


def test_train_steps_match_reference(model, mesh8, pc8):
    """Three make_train_step steps (fused backend) against the reference's
    (``make_train_step``'s body over the module's compiled TP gradients,
    ``test_torch_training.j_train_step``): parameters (the float32 router
    among them), both moments, the metrics."""
    m = model
    cfg, jcfg, world = m["cfg"], m["jcfg"], m["world"]
    opt_cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, eps=1e-4, weight_decay=1.0)
    jstep = j_train_step(_vg(m, mesh8, None), jlm, jcfg, pc8, jopt.AdamWConfig(**opt_cfg),
                         grad_masks=jlm.grad_masks(jcfg, pc8))  # fmt: skip
    pc = ParallelContext(world=world, backend="fused")
    step = make_train_step(lm, cfg, pc, AdamWConfig(**opt_cfg), grad_masks=lm.grad_masks(cfg, pc))
    jp, jo = m["jparams"], jopt.init_opt_state(m["jparams"])
    p, o = m["params"], init_opt_state(lm.trainable(m["params"], cfg))
    for batch in m["batches"]:
        jp, jo, jm = jstep(jp, jo, batch)
        p, o, met = step(p, o, batch)
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert abs(met[k].item() - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    _assert_trees_close(lm.trainable(p, cfg), _port_tree(_np(jp), cfg, world), 1e-5, 1e-4, "params")
    for k in ("mu", "nu"):
        _assert_trees_close(o[k], _port_tree(_np(jo[k]), cfg, world), 1e-5, 1e-4, k)
    moe_layer = p["layers"][-1]["ffn"]
    assert moe_layer["router"].dtype == torch.float32 and int(o["step"]) == 3


def test_kept_sets_of_a_step_equal_reference(mesh8, pc8):
    """At capacity_factor 0.5 and 2 x 128 tokens a train step drops (token, k) pairs: every
    dispatch table the port builds in the step's forward (both ring flows
    of both MoE layers, fused backend) is bitwise the JAX package's
    ``_dispatch_tables`` of the same local ids, and the step's gradients
    still match jax.value_and_grad (another kept set would show as an O(1)
    error in the expert leaves)."""
    m = _setup("granite-moe-3b-a800m", mesh8, pc8, batch=2, seq=128, capacity_factor=0.5)
    calls, tables = [], moe_overlap._dispatch_tables

    def recording(local_ids, valid, e_loc, cap, dtype):
        out = tables(local_ids, valid, e_loc, cap, dtype)
        calls.append((local_ids, valid, e_loc, cap, out))
        return out

    moe_overlap._dispatch_tables = recording
    try:
        pc = ParallelContext(world=m["world"], backend="fused")
        loss, _, _, grads = loss_and_grads(lm, m["cfg"], pc, m["params"], m["batches"][0])
    finally:
        moe_overlap._dispatch_tables = tables
    assert len(calls) == 2 * TP  # one table per ring step and MoE layer
    kept = routed = 0
    for local_ids, valid, e_loc, cap, out in calls:
        mk = local_ids.shape[-2:]  # the reference's tables are per [m, k] (a vmap over the leading dims)
        want = jax.vmap(lambda i, v: j_moe_overlap._dispatch_tables(i, v, e_loc, cap, jnp.float32))(
            jnp.asarray(local_ids.reshape(-1, *mk).numpy()), jnp.asarray(valid.reshape(-1, *mk).numpy()))
        assert np.array_equal(out.reshape(-1, *out.shape[-4:]).numpy(), np.asarray(want))
        kept, routed = kept + int(out.sum()), routed + int(valid.sum())
    assert kept < routed  # the capacity really dropped pairs
    j_loss, j_grads = _jax_grads(m, mesh8, None, m["batches"][0])
    assert abs(loss.item() - j_loss) <= 1e-5 * abs(j_loss)
    _assert_trees_close(grads, j_grads, **GRAD_TOL, what="cf 0.5")


@pytest.mark.parametrize("form", ["shuffled", "groups"])
def test_grouped_matmul_grads_match_jax_vjp(form):
    """``_GroupedMatmul`` (the plain replay forward, dx through the wrapper
    on w^T, dw per expert) against ``jax.vjp`` of the JAX oracle.
    "shuffled": a non-monotone table with one entry outside [0, E), which
    the oracle sees as a zero expert (zero rows, nothing in dw); "groups":
    ``group_tile_table`` with ``group_rows``, 3 row tiles a group (dw one
    product per group)."""
    rng = np.random.default_rng(7)
    e, k, n, bm = 5, 24, 16, 8
    if form == "shuffled":
        table, kw = np.array([3, 0, 4, e, 1, 3, 2, 0], np.int32), {}
    else:  # groups of 264 rows (granite's capacity at 1 x 4096 tokens) in three 88-row tiles
        table, kw = group_tile_table(e, 264, torch.device("cpu")).numpy(), {"group_rows": 264}
        bm = 88
    x = rng.normal(size=(table.size * bm, k)).astype(np.float32)
    w = rng.normal(size=(e, k, n)).astype(np.float32)
    dy = rng.normal(size=(x.shape[0], n)).astype(np.float32)
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    out = grouped_matmul(xt, wt, torch.from_numpy(table), **kw)
    out.backward(torch.from_numpy(dy))
    valid = (table >= 0) & (table < e)
    w_pad = jnp.concatenate([jnp.asarray(w), jnp.zeros((1, k, n), jnp.float32)])  # expert e: the zero rows
    ref, vjp = jax.vjp(lambda x_, w_: grouped_matmul_ref(x_, w_, jnp.asarray(np.where(valid, table, e)), bm),
                       jnp.asarray(x), w_pad)  # fmt: skip
    dx, dw = vjp(jnp.asarray(dy))
    for got, want in ((out.detach(), ref), (xt.grad, dx), (wt.grad, np.asarray(dw)[:e])):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    if form == "shuffled":  # the out-of-range tile: zero rows, zero dx rows
        rows = slice(3 * bm, 4 * bm)
        assert not out.detach()[rows].any() and not xt.grad[rows].any()
        with pytest.raises(ValueError, match="groups of"):
            grouped_matmul(xt, wt, torch.from_numpy(table), group_rows=3)


def test_moe_training_rejects_only_mamba_and_fuse_seams():
    """Both MoE models train on TP and EP, and with fuse_seams (no MoE layer
    joins a seam chain; deepseek's dense first layer takes its intra-layer
    seam): the seamed gradients equal the unfused ones bitwise in float32
    (the seam runs the unfused pair's float ops)."""
    world = World(TP, "cpu")
    for arch in ARCHS:
        lm.check_trainable(reduce_config(get_config(arch)), ParallelContext(world=world, ep_axis="model"))
        lm.check_trainable(reduce_config(get_config(arch)), ParallelContext(world=world, fuse_seams=True))
    cfg = reduce_config(get_config("deepseek-moe-16b"))
    params = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2).host_batch()
    out = [loss_and_grads(lm, cfg, ParallelContext(world=world, backend="eager", fuse_seams=s), params, batch)
           for s in (True, False)]  # fmt: skip
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(topt.tree_leaves(out[0][3]), topt.tree_leaves(out[1][3])))


@pytest.mark.parametrize("donate", [False, True])
def test_bf16_step_keeps_the_f32_router(donate):
    """A bf16 reduced granite step (fused backend) with and without
    ``donate``: every leaf keeps its dtype (the float32 router among bf16
    leaves, its moments float32) and the router moves; the loss is finite."""
    cfg = _cfgs("granite-moe-3b-a800m")[1]
    world = World(TP, "cpu")
    pc = ParallelContext(world=world, backend="fused")
    params = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.bfloat16)
    dtypes = [t.dtype for t in topt.tree_leaves(lm.trainable(params, cfg))]
    router = params["layers"][0]["ffn"]["router"].clone()
    step = make_train_step(lm, cfg, pc, AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4),
                           grad_masks=lm.grad_masks(cfg, pc), donate=donate)  # fmt: skip
    batch = SyntheticLM(vocab_size=VOCAB, seq_len=S, global_batch=B, seed=2).host_batch()
    new, opt, met = step(params, init_opt_state(lm.trainable(params, cfg)), batch)
    assert [t.dtype for t in topt.tree_leaves(lm.trainable(new, cfg))] == dtypes
    assert router.dtype == torch.float32 and torch.bfloat16 in dtypes
    assert new["layers"][0]["ffn"]["router"].dtype == torch.float32
    assert not torch.equal(new["layers"][0]["ffn"]["router"], router)
    assert np.isfinite(met["loss"].item()) and opt["mu"]["layers"][0]["ffn"]["router"].dtype == torch.float32


@pytest.mark.parametrize("path", ["ag_moe", "a2a_moe"])
def test_ring_steps_share_one_weight_transpose(path, monkeypatch):
    """The grouped dx launches of a layer's W ring steps share one w^T copy
    of each expert weight (``SharedTranspose``): one copy of w_gu and one of
    w_down, taken W times each and dropped after the last step; the
    gradients match the non-grouped float32 path.  Registering other
    weights on a shared copy raises."""
    rng = np.random.default_rng(3)
    world, e_loc, d, f, k, m = World(TP, "cpu"), 2, 16, 8, 2, 16
    ids = np.argsort(rng.random((TP, 1, m, TP * e_loc)), -1)[..., :k]  # distinct experts per token
    x, wts, w_gu, w_down = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(TP, 1, m, d)), rng.random((TP, 1, m, k)), rng.normal(size=(TP, e_loc, d, 2 * f)),
        rng.normal(size=(TP, e_loc, f, d))))  # fmt: skip
    dy = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    made, take = [], SharedTranspose.take

    def recording(self, w):
        made.append(self.wt is None)
        out = take(self, w)
        assert self.users > 0 or self.wt is None  # the last step drops the copy
        return out

    monkeypatch.setattr(SharedTranspose, "take", recording)
    grads = {}
    for grouped in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (x, w_gu, w_down)]
        y = getattr(moe_overlap, path)(leaves[0], torch.from_numpy(ids), wts, *leaves[1:], world=world, grouped=grouped)
        grads[grouped] = torch.autograd.grad((y * dy).sum(), leaves)
    assert len(made) == 2 * TP and sum(made) == 2  # gate|up and down: one copy each, W steps each
    for got, want in zip(grads[True], grads[False]):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    shared = SharedTranspose()
    shared.register(w_gu.reshape(TP * e_loc, d, -1))
    with pytest.raises(ValueError, match="registered for weights"):
        shared.register(w_down.reshape(TP * e_loc, f, -1))
