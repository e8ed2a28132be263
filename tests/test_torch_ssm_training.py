"""The port's Mamba-2 training path against the JAX package's, on the CPU.

``ssd_chunked(intra="kernel")`` (the intra-chunk term's autograd Function,
``_SsdIntraChunk``: the plain forward on CPU tensors and the float32
backward in torch ops) and its einsum form against ``jax.grad`` of
``repro.kernels.mamba_ssd.ssd_chunked``, at lengths that are not a
multiple of the chunk; ``ssd_intra_chunk_backward`` against float32
autograd over the plain version; one reduced Mamba layer's leaf gradients
(``nn/mamba.apply_seq`` on a 4-rank ``World``) against ``jax.grad`` of the
JAX block in ``shard_map`` (the replicated ``w_bc`` and ``ln`` summed over
the ranks there, one gathered view here); reduced mamba2-2.7b (2 layers,
d_model 128, 16 heads of 16, d_state 16, chunk 16, vocab 256), weights from
the JAX ``lm.init`` (norm gains and the per-head leaves drawn from a numpy
seed) through ``convert.from_jax_params``: its loss and every leaf's
gradient against ``jax.value_and_grad``, and one AdamW step under
``remat_policy="dots"`` against the reference's ``make_train_step``;
``lm.check_trainable``; a checkpoint of Mamba's packed ``w_in`` restored at
W = 2.  Float32 throughout.

Tolerances: ``ssd_chunked``'s gradients 1e-5 of max |reference| (float32
sums in another order); the Mamba layer's 1e-5 + 1e-4 x max |reference
leaf| (as ``tests/test_torch_training.py``); the model's loss the logits'
bound (2e-3 + 2e-3 |ref|), each gradient 2e-3 of its leaf's max, the
step's parameters 1e-5 + 1e-4 |ref|; the restore 1e-5 of max |logits|.
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
from repro.models import lm as jlm
from repro.nn import mamba as j_mamba
from repro.parallel.context import ParallelContext as JContext
from repro.parallel.sharding import place
from repro.training import optimizer as jopt
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import from_jax_params, shard_mamba
from repro_torch.kernels import mamba_ssd
from repro_torch.models import lm
from repro_torch.nn import mamba
from repro_torch.parallel.context import ParallelContext
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training import optimizer as topt
from repro_torch.training.steps import loss_and_grads
from test_torch_checkpoint import _restore_w4_at_w2
from test_torch_mamba import _ssd_inputs
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from test_torch_training import GRAD_TOL, _assert_trees_close, _np, _port_tree, j_train_step, j_value_and_grad
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

TP = 4
ARCH = "mamba2-2.7b"
B, S, VOCAB = 2, 48, 256
LOGITS = dict(atol=2e-3, rtol=2e-3)
GRAD_REL = 2e-3
SSD_GRAD_REL = 1e-5
# the per-head leaves and the norm gains the JAX init leaves at 0 / 1, drawn so each gradient term acts
SEEDED = {"ln": 0.1, "dt_bias": 0.5, "a_log": 0.5, "d_skip": 0.5}


def _seeded(np_params, seed=3):
    """``np_params`` with the leaves of ``SEEDED`` drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    path_leaves, treedef = jax.tree_util.tree_flatten_with_path(np_params)
    out = []
    for path, a in path_leaves:
        name = str(getattr(path[-1], "key", ""))
        scale = next((v for k, v in SEEDED.items() if name.endswith(k)), None)
        out.append(a if scale is None else (rng.normal(size=a.shape) * scale).astype(a.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


# ---- ssd_chunked: the intra-chunk Function and the chunk recurrence ---------


@pytest.mark.parametrize("intra", mamba_ssd.INTRA_FORMS)
@pytest.mark.parametrize("length,chunk", [(50, 16), (37, 32)])
def test_ssd_chunked_grads_match_jax(intra, length, chunk):
    """The gradients of sum(y * dy) + sum(state * ds) w.r.t. x, dt, a_log, b
    and c against jax.grad of the reference's ``ssd_chunked`` (ragged
    lengths: padded with dt = 0 steps, sliced back)."""
    args = _ssd_inputs(length + 7 * chunk, length=length)
    rng = np.random.default_rng(length)
    dy = rng.standard_normal(args[0].shape).astype(np.float32)
    ds = rng.standard_normal((args[0].shape[0], args[0].shape[2], args[3].shape[3], args[0].shape[3]))
    ds = ds.astype(np.float32)

    def j_loss(*a):
        y, h = jk.ssd_chunked(*a, chunk=chunk, return_state=True)
        return jnp.sum(y * dy) + jnp.sum(h * ds)

    want = jax.grad(j_loss, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, h = mamba_ssd.ssd_chunked(*ts, chunk=chunk, return_state=True, intra=intra)
    ((y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(ds)).sum()).backward()
    for name, t, w in zip(("x", "dt", "a_log", "b", "c"), ts, want):
        w = np.asarray(w)
        err = np.abs(t.grad.numpy() - w).max()
        assert err <= SSD_GRAD_REL * np.abs(w).max(), (intra, name, err, np.abs(w).max())


@pytest.mark.parametrize("spread", [1.0, 60.0])
def test_ssd_intra_backward_matches_autograd(spread):
    """``_SsdIntraChunk``'s backward against float32 autograd over the plain
    version (``where(tril, exp(cum_i - cum_j), 0) * cb @ xdt``); a steep
    cum underflows the decays below the diagonal and stays finite."""
    rng = np.random.default_rng(int(spread))
    t, q, p = 5, 32, 24
    cum = -np.cumsum(np.abs(rng.standard_normal((t, q))) * spread, axis=1).astype(np.float32)
    cb, xdt = (rng.standard_normal(s).astype(np.float32) * 0.5 for s in ((t, q, q), (t, q, p)))
    dy = torch.from_numpy(rng.standard_normal((t, q, p)).astype(np.float32))
    got = [torch.from_numpy(a).requires_grad_(True) for a in (cum, cb, xdt)]
    y = mamba_ssd.ssd_intra_chunk(*got)
    y.backward(dy)
    ref = [torch.from_numpy(a).requires_grad_(True) for a in (cum, cb, xdt)]
    tril = torch.ones((q, q), dtype=torch.bool).tril()
    # the difference masked before exp: the masked exp's gradient is 0, not 0 x inf
    decay = torch.exp(torch.where(tril, ref[0][:, :, None] - ref[0][:, None, :], float("-inf")))
    y_ref = torch.matmul(decay * ref[1], ref[2])
    y_ref.backward(dy)
    assert torch.equal(y.detach(), mamba_ssd.ssd_intra_chunk_plain(*(a.detach() for a in got)))
    for a, b in zip(got, ref):
        assert torch.isfinite(a.grad).all()
        assert (a.grad - b.grad).abs().max().item() <= 1e-5 * b.grad.abs().max().item()
    assert not got[1].grad.triu(1).any()  # cb above the diagonal takes no gradient


# ---- one Mamba layer: nn/mamba.apply_seq against the JAX block in shard_map --


@pytest.fixture(scope="module")
def layer():
    jcfg = j_reduce_config(j_get_config(ARCH))
    cfg = reduce_config(get_config(ARCH))
    jp = _seeded(_np(j_mamba.init(jax.random.PRNGKey(2), jcfg, TP, jnp.float32)))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, TP * 9, cfg.d_model)).astype(np.float32)  # S = 36: a ragged last chunk
    dy = rng.standard_normal(x.shape).astype(np.float32)
    mesh4 = make_mesh((TP,), ("model",))
    jpc = JContext(mesh=mesh4)
    specs = {k: jpc.manual(v) for k, v in j_mamba.specs(None, TP, None).items()}
    sm = jpc.smap(lambda p, xx: j_mamba.apply_seq(p, xx, jpc, jcfg), (specs, P(None, "model", None)),
                  P(None, "model", None))  # fmt: skip
    j_grads = jax.jit(jax.grad(lambda p, xx: jnp.sum(sm(p, xx) * dy), argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x)
    )
    return cfg, jp, x, dy, _np(j_grads)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_mamba_layer_grads_match_reference(layer, backend):
    """Every leaf's gradient (w_in: the rank's x | z and dt columns, its pad
    zero; the replicated w_bc and ln; conv, dt_bias, a_log, d_skip, w_out)
    and the input's, against jax.grad of the reference block."""
    cfg, jp, x, dy, (j_gp, j_gx) = layer
    world = World(TP, "cpu")
    params = {k: v.requires_grad_(True) for k, v in shard_mamba(_torch(jp), world).items()}
    xt = world.shard(torch.from_numpy(x), dim=1).requires_grad_(True)
    pc = ParallelContext(world=world, backend=backend)
    out = mamba.apply_seq(params, xt, pc, cfg)
    (out * world.shard(torch.from_numpy(dy), dim=1)).sum().backward()
    want = shard_mamba(_torch(j_gp), world)
    assert set(want) == set(params) == {"ln", "w_in", "w_bc", "conv", "w_out", "dt_bias", "a_log", "d_skip"}
    for name, p in params.items():
        ref = want[name]
        assert p.grad.shape == ref.shape and ref.abs().max().item() > 0, name
        assert (p.grad - ref).abs().max().item() <= GRAD_TOL["atol"] + GRAD_TOL["rtol"] * ref.abs().max().item(), name
    width = 2 * mamba._dims(cfg)[0] // TP + mamba._dims(cfg)[1] // TP
    assert not params["w_in"].grad[..., width:].any()  # the pad columns take no gradient
    gx = world.unshard(xt.grad, dim=1).numpy()
    assert np.abs(gx - j_gx).max() <= GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(j_gx).max()


def _torch(tree):
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in tree.items()}


# ---- reduced mamba2-2.7b: loss, gradients and a train step -----------------


@pytest.fixture(scope="module")
def model(pc8, mesh8):
    jcfg = dataclasses.replace(j_reduce_config(j_get_config(ARCH)), vocab_size=VOCAB)
    cfg = dataclasses.replace(reduce_config(get_config(ARCH)), vocab_size=VOCAB)
    np_params = _seeded(_np(jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32)))
    jparams = place(jax.tree_util.tree_map(jnp.asarray, np_params), mesh8, jlm.specs(jcfg, pc8))
    world = World(TP, "cpu")
    toks = np.random.default_rng(1).integers(0, VOCAB, size=(B, S)).astype(np.int32)
    batch = {"inputs": toks, "labels": np.roll(toks, -1, axis=1)}

    vg = j_value_and_grad(jlm, jcfg, pc8, remat_policy="dots")  # compiled once, shared with the step's test
    (loss, _), g = vg(jparams, batch)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=from_jax_params(np_params, cfg, world), world=world,
                batch=batch, j_loss=float(loss), j_grads=_port_tree(_np(g), cfg, world), vg=vg)  # fmt: skip


def assert_loss_and_grads(loss, grads, j_loss, j_grads):
    """The model-level bounds: the loss the logits' bound, each leaf's
    gradient 2e-3 of its max, and every leaf has one."""
    assert abs(loss - j_loss) <= LOGITS["atol"] + LOGITS["rtol"] * abs(j_loss)
    got, want = topt.tree_leaves(grads), topt.tree_leaves(j_grads)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        top = b.abs().max().item()
        assert top > 0, i
        assert (a - b).abs().max().item() <= GRAD_REL * top, (i, tuple(a.shape))


@pytest.mark.parametrize("backend,remat", [("eager", "none"), ("fused", "none"), ("fused", "dots")])
def test_mamba2_grads_match_reference(model, backend, remat):
    """The loss and every leaf's gradient (the tied embedding, the final norm,
    each layer's eight Mamba leaves) against jax.value_and_grad, with and
    without the layers recomputed in the backward."""
    pc = ParallelContext(world=model["world"], backend=backend)
    loss, _, _, grads = loss_and_grads(lm, model["cfg"], pc, model["params"], model["batch"], remat_policy=remat)
    assert len(topt.tree_leaves(grads)) == 2 + 8 * model["cfg"].n_layers
    assert_loss_and_grads(loss.item(), grads, model["j_loss"], model["j_grads"])


def test_mamba2_train_step_matches_reference(model, pc8):
    """One make_train_step step under remat "dots" (the reference trainer's
    policy) on the fused backend against the reference's (``make_train_step``'s
    body over the module's compiled gradients,
    ``test_torch_training.j_train_step``): the metrics and
    every updated leaf; weight decay 1.0 shows a leaf decayed on one side
    only (the scanned layers' one-dimensional leaves are decayed in the
    reference's layout)."""
    cfg, jcfg, world = model["cfg"], model["jcfg"], model["world"]
    opt_cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, eps=1e-4, weight_decay=1.0)
    jstep = j_train_step(model["vg"], jlm, jcfg, pc8, jopt.AdamWConfig(**opt_cfg), grad_masks=jlm.grad_masks(jcfg, pc8))
    pc = ParallelContext(world=world, backend="fused")
    step = make_train_step(lm, cfg, pc, AdamWConfig(**opt_cfg), remat_policy="dots", grad_masks=lm.grad_masks(cfg, pc))
    jp, jo, jm = jstep(model["jparams"], jopt.init_opt_state(model["jparams"]), model["batch"])
    p, o, m = step(model["params"], init_opt_state(lm.trainable(model["params"], cfg)), model["batch"])
    assert abs(m["loss"].item() - float(jm["loss"])) <= LOGITS["atol"] + LOGITS["rtol"] * abs(float(jm["loss"]))
    assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) <= GRAD_REL * float(jm["grad_norm"])
    _assert_trees_close(lm.trainable(p, cfg), _port_tree(_np(jp), cfg, world), 1e-5, 1e-4, "params")
    assert int(o["step"]) == 1


def test_check_trainable_takes_mamba_and_refuses_fuse_seams():
    world = World(TP, "cpu")
    for arch in (ARCH, "zamba2-2.7b"):
        cfg = reduce_config(get_config(arch))
        lm.check_trainable(cfg, ParallelContext(world=world))
        assert lm.grad_masks(cfg, ParallelContext(world=world))["layers"][0] is None  # a Mamba layer masks nothing
        lm.check_trainable(cfg, ParallelContext(world=world, fuse_seams=True))  # trains with seams too (zamba2's
        # shared block takes its intra-layer seam; tests/test_torch_seam_training.py holds seamed gradients)


def test_mamba2_restore_onto_another_world_size(tmp_path):
    """Saved at W = 4, restored at W = 2: ``w_in`` is stored as its
    reference halves (w_x, w_z, w_dt, the pad dropped), so each rank's x | z
    columns re-pack for W = 2 (the global w_xz differs) and the logits are
    equal."""
    cfg = dataclasses.replace(reduce_config(get_config(ARCH)), vocab_size=128)
    _restore_w4_at_w2(tmp_path, cfg, ("w_xz",))


def test_train_cli_trains_mamba2_with_remat_and_resumes(tmp_path):
    """``python -m repro_torch.launch.train --arch mamba2-2.7b --reduce
    --device cpu --remat dots``: 2 steps with a checkpoint, then one more
    resumed from it, bitwise the loss of an uninterrupted 3-step run."""
    from repro_torch.launch import train as train_cli

    args = ["--arch", ARCH, "--reduce", "--device", "cpu", "--remat", "dots", "--batch", "2", "--seq", "32",
            "--log-every", "1"]  # fmt: skip
    ref = train_cli.main(args + ["--steps", "3", "--no-resume"])
    train_cli.main(args + ["--steps", "2", "--ckpt-dir", str(tmp_path)])
    resumed = train_cli.main(args + ["--steps", "3", "--ckpt-dir", str(tmp_path)])
    assert [r["step"] for r in resumed["history"]] == [2]
    assert resumed["history"][0]["loss"] == ref["history"][2]["loss"]
