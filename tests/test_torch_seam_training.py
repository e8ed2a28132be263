"""Training with fused RS -> AG seams: the port against the JAX package, on the CPU.

Two reduced smollm-360m variants (d_model 128, 8 / 4 heads of 16, vocab
256, W = 4): "period1", the config's own pattern at 2 layers (each scan
unit one layer: every seam intra-layer), and "period2", the pattern
``("attn", "attn")`` at 3 layers (one unit of two layers, whose chain has
an inter-layer seam, then a one-layer suffix).  Weights from the JAX
``lm.init`` with numpy-seeded norm gains, through ``convert.from_jax_params``;
float32 throughout.  The reference's loss and gradients are
``jax.value_and_grad`` of its ``forward`` on ``ParallelContext(fuse_seams=
True)``, compiled with ``test_torch_training.J_COMPILE``.

Tolerances: the loss 1e-5 relative; each gradient leaf 2e-3 of the
reference leaf's max |.| (the seam's float ops are the unfused pair's:
summation order only, observed ~1.5e-6); remat against none bitwise (the
recompute runs the same float ops); one seamed AdamW step against the
unfused step 1e-5 + 1e-4 |unfused|.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import lm as jlm
from repro.parallel.context import ParallelContext as JContext
from repro.parallel.sharding import place
from repro_torch.backend.mesh import World
from repro_torch.benchmarks import paper_e2e
from repro_torch.convert import from_jax_params
from repro_torch.core import overlap
from repro_torch.data import SyntheticLM
from repro_torch.models import lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training import optimizer as topt
from repro_torch.training.steps import loss_and_grads
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from test_torch_training import _cfgs, _np, _port_tree, _with_gains, j_value_and_grad

pytestmark = pytest.mark.usefixtures("torch_threads")

TP, B, S = 4, 4, 32
GRAD_RTOL = 2e-3
VARIANTS = {"period1": (("attn",), 2), "period2": (("attn", "attn"), 3)}
# seams fused by one forward: each layer's intra-layer seam, plus an inter-layer seam between consecutive
# layers of one segment (period2: the unit's two layers); under remat the units' chains run again
SEAMS = {"period1": (2, 4), "period2": (4, 7)}  # (forward, forward + the units' recompute)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model(request, mesh8):
    pattern, n_layers = VARIANTS[request.param]
    jcfg, cfg = _cfgs(4, n_layers=n_layers, pattern=pattern)
    jpc = JContext(mesh=mesh8, mode="overlap")
    np_params = _with_gains(_np(jlm.init(jax.random.PRNGKey(0), jcfg, jpc, jnp.float32)))
    jparams = place(jax.tree_util.tree_map(jnp.asarray, np_params), mesh8, jlm.specs(jcfg, jpc))
    world = World(TP, "cpu")
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=1).host_batch()
    (j_loss, _), j_grads = j_value_and_grad(jlm, jcfg, dataclasses.replace(jpc, fuse_seams=True))(jparams, batch)
    return dict(name=request.param, cfg=cfg, world=world, batch=batch, params=from_jax_params(np_params, cfg, world),
                j_loss=float(j_loss), j_grads=_port_tree(_np(j_grads), cfg, world))  # fmt: skip


def _seamed(model, backend="eager", remat="none"):
    pc = ParallelContext(world=model["world"], backend=backend, fuse_seams=True)
    overlap.matmul_rs_ag.calls = 0
    loss, _, _, grads = loss_and_grads(lm, model["cfg"], pc, model["params"], model["batch"], remat_policy=remat)
    return loss, grads, overlap.matmul_rs_ag.calls


def _leaves(tree):
    return topt.tree_leaves(tree)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_seamed_grads_match_reference(model, backend):
    """The seamed forward's loss and every leaf's gradient against the
    reference's value_and_grad on its seamed forward."""
    loss, grads, seams = _seamed(model, backend)
    assert seams == SEAMS[model["name"]][0]
    assert abs(loss.item() - model["j_loss"]) <= 1e-5 * abs(model["j_loss"])
    got, ref = _leaves(grads), _leaves(model["j_grads"])
    assert len(got) == len(ref) == 3 + 6 * model["cfg"].n_layers - 1  # the tied head is the embedding
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        assert (a - b).abs().max().item() <= GRAD_RTOL * b.abs().max().item(), i


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_seamed_remat_matches_none(model, remat):
    """Remat with seams recomputes each scan unit's chain (not the prefix or
    the suffix): the same loss and gradients, bitwise, as without."""
    loss0, grads0, _ = _seamed(model)
    loss, grads, seams = _seamed(model, remat=remat)
    assert seams == SEAMS[model["name"]][1]
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(grads), _leaves(grads0)))


def test_seamed_train_step_matches_unfused(model):
    """make_train_step with fused seams builds and steps: its parameters after
    one AdamW step against the unfused step's, on the fused backend."""
    cfg, world = model["cfg"], model["world"]
    out = {}
    for seams in (True, False):
        pc = ParallelContext(world=world, backend="fused", fuse_seams=seams)
        step = make_train_step(lm, cfg, pc, AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=3),
                               grad_masks=lm.grad_masks(cfg, pc))  # fmt: skip
        params, _, metrics = step(model["params"], init_opt_state(lm.trainable(model["params"], cfg)), model["batch"])
        out[seams] = (params, metrics)
    assert abs(out[True][1]["loss"].item() - out[False][1]["loss"].item()) <= 1e-5 * out[False][1]["loss"].item()
    for a, b in zip(_leaves(out[True][0]), _leaves(out[False][0])):
        assert (a - b).abs().max().item() <= 1e-5 + 1e-4 * b.abs().max().item()


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_expected_launches_count_the_chains(model, remat, monkeypatch):
    """``paper_e2e.expected_launches(..., fuse_seams=True)``'s AG+GEMM and
    GEMM+RS counts are the fused collectives one seamed train step calls
    (here their plain versions, which the wrappers run on the CPU)."""
    calls = {"ag_gemm": 0, "gemm_rs": 0}
    for name in calls:
        mod = sys.modules[f"repro_torch.kernels.{name}"]
        plain = getattr(mod, f"{name}_plain")

        def counted(*a, _plain=plain, _name=name, **kw):
            calls[_name] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(mod, f"{name}_plain", counted)
    _seamed(model, "fused", remat)
    expect = paper_e2e.expected_launches(model["cfg"], "overlap", remat, fuse_seams=True)
    assert calls == {k: expect[k] for k in calls}
