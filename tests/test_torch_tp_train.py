"""Training over the TP world of processes, on the CPU with gloo.

One module-scoped spawn of P = 2 processes (``launch/serve.run_tp``), each
holding 2 of W = 4 ranks, eager backend, float32, reduced smollm-360m (2
layers, vocab 128, norm gains drawn from a numpy seed so that weight decay
and the norms' gradients act from the first step).  The one-process World
(P = 1) runs the same in the parent, and the JAX reference's
``make_train_step`` runs on the model axis (4 ranks) of ``mesh8``, compiled
with ``test_torch_training``'s ``j_compiled`` / ``J_COMPILE``.  The worker
is a module-level function so the processes can import it, and the module
imports JAX only inside the fixture, so a process does not.

Held:
  * the gradient of every ``World`` collective over processes (permutes
    that cross the processes, a partial permute, psum, all_gather,
    reduce_scatter, shard, unshard) equal to the one-process World's,
    bitwise (``all_gather``'s adjoint, a reduce-scatter, within ``RS_TOL``);
  * one step's gradients (``training.steps.tp_procs_grads``): the loss
    bitwise P = 1's, every gradient within ``RS_TOL`` of P = 1's held slice
    (after the kv sync and the masks), the gradient norm within
    ``RS_TOL``, and the replicated leaves bitwise equal on both processes;
  * three ``make_train_step`` steps at ``STEP_OPT`` in both modes: the
    metrics equal on both processes, parameters and moments within
    ``RS_TOL`` of P = 1's, and within ``test_train_steps_match_reference``'s
    bounds of the reference's (metrics 1e-5 relative; trees 1e-5 + 1e-4 of
    each leaf's max);
  * ``lm.sync_grads`` with one kv head at W = 4 (its copies on both
    processes) bitwise P = 1's on the same gradients;
  * a checkpoint saved at P = 2, restored at P = 2 and at P = 1: the next
    step's loss bitwise the uninterrupted run's;
  * ``launch/train --procs 2`` printing the losses of ``--procs 1`` within
    ``RS_TOL``;
  * the peer route's plain replay of ``return_gathered`` (``split=True``)
    bitwise the one-allocation replay's, the gathered operand of call 1
    unchanged after call 2 on the same pool.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.backend.mesh import World
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import HELD_LEAVES, from_jax_params
from repro_torch.core.channels import BlockChannel, CommSpec
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training.optimizer import apply_masks, global_norm, tree_leaves
from repro_torch.training.steps import loss_and_grads, tp_procs_grads
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

W, P = 4, 2
HELD = W // P
VOCAB, B, S = 128, 2, 16
STEPS = 3
RS_TOL = 1e-5  # atol and rtol: a sum over processes vs the one-process World's sum over every rank (f32)
REF_TOL = (1e-5, 1e-4)  # trees against the reference: atol, rtol of each leaf's max (test_torch_training)
MODES = ("overlap", "baseline")
COLLECTIVES = ("permute ring", "permute swap", "permute partial", "psum", "all_gather 0", "all_gather 1",
               "reduce_scatter 0", "unshard 1", "shard 1")  # fmt: skip
PAIRS = {"ring": [(r, (r + 1) % W) for r in range(W)], "swap": [(0, 2), (2, 0), (1, 3), (3, 1)],
         "partial": [(1, 0), (3, 2)]}  # fmt: skip


def _cfg(**kw):
    return dataclasses.replace(reduce_config(get_config("smollm-360m")), vocab_size=VOCAB, **kw)


def _collective(world: World, name: str, x: torch.Tensor) -> torch.Tensor:
    op, arg = name.split(" ") if " " in name else (name, None)
    if op == "permute":
        return world.permute(x, PAIRS[arg])
    if op == "psum":
        return world.psum(x)
    return getattr(world, op)(x, int(arg))


def _collective_grads(world: World, job: dict) -> dict:
    """The gradient of each collective at its input, under the cotangent
    ``job["cot"][name]`` (its held ranks' slice where the output is
    rank-stacked, whole where every process holds it whole)."""
    lo, hi = world.rank0, world.rank0 + world.held
    out = {}
    for name in COLLECTIVES:
        whole_in = name.startswith("shard")
        x = torch.from_numpy(job["glob"] if whole_in else job["xs"][lo:hi]).clone().requires_grad_(True)
        y = _collective(world, name, x)
        cot = torch.from_numpy(job["cot"][name])
        cot = cot if name in ("psum", "unshard 1") else cot[lo:hi]
        out[name] = torch.autograd.grad(y, x, grad_outputs=cot)[0]
    return out


def _params(job: dict, world: World):
    return from_jax_params(job["np_params"], job["cfg"], world)


def _pc(world: World, mode: str = "overlap") -> ParallelContext:
    return ParallelContext(world=world, backend="eager", mode=mode)


def _grads(world: World, job: dict) -> dict:
    """One step's loss, gradients (after the kv sync and the masks) and norm."""
    cfg, pc = job["cfg"], _pc(world)
    params, batch, masks = _params(job, world), job["batches"][0], lm.grad_masks(cfg, pc)
    if world.nprocs > 1:
        loss, _, _, grads, gnorm = tp_procs_grads(lm, cfg, pc, params, batch, grad_masks=masks)
    else:
        loss, _, _, grads = loss_and_grads(lm, cfg, pc, params, batch)
        grads = apply_masks(lm.sync_grads(grads, cfg, pc), masks)
        gnorm = global_norm(grads)
    return {"loss": loss, "grads": grads, "gnorm": gnorm}


def _train(world: World, job: dict, mode: str, ckpt=None) -> dict:
    """``STEPS`` steps of ``make_train_step`` at ``job["opt"]``: every
    step's metrics, the trainable parameters and the moments after them;
    with ``ckpt`` (overlap), the state saved there after the last step and
    the next step's loss uninterrupted."""
    cfg, pc = job["cfg"], _pc(world, mode)
    step = make_train_step(lm, cfg, pc, AdamWConfig(**job["opt"]), grad_masks=lm.grad_masks(cfg, pc))
    params = _params(job, world)
    opt = init_opt_state(lm.trainable(params, cfg))
    metrics = []
    for batch in job["batches"][:STEPS]:
        params, opt, m = step(params, opt, batch)
        metrics.append({k: v.detach().clone() for k, v in m.items()})
    out = {"metrics": metrics, "params": lm.trainable(params, cfg), "opt": opt}
    if ckpt is not None:
        mgr = CheckpointManager(ckpt)
        mgr.save(STEPS, params, opt, cfg=cfg, world=world)
        mgr.wait()
        world.procs.barrier()  # process 0 has written it
        out["next_loss"] = step(params, opt, job["batches"][STEPS])[2]["loss"]
        out["restored_loss"] = _restored_loss(world, job, ckpt)
    return out


def _restored_loss(world: World, job: dict, ckpt: str) -> torch.Tensor:
    """The loss of the step after the checkpoint, from its state restored onto ``world``."""
    cfg, pc = job["cfg"], _pc(world)
    params = _params(job, world)
    like = {"params": params, "opt": init_opt_state(lm.trainable(params, cfg))}
    restored, meta = CheckpointManager(ckpt).restore(STEPS, like, cfg=cfg, world=world)
    assert meta["step"] == STEPS
    step = make_train_step(lm, cfg, pc, AdamWConfig(**job["opt"]), grad_masks=lm.grad_masks(cfg, pc))
    return step(restored["params"], restored["opt"], job["batches"][STEPS])[2]["loss"]


def _held_grads(grads: dict, p: int) -> dict:
    """A one-process tree's slices of process ``p``'s held ranks."""
    lo, hi = p * HELD, (p + 1) * HELD
    layers = [{part: {k: (v[lo:hi] if k in HELD_LEAVES[part] else v) for k, v in sub.items()}
               for part, sub in layer.items()} for layer in grads["layers"]]  # fmt: skip
    return {**grads, "layers": layers}


def _sync_kv1(world: World, job: dict) -> dict:
    """``lm.sync_grads`` of one kv head at W = 4 on the one-process gradients
    ``job["kv1_grads"]`` (this process's slices)."""
    cfg = _cfg(n_kv_heads=1)
    return lm.sync_grads(_held_grads(job["kv1_grads"], world.procs.rank), cfg, _pc(world))


def _worker(world: World, job: dict) -> dict:
    """This process's part of every check."""
    return {
        "rank0": world.rank0, "collectives": _collective_grads(world, job), "grads": _grads(world, job),
        "train": {m: _train(world, job, m, ckpt=job["ckpt"] if m == "overlap" else None) for m in MODES},
        "kv1": _sync_kv1(world, job),
    }  # fmt: skip


@pytest.fixture(scope="module")
def tp(pc8, mesh8, tmp_path_factory):
    """The job, the reference's steps, the one-process World's results and
    what the two processes made of them (one spawn)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.models import lm as jlm
    from repro.parallel.sharding import place
    from repro.training import optimizer as jopt
    from repro.training import steps as jsteps
    from repro_torch.data import SyntheticLM
    from test_torch_training import STEP_OPT, _with_gains, j_compiled
    from utils import reduce_config as j_reduce_config

    rng = np.random.default_rng(17)
    jcfg = dataclasses.replace(j_reduce_config(j_get_config("smollm-360m")), vocab_size=VOCAB)
    np_params = _with_gains(jax.tree_util.tree_map(np.asarray, jlm.init(jax.random.PRNGKey(3), jcfg, pc8,
                                                                         jnp.float32)))  # fmt: skip
    pipe = SyntheticLM(vocab_size=VOCAB, seq_len=S, global_batch=B, seed=2)
    job = {
        "cfg": _cfg(), "np_params": np_params, "opt": STEP_OPT,
        "batches": [pipe.host_batch() for _ in range(STEPS + 1)],
        "xs": rng.standard_normal((W, 8, 6)).astype(np.float32),
        "glob": rng.standard_normal((3, 8, 5)).astype(np.float32),
        "ckpt": str(tmp_path_factory.mktemp("tp_ckpt")),
    }  # fmt: skip
    one = World(W, "cpu")
    job["cot"] = {}
    for name in COLLECTIVES:  # a cotangent of each output's every-rank shape
        x = torch.from_numpy(job["glob"] if name.startswith("shard") else job["xs"])
        job["cot"][name] = rng.standard_normal(tuple(_collective(one, name, x).shape)).astype(np.float32)
    kv1 = _cfg(n_kv_heads=1)
    kv1_params = lm.init(kv1, one, torch.Generator().manual_seed(4), torch.float32)
    job["kv1_grads"] = loss_and_grads(lm, kv1, _pc(one), kv1_params, job["batches"][0])[3]
    # the reference: make_train_step on the model axis of mesh8
    jparams = place(jax.tree_util.tree_map(jnp.asarray, np_params), mesh8, jlm.specs(jcfg, pc8))
    jstep = j_compiled(jsteps.make_train_step(jlm, jcfg, pc8, jopt.AdamWConfig(**STEP_OPT),
                                              grad_masks=jlm.grad_masks(jcfg, pc8), donate=False))  # fmt: skip
    jp, jo, jm = jparams, jopt.init_opt_state(jparams), []
    for batch in job["batches"][:STEPS]:
        jp, jo, m = jstep(jp, jo, batch)
        jm.append({k: float(v) for k, v in m.items()})
    ref = {"metrics": jm, "params": _port(jp, job["cfg"], one),
           "opt": {k: _port(jo[k], job["cfg"], one) for k in ("mu", "nu")}}  # fmt: skip
    p1 = {
        "collectives": _collective_grads(one, job), "grads": _grads(one, job),
        "train": {m: _train(one, job, m) for m in MODES}, "kv1": lm.sync_grads(job["kv1_grads"], kv1, _pc(one)),
    }  # fmt: skip
    got = serve.run_tp(_worker, W, P, "cpu", args=(job,))
    p1["restored_loss"] = _restored_loss(one, job, job["ckpt"])
    return {"job": job, "ref": ref, "p1": p1, "got": got}


def _port(np_tree, cfg, world: World) -> dict:
    """A JAX-layout tree (parameters or moments) in the port's trainable layout."""
    import jax

    return lm.trainable(from_jax_params(jax.tree_util.tree_map(np.asarray, np_tree), cfg, world), cfg)


def _pairs(got: dict, want: dict, p: int):
    """(process p's leaf, the one-process leaf's slice of p's ranks) over a trainable tree."""
    return list(zip(tree_leaves(got), tree_leaves(_held_grads(want, p))))


def _close(a: torch.Tensor, b: torch.Tensor, atol: float, rtol: float) -> bool:
    return bool(((a.float() - b.float()).abs() <= atol + rtol * b.float().abs().max()).all())


# ---- the collectives' adjoints ----------------------------------------------------------------------------------


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_gradients_equal_the_one_process_world(tp, name):
    want = tp["p1"]["collectives"][name]
    for p, got in enumerate(tp["got"]):
        g = got["collectives"][name]
        ref = want if name.startswith("shard") else want[p * HELD : (p + 1) * HELD]
        if name.startswith("all_gather"):  # its adjoint sums every rank's copy over the processes: a reduce-scatter
            assert torch.allclose(g, ref, rtol=RS_TOL, atol=RS_TOL), (p, name)
        else:
            assert torch.equal(g, ref), (p, name)


# ---- one step's gradients ---------------------------------------------------------------------------------------


def test_step_gradients_equal_p1(tp):
    want = tp["p1"]["grads"]
    for p, got in enumerate(tp["got"]):
        g = got["grads"]
        assert torch.equal(g["loss"], want["loss"]), p
        assert torch.allclose(g["gnorm"], want["gnorm"], rtol=RS_TOL, atol=RS_TOL), p
        for i, (a, b) in enumerate(_pairs(g["grads"], want["grads"], p)):
            assert a.shape == b.shape and torch.allclose(a, b, rtol=RS_TOL, atol=RS_TOL), (p, i)


def test_replicated_gradients_are_equal_on_every_process(tp):
    cfg = tp["job"]["cfg"]
    trees = [g["grads"]["grads"] for g in tp["got"]]
    roles = tree_leaves(lm.proc_roles(trees[0], cfg))
    assert {"held", "summed", "whole"} <= set(roles)
    for role, *leaves in zip(roles, *(tree_leaves(t) for t in trees)):
        if role != "held":
            assert all(torch.equal(leaf, leaves[0]) for leaf in leaves), role
    assert torch.equal(tp["got"][0]["grads"]["gnorm"], tp["got"][1]["grads"]["gnorm"])


# ---- three train steps -------------------------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_train_metrics_are_equal_on_every_process(tp, mode):
    ms = [g["train"][mode]["metrics"] for g in tp["got"]]
    for step in zip(*ms):
        assert all(set(m) == set(step[0]) and all(torch.equal(m[k], step[0][k]) for k in m) for m in step)


@pytest.mark.parametrize("mode", MODES)
def test_train_steps_equal_p1(tp, mode):
    want = tp["p1"]["train"][mode]
    for p, got in enumerate(tp["got"]):
        run = got["train"][mode]
        for m, w in zip(run["metrics"], want["metrics"]):
            for k in ("loss", "ce", "grad_norm", "lr"):
                assert torch.allclose(m[k], w[k], rtol=RS_TOL, atol=RS_TOL), (p, k)
        for tree in ("params", "mu", "nu"):
            a, b = (run["params"], want["params"]) if tree == "params" else (run["opt"][tree], want["opt"][tree])
            for i, (x, y) in enumerate(_pairs(a, b, p)):
                assert x.shape == y.shape and torch.allclose(x, y, rtol=RS_TOL, atol=RS_TOL), (p, tree, i)
        assert int(run["opt"]["step"]) == STEPS


@pytest.mark.parametrize("mode", MODES)
def test_train_steps_match_the_reference(tp, mode):
    """Within ``test_train_steps_match_reference``'s bounds of the JAX
    package's ``make_train_step``: metrics 1e-5 relative (lr 1e-7), each
    tree leaf 1e-5 + 1e-4 of its max."""
    ref = tp["ref"]
    for p, got in enumerate(tp["got"]):
        run = got["train"][mode]
        for m, jm in zip(run["metrics"], ref["metrics"]):
            for k in ("loss", "ce", "grad_norm"):
                assert abs(m[k].item() - jm[k]) <= 1e-5 * abs(jm[k]), (p, k)
            assert abs(m["lr"].item() - jm["lr"]) <= 1e-7 * jm["lr"]
        for tree in ("params", "mu", "nu"):
            a, b = (run["params"], ref["params"]) if tree == "params" else (run["opt"][tree], ref["opt"][tree])
            for i, (x, y) in enumerate(_pairs(a, b, p)):
                assert x.shape == y.shape and _close(x, y, *REF_TOL), (p, tree, i)


# ---- the kv copies, the checkpoint, the CLI ---------------------------------------------------------------------


def test_sync_grads_one_kv_head_over_processes(tp):
    """One kv head at W = 4: its four copies on both processes, averaged
    bitwise as on one process (and equal to each other)."""
    cfg = _cfg(n_kv_heads=1)
    want = tp["p1"]["kv1"]
    nq = 2 * cfg.hd  # h_loc = 2 query heads a rank
    for p, got in enumerate(tp["got"]):
        for i, (a, b) in enumerate(_pairs(got["kv1"], want, p)):
            assert torch.equal(a, b), (p, i)
    kv = [g["kv1"]["layers"][0]["mixer"]["wqkv"][..., nq:] for g in tp["got"]]
    raw = tp["job"]["kv1_grads"]["layers"][0]["mixer"]["wqkv"][..., nq:]
    assert torch.equal(kv[0][0], kv[1][1]) and not torch.equal(raw[0], raw[3])


def test_checkpoint_saved_at_p2_resumes_at_p1_and_p2_bitwise(tp):
    want = tp["got"][0]["train"]["overlap"]["next_loss"]
    for got in tp["got"]:
        assert torch.equal(got["train"]["overlap"]["next_loss"], want)
        assert torch.equal(got["train"]["overlap"]["restored_loss"], want)
    assert torch.equal(tp["p1"]["restored_loss"], want)


def test_train_cli_procs_2_prints_the_losses_of_procs_1(capfd):
    kw = dict(reduce=True, layers=2, device="cpu", dtype="f32", steps=2, batch=2, seq=16, world=W, log_every=1)
    one = train_cli.train("smollm-360m", **kw)
    two = train_cli.train("smollm-360m", procs=P, **kw)
    a, b = ([r["loss"] for r in o["history"]] for o in (one, two))
    assert len(a) == len(b) == 2 and np.allclose(b, a, rtol=RS_TOL, atol=RS_TOL), (a, b)
    assert [p["device"] for p in two["processes"]] == ["cpu", "cpu"]
    out = capfd.readouterr().out
    assert "over 2 processes (2 a process), torch.distributed gloo" in out
    assert out.count("step 1: loss=") == 2  # once by the one-process run, once by process 0


# ---- the peer route's gathered operand --------------------------------------------------------------------------

ORDERS = ("ring", "bidir_ring", "all2all")


@pytest.mark.parametrize("order,nch", [(o, c) for o in ORDERS for c in (1, 2)])
def test_peer_replay_return_gathered_outlives_the_next_call(order, nch):
    """``return_gathered`` on the split pool: out and gathered bitwise the
    one-allocation replay's, and call 1's gathered operand unchanged after
    call 2 (other operands, the same pool) overwrote the slots."""
    rng = np.random.default_rng(5)
    x1, x2 = (torch.from_numpy(rng.standard_normal((W, 2, 8, 16)).astype(np.float32)) for _ in range(2))
    w = torch.from_numpy(rng.standard_normal((W, 16, 24)).astype(np.float32))
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    out1, g1 = K.ag_gemm(x1, w, channel=ch, return_gathered=True, split=True)
    kept = g1.clone()
    out2, g2 = K.ag_gemm(x2, w, channel=ch, return_gathered=True, split=True)
    for x, out, g in ((x1, out1, g1), (x2, out2, g2)):
        one_out, one_g = K.ag_gemm(x, w, channel=ch, return_gathered=True)
        assert torch.equal(out, one_out) and torch.equal(g, one_g)
        rows = x.transpose(0, 1).reshape(2, W * 8, 16)  # every rank's rows of each batch row, rank-major
        assert torch.equal(g, rows.expand(W, -1, -1, -1))
    assert torch.equal(g1, kept) and not torch.equal(g1, g2)
