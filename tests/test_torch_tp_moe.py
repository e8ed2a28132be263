"""MoE over the TP world of processes, on the CPU with gloo.

One module-scoped spawn of P = 2 processes (``launch/serve.run_tp``), each
holding 2 of W = 4 ranks, float32; the one-process World (P = 1) runs the
same in the parent, and the JAX reference on the model axis (4 ranks) of
``mesh8``, its train steps compiled with ``test_torch_training``'s
``j_compiled`` (``J_COMPILE``).  Reduced granite-moe-3b-a800m (2 MoE
layers) and deepseek-moe-16b (a dense first layer, then MoE layers with 2
shared experts), vocab 128, weights from the JAX ``init`` with norm gains
from a numpy seed (``test_torch_moe_training``'s reduced configs,
``_cfgs``).  The worker is a module-level function so the processes can
import it; the processes never import JAX.

Held:
  * ``ag_moe`` and ``a2a_moe`` (the eager executor and the fused backend,
    whose grouped GEMM runs its plain version here) over C = 1, 2 at
    capacity factors 1.25 and 0.25: bitwise P = 1's held slice, and the
    kept (token, k) sets of every dispatch table built equal to P = 1's;
    their baselines (an all-gather of the origins, a reduce-scatter home)
    within ``RS_TOL`` with the same kept sets; at 0.25 tokens really drop;
  * the lazy permute (``World.permute_start``): an ``ag_matmul`` ring's
    exchange for step s + 1 issued before step s's compute and waited on
    after it, and every ring step's expert GEMMs of ``ag_moe`` / ``a2a_moe``
    run with a transfer in flight;
  * prefill logits in TP and EP, overlap and baseline: bitwise P = 1's in
    overlap mode, within ``RS_TOL`` in baseline mode, and within
    ``tests/test_serving.py``'s bound of the reference's prefill (TP; EP for
    deepseek);
  * each process stores its held ranks' leaves only (storage of their own
    size);
  * greedy tokens, with the gathered and the streamed MoE decode, equal to
    the reference's per-token greedy decoding;
  * deepseek's step gradients (``training.steps.tp_procs_grads``) in TP and
    EP within ``RS_TOL`` of P = 1's held slices: the router, the MoE
    ``ln`` and the shared experts' MLP among them;
  * three granite ``make_train_step`` steps in TP and EP against P = 1
    (``RS_TOL``) and against the reference's ``make_train_step``
    (``test_train_steps_match_reference``'s bounds);
  * a granite and a deepseek checkpoint saved at P = 2, restored at P = 1
    and at P = 2: the next step's loss bitwise the uninterrupted run's;
  * what ``launch/train --procs 2`` and ``launch/serve --procs 2`` (the
    streamed decode in overlap mode, the gathered one in baseline mode) run
    in each process (``train_tp`` / ``serve_tp``) on granite: process 0's
    losses and every process's tokens those of ``--procs 1``.

The JAX references compile while the processes run (the spawn waits in a
thread of the parent).
"""

import contextlib
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.backend.mesh import World
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import HELD_LEAVES, from_jax_params
from repro_torch.core import moe_overlap
from repro_torch.core import overlap as ov
from repro_torch.core.channels import BlockChannel
from repro_torch.core.compiler import compile_overlap
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
GRANITE, DEEPSEEK = "granite-moe-3b-a800m", "deepseek-moe-16b"
ARCHS = (GRANITE, DEEPSEEK)
VOCAB, B, S, NEW = 128, 2, 16, 4
STEPS = 3
LOGIT_ATOL = LOGIT_RTOL = 2e-3  # tests/test_serving.py's bound
RS_TOL = 1e-5  # atol and rtol: a sum over processes vs the one-process World's sum over every rank (f32)
REF_TOL = (1e-5, 1e-4)  # trees against the reference: atol, rtol of each leaf's max (test_torch_training)
EP = {"tp": None, "ep": "model"}
MODES = ("overlap", "baseline")
# the executors: (kind, backend, capacity factor, C); the baselines (kind, capacity factor, C)
OPS = [(k, b, cf, c) for k in ("ag_moe", "a2a_moe") for b in ("eager", "fused") for cf in (1.25, 0.25) for c in (1, 2)]
BASES = [("ag_moe", cf, 1) for cf in (1.25, 0.25)] + [("a2a_moe", cf, c) for cf in (1.25, 0.25) for c in (1, 2)]
M_LOC, D, E, K_TOP, F = 64, 16, 8, 2, 12  # the executors' operands: x [W, 2, M_LOC, D], E experts top-K, width F


def _cfg(arch: str):
    return dataclasses.replace(reduce_config(get_config(arch)), vocab_size=VOCAB)


@contextlib.contextmanager
def _kept():
    """Record the kept (token, k) pairs of every dispatch table built
    (``core/moe_overlap._dispatch_tables``), in build order."""
    calls, tables = [], moe_overlap._dispatch_tables

    def recording(*a, **kw):
        out = tables(*a, **kw)
        calls.append(out.sum((-2, -1)) > 0)  # [ranks, lead, m, k]
        return out

    moe_overlap._dispatch_tables = recording
    try:
        yield calls
    finally:
        moe_overlap._dispatch_tables = tables


def _op(world: World, case, args):
    """One executor case (``OPS`` or, with three entries, ``BASES``): the
    output and the kept sets of its dispatch tables."""
    kind, backend, cf, nch = case if len(case) == 4 else (case[0], "eager", case[1], case[2])
    ch = BlockChannel(axis="model", num_channels=nch)
    kinds = "ag_moe" if kind == "ag_moe" else ["a2a_dispatch", "combine_rs"]
    fn = compile_overlap(kinds, ch, world=world, backend=backend, overlapped=len(case) == 4)
    with _kept() as calls:
        out = fn(*args, capacity_factor=cf)
    return {"out": out, "kept": calls}


def _ops(world: World, job: dict) -> dict:
    lo, hi = world.rank0, world.rank0 + world.held
    args = [torch.from_numpy(a)[lo:hi].clone() for a in job["ops"]]
    return {case: _op(world, case, args) for case in OPS + BASES}


def _lazy(world: World, job: dict) -> dict:
    """The order of an ``ag_matmul`` ring's exchanges, waits and computes
    over the processes, and the transfers in flight at each expert GEMM of
    ``ag_moe`` / ``a2a_moe`` (its first operand's call)."""
    procs, log, flight = world.procs, [], [0]
    exchange = procs.exchange

    class Logged:  # one batch's works, waited on together
        def __init__(self, works, n):
            self.works, self.n = works, n

        def wait(self):
            log.append(f"land {self.n}")
            flight[0] -= 1
            for work in self.works:
                work.wait()

    def logged(sends, recvs, wait=True):
        works = exchange(sends, recvs, wait=wait)
        if wait or not works:
            return works
        n = sum(e.startswith("issue") for e in log)
        log.append(f"issue {n}")
        flight[0] += 1
        return [Logged(works, n)]

    procs.exchange = logged
    try:
        lo, hi = world.rank0, world.rank0 + world.held
        x, w = (torch.from_numpy(a)[lo:hi].clone() for a in job["ag"])
        plan = ov.plan_for("ag_matmul", BlockChannel(axis="model"), W, x.shape[-2])

        def tile_fn(ctx, tile, carry):
            log.append(f"compute {ctx.step}")
            return carry + [tile @ w]

        ov.run_plan(plan, world, tile_fn, state=[x], carry=[])
        ring = list(log)
        args = [torch.from_numpy(a)[lo:hi].clone() for a in job["ops"]]
        in_flight = {}
        ffn = moe_overlap.local_expert_ffn
        for kind in ("ag_moe", "a2a_moe"):
            seen = in_flight[kind] = []
            moe_overlap.local_expert_ffn = lambda *a, _f=ffn, _s=seen, **kw: (_s.append(flight[0]), _f(*a, **kw))[1]
            try:
                _op(world, (kind, "eager", 1.25, 1), args)
            finally:
                moe_overlap.local_expert_ffn = ffn
    finally:
        procs.exchange = exchange
    return {"ring": ring, "in_flight": in_flight}


def _pc(world: World, mode: str = "overlap", ep=None, stream: bool = False) -> ParallelContext:
    return ParallelContext(world=world, backend="eager", mode=mode, ep_axis=ep, moe_decode_stream=stream)


def _serve_model(world: World, job: dict, arch: str) -> dict:
    """Prefill logits (TP / EP x overlap / baseline) and greedy tokens (the
    gathered and the streamed decode) of ``arch``."""
    cfg, params = job["cfgs"][arch], from_jax_params(job["np_params"][arch], job["cfgs"][arch], world)
    prompts = torch.as_tensor(job["tokens"])
    held = [leaf for leaf, role in zip(tree_leaves(params), tree_leaves(lm.proc_roles(params, cfg))) if role == "held"]
    out = {"logits": {}, "greedy": {}, "held_storage": [(t.shape[0], t.untyped_storage().nbytes() // t.element_size(),
                                                        t.numel()) for t in held]}  # fmt: skip
    with torch.no_grad():
        for ep in EP:
            for mode in MODES:
                out["logits"][(ep, mode)] = lm.prefill(params, cfg, _pc(world, mode, EP[ep]), prompts, max_len=S + NEW)[0]
        for stream in (False, True):
            out["greedy"][stream] = serve.greedy(params, cfg, _pc(world, stream=stream), prompts, NEW)[0]
    return out


def _grads(world: World, job: dict, ep) -> dict:
    """deepseek's step: loss, gradients (after the kv sync and the masks) and norm."""
    cfg, pc = job["cfgs"][DEEPSEEK], _pc(world, ep=ep)
    params, batch, masks = from_jax_params(job["np_params"][DEEPSEEK], cfg, world), job["batches"][0], None
    masks = lm.grad_masks(cfg, pc)
    if world.nprocs > 1:
        loss, _, _, grads, gnorm = tp_procs_grads(lm, cfg, pc, params, batch, grad_masks=masks)
    else:
        loss, _, _, grads = loss_and_grads(lm, cfg, pc, params, batch)
        grads = apply_masks(lm.sync_grads(grads, cfg, pc), masks)
        gnorm = global_norm(grads)
    return {"loss": loss, "grads": grads, "gnorm": gnorm}


def _train(world: World, job: dict, arch: str, ep, steps: int = STEPS, ckpt=None) -> dict:
    """``steps`` steps of ``make_train_step`` at ``job["opt"]``: the metrics,
    the trainable parameters and the moments; with ``ckpt``, the state
    saved there after the last step, the next step's loss uninterrupted and
    restored onto ``world``."""
    cfg, pc = job["cfgs"][arch], _pc(world, ep=ep)
    step = make_train_step(lm, cfg, pc, AdamWConfig(**job["opt"]), grad_masks=lm.grad_masks(cfg, pc))
    params = from_jax_params(job["np_params"][arch], cfg, world)
    opt = init_opt_state(lm.trainable(params, cfg))
    metrics = []
    for batch in job["batches"][:steps]:
        params, opt, m = step(params, opt, batch)
        metrics.append({k: v.detach().clone() for k, v in m.items()})
    out = {"metrics": metrics, "params": lm.trainable(params, cfg), "opt": opt}
    if ckpt is not None:
        mgr = CheckpointManager(ckpt)
        mgr.save(steps, params, opt, cfg=cfg, world=world)
        mgr.wait()
        world.procs.barrier()  # process 0 has written it
        out["next_loss"] = step(params, opt, job["batches"][steps])[2]["loss"]
        out["restored_loss"] = _restored_loss(world, job, ckpt, arch)
    return out


def _restored_loss(world: World, job: dict, ckpt: str, arch: str) -> torch.Tensor:
    """The loss of the step after ``arch``'s checkpoint, from its state restored onto ``world``."""
    cfg, pc = job["cfgs"][arch], _pc(world)
    params = from_jax_params(job["np_params"][arch], cfg, world)
    like = {"params": params, "opt": init_opt_state(lm.trainable(params, cfg))}
    restored, meta = CheckpointManager(ckpt).restore(1, like, cfg=cfg, world=world)
    assert meta["step"] == 1
    step = make_train_step(lm, cfg, pc, AdamWConfig(**job["opt"]), grad_masks=lm.grad_masks(cfg, pc))
    return step(restored["params"], restored["opt"], job["batches"][1])[2]["loss"]


# the CLIs' keywords: launch/train's from ``steps`` to ``time_data``, launch/serve's from ``batch`` to ``ckpt_dir``
CLI_TRAIN = dict(steps=2, batch=2, seq=16, reduce=True, layers=2, mode="overlap", remat="none", ckpt_dir=None,
                 ckpt_every=0, lr=3e-4, dtype="f32", world=W, log_every=1, resume=False, time_data=False)
CLI_SERVE = dict(batch=2, prompt_len=8, new_tokens=4, world=W, dtype="f32", seed=0, reduce=True, slots=2,
                 decode_block=4, temperature=0.0, top_k=0, eos_id=None, moe_stream=True, mode="overlap",
                 ckpt_dir=None)  # fmt: skip
CLI_SERVE_VARIANTS = ((True, "overlap"), (False, "baseline"))  # (--moe-stream, --mode)


def _worker(world: World, job: dict) -> dict:
    """This process's part of every check (its held ranks' slices)."""
    return {
        "rank0": world.rank0, "ops": _ops(world, job), "lazy": _lazy(world, job),
        "serve": {arch: _serve_model(world, job, arch) for arch in ARCHS},
        "grads": {ep: _grads(world, job, EP[ep]) for ep in EP},
        "train": {ep: _train(world, job, GRANITE, EP[ep]) for ep in EP},
        "ckpt": {arch: _train(world, job, arch, None, steps=1, ckpt=job["ckpt"][arch]) for arch in ARCHS},
        "cli_train": train_cli.train_tp(world, GRANITE, CLI_TRAIN)["history"],
        "cli_serve": {v: serve.serve_tp(world, GRANITE, dict(CLI_SERVE, moe_stream=v[0], mode=v[1]))["tokens"]
                      for v in CLI_SERVE_VARIANTS},
    }  # fmt: skip


@pytest.fixture(scope="module")
def tp(pc8, mesh8, tmp_path_factory):
    """The job, the JAX references, the one-process World's results and what
    the two processes made of them (one spawn)."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jlm
    from repro.parallel.context import ParallelContext as JContext
    from repro.training import optimizer as jopt
    from repro.training import steps as jsteps
    from repro.parallel.sharding import place
    from repro_torch.data import SyntheticLM
    from test_torch_moe_training import _cfgs
    from test_torch_training import STEP_OPT, _np, _with_gains, j_compiled, j_jit

    rng = np.random.default_rng(23)
    jcfgs = {arch: dataclasses.replace(_cfgs(arch)[0], vocab_size=VOCAB) for arch in ARCHS}
    jparams = {}
    for arch in ARCHS:
        np_p = _with_gains(_np(jlm.init(jax.random.PRNGKey(7), jcfgs[arch], pc8, jnp.float32)))
        jparams[arch] = place(jax.tree_util.tree_map(jnp.asarray, np_p), mesh8, jlm.specs(jcfgs[arch], pc8))
    pipe = SyntheticLM(vocab_size=VOCAB, seq_len=S, global_batch=B, seed=4)
    x = rng.standard_normal((W, 2, M_LOC, D)).astype(np.float32)
    ids, wts, _ = moe_overlap.moe_router(torch.from_numpy(x), torch.from_numpy(rng.standard_normal((D, E))
                                                                               .astype(np.float32)),
                                         num_experts=E, top_k=K_TOP)  # fmt: skip
    job = {
        "cfgs": {arch: _cfg(arch) for arch in ARCHS}, "opt": STEP_OPT,
        "np_params": {arch: jax.tree_util.tree_map(np.asarray, jparams[arch]) for arch in ARCHS},
        "tokens": rng.integers(0, VOCAB, size=(B, S)).astype(np.int64),
        "batches": [pipe.host_batch() for _ in range(STEPS + 1)],
        "ops": (x, ids.numpy(), wts.numpy(), rng.standard_normal((W, E // W, D, 2 * F)).astype(np.float32) / 4,
                rng.standard_normal((W, E // W, F, D)).astype(np.float32) / 4),
        "ag": (rng.standard_normal((W, 2, 8, 12)).astype(np.float32), rng.standard_normal((W, 12, 10)).astype(np.float32)),
        "ckpt": {arch: str(tmp_path_factory.mktemp("tp_moe_ckpt")) for arch in ARCHS},
    }  # fmt: skip
    # the processes run while the references compile
    got = []
    spawn = threading.Thread(target=lambda: got.extend(serve.run_tp(_worker, W, P, "cpu", args=(job,))))
    spawn.start()
    # the reference: prefill (TP, and EP for deepseek) and greedy decoding on the model axis of mesh8; granite's
    # train steps in TP and EP
    ref = {"logits": {}, "greedy": {}, "train": {}}
    tokens = jnp.asarray(job["tokens"], jnp.int32)
    for arch in ARCHS:
        jcfg = jcfgs[arch]
        for ep in EP if arch == DEEPSEEK else ("tp",):
            jpc = JContext(mesh=mesh8, ep_axis=EP[ep])
            lg, caches = j_jit(lambda p, t, jpc=jpc, jcfg=jcfg: jlm.prefill(p, jcfg, jpc, t, max_len=S + NEW))(
                jparams[arch], tokens)  # fmt: skip
            ref["logits"][(arch, ep)] = np.array(lg)
            if ep == "tp":
                tp_out = lg, caches
        step = j_jit(lambda p, c, t, n, jcfg=jcfg: jlm.decode_step(p, c, jcfg, pc8, t, n))
        lg, caches = tp_out
        tok = jnp.argmax(lg[:, -1], -1)
        greedy = [tok]
        for i in range(NEW - 1):
            lg, caches = step(jparams[arch], caches, tok[:, None].astype(jnp.int32), S + i)
            tok = jnp.argmax(lg[:, 0], -1)
            greedy.append(tok)
        ref["greedy"][arch] = np.stack([np.asarray(t) for t in greedy], 1)
    one = World(W, "cpu")
    jcfg = jcfgs[GRANITE]
    for ep in EP:
        jpc = JContext(mesh=mesh8, ep_axis=EP[ep])
        jstep = j_compiled(jsteps.make_train_step(jlm, jcfg, jpc, jopt.AdamWConfig(**STEP_OPT),
                                                  grad_masks=jlm.grad_masks(jcfg, jpc), donate=False))  # fmt: skip
        jp, jo, jm = jparams[GRANITE], jopt.init_opt_state(jparams[GRANITE]), []
        for batch in job["batches"][:STEPS]:
            jp, jo, m = jstep(jp, jo, batch)
            jm.append({k: float(v) for k, v in m.items()})
        ref["train"][ep] = {"metrics": jm, "params": _port(jp, job["cfgs"][GRANITE], one),
                            "opt": {k: _port(jo[k], job["cfgs"][GRANITE], one) for k in ("mu", "nu")}}  # fmt: skip
    p1 = {
        "ops": _ops(one, job), "serve": {arch: _serve_model(one, job, arch) for arch in ARCHS},
        "grads": {ep: _grads(one, job, EP[ep]) for ep in EP}, "train": {ep: _train(one, job, GRANITE, EP[ep]) for ep in EP},
        "cli_train": train_cli.train(GRANITE, device="cpu", **CLI_TRAIN)["history"],
        "cli_serve": {v: serve.serve(GRANITE, device="cpu", **dict(CLI_SERVE, moe_stream=v[0], mode=v[1]))["tokens"]
                      for v in CLI_SERVE_VARIANTS},
    }  # fmt: skip
    spawn.join()
    assert len(got) == P, "the processes failed (their tracebacks are printed above)"
    p1["restored_loss"] = {arch: _restored_loss(one, job, job["ckpt"][arch], arch) for arch in ARCHS}
    return {"job": job, "ref": ref, "p1": p1, "got": got}


def _port(np_tree, cfg, world: World) -> dict:
    """A JAX-layout tree (parameters or moments) in the port's trainable layout."""
    import jax

    return lm.trainable(from_jax_params(jax.tree_util.tree_map(np.asarray, np_tree), cfg, world), cfg)


def _held(t: torch.Tensor, p: int) -> torch.Tensor:
    return t[p * HELD : (p + 1) * HELD]


def _held_tree(tree: dict, p: int) -> dict:
    """A one-process trainable tree's slices of process ``p``'s held ranks
    (``HELD_LEAVES``, a MoE block's shared MLP included)."""

    def part(sub, names):
        return {k: part(v, names) if isinstance(v, dict) else (_held(v, p) if k in names else v)
                for k, v in sub.items()}  # fmt: skip

    layers = [{name: part(sub, HELD_LEAVES.get(name, ())) for name, sub in layer.items()} for layer in tree["layers"]]
    return {**tree, "layers": layers}


def _pairs(got: dict, want: dict, p: int):
    return list(zip(tree_leaves(got), tree_leaves(_held_tree(want, p))))


def _close(a: torch.Tensor, b: torch.Tensor, atol: float, rtol: float) -> bool:
    return bool(((a.float() - b.float()).abs() <= atol + rtol * b.float().abs().max()).all())


# ---- the executors ----------------------------------------------------------------------------------------------


@pytest.mark.parametrize("case", OPS + BASES, ids=lambda c: "-".join(map(str, c)))
def test_moe_executors_equal_p1(tp, case):
    """Overlapped forms bitwise P = 1's held slice; the baselines (a
    reduce-scatter over the processes) within RS_TOL; every dispatch
    table's kept (token, k) set exactly P = 1's."""
    want = tp["p1"]["ops"][case]
    for p, got in enumerate(tp["got"]):
        g = got["ops"][case]
        if len(case) == 4:
            assert torch.equal(g["out"], _held(want["out"], p)), p
        else:
            assert torch.allclose(g["out"], _held(want["out"], p), rtol=RS_TOL, atol=RS_TOL), p
        assert len(g["kept"]) == len(want["kept"]) > 0
        assert all(torch.equal(a, _held(b, p)) for a, b in zip(g["kept"], want["kept"])), p


@pytest.mark.parametrize("kind", ["ag_moe", "a2a_moe"])
def test_tight_capacity_drops_and_keeps_the_baselines_sets(tp, kind):
    """At capacity factor 0.25 the overlapped form drops (token, k) pairs,
    and over the processes it keeps what its baseline keeps."""
    c = 2 if kind == "a2a_moe" else 1
    for got in tp["got"]:
        def kept(case):
            return sum(int(k.sum()) for k in got["ops"][case]["kept"])

        assert kept((kind, "eager", 0.25, c)) == kept((kind, 0.25, c)) < kept((kind, "eager", 1.25, c))


# ---- the lazy permute ---------------------------------------------------------------------------------------------


def test_ring_exchange_is_issued_before_the_step_and_waited_after(tp):
    """An ``ag_matmul`` ring of W steps over the processes: step s + 1's
    exchange is issued before step s computes and waited on after it."""
    for got in tp["got"]:
        log = got["lazy"]["ring"]
        want = []
        for s in range(W):
            if s < W - 1:
                want.append(f"issue {s}")
            want.append(f"compute {s}")
            if s < W - 1:
                want.append(f"land {s}")
        assert log == want, log


@pytest.mark.parametrize("kind", ["ag_moe", "a2a_moe"])
def test_expert_gemms_run_with_a_transfer_in_flight(tp, kind):
    """Every ring step's local experts but the last run while the next
    step's tile is in flight (issued, not waited on)."""
    for got in tp["got"]:
        seen = got["lazy"]["in_flight"][kind]
        assert len(seen) == W and all(n > 0 for n in seen[:-1]), seen


# ---- the model ---------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ep", sorted(EP))
@pytest.mark.parametrize("mode", MODES)
def test_prefill_logits_match_the_reference_and_p1(tp, arch, ep, mode):
    """Against P = 1 in every case; against the reference's prefill in TP,
    and in EP for deepseek (its compile is the costly part of the module)."""
    ref = tp["ref"]["logits"].get((arch, ep))
    want = tp["p1"]["serve"][arch]["logits"][(ep, mode)]
    for got in tp["got"]:
        lg = got["serve"][arch]["logits"][(ep, mode)]
        if ref is not None:
            ref_t = torch.from_numpy(ref)
            assert bool(((lg - ref_t).abs() <= LOGIT_ATOL + LOGIT_RTOL * ref_t.abs()).all())
        if mode == "baseline":  # the MoE baseline and the GEMM+RS return home by a reduce-scatter
            assert torch.allclose(lg, want, rtol=RS_TOL, atol=RS_TOL)
        else:
            assert torch.equal(lg, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_process_stores_only_its_held_ranks(tp, arch):
    """Each held leaf (the experts, the shared MLP, attention) is ``[held,
    ...]`` in a storage of its own size: no process keeps every rank's copy."""
    for got in tp["got"]:
        rec = got["serve"][arch]["held_storage"]
        assert rec and all(lead == HELD and stored == n for lead, stored, n in rec), rec


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("stream", [False, True], ids=["gathered", "streamed"])
def test_greedy_tokens_equal_the_reference(tp, arch, stream):
    for got in tp["got"]:
        assert np.array_equal(got["serve"][arch]["greedy"][stream].numpy(), tp["ref"]["greedy"][arch])
    assert np.array_equal(tp["p1"]["serve"][arch]["greedy"][stream].numpy(), tp["ref"]["greedy"][arch])


@pytest.mark.parametrize("ep", sorted(EP))
def test_step_gradients_equal_p1(tp, ep):
    """deepseek's gradients over the processes, the router, the MoE ``ln``
    and the shared experts' MLP among them, within RS_TOL of P = 1's."""
    want = tp["p1"]["grads"][ep]
    roles = tree_leaves(lm.proc_roles(want["grads"], tp["job"]["cfgs"][DEEPSEEK]))
    assert roles.count("held") > 0 and roles.count("summed") > 0
    for p, got in enumerate(tp["got"]):
        g = got["grads"][ep]
        assert torch.equal(g["loss"], want["loss"]), p
        assert torch.allclose(g["gnorm"], want["gnorm"], rtol=RS_TOL, atol=RS_TOL), p
        for i, (a, b) in enumerate(_pairs(g["grads"], want["grads"], p)):
            assert a.shape == b.shape and torch.allclose(a, b, rtol=RS_TOL, atol=RS_TOL), (p, i)
        for layer in g["grads"]["layers"][1:]:  # the MoE layers: router, ln and shared experts got gradients
            f = layer["ffn"]
            assert all(t.abs().max() > 0 for t in (f["router"], f["ln"], f["shared"]["w_gu"], f["shared"]["w_down"]))
            assert f["shared"]["w_gu"].shape[0] == f["w_gu"].shape[0] == HELD


@pytest.mark.parametrize("ep", sorted(EP))
def test_replicated_gradients_are_equal_on_every_process(tp, ep):
    cfg = tp["job"]["cfgs"][DEEPSEEK]
    trees = [g["grads"][ep]["grads"] for g in tp["got"]]
    roles = tree_leaves(lm.proc_roles(trees[0], cfg))
    for role, *leaves in zip(roles, *(tree_leaves(t) for t in trees)):
        if role != "held":
            assert all(torch.equal(leaf, leaves[0]) for leaf in leaves), role


@pytest.mark.parametrize("ep", sorted(EP))
def test_train_steps_equal_p1(tp, ep):
    want = tp["p1"]["train"][ep]
    for p, got in enumerate(tp["got"]):
        run = got["train"][ep]
        for m, w in zip(run["metrics"], want["metrics"]):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                assert torch.allclose(m[k], w[k], rtol=RS_TOL, atol=RS_TOL), (p, k)
        for tree in ("params", "mu", "nu"):
            a, b = (run["params"], want["params"]) if tree == "params" else (run["opt"][tree], want["opt"][tree])
            for i, (x, y) in enumerate(_pairs(a, b, p)):
                assert x.shape == y.shape and torch.allclose(x, y, rtol=RS_TOL, atol=RS_TOL), (p, tree, i)


@pytest.mark.parametrize("ep", sorted(EP))
def test_train_steps_match_the_reference(tp, ep):
    """Within ``test_train_steps_match_reference``'s bounds of the JAX
    package's ``make_train_step``: metrics 1e-5 relative (lr 1e-7), each
    tree leaf 1e-5 + 1e-4 of its max."""
    ref = tp["ref"]["train"][ep]
    for p, got in enumerate(tp["got"]):
        run = got["train"][ep]
        for m, jm in zip(run["metrics"], ref["metrics"]):
            for k in ("loss", "ce", "grad_norm"):
                assert abs(m[k].item() - jm[k]) <= 1e-5 * abs(jm[k]), (p, k)
            assert abs(m["lr"].item() - jm["lr"]) <= 1e-7 * jm["lr"]
        for tree in ("params", "mu", "nu"):
            a, b = (run["params"], ref["params"]) if tree == "params" else (run["opt"][tree], ref["opt"][tree])
            for i, (x, y) in enumerate(_pairs(a, b, p)):
                assert x.shape == y.shape and _close(x, y, *REF_TOL), (p, tree, i)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_saved_at_p2_resumes_at_p1_and_p2_bitwise(tp, arch):
    want = tp["got"][0]["ckpt"][arch]["next_loss"]
    for got in tp["got"]:
        assert torch.equal(got["ckpt"][arch]["next_loss"], want)
        assert torch.equal(got["ckpt"][arch]["restored_loss"], want)
    assert torch.equal(tp["p1"]["restored_loss"][arch], want)


# ---- the CLIs ----------------------------------------------------------------------------------------------------


def test_train_cli_procs_2_gives_the_losses_of_procs_1(tp):
    """``launch/train --procs 2``'s per-process run: process 0's history has
    the one-process run's losses (within RS_TOL), the other logs none."""
    a = [r["loss"] for r in tp["p1"]["cli_train"]]
    b = [r["loss"] for r in tp["got"][0]["cli_train"]]
    assert len(a) == len(b) == CLI_TRAIN["steps"] and np.allclose(b, a, rtol=RS_TOL, atol=RS_TOL), (a, b)
    assert tp["got"][1]["cli_train"] is None


@pytest.mark.parametrize("variant", CLI_SERVE_VARIANTS, ids=["streamed-overlap", "gathered-baseline"])
def test_serve_cli_procs_2_gives_the_tokens_of_procs_1(tp, variant):
    """``launch/serve --procs 2``'s per-process run (``--moe-stream`` in
    overlap mode, the gathered decode in baseline mode): every process's
    engine tokens those of the one-process run."""
    want = tp["p1"]["cli_serve"][variant]
    assert want.shape == (CLI_SERVE["batch"], CLI_SERVE["new_tokens"])
    for got in tp["got"]:
        assert np.array_equal(got["cli_serve"][variant], want)
