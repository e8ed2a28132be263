"""The TP world over processes (``backend/mesh.World(..., procs=)``) and the
fused kernels' peer route, on the CPU with gloo.

One module-scoped spawn of P = 2 processes (``launch/serve.run_tp``), each
holding 2 of W = 4 ranks, eager backend, float32; the JAX reference runs on
the model axis (4 ranks) of ``mesh8``, on numpy inputs from one seed.  The
worker is a module-level function so the processes can import it, and the
module imports JAX only inside the fixture, so a process does not.

Held:
  * every ``World`` collective (permutes whose pairs cross the processes, a
    partial permute, psum, all_gather, reduce_scatter, shard, unshard) equal
    to the one-process World's on the same data, bitwise (reduce_scatter,
    whose library call sums the processes in its own order, within
    ``RS_TOL``), with equal ``CommCounter`` payloads;
  * ``ag_matmul`` / ``matmul_rs`` on the eager executor and their baselines
    over orders x C, bitwise the one-process World's in f32 (the
    ``matmul_rs`` baseline, a reduce_scatter, within ``RS_TOL``);
  * reduced smollm-360m: prefill logits within ``2e-3 + 2e-3 |ref|`` of the
    reference's and bitwise P = 1's in overlap mode (within ``RS_TOL`` in
    baseline mode, whose GEMM+RS is a reduce_scatter); greedy tokens equal to
    the reference's greedy decoding; the engine's tokens equal to P = 1's;
  * the refusals: data axes with processes, an unported layer kind (Mamba,
    at init and in training: MoE runs over processes and is
    held in ``tests/test_torch_tp_moe.py``), ring attention, fused seams,
    capture and tuning over processes, the fused wrappers on CPU tensors over processes,
    ``--procs`` beyond the visible cards or not dividing W, ``--procs``
    with ``--data`` (serve and train);
  * the serve CLI at ``--procs 2`` prints the tokens of ``--procs 1``;
  * the peer route's plain replay (every rank's slots a separate tensor,
    two calls on one pool, epochs, entry words) bitwise the one-allocation
    replay, and a launch without its entry words raises ``ProtocolError``;
  * the one-allocation route's regions: two tensors at fixed strides, the
    launch's arguments kept per layout;
  * the peer route's protocol (``analysis.protocol.check_peer_protocol``)
    over P in {1, 2, 4} processes and two calls, and a push without its
    entry wait caught (``overwrite``); the work items of a held block of
    ranks are the global items restricted to it; the flag-site lint rule
    over the system-scope forms.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.analysis import lint, protocol
from repro_torch.analysis.errors import PlanVerificationError
from repro_torch.analysis.ir import PlanTables
from repro_torch.backend.mesh import CommCounter, World
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import plan as tplan
from repro_torch.core import primitives as prim
from repro_torch.core.channels import BlockChannel, CommSpec
from repro_torch.core.compiler import compile_overlap
from repro_torch.kernels import peer
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.serving import Request, ServeEngine
from repro_torch.training import AdamWConfig, make_train_step
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

W, P = 4, 2
HELD = W // P
VOCAB, B, S, NEW = 128, 2, 8, 4
MAX_LEN = S + NEW
LOGIT_ATOL = LOGIT_RTOL = 2e-3
RS_TOL = 1e-5  # atol and rtol: a reduce_scatter over processes vs the one-process World's rank-order sum (f32)
ORDERS = ("ring", "bidir_ring", "all2all")
EXECUTORS = [(kind, order, nch, mode) for kind in ("ag_matmul", "matmul_rs") for order in ORDERS
             for nch in (1, 2) for mode in ("overlap", "baseline")]  # fmt: skip
ENGINE_KW = dict(max_len=MAX_LEN + 4, n_slots=2, prefill_chunk=4, decode_block=4)
PROMPTS = (7, 5, 9)
BUDGETS = (4, 3, 5)


def _pairs() -> dict:
    """Permute cases: rings both ways, pairs that cross the processes, a
    partial permute (the others take rank 0's value) and the identity."""
    return {
        "ring": [(r, (r + 1) % W) for r in range(W)],
        "reverse": [(r, (r - 1) % W) for r in range(W)],
        "swap": [(0, 2), (2, 0), (1, 3), (3, 1)],
        "partial": [(1, 0), (3, 2)],
        "identity": [(r, r) for r in range(W)],
    }


def _collectives(world: World, xs: torch.Tensor, glob: torch.Tensor) -> dict:
    """Every collective of ``world`` on ``xs`` (this process's ranks) and on
    the global ``glob``, with the payloads counted."""
    out = {}
    with world.counting() as counter:
        for name, pairs in _pairs().items():
            out[f"permute {name}"] = world.permute(xs, pairs)
        out["psum"] = world.psum(xs)
        out["all_gather 0"] = world.all_gather(xs, 0)
        out["all_gather 1"] = world.all_gather(xs, 1)
        out["reduce_scatter 0"] = world.reduce_scatter(xs, 0)
        out["unshard 1"] = world.unshard(xs, 1)
        out["shard 1"] = world.shard(glob, 1)
    out["payload"] = {k: dict(v) for k, v in counter.payload.items() if v}
    out["directions"] = dict(counter.permute_dirs)
    return out


def _executor(world: World, kind: str, order: str, nch: int, mode: str, x, w):
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    return compile_overlap(kind, ch, world=world, backend="eager", overlapped=mode == "overlap")(x, w)


def _requests(prompts):
    return [Request(tokens=p, max_new_tokens=m, seed=7 + i) for i, (p, m) in enumerate(zip(prompts, BUDGETS))]


def _model(world: World, job: dict, mode: str = "overlap") -> dict:
    """Prefill logits, greedy tokens and the engine's tokens of the reduced
    smollm on ``world``."""
    from repro_torch.convert import from_jax_params

    cfg = job["cfg"]
    params = from_jax_params(job["jparams"], cfg, world)
    pc = ParallelContext(world=world, backend="eager", mode=mode)
    prompts = torch.as_tensor(job["tokens"])
    with torch.no_grad():
        lg, _ = lm.prefill(params, cfg, pc, prompts, max_len=MAX_LEN)
        toks = serve.greedy(params, cfg, pc, prompts, NEW)[0]
    eng = ServeEngine(cfg, pc, params, **ENGINE_KW)
    handles = [eng.submit(r) for r in _requests(job["prompts"])]
    outs = eng.drain(handles)
    return {"logits": lg, "greedy": toks, "engine": [[int(t) for t in outs[h]] for h in handles],
            "capture": eng.capture}  # fmt: skip


def _refusals(world: World, job: dict) -> dict:
    """The messages of what a world over processes refuses (None: no raise)."""
    cfg = job["cfg"]
    pc = ParallelContext(world=world, backend="eager")
    params = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)
    x = torch.zeros((world.held, 1, 4, cfg.d_model))
    cases = {
        "data": lambda: ParallelContext(world=world, data=world.procs),
        "tune": lambda: ParallelContext(world=world, tune=True),
        # "moe" / "train": the layer kind refused at init and in training over processes, now Mamba
        "moe": lambda: lm.init(dataclasses.replace(reduce_config(get_config("mamba2-2.7b")), vocab_size=VOCAB),
                               world, torch.Generator().manual_seed(0)),
        "ring": lambda: pc.ring_attention(x, x, x),
        "seams": lambda: lm.forward(params, cfg, dataclasses.replace(pc, fuse_seams=True),
                                    torch.zeros((1, 8), dtype=torch.int64)),
        "train": lambda: make_train_step(lm, dataclasses.replace(reduce_config(get_config("mamba2-2.7b")),
                                                                 vocab_size=VOCAB), pc, AdamWConfig()),
        "capture": lambda: ServeEngine(cfg, pc, params, capture=True, **ENGINE_KW),
        "fused_cpu": lambda: K.ag_gemm(torch.zeros((world.held, 4, 8)), torch.zeros((world.held, 8, 8)), world=world),
    }  # fmt: skip
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _worker(world: World, job: dict) -> dict:
    """This process's part of every check (its held ranks' slices)."""
    lo, hi = world.rank0, world.rank0 + world.held
    out = {"held": world.held, "rank0": lo, "nprocs": world.nprocs}
    glob = torch.from_numpy(job["glob"])
    out["collectives"] = _collectives(world, torch.from_numpy(job["xs"])[lo:hi].clone(), glob)
    out["executors"] = {}
    for case in EXECUTORS:
        xw = job["ag"] if case[0] == "ag_matmul" else job["rs"]
        x, w = (torch.from_numpy(a)[lo:hi].clone() for a in xw)
        out["executors"][case] = _executor(world, *case, x, w)
    out["model"] = {mode: _model(world, job, mode) for mode in ("overlap", "baseline")}
    out["refused"] = _refusals(world, job)
    return out


@pytest.fixture(scope="module")
def tp(pc8, mesh8):
    """The job, the JAX references, the one-process World's results and what
    the two processes made of them (one spawn)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.models import lm as jlm
    from repro.parallel.sharding import place
    from utils import reduce_config as j_reduce_config

    rng = np.random.default_rng(11)
    jcfg = dataclasses.replace(j_reduce_config(j_get_config("smollm-360m")), vocab_size=VOCAB)
    cfg = dataclasses.replace(reduce_config(get_config("smollm-360m")), vocab_size=VOCAB)
    jparams = place(jlm.init(jax.random.PRNGKey(5), jcfg, pc8, jnp.float32), mesh8, jlm.specs(jcfg, pc8))
    tokens = rng.integers(0, VOCAB, size=(B, S)).astype(np.int64)
    job = {
        "cfg": cfg, "jparams": jax.tree_util.tree_map(np.asarray, jparams), "tokens": tokens,
        "prompts": [rng.integers(0, VOCAB, size=n).astype(np.int32) for n in PROMPTS],
        "xs": rng.standard_normal((W, 8, 6)).astype(np.float32),
        "glob": rng.standard_normal((3, 8, 5)).astype(np.float32),
        "ag": (rng.standard_normal((W, 2, 8, 12)).astype(np.float32), rng.standard_normal((W, 12, 10)).astype(np.float32)),
        "rs": (rng.standard_normal((W, 2, 16, 12)).astype(np.float32), rng.standard_normal((W, 12, 20)).astype(np.float32)),
    }  # fmt: skip
    # the reference: prefill, then greedy decoding, on the model axis of mesh8
    prefill = jax.jit(lambda p, t: jlm.prefill(p, jcfg, pc8, t, max_len=MAX_LEN))
    step = jax.jit(lambda p, c, t, n: jlm.decode_step(p, c, jcfg, pc8, t, n))
    lg, caches = prefill(jparams, jnp.asarray(tokens, jnp.int32))
    ref_logits = np.asarray(lg)
    tok = jnp.argmax(lg[:, -1], -1)
    greedy = [tok]
    for i in range(NEW - 1):
        lg, caches = step(jparams, caches, tok[:, None].astype(jnp.int32), S + i)
        tok = jnp.argmax(lg[:, 0], -1)
        greedy.append(tok)
    one = World(W, "cpu")
    p1 = {
        "collectives": _collectives(one, torch.from_numpy(job["xs"]), torch.from_numpy(job["glob"])),
        "executors": {c: _executor(one, *c, *(torch.from_numpy(a) for a in (job["ag"] if c[0] == "ag_matmul"
                                                                                else job["rs"])))
                      for c in EXECUTORS},
        "model": {mode: _model(one, job, mode) for mode in ("overlap", "baseline")},
    }  # fmt: skip
    got = serve.run_tp(_worker, W, P, "cpu", args=(job,))
    return {"job": job, "ref_logits": ref_logits, "ref_greedy": np.stack([np.asarray(t) for t in greedy], 1),
            "p1": p1, "got": got}  # fmt: skip


def _held(t: torch.Tensor, p: int) -> torch.Tensor:
    return t[p * HELD : (p + 1) * HELD]


# ---- the world ----------------------------------------------------------------------------------------------


def test_each_process_holds_its_block_of_ranks(tp):
    assert [(g["rank0"], g["held"], g["nprocs"]) for g in tp["got"]] == [(0, HELD, P), (HELD, HELD, P)]


@pytest.mark.parametrize("name", [f"permute {n}" for n in _pairs()] + ["all_gather 0", "all_gather 1",
                                                                      "reduce_scatter 0", "shard 1"])  # fmt: skip
def test_rank_stacked_collectives_equal_the_one_process_world(tp, name):
    want = tp["p1"]["collectives"][name]
    for p, got in enumerate(tp["got"]):
        if name.startswith("reduce_scatter"):  # the library's sum over the processes, in its own order
            assert torch.allclose(got["collectives"][name], _held(want, p), rtol=RS_TOL, atol=RS_TOL), (p, name)
        else:
            assert torch.equal(got["collectives"][name], _held(want, p)), (p, name)


@pytest.mark.parametrize("name", ["psum", "unshard 1"])
def test_replicated_collectives_equal_the_one_process_world(tp, name):
    for got in tp["got"]:
        assert torch.equal(got["collectives"][name], tp["p1"]["collectives"][name])


def test_counted_payloads_equal_the_one_process_world(tp):
    want = tp["p1"]["collectives"]
    for got in tp["got"]:
        assert got["collectives"]["payload"] == want["payload"]
        assert got["collectives"]["directions"] == want["directions"]


def test_world_refuses_a_process_count_that_does_not_divide():
    fake = type("Procs", (), {"size": 3, "rank": 0, "device": torch.device("cpu")})()
    with pytest.raises(ValueError, match="3 processes do not divide"):
        World(4, "cpu", procs=fake)


# ---- the executors ------------------------------------------------------------------------------------------


@pytest.mark.parametrize("case", EXECUTORS, ids=lambda c: "-".join(map(str, c)))
def test_executors_equal_the_one_process_world_bitwise(tp, case):
    want = tp["p1"]["executors"][case]
    for p, got in enumerate(tp["got"]):
        if case[0] == "matmul_rs" and case[3] == "baseline":  # a reduce_scatter over the processes
            assert torch.allclose(got["executors"][case], _held(want, p), rtol=RS_TOL, atol=RS_TOL), p
        else:
            assert torch.equal(got["executors"][case], _held(want, p)), p


# ---- the model ------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["overlap", "baseline"])
def test_prefill_logits_match_the_reference_and_p1(tp, mode):
    ref = torch.from_numpy(np.array(tp["ref_logits"]))
    for got in tp["got"]:
        lg = got["model"][mode]["logits"]
        assert bool(((lg - ref).abs() <= LOGIT_ATOL + LOGIT_RTOL * ref.abs()).all())
        if mode == "baseline":  # each GEMM+RS a reduce_scatter over the processes
            assert torch.allclose(lg, tp["p1"]["model"][mode]["logits"], rtol=RS_TOL, atol=RS_TOL)
        else:
            assert torch.equal(lg, tp["p1"]["model"][mode]["logits"])


@pytest.mark.parametrize("mode", ["overlap", "baseline"])
def test_greedy_tokens_equal_the_reference(tp, mode):
    for got in tp["got"]:
        assert np.array_equal(got["model"][mode]["greedy"].numpy(), tp["ref_greedy"])


@pytest.mark.parametrize("mode", ["overlap", "baseline"])
def test_engine_tokens_equal_p1_and_it_steps_eagerly(tp, mode):
    want = tp["p1"]["model"][mode]["engine"]
    assert [len(t) for t in want] == list(BUDGETS)
    for got in tp["got"]:
        assert got["model"][mode]["engine"] == want and got["model"][mode]["capture"] is False


# ---- the refusals ---------------------------------------------------------------------------------------------


REFUSED = {
    "data": "ValueError: a TP world over processes takes no data axes",
    "tune": "ValueError: tune=True over a TP world of processes",
    "moe": "NotImplementedError: mamba2-2.7b: layers",
    "ring": "NotImplementedError: ring attention over a TP world of 2 processes",
    "seams": "NotImplementedError: the fused RS -> AG seam over a TP world of 2 processes",
    "train": "NotImplementedError: training mamba2-2.7b: layers",
    "capture": "ValueError: no CUDA-graph capture over a TP world of processes",
    "fused_cpu": "ValueError: ag_gemm: the peer route over processes runs on the card",
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refusals_over_processes(tp, case):
    for got in tp["got"]:
        assert got["refused"][case] is not None and got["refused"][case].startswith(REFUSED[case]), got["refused"]


def test_run_tp_refuses_more_processes_than_cards(monkeypatch):
    monkeypatch.setattr(serve, "resolve_device", lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 CUDA device"):
        serve.run_tp(_worker, W, 2, "cuda")


@pytest.mark.parametrize("world,procs", [(4, 3), (4, 0)])
def test_run_tp_refuses_a_process_count_that_does_not_divide_w(world, procs):
    with pytest.raises(ValueError, match="must divide"):
        serve.run_tp(_worker, world, procs, "cpu")


def test_serve_refuses_procs_with_data():
    with pytest.raises(ValueError, match="TP x data across processes"):
        serve.serve("smollm-360m", procs=2, data=2, device="cpu", reduce=True)


def test_serve_cli_procs_2_prints_the_tokens_of_procs_1(capfd):
    kw = dict(batch=2, prompt_len=8, new_tokens=4, world=W, dtype="f32", device="cpu", reduce=True, slots=2,
              decode_block=4)  # fmt: skip
    one = serve.serve("smollm-360m", **kw)
    two = serve.serve("smollm-360m", procs=2, **kw)
    assert np.array_equal(one["tokens"], two["tokens"]) and one["graph_captures"] == two["graph_captures"] == 0
    assert [p["device"] for p in two["processes"]] == ["cpu", "cpu"]
    assert "over 2 processes (2 a process), torch.distributed gloo" in capfd.readouterr().out


# ---- the peer route's plain replay -----------------------------------------------------------------------------

PEER = [(kind, order, nch) for kind in ("ag_gemm", "gemm_rs") for order in ORDERS for nch in (1, 2)]


def _peer_operands(kind: str, dtype=torch.float32):
    rng = np.random.default_rng(3)
    if kind == "ag_gemm":
        x, w = rng.standard_normal((W, 2, 8, 16)), rng.standard_normal((W, 16, 24))
    else:
        x, w = rng.standard_normal((W, 2, 16, 12)), rng.standard_normal((W, 12, 32))
    return torch.from_numpy(x.astype(np.float32)).to(dtype), torch.from_numpy(w.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("kind,order,nch", PEER)
def test_peer_plain_replay_equals_the_one_allocation_replay(kind, order, nch):
    """Every rank's slots a separate tensor, two calls on one pool (its
    epoch carried), each bitwise the one-allocation replay; every flag of
    the pool holds the second call's epoch."""
    x, w = _peer_operands(kind)
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    plain = getattr(K, f"{kind}_plain")
    one = plain(x, w, channel=ch)
    before = {id(p): p.epoch for p in peer.pools().values()}
    outs = [getattr(K, kind)(x, w, channel=ch, split=True) for _ in range(2)]
    assert all(torch.equal(o, one) for o in outs)
    pool = next(p for p in peer.pools().values() if p.mode == "split" and p.epoch - before.get(id(p), 0) == 2)
    values = {v for board in pool.boards for v in board._values.values()}
    assert values == {pool.epoch} and len(pool.slots) == W and len({t.data_ptr() for t in pool.slots}) == W


@pytest.mark.parametrize("kind", ["ag_gemm", "gemm_rs"])
def test_peer_plain_replay_without_entry_words_raises(kind, monkeypatch):
    """A launch whose prologue sets no entry word: the first push waits on
    one no earlier step set."""
    mod = sys.modules[f"repro_torch.kernels.{kind}"]
    monkeypatch.setattr(mod, "entry_keys", lambda world, ranks, epoch=None: ())
    x, w = _peer_operands(kind)
    with pytest.raises(prim.ProtocolError, match="entry"):
        getattr(K, f"{kind}_plain")(x, w, channel=BlockChannel(axis="model", num_channels=2), split=True)


def test_train_refuses_procs_with_data():
    with pytest.raises(ValueError, match="TP x data across processes"):
        train_cli.train("smollm-360m", procs=2, data=2, device="cpu", reduce=True)


def test_one_allocation_regions_sit_at_fixed_strides():
    """The one-allocation route's regions of a call: every rank's slots in
    one tensor and every rank's control words in one zeroed tensor, passed
    as two addresses at fixed strides (no table), with the arguments kept
    per layout and only the addresses filled in per call."""
    lay = peer.Layout((W * 2, 12, 8), torch.bfloat16, 24, W)
    a, b = (peer.regions("ag_gemm", lay, torch.device("cpu")) for _ in range(2))
    assert a.mode == b.mode == "one" and a.args is b.args and a.address == b.address
    slots, ctl = b.keep
    assert b.slots is slots and tuple(slots.shape) == (W,) + lay.slot_shape and slots.is_contiguous()
    assert ctl.dtype == torch.int32 and ctl.numel() == W * lay.ctl_words and not ctl.any()
    args = b.args
    assert (args.bases, args.slot0, args.ctl0) == (None, slots.data_ptr(), ctl.data_ptr())
    assert (args.slot_stride, args.ctl_stride) == (lay.slot_bytes, 4 * lay.ctl_words)
    assert (args.entry_off, args.ctl_off, args.rank0, args.held, args.sys) == (4 * 24, 4 * (24 + W), 0, W, 0)


# ---- the peer route's protocol ---------------------------------------------------------------------------------


def _tables(kind: str, order: str, nch: int) -> PlanTables:
    ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
    return PlanTables.from_plan(tplan.build_plan(kind, ch, W, nch))


@pytest.mark.parametrize("procs", [1, 2, 4])
@pytest.mark.parametrize("kind,order,nch", [(k, o, c) for k in ("ag_matmul", "matmul_rs") for o in ORDERS
                                            for c in (1, 2)])  # fmt: skip
def test_peer_protocol_holds_over_processes_and_calls(kind, order, nch, procs):
    checks, events = protocol.check_peer_protocol(_tables(kind, order, nch), procs)
    assert checks > 0 and events > 0


@pytest.mark.parametrize("kind,procs", [("ag_matmul", 4), ("matmul_rs", 2), ("matmul_rs", 4)])
def test_peer_protocol_catches_a_push_without_its_entry_wait(kind, procs, monkeypatch):
    t = _tables(kind, "ring", 2)  # built (and verified) before the items lose their entry waits
    mod = sys.modules["repro_torch.kernels." + ("ag_gemm" if kind == "ag_matmul" else "gemm_rs")]
    items = mod.work_items
    monkeypatch.setattr(mod, "work_items", lambda *a, **kw: [it._replace(entry=None) for it in items(*a, **kw)])
    with pytest.raises(PlanVerificationError) as e:
        protocol.check_peer_protocol(t, procs)
    assert e.value.check == "overwrite" and "before call 1 has read it" in str(e.value)


@pytest.mark.parametrize("kind", ["ag_matmul", "matmul_rs"])
def test_held_ranks_items_are_the_global_items_restricted(kind):
    t = _tables(kind, "bidir_ring", 2)
    items = protocol._peer_items(t, 3)
    for p in range(P):
        ranks = range(p * HELD, (p + 1) * HELD)
        mine = protocol._peer_items(t, 3, ranks)
        want = [it for it in items if it.r in ranks]
        assert [it._replace(index=0) for it in mine] == [it._replace(index=0) for it in want]
        assert [it.index for it in mine] == list(range(len(mine)))
        assert all(key[-1] == 3 for it in mine for key in it.sets + it.writes + ((it.entry,) if it.entry else ()))


@pytest.mark.parametrize("line", ["__threadfence_system();", "asm(\"ld.acquire.sys.global.s32 %0, [%1];\");",
                                  "tl_fence(1);", "tl_spin(f, 2, 1);", "peer_entry_wait(t, 0, 1, 2);"])  # fmt: skip
def test_flag_site_rule_covers_the_system_scope_forms(line):
    got = lint.lint_source(line, "kernels/csrc/flash_attention.cu")
    assert got and got[0].rule == "flag-site"
    assert not lint.lint_source(line, "kernels/csrc/tile_sync.cuh")
