"""Data-parallel serving (``serving/engine.py``, ``serving/cache.py`` and
``launch/serve.py`` under ``pc.data``) on the CPU with gloo.

One module-scoped spawn of D = 2 replica processes (``launch/train.
run_replicas``), each the W = 4 model group, ``backend="eager"``, float32,
serves reduced smollm-360m, granite-moe-3b-a800m and mamba2-2.7b, weights
carried across from the JAX package's init on ``mesh8`` by
``convert.from_jax_params``.  Six requests (four greedy, two sampled) on
four slots (two a replica), prompt lengths that do not divide the prefill
chunk, budgets such that admission re-seats a freed slot on each replica.
The workers are module-level functions so the processes can import them,
and the module imports JAX only inside the fixture that builds the
references, so a replica process does not.

Held:
  * the greedy streams against per-token JAX reference decoding on
    ``mesh8`` (the ``_ref_greedy`` pattern of ``tests/test_torch_engine.py``),
    and every token, greedy and sampled, against the port's D = 1 engine
    on the same requests, with the same slots seated in the same order;
  * each replica stores ``n_slots / D`` rows of every cache and its block
    of every parameter the data axes split; a reset of a global slot zeroes
    exactly the owner's row (bitwise, the Mamba state included);
  * one host sync a step, no capture; each step's payload on the data
    transport equal to ``launch/roofline.data_axis_bytes`` of the leaves a
    ``decode_step`` gathers, times the step's calls, plus the token-buffer
    all-gather;
  * ``serve.greedy`` under ``pc.data`` decodes this replica's rows, as D = 1
    decodes them;
  * an ``n_slots`` that D does not divide, ``capture=True`` or ``tune=True``
    with data, and a diverged scheduler raise;
  * the serve CLI at ``--data 2`` prints the tokens of ``--data 1``,
    ``--mode baseline`` the greedy tokens of ``overlap``, and ``--ckpt-dir``
    restores a checkpoint that ``launch/train`` wrote at D = 1, at D = 1
    and at D = 2.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.backend.mesh import CommCounter, DistWorld, World
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as R
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.parallel.sharding import data_dim, map_specs, place_data
from repro_torch.serving import Request, ServeEngine
from repro_torch.training import init_opt_state
from repro_torch.training import optimizer as topt
from repro_torch.training.steps import data_blocks
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

D, TP = 2, 4
ARCHS = ("smollm-360m", "granite-moe-3b-a800m", "mamba2-2.7b")
VOCAB, MAX_LEN = 128, 40
ENGINE_KW = dict(max_len=MAX_LEN, n_slots=4, prefill_chunk=4, decode_block=4)
# prompt lengths that do not divide the prefill chunk; slots 1 (replica 0) and 2 (replica 1) free first
PROMPTS = (9, 5, 7, 10, 6, 11)
BUDGETS = (8, 2, 3, 7, 5, 4)
SAMPLED = {3: (0.8, 40), 5: (1.1, 8)}  # request -> (temperature, top-k); the rest greedy
GREEDY_ROWS, GREEDY_LEN, GREEDY_NEW = 4, 8, 4  # serve.greedy's batch


def _requests(prompts):
    return [Request(tokens=p, max_new_tokens=m, temperature=SAMPLED.get(i, (0.0, 0))[0],
                    top_k=SAMPLED.get(i, (0.0, 0))[1], seed=100 + i)
            for i, (p, m) in enumerate(zip(prompts, BUDGETS))]  # fmt: skip


def _run(eng, reqs, data=None):
    """Every request submitted, then the engine stepped to the end: the
    tokens by request, the slots seated at each step, and each step's
    decode_step calls and data-transport payload."""
    handles = [eng.submit(r) for r in reqs]
    seats, calls, payloads = [], [], []
    while eng.scheduler.has_work:
        before = eng.stats["decode_calls"]
        counter = CommCounter()
        if data is None:
            eng.step()
        else:
            with data.counting(counter):
                eng.step()
        seats.append(list(eng.scheduler.slots))
        calls.append(eng.stats["decode_calls"] - before)
        payloads.append({k: float(sum(v.values())) for k, v in counter.payload.items() if v})
    return {"tokens": [eng.scheduler.states[h].generated for h in handles], "seats": seats, "calls": calls,
            "payloads": payloads}  # fmt: skip


def _serve_worker(data: DistWorld, jobs: dict):
    """Each job's engine at D = 2 on this replica's blocks, its cache and
    parameter shapes, resets of every global slot, serve.greedy on this
    replica's rows; then the refusals."""
    out = {}
    for name, job in jobs.items():
        cfg = job["cfg"]
        pc = serve.serve_context(TP, "cpu", data, backend="eager")
        blocks = lm.with_tied(data_blocks(lm, cfg, pc, lm.trainable(job["params"], cfg)), cfg)
        eng = ServeEngine(cfg, pc, blocks, **ENGINE_KW)
        res = _run(eng, _requests(job["prompts"]), data)
        res.update(stats={k: v for k, v in eng.stats.items() if k != "launches"}, capture=eng.capture,
                   graphs=len(eng.graphs), n_loc=eng.pool.n_loc,
                   cache_shapes=[{k: tuple(t.shape) for k, t in c.items()} for c in eng.pool.caches],
                   param_shapes=[tuple(t.shape) for t in topt.tree_leaves(blocks)])  # fmt: skip
        resets = []
        for slot in range(ENGINE_KW["n_slots"]):
            for c in eng.pool.caches:
                for t in c.values():
                    t.fill_(1.0)
            eng.pool.reset(slot)
            rows = []
            for j in range(eng.pool.n_loc):
                rs = [t[:, j] for c in eng.pool.caches for t in c.values()]
                rows.append("zero" if all(bool((r == 0).all()) for r in rs) else
                            "one" if all(bool((r == 1).all()) for r in rs) else "mixed")  # fmt: skip
            resets.append(rows)
        res["resets"] = resets
        with torch.no_grad():
            res["greedy"] = serve.greedy(blocks, cfg, pc, torch.as_tensor(job["greedy_prompts"]), GREEDY_NEW)[0]
        out[name] = res
    out["refused"] = _refusals(data, jobs["smollm-360m"])
    return out


def _refusals(data, job) -> dict:
    """The messages of the engine's refusals under ``pc.data``."""
    cfg = job["cfg"]
    pc = serve.serve_context(TP, "cpu", data, backend="eager")
    blocks = lm.with_tied(data_blocks(lm, cfg, pc, lm.trainable(job["params"], cfg)), cfg)
    out = {}
    for case, kw, p in (("slots", {"n_slots": 3}, pc), ("capture", {"capture": True}, pc),
                        ("tune", {}, dataclasses.replace(pc, tune=True))):  # fmt: skip
        try:
            ServeEngine(cfg, p, blocks, **{**ENGINE_KW, **kw})
            out[case] = None
        except ValueError as e:
            out[case] = str(e)
    # the replicas seat the same four requests; replica 1 alone queues a fifth: the step's digests differ
    eng = ServeEngine(cfg, pc, blocks, **ENGINE_KW)
    reqs = _requests(job["prompts"])
    for r in reqs[: 4 + data.rank]:
        eng.submit(r)
    try:
        eng.step()
        out["diverged"] = None
    except RuntimeError as e:
        out["diverged"] = str(e)
    return out


@pytest.fixture(scope="module")
def dp(pc8, mesh8):
    """The jobs, the JAX references, the port's D = 1 engine and greedy,
    and what the two replica processes made of them (one spawn)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.models import lm as jlm
    from repro.parallel.sharding import place
    from repro_torch.convert import from_jax_params
    from utils import reduce_config as j_reduce_config

    jobs, refs, d1 = {}, {}, {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(j_reduce_config(j_get_config(arch)), vocab_size=VOCAB)
        cfg = dataclasses.replace(reduce_config(get_config(arch)), vocab_size=VOCAB)
        jparams = place(jlm.init(jax.random.PRNGKey(4), jcfg, pc8, jnp.float32), mesh8, jlm.specs(jcfg, pc8))
        params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, World(TP, "cpu"))
        rng = np.random.default_rng(21)
        prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32) for n in PROMPTS]
        greedy_prompts = rng.integers(0, VOCAB, size=(GREEDY_ROWS, GREEDY_LEN)).astype(np.int64)
        jobs[arch] = {"cfg": cfg, "params": params, "prompts": prompts, "greedy_prompts": greedy_prompts}
        step = jax.jit(lambda p, c, t, n, jcfg=jcfg: jlm.decode_step(p, c, jcfg, pc8, t, n))
        refs[arch] = {}
        for i, (prompt, m) in enumerate(zip(prompts, BUDGETS)):
            if i in SAMPLED:
                continue
            # per-token reference: the prompt one token at a time, then greedy (batch 2, both rows the prompt)
            caches = jlm.init_caches(jcfg, pc8, 2, MAX_LEN, jnp.float32)
            for t, tok in enumerate(prompt):
                lg, caches = step(jparams, caches, jnp.full((2, 1), tok, jnp.int32), t)
            ref = []
            for j in range(m):
                ref.append(int(jnp.argmax(lg[0, 0])))
                lg, caches = step(jparams, caches, jnp.full((2, 1), ref[-1], jnp.int32), len(prompt) + j)
            refs[arch][i] = ref
        pc = ParallelContext(world=World(TP, "cpu"), backend="eager")
        eng = ServeEngine(cfg, pc, params, **ENGINE_KW)
        d1[arch] = _run(eng, _requests(prompts))
        with torch.no_grad():
            d1[arch]["greedy"] = serve.greedy(params, cfg, pc, torch.as_tensor(greedy_prompts), GREEDY_NEW)[0]
    got = train_cli.run_replicas(_serve_worker, D, device="cpu", args=(jobs,))
    return {"jobs": jobs, "refs": refs, "d1": d1, "got": got}


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_per_token_reference(dp, arch):
    for r, got in enumerate(dp["got"]):
        for i, ref in dp["refs"][arch].items():
            assert got[arch]["tokens"][i] == ref, (r, i)


@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_and_seating_match_the_d1_engine(dp, arch):
    """Every token, greedy and sampled (the noise a hash of (seed, count),
    not of the batch), and the slots seated at every step, as the D = 1
    engine on the same requests; a freed slot is re-seated on each replica."""
    d1 = dp["d1"][arch]
    for got in dp["got"]:
        assert got[arch]["tokens"] == d1["tokens"]
        assert got[arch]["seats"] == d1["seats"] and got[arch]["calls"] == d1["calls"]
    n_loc = ENGINE_KW["n_slots"] // D
    reseated = {s // n_loc for s in range(ENGINE_KW["n_slots"])
                if len({seats[s] for seats in d1["seats"] if seats[s] is not None}) > 1}  # fmt: skip
    assert reseated == set(range(D))
    assert all(len(t) == m for t, m in zip(d1["tokens"], BUDGETS))


@pytest.mark.parametrize("arch", ARCHS)
def test_each_replica_holds_its_rows_and_blocks(dp, arch):
    """n_slots / D rows of every cache, and ``place_data``'s block of every
    parameter the data axes split (the tied head's copy included)."""
    job = dp["jobs"][arch]
    cfg = job["cfg"]
    n_loc = ENGINE_KW["n_slots"] // D
    pc = ParallelContext(world=World(TP, "cpu"), backend="eager")
    want_caches = [{k: tuple(t.shape) for k, t in c.items()} for c in lm.init_caches(cfg, pc, n_loc, MAX_LEN)]
    pcd = make_dev_mesh(TP, D).context("cpu", backend="eager")
    specs = lm.trainable(lm.specs(cfg, pcd), cfg)
    blocks = map_specs(lambda s, t: place_data(t, s, World(D, "cpu"), pcd.dp_axes)[0]
                       if data_dim(s, pcd.dp_axes) is not None else t, specs, lm.trainable(job["params"], cfg))  # fmt: skip
    want = [tuple(t.shape) for t in topt.tree_leaves(lm.with_tied(blocks, cfg))]
    whole = [tuple(t.shape) for t in topt.tree_leaves(job["params"])]
    assert len(want) == len(whole) and want != whole
    for got in dp["got"]:
        assert got[arch]["n_loc"] == n_loc and got[arch]["cache_shapes"] == want_caches
        assert got[arch]["param_shapes"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_zeroes_exactly_the_owners_row(dp, arch):
    """Every cache leaf filled with ones, then one global slot reset: its
    owner's row is zero bit for bit (KV, and the SSM and conv state), every
    other row on both replicas still ones."""
    n_loc = ENGINE_KW["n_slots"] // D
    for r, got in enumerate(dp["got"]):
        for slot, rows in enumerate(got[arch]["resets"]):
            assert rows == ["zero" if r * n_loc + j == slot else "one" for j in range(n_loc)], (r, slot)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_host_sync_a_step_and_no_capture(dp, arch):
    for got in dp["got"]:
        st = got[arch]["stats"]
        assert st["host_syncs"] == st["steps"] == len(got[arch]["calls"]) > 0
        assert st["graph_captures"] == 0 and got[arch]["graphs"] == 0 and got[arch]["capture"] is False
        assert st["decode_calls"] == sum(got[arch]["calls"]) and st["resets"] == len(PROMPTS)


@pytest.mark.parametrize("arch", ARCHS)
def test_data_bytes_a_step_match_the_model(dp, arch):
    """Each step's link bytes on the data transport: ``data_axis_bytes`` of
    the leaves one ``decode_step`` gathers (every leaf once: the embedding
    and the head once a call) times the step's calls, plus the all-gather of
    every replica's token-buffer rows and its digest (mesh (pod 1, data 2,
    model 1): one replica process holds its whole model group)."""
    job = dp["jobs"][arch]
    cfg = job["cfg"]
    pcd = make_dev_mesh(TP, D).context("cpu", backend="eager")
    leaves = dryrun.data_leaves(cfg, job["params"], lm.specs(cfg, pcd), train=False)
    _, per_call = R.data_axis_bytes(leaves, {"pod": 1, "data": D, "model": 1}, pcd.dp_axes, train=False,
                                    recompute=False)  # fmt: skip
    assert set(per_call) == {"all-gather"}
    sync = D * (ENGINE_KW["n_slots"] // D + 1) * (ENGINE_KW["decode_block"] + 1) * 8  # int64 rows + digest row
    for got in dp["got"]:
        for calls, payload in zip(got[arch]["calls"], got[arch]["payloads"], strict=True):
            counter = CommCounter()
            for kind, nbytes in payload.items():
                counter.add(kind, nbytes, D)
            model = CommCounter()
            model.add("all_gather", sync, D)
            want = {"all-gather": per_call["all-gather"] * calls + R.collective_bytes(model)[1]["all-gather"]}
            assert R.collective_bytes(counter)[1] == want, (calls, payload)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decodes_the_replicas_rows(dp, arch):
    """``serve.greedy`` under ``pc.data``: replica r's tokens are D = 1's of
    rows r B/D .. (r+1) B/D."""
    rows = GREEDY_ROWS // D
    for r, got in enumerate(dp["got"]):
        assert torch.equal(got[arch]["greedy"], dp["d1"][arch]["greedy"][r * rows : (r + 1) * rows])


@pytest.mark.parametrize("case,match", [("slots", "do not divide"), ("capture", "no CUDA-graph capture"),
                                        ("tune", "pc.tune"), ("diverged", "diverged")])  # fmt: skip
def test_the_engine_refuses_under_data(dp, case, match):
    """3 slots over 2 replicas, capture=True and tune=True with data raise
    ValueError; a scheduler that diverged (one replica queued a request the
    other did not) raises RuntimeError at the step, on every replica."""
    for got in dp["got"]:
        assert got["refused"][case] is not None and match in got["refused"][case], got["refused"][case]


# ---- the serve CLI ----------------------------------------------------------------------------

CLI = ["--arch", "smollm-360m", "--reduce", "--device", "cpu", "--dtype", "f32", "--batch", "3", "--prompt-len", "6",
       "--new-tokens", "4", "--slots", "2", "--decode-block", "3"]  # fmt: skip


def _sample(out: str) -> list:
    return [line for line in out.splitlines() if line.startswith("sample:")]


def test_serve_cli_restores_a_train_checkpoint_at_either_d(tmp_path, capfd):
    """``launch/train`` at D = 1 writes step 2; ``--ckpt-dir`` restores it at
    D = 1 and at D = 2 (``loaded checkpoint step 2``, printed by rank 0), the
    same tokens both ways, equal to an engine over the restored parameters,
    and not the seeded init's."""
    ckpt = str(tmp_path / "ckpt")
    train_cli.main(["--arch", "smollm-360m", "--reduce", "--device", "cpu", "--batch", "4", "--seq", "16",
                    "--steps", "2", "--ckpt-every", "2", "--lr", "0.05", "--ckpt-dir", ckpt])  # fmt: skip
    capfd.readouterr()
    sampled = ["--temperature", "0.8", "--top-k", "5"]
    r1 = serve.main(CLI + sampled + ["--ckpt-dir", ckpt])
    out1 = capfd.readouterr().out
    r2 = serve.main(CLI + sampled + ["--ckpt-dir", ckpt, "--data", "2"])
    out2 = capfd.readouterr().out
    assert "loaded checkpoint step 2" in out1 and out2.count("loaded checkpoint step 2") == 1
    assert "data axis: 2 replica processes over torch.distributed gloo, staging direct" in out2
    np.testing.assert_array_equal(r1["tokens"], r2["tokens"])
    assert _sample(out1) == _sample(out2) and len(r2["replicas"]) == 2
    assert r2["host_syncs"] == r2["steps"] and r2["graph_captures"] == 0 and r2["data_bytes"]["all_gather"] > 0
    # the restored parameters served directly
    cfg = reduce_config(get_config("smollm-360m"))
    world = World(TP, "cpu")
    init = lm.init(cfg, world, torch.Generator().manual_seed(7), torch.float32)
    restored, _ = CheckpointManager(ckpt).restore(2, {"params": init, "opt": init_opt_state(lm.trainable(init, cfg))},
                                                  cfg=cfg, world=world)  # fmt: skip
    eng = ServeEngine(cfg, ParallelContext(world=world), restored["params"], max_len=10, n_slots=2, decode_block=3)
    handles = [eng.submit(Request(tokens=p, max_new_tokens=4, temperature=0.8, top_k=5, seed=i))
               for i, p in enumerate(serve.make_prompts(cfg.vocab_size, 3, 6, 0))]  # fmt: skip
    outs = eng.drain(handles)
    np.testing.assert_array_equal(np.stack([outs[h] for h in handles]), r1["tokens"])
    seeded = serve.main(CLI + sampled)
    assert "loaded checkpoint" not in capfd.readouterr().out
    assert not np.array_equal(seeded["tokens"], r1["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_baseline_mode_gives_the_overlap_tokens(arch, capsys):
    args = ["--arch", arch] + CLI[2:]
    over = serve.main(args)
    base = serve.main(args + ["--mode", "baseline"])
    np.testing.assert_array_equal(over["tokens"], base["tokens"])
    assert (over["tokens"] >= 0).all()


def test_data_parallel_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the policy under test is the CUDA-less one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve("smollm-360m", reduce=True, batch=2, prompt_len=8, new_tokens=2, data=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "smollm-360m", "--reduce", "--data", "2"])
    with pytest.raises(ValueError, match="replica count"):
        serve.serve("smollm-360m", reduce=True, device="cpu", data=0)
