"""The port's continuous-batching engine (``repro_torch.serving``) on the CPU.

Greedy streams are held token for token against per-token JAX reference
decoding (the ``_ref_greedy`` pattern of ``tests/test_serving.py``: the
prompt fed one token at a time through ``lm.decode_step``, then argmax),
not against the JAX engine (its contract test is an unusable oracle, see
ROADMAP queue 3).  Reduced smollm-360m, granite-moe-3b-a800m,
deepseek-moe-16b (with ``moe_decode_stream`` on both sides, as the serve
CLI's ``--moe-stream`` runs it) and mamba2-2.7b in float32, weights carried
across by ``convert.from_jax_params``.

Also: the port's ``Scheduler`` against ``repro.serving.scheduler``; the
sampler (reproducible per (seed, count), batch-independent, top-k and
greedy limits, and frequencies against softmax(logits / T) by a chi-square
bound); the capture-safe decode writes (a row with ``q_valid = 0`` leaves
its KV rows and SSM / conv state bitwise unchanged); one host sync per
step; and the device policy of the engine's entry points.
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
from repro.serving import scheduler as jsched
from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.serving import Request, Scheduler, ServeEngine, SlotPool
from repro_torch.serving.engine import gumbel_noise, sample
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

ARCHS = ("smollm-360m", "granite-moe-3b-a800m", "deepseek-moe-16b", "mamba2-2.7b")
STREAMED = ("deepseek-moe-16b",)  # served with the streamed MoE decode
VOCAB, MAX_LEN = 128, 40
# prompt lengths that do not divide the prefill chunk (4); three requests on two slots
PROMPTS = (5, 11, 7)
BUDGETS = (6, 3, 5)


@pytest.fixture(scope="module", params=ARCHS)
def model(request, pc8, mesh8):
    arch = request.param
    stream = arch in STREAMED
    pc8 = dataclasses.replace(pc8, moe_decode_stream=stream)
    jcfg = dataclasses.replace(j_reduce_config(j_get_config(arch)), vocab_size=VOCAB)
    cfg = dataclasses.replace(reduce_config(get_config(arch)), vocab_size=VOCAB)
    jparams = place(jlm.init(jax.random.PRNGKey(4), jcfg, pc8, jnp.float32), mesh8, jlm.specs(jcfg, pc8))
    world = World(4, "cpu")
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, world)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32) for n in PROMPTS]
    step = jax.jit(lambda p, c, t, n: jlm.decode_step(p, c, jcfg, pc8, t, n))

    def ref_greedy(prompt, n_new):
        """Per-token JAX reference: the prompt one token at a time, then
        greedy decoding (batch 2, both rows the same prompt)."""
        caches = jlm.init_caches(jcfg, pc8, 2, MAX_LEN, jnp.float32)
        lg = None
        for t, tok in enumerate(prompt):
            lg, caches = step(jparams, caches, jnp.full((2, 1), tok, jnp.int32), t)
        out = []
        for i in range(n_new):
            out.append(int(jnp.argmax(lg[0, 0])))
            lg, caches = step(jparams, caches, jnp.full((2, 1), out[-1], jnp.int32), len(prompt) + i)
        return out

    refs = [ref_greedy(p, m) for p, m in zip(prompts, BUDGETS)]
    return cfg, params, ParallelContext(world=world, moe_decode_stream=stream), prompts, refs, ref_greedy


def _engine(cfg, params, pc, **kw):
    kw = {"max_len": MAX_LEN, "n_slots": 2, "prefill_chunk": 4, "decode_block": 4, **kw}
    return ServeEngine(cfg, pc, params, **kw)


def test_greedy_streams_match_per_token_reference(model):
    """Mid-run admission (three requests on two slots), exact budgets, and
    prefill chunks interleaved with decode in one forward."""
    cfg, params, pc, prompts, refs, _ = model
    eng = _engine(cfg, params, pc)
    handles = [eng.submit(Request(tokens=p, max_new_tokens=m)) for p, m in zip(prompts, BUDGETS)]
    assert [eng.poll(h)["queued"] for h in handles] == [True, True, True]
    streamed = {h: [] for h in handles}
    for h, toks in eng.step().items():
        streamed[h].extend(toks)
    assert eng.poll(handles[2])["queued"]  # no free slot yet
    outs = eng.drain()
    for h, ref, m in zip(handles, refs, BUDGETS):
        assert outs[h].tolist() == ref and len(ref) == m
        assert eng.poll(h) == {"done": True, "tokens": ref, "queued": False}
    assert eng.stats["host_syncs"] == eng.stats["steps"] > 0
    assert eng.stats["resets"] == 3 and eng.stats["graph_captures"] == 0
    assert all(s is None for s in eng.scheduler.slots)


def test_eos_stops_a_request_and_is_included(model):
    cfg, params, pc, prompts, _, ref_greedy = model
    ref = ref_greedy(prompts[1], 8)
    eos = ref[3]
    want = ref[: ref.index(eos) + 1]
    eng = _engine(cfg, params, pc)
    h_eos = eng.submit(Request(tokens=prompts[1], max_new_tokens=8, eos_id=eos))
    h_other = eng.submit(Request(tokens=prompts[0], max_new_tokens=4))
    outs = eng.drain()
    assert outs[h_eos].tolist() == want
    assert len(outs[h_other]) == 4


def test_generate_matches_per_token_reference(model):
    cfg, params, pc, prompts, _, ref_greedy = model
    batch = np.stack([prompts[0], prompts[2][:5]])
    out = _engine(cfg, params, pc, decode_block=32).generate(batch, max_new_tokens=5)
    assert out.shape == (2, 10)
    np.testing.assert_array_equal(out[:, :5], batch)
    for row, prompt in zip(out, batch):
        assert row[5:].tolist() == ref_greedy(prompt, 5)


def test_sampled_request_is_independent_of_batch_and_step_boundaries(model):
    """A sampled request gives the same tokens alone and beside others, and
    over other decode blocks (the same slot, so the same shapes)."""
    cfg, params, pc, prompts, _, _ = model
    req = Request(tokens=prompts[1], max_new_tokens=9, temperature=0.9, top_k=20, seed=1234)
    runs = []
    for decode_block, others in ((4, 0), (4, 2), (3, 2)):
        eng = _engine(cfg, params, pc, n_slots=3, decode_block=decode_block)
        h = eng.submit(req)
        for i in range(others):
            eng.submit(Request(tokens=prompts[2 * i], max_new_tokens=5, temperature=0.5, seed=i))
        runs.append(eng.drain()[h].tolist())
    assert runs[0] == runs[1] == runs[2] and len(runs[0]) == 9


def test_scheduler_decisions_match_reference():
    """A seeded submit / admit / release sequence: the port's Scheduler and
    the JAX package's seat and release the same requests in the same slots."""
    rng = np.random.default_rng(3)
    ours, ref = Scheduler(3), jsched.Scheduler(3)
    for _ in range(60):
        op = rng.integers(0, 3)
        if op == 0:
            toks = rng.integers(0, 50, size=int(rng.integers(1, 6)))
            m = int(rng.integers(1, 9))
            assert ours.submit(Request(tokens=toks, max_new_tokens=m)) == ref.submit(
                jsched.Request(tokens=toks, max_new_tokens=m)
            )
        elif op == 1:
            assert ours.admit() == ref.admit()
        else:
            slot = int(rng.integers(0, 3))
            ours.release(slot)
            ref.release(slot)
        assert ours.slots == ref.slots and list(ours.queue) == list(ref.queue)
        assert [(i, s.rid) for i, s in ours.active()] == [(i, s.rid) for i, s in ref.active()]
        assert ours.has_work == ref.has_work


# ---- sampling --------------------------------------------------------------


def _logits(rows, vocab, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((rows, vocab)).astype(np.float32) * 2)


def _knobs(rows, temp, topk, seed0=0, counter=0):
    return (torch.full((rows,), temp, dtype=torch.float32), torch.full((rows,), topk, dtype=torch.int64),
            torch.arange(seed0, seed0 + rows, dtype=torch.int64), torch.full((rows,), counter, dtype=torch.int64))  # fmt: skip


def test_sampling_is_reproducible_per_seed_and_counter():
    lg = _logits(64, 50)
    a = sample(lg, *_knobs(64, 0.8, 0))
    assert torch.equal(a, sample(lg, *_knobs(64, 0.8, 0)))
    assert not torch.equal(a, sample(lg, *_knobs(64, 0.8, 0, seed0=1000)))
    assert not torch.equal(a, sample(lg, *_knobs(64, 0.8, 0, counter=1)))
    # the noise is a function of (seed, counter, token id) alone
    noise = gumbel_noise(torch.tensor([7, 7, 8]), torch.tensor([3, 3, 3]), 50)
    assert torch.equal(noise[0], noise[1]) and not torch.equal(noise[0], noise[2])


def test_sampling_is_independent_of_the_batch():
    lg = _logits(32, 40)
    temp, topk, seeds, ctr = _knobs(32, 0.7, 5)
    temp[::3] = 0.0
    topk[1::4] = 0
    batched = sample(lg, temp, topk, seeds, ctr)
    for i in range(32):
        alone = sample(lg[i : i + 1], temp[i : i + 1], topk[i : i + 1], seeds[i : i + 1], ctr[i : i + 1])
        assert alone.item() == batched[i].item()
    perm = torch.randperm(32, generator=torch.Generator().manual_seed(0))
    assert torch.equal(sample(lg[perm], temp[perm], topk[perm], seeds[perm], ctr[perm]), batched[perm])


def test_greedy_limits_of_sampling():
    """temperature 0 and top_k == 1 are both greedy."""
    lg = _logits(256, 300)
    greedy = lg.argmax(-1)
    assert torch.equal(sample(lg, *_knobs(256, 0.0, 0)), greedy)
    assert torch.equal(sample(lg, *_knobs(256, 0.0, 7)), greedy)
    assert torch.equal(sample(lg, *_knobs(256, 1.5, 1)), greedy)


def test_top_k_never_draws_outside_the_top_k():
    lg = _logits(4000, 200, seed=2)
    for k in (3, 10, 64, 100):
        tok = sample(lg, *_knobs(4000, 5.0, k))
        kk = min(k, 64)  # the static top-k lattice, as in the JAX package
        top = torch.topk(lg, kk, dim=-1).indices
        assert (top == tok[:, None]).any(-1).all(), k


@pytest.mark.parametrize("temp,topk", [(0.7, 0), (1.3, 5)])
def test_sampling_frequencies_match_softmax(temp, topk):
    """20000 draws (one per seed) from one 16-token row: the chi-square
    statistic against softmax(logits / T) over the kept tokens must stay
    below its 1 - 1e-6 quantile (56.49 for 15 degrees of freedom, 33.38
    for 4), so a correct sampler fails this about once in a million runs."""
    n, v = 20000, 16
    row = _logits(1, v, seed=5)[0] * 0.5
    tok = sample(row.expand(n, v).contiguous(), *_knobs(n, temp, topk))
    keep = torch.ones(v, dtype=torch.bool)
    if topk:
        keep[:] = False
        keep[torch.topk(row, topk).indices] = True
    p = torch.softmax((row / temp).masked_fill(~keep, float("-inf")), -1).double()
    counts = torch.bincount(tok, minlength=v).double()
    assert counts[~keep].sum() == 0
    expected = n * p[keep]
    chi2 = ((counts[keep] - expected) ** 2 / expected).sum().item()
    assert chi2 < {15: 56.49, 4: 33.38}[int(keep.sum()) - 1], chi2


# ---- capture-safe decode writes ----------------------------------------------


def _cfg(name):
    cfg = dataclasses.replace(reduce_config(get_config(name.removesuffix("-ring"))), vocab_size=VOCAB)
    if name.endswith("-ring"):  # sliding-window layers with a ring cache smaller than max_len
        cfg = dataclasses.replace(cfg, pattern=("attn_local", "attn"), local_window=8)
    return cfg


@pytest.mark.parametrize(
    "name", ["smollm-360m", "smollm-360m-ring", "granite-moe-3b-a800m", "deepseek-moe-16b", "mamba2-2.7b"]
)
@pytest.mark.parametrize("lens", [(3, 9, 14), (3, 9, 17)], ids=["inside", "edge"])
def test_masked_rows_leave_caches_bitwise_unchanged(name, lens):
    """decode_step with C = 4 and q_valid (4, 0, 2): the slot with no real
    row keeps every cache row and its SSM / conv state bit for bit, and no
    cache row outside the real rows' positions changes.  Inside the cache,
    the real rows' logits and cache writes are bitwise those of the
    unmasked call (the old nonzero write, now made with a fixed shape); at
    the edge (17 + 4 > 20 rows), the masked rows' positions fall past the
    cache and are not written."""
    cfg = _cfg(name)
    world = World(4, "cpu")
    pc = ParallelContext(world=world)
    params = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)
    g = torch.Generator().manual_seed(1)
    caches = [{k: torch.randn(t.shape, generator=g) for k, t in c.items()} for c in lm.init_caches(cfg, pc, 3, 20)]
    before = [{k: t.clone() for k, t in c.items()} for c in caches]
    full = [{k: t.clone() for k, t in c.items()} for c in caches]
    toks = torch.randint(0, VOCAB, (3, 4), generator=g)
    lens, nv = torch.tensor(lens), torch.tensor([4, 0, 2])
    lg, _ = lm.decode_step(params, caches, cfg, pc, toks, lens, q_valid=nv)
    assert torch.isfinite(lg).all()
    inside = int(lens.max()) + 4 <= 20
    if inside:
        lg_full, _ = lm.decode_step(params, full, cfg, pc, toks, lens)
        for b in (0, 2):
            assert torch.equal(lg[b, : nv[b]], lg_full[b, : nv[b]])
    for d, c, c0, cf in zip(lm.layer_plan(cfg), caches, before, full):
        for k in c:
            assert torch.equal(c[k][:, 1], c0[k][:, 1]), (d.kind, k)  # the masked slot
        if d.kind == "mamba":
            for k in c:  # all four rows of slot 0 real: the state of the unmasked call
                assert not inside or torch.equal(c[k][:, 0], cf[k][:, 0]), k
            continue
        size = c["k"].shape[3]
        for b in (0, 2):
            written = torch.zeros(size, dtype=torch.bool)
            written[torch.remainder(lens[b] + torch.arange(int(nv[b])), size)] = True
            for k in ("k", "v"):
                assert torch.equal(c[k][:, b, :, ~written], c0[k][:, b, :, ~written])
                assert not torch.equal(c[k][:, b, :, written], c0[k][:, b, :, written])
                assert not inside or torch.equal(c[k][:, b, :, written], cf[k][:, b, :, written])


def test_slot_pool_reset_zeroes_one_slot_in_place():
    cfg = _cfg("mamba2-2.7b")
    pool = SlotPool(cfg, ParallelContext(world=World(4, "cpu")), 3, 16, torch.float32)
    ptrs = [t.data_ptr() for c in pool.caches for t in c.values()]
    for c in pool.caches:
        for t in c.values():
            t.fill_(1.0)
    pool.reset(1)
    assert [t.data_ptr() for c in pool.caches for t in c.values()] == ptrs
    for c in pool.caches:
        assert set(c) == {"ssm", "conv"}
        for t in c.values():
            assert (t[:, 1] == 0).all() and (t[:, 0] == 1).all() and (t[:, 2] == 1).all()
    with pytest.raises(IndexError):
        pool.reset(3)


# ---- policy ------------------------------------------------------------------


def test_engine_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the policy under test is the CUDA-less one")
    cfg = _cfg("smollm-360m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve("smollm-360m", reduce=True, batch=1, prompt_len=8, new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "smollm-360m", "--reduce", "--slots", "2"])
    world = World(4, "cpu")
    params = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)
    with pytest.raises(ValueError, match="capture"):
        ServeEngine(cfg, ParallelContext(world=world), params, max_len=16, capture=True)
    eng = ServeEngine(cfg, ParallelContext(world=world), params, max_len=16)
    assert not eng.capture and eng.graphs == {}
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(tokens=[1] * 10, max_new_tokens=7))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request(tokens=[], max_new_tokens=1))


def test_prefill_chunk_is_capped_by_the_ring():
    cfg = _cfg("smollm-360m-ring")
    world = World(4, "cpu")
    params = lm.init(cfg, world, torch.Generator().manual_seed(0), torch.float32)
    eng = ServeEngine(cfg, ParallelContext(world=world), params, max_len=32, prefill_chunk=16)
    assert eng.prefill_chunk == 8


def test_serve_cli_runs_the_engine_on_cpu(capsys):
    r = serve.main(["--arch", "smollm-360m", "--reduce", "--device", "cpu", "--dtype", "f32", "--batch", "3",
                    "--prompt-len", "6", "--new-tokens", "4", "--slots", "2", "--decode-block", "3",
                    "--temperature", "0.8", "--top-k", "5"])  # fmt: skip
    assert r["tokens"].shape == (3, 4) and r["host_syncs"] == r["steps"] and r["graph_captures"] == 0
    assert "tokens/s" in capsys.readouterr().out
