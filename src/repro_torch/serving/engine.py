"""Continuous-batching serving engine: a request-level API over one captured step.

The port of ``repro/serving/engine.py``.  ``submit(Request) -> handle``
queues work; the scheduler seats requests into a fixed slot pool
(`serving.cache.SlotPool`) as slots free up.  ``step()`` advances every
admitted sequence one iteration:

  * chunked prefill and decode interleave in the SAME forward — one
    ``lm.decode_step`` call where prefilling slots carry up to
    ``prefill_chunk`` prompt tokens and decoding slots carry their one
    pending token, masked per slot by length + validity;
  * then up to ``decode_block - 1`` decode iterations sample ON DEVICE
    (greedy / temperature / top-k, per-slot knobs), writing into a device
    token buffer — no per-token host round-trip;
  * the host syncs exactly once per step (one device -> host copy of the
    token buffer and the emitted counts), asserted by
    ``stats["host_syncs"] == stats["steps"]``.

On the card the step is two CUDA graphs, captured once per engine (after an
eager warm-up on a side stream, which also builds the kernel library) over
static input and state buffers: the mixed forward at ``[n_slots,
prefill_chunk]`` with the first sample, and one decode iteration at
``[n_slots, 1]``.  Per step the host copies its slot tables into the static
buffers, replays the forward once and the decode graph ``n_decode - 1``
times (``n_decode = min(decode_block, largest budget)``, as the JAX host
computes it), then makes one device -> host copy.  The step index, the
alive mask, the lengths and the sample counters live on the device and are
updated inside the graphs; ``stats["graph_captures"]`` stays 2 for the
engine's lifetime whatever the traffic (the JAX package's ``step_traces ==
1``).  A capture or replay failure raises; there is no quiet eager path.

Data-parallel serving (``pc.data``: D replica processes, each the W-rank
model group, as the JAX package serves on its ``(pod, data, model)`` mesh)
is one logical engine.  Every replica runs the same :class:`Scheduler`
over all ``n_slots`` on the same submitted requests, so admission is the
reference's (lowest free slot first); the slot pool, the device tables and
the token buffer hold only this replica's ``n_slots / D`` rows
(:class:`~repro_torch.serving.cache.SlotPool`), and the parameters are its
blocks, each layer gathered at its use inside ``lm.decode_step``.  The
host builds the global tables, uploads this replica's rows, and runs the
same number of ``lm.decode_step`` calls on every replica (``n_decode``
from the global tables: each call's gathers are collectives, so a replica
with no slot in use runs the step too).  The step's one host sync is the
device -> host copy followed by one ``data.all_gather`` of every replica's
rows of the token buffer and emitted counts, which also carries a digest
of each replica's scheduler state (queue, slots, prompt cursors, cache
lengths, generated counts): if the digests differ, the replicas' schedulers
have diverged and the step raises.  Under ``pc.data`` the engine captures
nothing, by design: a CUDA graph cannot hold the gloo collectives of the
use-time gathers (``DistWorld`` over gloo, ``GLOO_CUDA_STAGING``), and NCCL
cannot put two ranks on one card.  So ``capture=None`` runs the step
eagerly and ``capture=True`` raises ValueError; capturing each layer
between its gathers is later speed work.  ``pc.tune`` is refused with
data (ValueError): each replica would time its own candidates and could
resolve other decode channels than its peers.

One difference from the JAX step: its ``while_loop`` also stops as soon as
no slot is alive.  The port replays the decode graph ``n_decode - 1`` times
whatever, with dead slots masked (``q_valid = 0``: their caches, states and
lengths stay as they were, and their samples are dropped), which gives the
same tokens.

Over a TP world of processes (``World(..., procs=)``, one card each) every
process runs the same engine on the same requests (SPMD: the logits after
each collective are the same on every process, so are the schedulers), and
the step runs eagerly: ``capture=None`` resolves to eager, ``capture=True``
raises ValueError.

On a CPU context (``device="cpu"``, asked for explicitly) the same step
functions run eagerly; ``capture=False`` runs them eagerly on the card too,
for the captured-vs-eager check only.

``poll(handle)`` reads a request's progress, ``step()``'s return value is
the streaming surface ({handle: new tokens}), and ``drain()`` runs steps to
completion.  ``generate(prompts, max_new_tokens)`` keeps the padded-batch
convenience surface on top.

Sampling is reproducible per request: the Gumbel noise of a slot's n-th
sample is a counter-based hash of ``(request.seed, n, token id)``, so
results depend neither on which other requests share the batch nor on step
boundaries, and no generator state lives inside the graphs.  The JAX
package's threefry bits are not reproduced; the distribution is.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.models import lm
from repro_torch.serving.cache import SlotPool
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["ServeEngine", "Request", "sample", "gumbel_noise", "decode_gemm_shapes"]

_TOPK_MAX = 64  # static width of the top-k threshold lattice (clamped to V)
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of int64 values in [0, 2**32): xor-shift-multiply
    rounds whose constants are below 2**31, so no int64 product overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def gumbel_noise(seeds: torch.Tensor, counters: torch.Tensor, vocab: int) -> torch.Tensor:
    """Standard Gumbel noise [S, vocab] (float32), a pure function of each
    row's (seed, counter) and the token id."""
    row = _mix32(_mix32(seeds & _M32) ^ (counters & _M32))  # [S]
    v = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    bits = _mix32(_mix32((row[:, None] + v[None, :] * _GOLDEN) & _M32))
    u = ((bits >> 8).float() + 0.5) * 2.0**-24  # uniform in (0, 1)
    return -torch.log(-torch.log(u))


def sample(logits, temp, topk, seeds, counters) -> torch.Tensor:
    """Per-slot on-device sampling. logits [S, V] f32; temp [S] f32; topk,
    seeds, counters [S] int64 -> tokens [S] int64.  Greedy where temp <= 0;
    else the top-k truncated (top_k == 0: none), temperature-scaled
    categorical, drawn as the argmax of logits / T plus Gumbel noise."""
    greedy = logits.argmax(-1)
    kmax = min(logits.shape[-1], _TOPK_MAX)
    vals = torch.topk(logits, kmax, dim=-1).values  # [S, kmax] sorted desc
    thresh = vals.gather(1, (topk - 1).clamp(0, kmax - 1)[:, None])
    masked = logits.masked_fill((topk > 0)[:, None] & (logits < thresh), float("-inf"))
    scaled = masked / temp.clamp_min(1e-6)[:, None]
    sampled = (scaled + gumbel_noise(seeds, counters, logits.shape[-1])).argmax(-1)
    return torch.where(temp > 0, sampled, greedy)


def decode_gemm_shapes(cfg, tp: int, n_slots: int) -> Dict[str, tuple]:
    """The per-rank operand shapes of a decode step's TP GEMMs, by name:
    ``(kind, (x_shape, w_shape))`` for the qkv and attention-output
    projections and, with a dense MLP, its gate|up and down projections
    (``n_slots`` rows of one token), as the JAX package's engine lists them."""
    from repro_torch.nn.attention import layout

    lay = layout(cfg, tp)
    hd, d, s = cfg.hd, cfg.d_model, n_slots
    gemms = {
        "qkv": ("ag_matmul", ((s, 1, d), (d, (lay.h_loc + 2 * lay.kv_loc) * hd))),
        "attn_out": ("matmul_rs", ((s, 1, lay.h_loc * hd), (lay.h_loc * hd, d))),
    }
    if cfg.d_ff:
        f_loc = max(1, cfg.d_ff // tp)
        gemms["ffn_gu"] = ("ag_matmul", ((s, 1, d), (d, 2 * f_loc)))
        gemms["ffn_down"] = ("matmul_rs", ((s, 1, f_loc), (f_loc, d)))
    return gemms


def _digest(sch: Scheduler) -> int:
    """A 63-bit digest of a scheduler's state: the requests submitted, the
    queue, and each seated request's slot, prompt cursor, cache length and
    generated count (what the next step's tables are built from)."""
    state = (len(sch.states), list(sch.queue),
             [(i, st.rid, st.pos, st.cache_len, len(st.generated)) for i, st in sch.active()])  # fmt: skip
    return int.from_bytes(hashlib.blake2b(repr(state).encode(), digest_size=8).digest(), "little") >> 1


# rows of the int64 slot table the host uploads every step
_FIELDS = ("lens", "valid", "active", "budget", "eos", "topk", "seeds", "nsamp")


@dataclasses.dataclass
class ServeEngine:
    """Request-level continuous-batching engine over ``lm.decode_step``."""

    cfg: object
    pc: object
    params: object
    max_len: int = 512
    temperature: float = 0.0  # default for the generate() convenience path
    n_slots: int = 8
    prefill_chunk: int = 16
    decode_block: int = 32
    cache_dtype: object = None
    capture: Optional[bool] = None  # None: capture on the card; False: eager (the captured-vs-eager check)

    def __post_init__(self):
        cfg, pc = self.cfg, self.pc
        dev = pc.device
        if self.cache_dtype is None:
            self.cache_dtype = self.params["embed"].dtype
        if self.decode_block < 1:
            raise ValueError(f"decode_block must be >= 1, got {self.decode_block}")
        # ring-buffer (sliding window) layers cap the prefill chunk: a chunk
        # wider than the ring would overwrite rows its own queries still need
        rings = [min(self.max_len, d.window) for d in lm.layer_plan(cfg) if d.window is not None]
        self.prefill_chunk = max(1, min([self.prefill_chunk, self.max_len] + rings))
        if pc.data is not None:
            if self.capture:
                raise ValueError(
                    "no CUDA-graph capture under pc.data: a graph cannot hold the gloo collectives of the use-time "
                    "gathers, and NCCL cannot put two ranks on one card; the data-parallel engine steps eagerly"
                )
            if pc.tune:
                raise ValueError("pc.tune with pc.data: each replica would time its own decode channels")
            self.capture = False
        if pc.world.nprocs > 1:
            if self.capture:
                raise ValueError(
                    "no CUDA-graph capture over a TP world of processes: a graph would hold one process's NCCL "
                    "collectives and peer pushes; the engine steps eagerly there (capture across cards: ROADMAP "
                    "queue 1 item 1 (d))"
                )
            self.capture = False
        if self.capture is None:
            self.capture = dev.type == "cuda"
        if self.capture and dev.type != "cuda":
            raise ValueError("CUDA-graph capture needs a context on the card; pass capture=False on the CPU")
        self.scheduler = Scheduler(self.n_slots)
        self.pool = SlotPool(cfg, pc, self.n_slots, self.max_len, self.cache_dtype)
        self.stats = {"steps": 0, "host_syncs": 0, "resets": 0, "graph_captures": 0, "decode_calls": 0,
                      "launches": {name: 0 for name in K.WRAPPERS}}  # fmt: skip
        n, c, dmax = self.pool.n_loc, self.prefill_chunk, self.decode_block  # this replica's rows
        i64 = dict(dtype=torch.int64, device=dev)
        # static inputs, written from the host each step (one int64 table + the temperatures)
        self._ints = torch.zeros((len(_FIELDS) * n + n * c,), **i64)
        self._temp = torch.zeros((n,), dtype=torch.float32, device=dev)
        self._tab = dict(zip(_FIELDS, self._ints[: len(_FIELDS) * n].view(len(_FIELDS), n)))
        self._tokens = self._ints[len(_FIELDS) * n :].view(n, c)
        # device loop state and the output (the token buffer, then the emitted counts)
        self._t = torch.zeros((1,), **i64)
        self._tok = torch.zeros((n,), **i64)
        self._alive = torch.zeros((n,), dtype=torch.bool, device=dev)
        self._lens = torch.zeros((n,), **i64)
        self._ns = torch.zeros((n,), **i64)
        self._out = torch.full((n, dmax + 1), -1, **i64)
        pin = dev.type == "cuda"
        self._ints_h = torch.zeros(self._ints.shape, dtype=torch.int64, pin_memory=pin)
        self._temp_h = torch.zeros(self._temp.shape, dtype=torch.float32, pin_memory=pin)
        self._out_h = torch.zeros(self._out.shape, dtype=torch.int64, pin_memory=pin)
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self._graph_launches: Dict[str, Dict[str, int]] = {}
        # decode-shape winners resolve here, before the capture (nothing can be timed inside one)
        self.decode_channels = self._warm_decode_channels() if pc.tune else {}
        if self.capture:
            self._capture()

    # ------------------------------------------------------ the device step
    def _forward(self):
        """The mixed forward, the first sample of every slot and the loop state."""
        n, c, dmax = self.pool.n_loc, self.prefill_chunk, self.decode_block
        tab = self._tab
        logits, _ = lm.decode_step(self.params, self.pool.caches, self.cfg, self.pc, self._tokens, tab["lens"],
                                   q_valid=tab["valid"])  # fmt: skip
        idx = (tab["valid"] - 1).clamp(0, c - 1)
        last = logits.gather(1, idx[:, None, None].expand(n, 1, logits.shape[-1]))[:, 0].float()
        tok0 = sample(last, self._temp, tab["topk"], tab["seeds"], tab["nsamp"])
        alive = (tab["active"] != 0) & (tab["budget"] > 0)
        self._ns.copy_(tab["nsamp"] + alive)
        self._lens.copy_(tab["lens"] + tab["valid"])
        self._out.fill_(-1)
        self._out[:, 0] = tok0.masked_fill(~alive, -1)
        self._out[:, dmax] = alive.long()
        self._alive.copy_(alive & (tok0 != tab["eos"]) & (tab["budget"] > 1))
        self._tok.copy_(tok0)
        self._t.fill_(1)

    def _decode(self):
        """One decode iteration over every slot, dead slots masked."""
        n, dmax = self.pool.n_loc, self.decode_block
        tab, alive = self._tab, self._alive
        lg, _ = lm.decode_step(self.params, self.pool.caches, self.cfg, self.pc, self._tok[:, None], self._lens,
                               q_valid=alive.long())  # fmt: skip
        nt = sample(lg[:, 0].float(), self._temp, tab["topk"], tab["seeds"], self._ns)
        self._lens.add_(alive)
        self._ns.add_(alive)
        # the column stays in bounds even when a drained engine is replayed past its block
        col = self._t.remainder(dmax).expand(n)[:, None]
        self._out[:, :dmax].scatter_(1, col, nt.masked_fill(~alive, -1)[:, None])
        emitted = self._out[:, dmax]
        emitted.add_(alive)
        self._alive.copy_(alive & (nt != tab["eos"]) & (emitted < tab["budget"]))
        self._tok.copy_(nt)
        self._t.add_(1)

    def _capture(self):
        """Warm up eagerly on a side stream (the static inputs describe an
        idle pool, so nothing is written), then capture both graphs."""
        dev = self.pc.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._forward()
                self._decode()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        pool = None
        for name, fn in (("forward", self._forward), ("decode", self._decode)):
            graph = torch.cuda.CUDAGraph()
            before = K.launch_counts()
            with torch.cuda.graph(graph, pool=pool):
                fn()
            self._graph_launches[name] = {k: v - before[k] for k, v in K.launch_counts().items()}
            pool = graph.pool()
            self.graphs[name] = graph
            self.stats["graph_captures"] += 1

    def _warm_decode_channels(self) -> Dict[str, object]:
        """Resolve the decode-shape winners of this engine's four TP GEMMs
        (:func:`decode_gemm_shapes`).

        Decode GEMMs (``n_slots`` rows of one token) sit in another corner
        of the space than prefill shapes; ``signature(..., decode=True)``
        keys them apart, so the cache holds both.  They resolve in
        ``__init__``, before the two graphs are captured: on the card the
        default ranker times the candidates on the context's kernels, which
        a capture could not do.  The captured decode step runs the per-rank
        GEMMs of ``lm.decode_step``, as the untuned step does, so it
        launches nothing new; the winners wait in the cache (and in
        ``decode_channels``) for the collective ops at these shapes.
        """
        from repro_torch import tune

        pc = self.pc
        dtype = self.params["embed"].dtype
        return {
            name: tune.resolve_channel(
                kind, sig=tune.signature(kind, shapes, decode=True), world=pc.world, axis=pc.channel.axis,
                backend=pc.backend, dtype=dtype, base=pc.channel, ranker=pc.tune_ranker, space=tune.JOINT_SPACE,
            )  # fmt: skip
            for name, (kind, shapes) in decode_gemm_shapes(self.cfg, pc.tp, self.n_slots).items()
        }

    def run(self, name: str) -> None:
        """One ``"forward"`` or ``"decode"`` part of a step: a graph replay on
        a capturing engine, else the eager call.  Replaying ``"decode"`` on a
        drained engine (every slot dead) changes nothing that a later step
        reads."""
        if self.graphs:
            self.graphs[name].replay()
            launched = self._graph_launches[name]
        else:
            before = K.launch_counts()
            (self._forward if name == "forward" else self._decode)()
            launched = {k: v - before[k] for k, v in K.launch_counts().items()}
        for k, v in launched.items():
            self.stats["launches"][k] += v
        self.stats["decode_calls"] += 1

    def _upload(self, rows: Dict[str, np.ndarray], tokens: np.ndarray, temp: np.ndarray) -> None:
        """This replica's rows of the step's global slot tables into the static inputs."""
        ints = self._ints_h.numpy()
        n, mine = self.pool.n_loc, slice(self.pool.first, self.pool.first + self.pool.n_loc)
        for i, f in enumerate(_FIELDS):
            ints[i * n : (i + 1) * n] = rows[f][mine]
        ints[len(_FIELDS) * n :] = tokens[mine].reshape(-1)
        self._temp_h.numpy()[:] = temp[mine]
        self._ints.copy_(self._ints_h, non_blocking=True)
        self._temp.copy_(self._temp_h, non_blocking=True)

    def _fetch(self, digest: int) -> np.ndarray:
        """The step's one host sync: the token buffer and the emitted counts of
        every slot, [n_slots, decode_block + 1].  Under ``pc.data`` each
        replica's rows and its scheduler ``digest`` are joined by one
        all-gather, and diverged digests raise."""
        self._out_h.copy_(self._out, non_blocking=True)
        if self.pc.device.type == "cuda":
            torch.cuda.current_stream(self.pc.device).synchronize()
        self.stats["host_syncs"] += 1
        data = self.pc.data
        if data is None:
            return self._out_h.numpy()
        n = self.pool.n_loc
        buf = torch.zeros((n + 1, self._out_h.shape[1]), dtype=torch.int64)  # the rows, then the digest
        buf[:n] = self._out_h
        buf[n, 0] = digest
        out = data.all_gather(buf, 0).view(data.size, n + 1, -1)  # a host tensor: gloo's, whatever the staging
        digests = out[:, n, 0].tolist()
        if len(set(digests)) != 1:
            raise RuntimeError(f"the data replicas' schedulers diverged: state digests {digests} by rank")
        return out[:, :n].reshape(self.n_slots, -1).numpy()

    # ------------------------------------------------------------------ host
    def submit(self, req: Request) -> int:
        """Queue a request; returns a handle for poll()/drain()."""
        n_prompt = int(np.asarray(req.tokens).reshape(-1).shape[0])
        if n_prompt == 0:
            raise ValueError("empty prompt")
        if n_prompt + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({n_prompt}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds the engine max_len ({self.max_len})"
            )
        return self.scheduler.submit(req)

    def _admit(self) -> None:
        for slot in self.scheduler.admit():
            self.pool.reset(slot)
            self.stats["resets"] += 1

    def step(self) -> Dict[int, List[int]]:
        """Advance every admitted sequence one iteration.

        Returns {handle: tokens emitted this step} — the streaming surface.
        Exactly one host sync regardless of how many tokens were decoded.
        """
        self._admit()
        sch = self.scheduler
        if not any(r is not None for r in sch.slots):
            return {}
        n, c, dmax = self.n_slots, self.prefill_chunk, self.decode_block
        rows = {f: np.zeros((n,), np.int64) for f in _FIELDS}
        rows["eos"][:] = -1
        tokens = np.zeros((n, c), np.int64)
        temp = np.zeros((n,), np.float32)
        for i, st in sch.active():
            req = st.request
            rows["lens"][i] = st.cache_len
            rows["budget"][i] = st.remaining
            rows["eos"][i] = -1 if req.eos_id is None else req.eos_id
            temp[i] = req.temperature
            rows["topk"][i] = req.top_k
            rows["seeds"][i] = req.seed
            rows["nsamp"][i] = len(st.generated)
            if st.pos < len(st.prompt):
                take = min(c, len(st.prompt) - st.pos)
                tokens[i, :take] = st.prompt[st.pos : st.pos + take]
                rows["valid"][i] = take
                st.pos += take
                rows["active"][i] = st.pos == len(st.prompt)
            else:
                tokens[i, 0] = st.pending
                rows["valid"][i] = 1
                rows["active"][i] = 1
        n_decode = int(min(dmax, max([0] + [int(rows["budget"][i]) for i, _ in sch.active() if rows["active"][i]])))

        digest = _digest(sch) if self.pc.data is not None else 0
        self._upload(rows, tokens, temp)
        self.run("forward")
        for _ in range(n_decode - 1):
            self.run("decode")
        out = self._fetch(digest)
        buf, emitted = out[:, :dmax], out[:, dmax]
        self.stats["steps"] += 1

        results: Dict[int, List[int]] = {}
        finished = []
        for i, st in sch.active():
            e = int(emitted[i])
            st.cache_len += int(rows["valid"][i]) + max(0, e - 1)
            if e:
                toks = buf[i, :e].tolist()
                st.generated.extend(toks)
                results[st.rid] = toks
                hit_eos = st.request.eos_id is not None and toks[-1] == st.request.eos_id
                if hit_eos or st.remaining <= 0:
                    st.done = True
                    finished.append(i)
        for i in finished:
            sch.release(i)
        return results

    def poll(self, handle: int) -> Dict[str, object]:
        """Progress of one request: done flag, tokens so far, queue state."""
        st = self.scheduler.states[handle]
        return {"done": st.done, "tokens": list(st.generated), "queued": st.slot is None and not st.done}

    def drain(self, handles=None, max_steps: int = 100_000):
        """Run step() until the given (default: all) requests finish."""
        if handles is None:
            handles = list(self.scheduler.states)
        for _ in range(max_steps):
            if all(self.scheduler.states[h].done for h in handles):
                break
            if not self.scheduler.has_work:
                break
            self.step()
        return {h: np.asarray(self.scheduler.states[h].generated, np.int32) for h in handles}

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 32, seed: int = 0) -> np.ndarray:
        """Convenience surface: prompts [B, S0] (already padded, pads attend
        as real tokens); returns [B, S0 + max_new_tokens] with exactly
        ``max_new_tokens`` new tokens per row."""
        prompts = np.asarray(prompts, np.int32)
        _, s0 = prompts.shape
        if s0 + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        handles = [
            self.submit(Request(tokens=row, max_new_tokens=max_new_tokens, temperature=self.temperature, seed=seed + i))
            for i, row in enumerate(prompts)
        ]
        outs = self.drain(handles)
        gen = np.stack([outs[h] for h in handles])
        return np.concatenate([prompts, gen], axis=1)
