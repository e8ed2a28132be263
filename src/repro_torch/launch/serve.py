"""Serve entry point: seeded requests through the continuous-batching engine.

The port of ``repro/launch/serve.py``.  ``main`` / :func:`serve` submit
``--batch`` seeded requests to ``serving.ServeEngine`` (``--slots``,
``--decode-block``, per-request ``--temperature`` / ``--top-k`` /
``--eos-id``) and drain it: on the card one captured step per iteration
with one host sync.  :func:`greedy` is the fixed-batch path, ``lm.prefill``
(the fused kernels on the card) then a greedy ``decode_step`` loop.
Example, on the card (``--arch`` any registered config: smollm-360m,
qwen2-72b, starcoder2-7b, gemma3-27b, granite-moe-3b-a800m,
deepseek-moe-16b, mamba2-2.7b, zamba2-2.7b or paligemma-3b; the engine
serves text prompts, ``greedy(embeds=)`` takes an image prefix; an
encoder-decoder is refused, as in the JAX package):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \\
      --batch 16 --prompt-len 256 --new-tokens 16 --slots 8 --world 4 --dtype bf16

``--moe-stream`` sets ``ParallelContext.moe_decode_stream``: the MoE decode
streams each local expert once over all tokens instead of gathering expert
weights per (token, k).  deepseek-moe-16b needs it in the engine, whose
forward decodes [slots, 16] tokens at once (the gathers would copy a 17 MB
expert for each of them):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b --moe-stream \\
      --batch 8 --prompt-len 256 --new-tokens 32 --slots 4

Add ``--device cpu --reduce`` for a small run on the CPU.

``--data D`` serves with D data-parallel replicas of the W-rank model group
(the JAX package's ``make_dev_mesh()``: ``(pod, data, model)`` with pod x
data = D), one spawned process each (``launch/train.run_replicas``, joined
by a gloo :class:`~repro_torch.backend.mesh.DistWorld`, staged as
``launch/train.staging_for`` says).  Every replica makes the same seeded
prompts and submits the same requests to one logical engine: the slots are
split over the replicas, each stores only its block of every parameter the
data axes split (ZeRO-3, ``training.steps.data_blocks``), and each layer is
gathered at its use (``serving/engine.py``: no CUDA-graph capture under
data).  Rank 0 prints; ``serve`` returns its tokens and counters.
``--mode baseline`` runs the non-overlapped collectives (``ParallelContext``).
``--ckpt-dir`` restores the newest step that ``launch/train`` wrote (at any
D: its checkpoints hold the logical arrays), then places the parameters,
as the JAX package's serve CLI does:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --data 2 \\
      --batch 8 --prompt-len 64 --new-tokens 16 --slots 8 --decode-block 16 --ckpt-dir /path/to/ckpt

On the CPU: ``--data 2 --device cpu --reduce``.

``--procs P`` spreads the W tensor-parallel ranks over P processes (P
divides W), spawned as ``--data`` spawns its replicas: process p holds the
ranks ``[p W/P, (p + 1) W/P)`` on ``cuda:p`` (NCCL; gloo with ``--device
cpu``), builds the same seeded global weights and keeps its ranks' slices
(``convert.shard_params``), and the fused AG+GEMM / GEMM+RS push their
tiles into the peer cards' receive regions (``kernels/peer``).  Every
process serves the same requests (SPMD); rank 0 prints.  The engine steps
eagerly there (no CUDA-graph capture across cards), and only the dense
path is ported (attention with a dense MLP: smollm-360m, qwen2-72b,
starcoder2-7b, gemma3-27b).  On the card ``P`` beyond the visible cards
raises; nothing falls back to one card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --world 4 --procs 4 \\
      --batch 4 --prompt-len 256 --new-tokens 16 --slots 4
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.backend.mesh import DistWorld, World
from repro_torch.backend.target import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.serving import Request, ServeEngine
from repro_torch.training import init_opt_state
from repro_torch.training.optimizer import tree_map
from repro_torch.training.steps import data_blocks

__all__ = ["greedy", "serve", "serve_replica", "serve_tp", "run_tp", "serve_context", "serve_params", "make_prompts",
           "main"]  # fmt: skip

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# the JAX package's serve CLI refuses an encoder-decoder the same way
ENCDEC_REFUSED = (
    "serve.py drives decoder-only archs; enc-dec decode is exercised through models/encdec "
    "(encode, build_cross_caches, decode_step)"
)


def make_prompts(vocab: int, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """Seeded prompt tokens [batch, prompt_len] (int64)."""
    return np.random.default_rng(seed).integers(0, vocab, size=(batch, prompt_len), dtype=np.int64)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy(
    params, cfg, pc: ParallelContext, prompts: torch.Tensor, new_tokens: int, max_len: Optional[int] = None,
    embeds: Optional[torch.Tensor] = None,
):  # fmt: skip
    """Greedy continuation of ``prompts`` [B, S] after the stub frontend's
    prefix ``embeds`` [B, S0, D] (paligemma's image patches; None: text
    only): the first token from the prefill logits, each later one from a
    ``decode_step`` at position S0 + S + i.

    Returns (tokens [B, new_tokens], timings) with the prefill and decode
    seconds (host clock around work that ends in a device synchronise).
    Under ``pc.data`` (``params`` this replica's blocks) replica r decodes
    its rows r B/D .. (r+1) B/D of ``prompts`` (and ``embeds``), and the
    tokens are those rows'.
    """
    if pc.data is not None:
        prompts = pc.data.shard(prompts, 0)
        embeds = None if embeds is None else pc.data.shard(embeds, 0)
    s0 = prompts.shape[1] + (0 if embeds is None else embeds.shape[1])
    max_len = max_len or s0 + new_tokens
    dev = pc.device
    _sync(dev)
    t0 = time.perf_counter()
    lg, caches = lm.prefill(params, cfg, pc, prompts, embeds, max_len=max_len)
    tok = lg[:, -1].argmax(-1)
    _sync(dev)
    t1 = time.perf_counter()
    out = [tok]
    for i in range(new_tokens - 1):
        lg, caches = lm.decode_step(params, caches, cfg, pc, tok[:, None], s0 + i)
        tok = lg[:, 0].argmax(-1)
        out.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    timings = {"prefill_s": t1 - t0, "decode_s": t2 - t1, "decode_steps": new_tokens - 1}
    return torch.stack(out, dim=1), timings


def serve(
    arch: str,
    *,
    batch: int = 4,
    prompt_len: int = 256,
    new_tokens: int = 16,
    world: int = 4,
    dtype: str = "bf16",
    device=None,
    seed: int = 0,
    reduce: bool = False,
    slots: int = 8,
    decode_block: int = 32,
    temperature: float = 0.0,
    top_k: int = 0,
    eos_id: Optional[int] = None,
    moe_stream: bool = False,
    mode: str = "overlap",
    ckpt_dir: Optional[str] = None,
    data: int = 1,
    procs: int = 1,
) -> dict:
    """Build a seeded model (restored from ``ckpt_dir``'s newest step when
    it has one) and serve ``batch`` requests through the continuous-batching
    engine (``serving.ServeEngine``: a captured step on the card, the same
    step eagerly on the CPU).  Request i samples with seed ``seed + i``;
    ``moe_stream`` streams the MoE decode; ``mode`` is the
    ``ParallelContext``'s.  ``data`` > 1 serves with that many replica
    processes, ``procs`` > 1 spreads the W ranks over that many processes
    (module docstring).  Returns the tokens [batch, new_tokens]
    (-1 after an eos), the wall time of the drain and the engine's counters
    (rank 0's under ``data``, with "replicas": each process's peak device
    memory, placed parameter bytes, launch counts and data-transport
    payload)."""
    kw = dict(batch=batch, prompt_len=prompt_len, new_tokens=new_tokens, world=world, dtype=dtype, seed=seed,
              reduce=reduce, slots=slots, decode_block=decode_block, temperature=temperature, top_k=top_k,
              eos_id=eos_id, moe_stream=moe_stream, mode=mode, ckpt_dir=ckpt_dir)  # fmt: skip
    if procs != 1:
        if data != 1:
            raise ValueError(f"--procs {procs} with --data {data}: TP x data across processes is not ported "
                             "(ROADMAP queue 1 item 1 (d))")  # fmt: skip
        outs = run_tp(serve_tp, world, procs, device, args=(arch, kw))
        keys = ("peak_bytes", "placed_bytes", "launches", "data_bytes", "device")
        return {**outs[0], "processes": [{k: o[k] for k in keys} for o in outs]}
    if data == 1:
        return _serve(arch, device=device, dist=None, **kw)
    if data < 1:
        raise ValueError(f"--data {data}: the replica count must be >= 1")
    from repro_torch.launch import train as train_cli  # it imports this module

    dev = resolve_device(device)
    stage = train_cli.staging_for("gloo", dev)
    print(f"data axis: {data} replica processes over torch.distributed gloo, staging {stage or 'direct'}")
    outs = train_cli.run_replicas(serve_replica, data, device=dev, staging=stage, args=(arch, kw))
    keys = ("peak_bytes", "placed_bytes", "launches", "data_bytes")
    return {**outs[0], "replicas": [{k: o[k] for k in keys} for o in outs]}


def run_tp(target, world: int, procs: int, device=None, args=()) -> list:
    """``target(tp_world, *args)`` in ``procs`` spawned processes, each
    holding its block of the ``world`` TP ranks (``World(world, device,
    procs=)``) over ``launch/train.run_replicas``' spawn: NCCL with process
    p on ``cuda:p``, gloo on the CPU.  Raises unless ``procs`` divides
    ``world``, and on the card unless ``procs`` cards are visible.  Each
    process that returns releases its receive pools after a barrier (one
    that raises leaves them to the process's exit); returns the results
    by process."""
    from repro_torch.launch import train as train_cli  # it imports this module

    if procs < 1 or world % procs:
        raise ValueError(f"--procs {procs} must divide --world {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and procs > torch.cuda.device_count():
        raise ValueError(f"--procs {procs}: {torch.cuda.device_count()} CUDA device(s) visible; one process a card, "
                         "and nothing falls back to one card")  # fmt: skip
    backend = "nccl" if dev.type == "cuda" else "gloo"
    print(f"TP world of {world} ranks over {procs} processes ({world // procs} a process), torch.distributed {backend}")
    return train_cli.run_replicas(_tp_process, procs, device=dev, backend=backend, args=(target, world, args))


def _tp_process(dist: DistWorld, target, world: int, args) -> dict:
    """One process of :func:`run_tp`."""
    from repro_torch.kernels import peer

    tp = World(world, dist.device, procs=dist)
    out = target(tp, *args)  # a failure raises here, with no collective after it: its peers fail, not hang
    peer.release(dist.barrier)  # every process's last push has landed, then no process maps a peer's region
    return out


def serve_tp(tp: World, arch: str, kw: dict) -> dict:
    """One process of ``serve(procs=P)``: ``kw`` holds every keyword of
    :func:`serve` from ``batch`` to ``ckpt_dir``."""
    return _serve(arch, device=tp.device, dist=None, tp=tp, **kw)


def serve_replica(dist: DistWorld, arch: str, kw: dict) -> dict:
    """One replica of ``serve(data=D)``, in a process of ``dist``: ``kw``
    holds every keyword of :func:`serve` from ``batch`` to ``ckpt_dir``."""
    return _serve(arch, device=dist.device, dist=dist, **kw)


def serve_context(world, device, dist: Optional[DistWorld] = None, **kw) -> ParallelContext:
    """The serve CLI's context: W = ``world`` ranks on ``device`` (or
    ``world`` a :class:`World` over processes, used as it is); under
    ``dist`` (one replica's DistWorld) over ``make_dev_mesh(world,
    dist.size)`` with its data axes run by ``dist``.  ``kw``: further
    ``ParallelContext`` fields (``mode``, ``moe_decode_stream``)."""
    if isinstance(world, World):
        return ParallelContext(world=world, **kw)
    if dist is None:
        return ParallelContext(world=World(world, device), **kw)
    return make_dev_mesh(world, dist.size).context(device, data=dist, **kw)


def serve_params(cfg, pc: ParallelContext, dtype: str, seed: int = 0, ckpt_dir: Optional[str] = None,
                 log: bool = True):  # fmt: skip
    """The serve CLI's parameters: seeded (``seed``) in ``dtype``, replaced
    by the newest checkpoint in ``ckpt_dir`` where it has one (``launch/train``'s
    logical arrays, restored onto this world; printed as "loaded checkpoint
    step N" when ``log``), then under ``pc.data`` this replica's blocks
    (``training.steps.data_blocks``; a tied head's block from ``lm.with_tied``)."""
    w = pc.world
    params = lm.init(cfg, w, torch.Generator(device=w.device).manual_seed(seed), DTYPES[dtype])
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    step = mgr.latest_step() if mgr else None
    if step is not None:
        # the moments come along in the checkpoint: restored onto meta, so nothing of them is kept
        opt = init_opt_state(tree_map(lambda t: t.to("meta"), lm.trainable(params, cfg)))
        restored, _ = mgr.restore(step, {"params": params, "opt": opt}, cfg=cfg, world=w)
        params = restored["params"]
        if log:
            print(f"loaded checkpoint step {step}")
    if pc.data is not None:
        params = lm.with_tied(data_blocks(lm, cfg, pc, lm.trainable(params, cfg)), cfg)
    return params


def _serve(arch, *, batch, prompt_len, new_tokens, world, dtype, device, seed, reduce, slots, decode_block,
           temperature, top_k, eos_id, moe_stream, mode, ckpt_dir, dist: Optional[DistWorld],
           tp: Optional[World] = None) -> dict:  # fmt: skip
    """:func:`serve` in this process: one replica of ``dist``, one process of
    the TP world ``tp``, or the whole engine."""
    from repro_torch import kernels as K
    from repro_torch.backend.mesh import CommCounter
    from repro_torch.launch.train import device_bytes

    cfg = get_config(arch)
    if reduce:
        cfg = reduce_config(cfg)
    if cfg.encoder_layers:
        raise SystemExit(ENCDEC_REFUSED)
    pc = serve_context(tp or world, device, dist, mode=mode, moe_decode_stream=moe_stream)
    dev = pc.device
    lead = (dist is None or dist.rank == 0) and (tp is None or tp.procs.rank == 0)
    if (dist is not None or tp is not None) and dev.type == "cuda":  # one process of several: its peak from here
        torch.cuda.reset_peak_memory_stats(dev)
    launched = K.launch_counts()
    before = device_bytes(dev)
    params = serve_params(cfg, pc, dtype, seed, ckpt_dir, log=lead)
    placed = None if before is None else {k: v - before[k] for k, v in device_bytes(dev).items()}
    prompts = make_prompts(cfg.vocab_size, batch, prompt_len, seed)
    eng = ServeEngine(cfg, pc, params, max_len=prompt_len + new_tokens, temperature=temperature, n_slots=slots,
                      decode_block=decode_block)
    handles = [
        eng.submit(Request(tokens=p, max_new_tokens=new_tokens, temperature=temperature, top_k=top_k, eos_id=eos_id,
                           seed=seed + i))
        for i, p in enumerate(prompts)
    ]  # fmt: skip
    counter = CommCounter()
    _sync(dev)
    t0 = time.perf_counter()
    transport = dist if dist is not None else tp
    with transport.counting(counter) if transport is not None else contextlib.nullcontext():
        outs = eng.drain(handles)
    seconds = time.perf_counter() - t0
    tokens = np.full((batch, new_tokens), -1, np.int64)
    for i, h in enumerate(handles):
        tokens[i, : len(outs[h])] = outs[h]
    n_tok = sum(len(outs[h]) for h in handles)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {
        "tokens": tokens,
        "device": name,
        "backend": pc.backend,
        "seconds": seconds,
        "generated": n_tok,
        "tokens_per_s": n_tok / seconds,
        "steps": eng.stats["steps"],
        "host_syncs": eng.stats["host_syncs"],
        "graph_captures": eng.stats["graph_captures"],
        "launches": {k: v - launched[k] for k, v in K.launch_counts().items()},
        "data_bytes": {k: float(sum(v.values())) for k, v in counter.payload.items() if v},
        "placed_bytes": placed,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, help="a registered config, e.g. smollm-360m, mamba2-2.7b, zamba2-2.7b")
    ap.add_argument("--reduce", action="store_true", help="reduced same-family config (CPU runs)")
    ap.add_argument("--batch", type=int, default=4, help="requests submitted")
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--world", type=int, default=4,
                    help="tensor-parallel ranks (emulated on one device unless --procs)")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--device", default=None, help="default: cuda (raises when absent)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8, help="engine batch slots")
    ap.add_argument("--decode-block", type=int, default=32, help="tokens decoded per engine step")
    ap.add_argument("--temperature", type=float, default=0.0, help="<= 0: greedy")
    ap.add_argument("--top-k", type=int, default=0, help="0: no truncation")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--moe-stream", action="store_true", help="MoE decode: stream each local expert once")
    ap.add_argument("--mode", default="overlap", choices=["overlap", "baseline"])
    ap.add_argument("--ckpt-dir", default=None, help="restore the newest checkpoint launch/train wrote there")
    ap.add_argument("--data", type=int, default=1, help="data-parallel replicas, one spawned process each")
    ap.add_argument("--procs", type=int, default=1, help="processes the --world ranks span, one card each (divides W)")
    args = ap.parse_args(argv)
    r = serve(
        args.arch, batch=args.batch, prompt_len=args.prompt_len, new_tokens=args.new_tokens, world=args.world,
        dtype=args.dtype, device=args.device, seed=args.seed, reduce=args.reduce, slots=args.slots,
        decode_block=args.decode_block, temperature=args.temperature, top_k=args.top_k, eos_id=args.eos_id,
        moe_stream=args.moe_stream, mode=args.mode, ckpt_dir=args.ckpt_dir, data=args.data, procs=args.procs,
    )  # fmt: skip
    print(
        f"device {r['device']} backend {r['backend']}: {r['generated']} tokens for {args.batch} requests of "
        f"{args.prompt_len} prompt tokens in {r['seconds'] * 1e3:.2f} ms, {r['tokens_per_s']:.1f} tokens/s; "
        f"{r['steps']} steps, {r['host_syncs']} host syncs, {r['graph_captures']} graph captures"
    )
    print("sample:", r["tokens"][0].tolist())
    return r


if __name__ == "__main__":
    main()
