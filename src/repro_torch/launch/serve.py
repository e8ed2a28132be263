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
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.backend.mesh import World
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.serving import Request, ServeEngine

__all__ = ["greedy", "serve", "make_prompts", "main"]

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
    """
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
) -> dict:
    """Build a seeded model and serve ``batch`` requests through the
    continuous-batching engine (``serving.ServeEngine``: a captured step on
    the card, the same step eagerly on the CPU).  Request i samples with
    seed ``seed + i``; ``moe_stream`` streams the MoE decode.  Returns the
    tokens [batch, new_tokens] (-1 after an eos), the wall time of the drain
    and the engine's counters."""
    cfg = get_config(arch)
    if reduce:
        cfg = reduce_config(cfg)
    if cfg.encoder_layers:
        raise SystemExit(ENCDEC_REFUSED)
    w = World(world, device)
    pc = ParallelContext(world=w, moe_decode_stream=moe_stream)
    gen = torch.Generator(device=w.device).manual_seed(seed)
    params = lm.init(cfg, w, gen, DTYPES[dtype])
    prompts = make_prompts(cfg.vocab_size, batch, prompt_len, seed)
    eng = ServeEngine(cfg, pc, params, max_len=prompt_len + new_tokens, temperature=temperature, n_slots=slots,
                      decode_block=decode_block)
    handles = [
        eng.submit(Request(tokens=p, max_new_tokens=new_tokens, temperature=temperature, top_k=top_k, eos_id=eos_id,
                           seed=seed + i))
        for i, p in enumerate(prompts)
    ]  # fmt: skip
    _sync(w.device)
    t0 = time.perf_counter()
    outs = eng.drain(handles)
    seconds = time.perf_counter() - t0
    tokens = np.full((batch, new_tokens), -1, np.int64)
    for i, h in enumerate(handles):
        tokens[i, : len(outs[h])] = outs[h]
    n_tok = sum(len(outs[h]) for h in handles)
    name = torch.cuda.get_device_name(w.device) if w.device.type == "cuda" else "cpu"
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
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, help="a registered config, e.g. smollm-360m, mamba2-2.7b, zamba2-2.7b")
    ap.add_argument("--reduce", action="store_true", help="reduced same-family config (CPU runs)")
    ap.add_argument("--batch", type=int, default=4, help="requests submitted")
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--world", type=int, default=4, help="tensor-parallel ranks (emulated on one device)")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--device", default=None, help="default: cuda (raises when absent)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8, help="engine batch slots")
    ap.add_argument("--decode-block", type=int, default=32, help="tokens decoded per engine step")
    ap.add_argument("--temperature", type=float, default=0.0, help="<= 0: greedy")
    ap.add_argument("--top-k", type=int, default=0, help="0: no truncation")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--moe-stream", action="store_true", help="MoE decode: stream each local expert once")
    args = ap.parse_args(argv)
    r = serve(
        args.arch, batch=args.batch, prompt_len=args.prompt_len, new_tokens=args.new_tokens, world=args.world,
        dtype=args.dtype, device=args.device, seed=args.seed, reduce=args.reduce, slots=args.slots,
        decode_block=args.decode_block, temperature=args.temperature, top_k=args.top_k, eos_id=args.eos_id,
        moe_stream=args.moe_stream,
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
