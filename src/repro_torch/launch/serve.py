"""Serve entry point: seeded prompts, ``lm.prefill``, then a greedy ``decode_step`` loop.

The port of ``repro/launch/serve.py`` for a fixed batch of requests (the
continuous-batching engine, scheduler, slot pool and sampling are later
work).  Example, on the card (``--arch smollm-360m``,
``granite-moe-3b-a800m`` or ``mamba2-2.7b``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \\
      --batch 4 --prompt-len 256 --new-tokens 16 --world 4 --dtype bf16

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

__all__ = ["greedy", "serve", "make_prompts", "main"]

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def make_prompts(vocab: int, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """Seeded prompt tokens [batch, prompt_len] (int64)."""
    return np.random.default_rng(seed).integers(0, vocab, size=(batch, prompt_len), dtype=np.int64)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy(params, cfg, pc: ParallelContext, prompts: torch.Tensor, new_tokens: int, max_len: Optional[int] = None):
    """Greedy continuation of ``prompts`` [B, S]: the first token from the
    prefill logits, each later one from a ``decode_step``.

    Returns (tokens [B, new_tokens], timings) with the prefill and decode
    seconds (host clock around work that ends in a device synchronise).
    """
    b, s0 = prompts.shape
    max_len = max_len or s0 + new_tokens
    dev = pc.device
    _sync(dev)
    t0 = time.perf_counter()
    lg, caches = lm.prefill(params, cfg, pc, prompts, max_len=max_len)
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
) -> dict:
    """Build a seeded model, serve ``batch`` greedy requests, report the run.

    The backend follows the device: the fused kernels on CUDA, the eager
    executor on the CPU."""
    cfg = get_config(arch)
    if reduce:
        cfg = reduce_config(cfg)
    w = World(world, device)
    pc = ParallelContext(world=w)
    gen = torch.Generator(device=w.device).manual_seed(seed)
    params = lm.init(cfg, w, gen, DTYPES[dtype])
    prompts = torch.from_numpy(make_prompts(cfg.vocab_size, batch, prompt_len, seed)).to(w.device)
    tokens, t = greedy(params, cfg, pc, prompts, new_tokens)
    name = torch.cuda.get_device_name(w.device) if w.device.type == "cuda" else "cpu"
    return {
        "tokens": tokens.cpu().numpy(),
        "device": name,
        "backend": pc.backend,
        "prefill_ms": t["prefill_s"] * 1e3,
        "decode_tokens_per_s": batch * t["decode_steps"] / t["decode_s"] if t["decode_steps"] else float("nan"),
        **t,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, help="smollm-360m, granite-moe-3b-a800m or mamba2-2.7b")
    ap.add_argument("--reduce", action="store_true", help="reduced same-family config (CPU runs)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--world", type=int, default=4, help="tensor-parallel ranks (emulated on one device)")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--device", default=None, help="default: cuda (raises when absent)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    r = serve(
        args.arch, batch=args.batch, prompt_len=args.prompt_len, new_tokens=args.new_tokens, world=args.world,
        dtype=args.dtype, device=args.device, seed=args.seed, reduce=args.reduce,
    )  # fmt: skip
    print(
        f"device {r['device']} backend {r['backend']}: prefill {r['prefill_ms']:.2f} ms "
        f"({args.batch} x {args.prompt_len} tokens), decode {r['decode_tokens_per_s']:.1f} tokens/s "
        f"({r['decode_steps']} steps x {args.batch})"
    )
    print("sample:", r["tokens"][0].tolist())
    return r


if __name__ == "__main__":
    main()
