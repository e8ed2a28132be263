"""Training entry point — the port of ``repro/launch/train.py``.

Wires together: config -> W tensor-parallel ranks emulated on one device ->
seeded parameters -> ``SyntheticLM`` -> the train step (the fused kernels
in both passes on the card) -> async checkpoints -> the step watchdog.  It
runs on the card unless ``--device cpu`` is given (then the kernels' plain
versions); ``--dtype`` defaults to bf16 on the card and f32 on the CPU.
Nothing falls back: without a card and without ``--device cpu`` it raises.
Example (smollm-360m at its published size, W = 4):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 50 --batch 8 --seq 256 --ckpt-dir /path/to/ckpt

Add ``--device cpu --reduce`` for a small run on the CPU.  ``--mode baseline``
runs the non-overlapped collectives (gather then GEMM, GEMM then
reduce-scatter, on tensor cores on the card) with the same flash attention
and LM head as ``--mode overlap``; ``--layers`` cuts the depth (the
published widths stay), e.g. gemma3-27b at one 5:1 period on the card:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-27b --layers 6 \\
      --batch 1 --seq 4096 --steps 10 --mode baseline

``--remat dots`` recomputes each layer in the backward (the JAX package's
trainer always runs ``remat_policy="dots"``); mamba2-2.7b's 64 layers at 8
x 256 tokens need it on one 80 GB card (their saved activations alone
would take ~51 GB):

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b --remat dots --steps 30

A stub-frontend model (paligemma-3b) trains text-only here, as in the JAX
package; an encoder-decoder (seamless-m4t-medium) is refused: its batches
need encoder frames, which ``SyntheticLM`` does not give
(``training.make_train_step`` takes them as ``batch["embeds"]``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import kernels as K
from repro_torch.backend.mesh import World
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.serve import DTYPES
from repro_torch.models import encdec, lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.runtime import StepWatchdog
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

__all__ = ["train", "model_module", "main"]


def model_module(cfg):
    """The model module of a config (``repro/launch/specs.model_module``)."""
    return encdec if cfg.encoder_layers else lm


def train(
    arch: str,
    *,
    steps: int = 100,
    batch: int = 8,
    seq: int = 256,
    reduce: bool = False,
    layers: Optional[int] = None,
    mode: str = "overlap",
    remat: str = "none",
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    lr: float = 3e-4,
    dtype: Optional[str] = None,
    world: int = 4,
    device=None,
    log_every: int = 10,
    resume: bool = True,
) -> dict:
    """Train ``arch`` for ``steps`` steps (resuming from the latest checkpoint
    in ``ckpt_dir`` when ``resume``) with seeded weights (seed 0);
    ``layers`` cuts the depth; ``remat`` is the step's ``remat_policy``.  Returns {"history": one record per
    step run (loss, ce, grad_norm, lr, ms, launches), "params", "opt_state",
    "cfg"}.  A step's ``ms`` is CUDA-event time on the card, host time on
    the CPU; ``launches`` counts each kernel's launches in that step."""
    cfg = get_config(arch)
    if reduce:
        cfg = reduce_config(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    mod = model_module(cfg)
    if mod is encdec:
        raise ValueError(
            f"the train CLI feeds SyntheticLM tokens, which carry no encoder frames: {arch} is an encoder-decoder; "
            "train it through training.make_train_step with batch['embeds']"
        )
    w = World(world, device)
    dtype = dtype or ("bf16" if w.device.type == "cuda" else "f32")
    pc = ParallelContext(world=w, mode=mode)
    params = mod.init(cfg, w, torch.Generator(device=w.device).manual_seed(0), DTYPES[dtype])
    opt_state = init_opt_state(mod.trainable(params, cfg))
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=max(5, steps // 20))
    # donated: each step updates the state it is given in place (one copy of the weights and moments)
    step_fn = make_train_step(
        mod, cfg, pc, opt_cfg, remat_policy=remat, grad_masks=mod.grad_masks(cfg, pc), donate=True
    )

    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr and resume and mgr.latest_step() is not None:
        s0 = mgr.latest_step()
        restored, meta = mgr.restore(s0, {"params": params, "opt": opt_state}, cfg=cfg, world=w)
        params, opt_state = restored["params"], restored["opt"]
        pipe.restore(meta["extra"]["data"])
        start = s0
        print(f"resumed from step {s0}")

    cuda = w.device.type == "cuda"
    wd = StepWatchdog()
    history = []
    for step in range(start, steps):
        batch_np = pipe.host_batch()
        before = K.launch_counts()
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        wd.start()
        params, opt_state, metrics = step_fn(params, opt_state, batch_np)
        if cuda:
            e1.record()
        loss = float(metrics["loss"])  # a host sync
        straggler = wd.stop()
        ms = e0.elapsed_time(e1) if cuda else (time.perf_counter() - t0) * 1e3
        after = K.launch_counts()
        rec = {"step": step, "loss": loss, "ce": float(metrics["ce"]), "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]), "ms": ms, "launches": {k: after[k] - before[k] for k in after}}  # fmt: skip
        history.append(rec)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step}: loss={loss:.4f} lr={rec['lr']:.2e} gnorm={rec['grad_norm']:.3f} "
                  f"step={ms:.1f}ms med_step={wd.median() * 1e3:.0f}ms" + (" [STRAGGLER]" if straggler else ""))  # fmt: skip
        if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, params, opt_state, extra={"data": pipe.state(), "arch": arch}, cfg=cfg, world=w)
    if mgr:
        mgr.save(steps, params, opt_state, extra={"data": pipe.state(), "arch": arch}, cfg=cfg, world=w)
        mgr.wait()
    return {"history": history, "params": params, "opt_state": opt_state, "cfg": cfg}


def main(argv=None):
    ap = argparse.ArgumentParser(description="train an LM of the port (W ranks emulated on one device)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mode", default="overlap", choices=["overlap", "baseline"])
    ap.add_argument("--remat", default="none", choices=list(lm.REMAT_POLICIES),
                    help="'dots': recompute each layer in the backward")  # fmt: skip
    ap.add_argument("--reduce", action="store_true", help="the reduced same-family config (CPU runs)")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers (published widths)")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", dest="resume", action="store_false")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None, help="default: bf16 on the card, f32 on the CPU")
    ap.add_argument("--world", type=int, default=4, help="tensor-parallel ranks (emulated on one device)")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    out = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq, reduce=args.reduce, layers=args.layers,
        mode=args.mode, remat=args.remat,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, lr=args.lr, dtype=args.dtype, world=args.world,
        device=args.device, log_every=args.log_every, resume=args.resume,
    )  # fmt: skip
    losses = [r["loss"] for r in out["history"]]
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return out


if __name__ == "__main__":
    main()
