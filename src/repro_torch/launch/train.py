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

``--data D`` trains D data-parallel replicas of the W-rank model group
(the JAX package's (pod, data, model) mesh with pod x data = D), one
spawned process each (:func:`run_replicas`: the ``spawn`` start method,
since the parent may hold a CUDA context), joined by a ``torch.distributed``
:class:`~repro_torch.backend.mesh.DistWorld` over a file store:
``--dist-backend`` gloo (the default: on one card every replica shares the
device, which NCCL refuses) or nccl (replica r on GPU r); gloo takes the
CUDA tensors of the card's replicas as
:data:`~repro_torch.backend.mesh.GLOO_CUDA_STAGING` says (the permute
through pinned host memory, the rest as they lie); both are printed.
Replica r reads rows r B/D .. (r+1) B/D of each global batch of B
(``SyntheticLM(n_hosts=D, host_id=r)``), and the step is
``training.make_train_step``'s data-parallel form, ZeRO-3: after init or
restore each replica keeps only its block of every parameter and moment
the data axes split, and the forward gathers each layer at its use.  The
parent builds the kernel
library before it spawns, so the replicas load it; rank 0 logs, returns the
history (each step's record gains ``data_bytes``, the data transport's
payload by kind, and ``data_ms``, its host time, which ``--time-data``
measures by draining the device around each collective; None without
it) and writes the
checkpoints, whose parameters and moments the replicas gather first
(``training.steps.gather_blocks``); a checkpoint restores at any D.  On the
CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduce \
      --device cpu --data 2 --batch 4 --seq 32 --steps 3

``--procs P`` spreads the W tensor-parallel ranks over P processes (P
divides W), one card each (``launch/serve.run_tp``: NCCL with process p on
``cuda:p``; gloo with ``--device cpu``).  Every process builds the same
seeded global weights and keeps its ranks' slices (``convert.shard_params``),
reads the same batches and runs ``training.make_train_step`` over the TP
world of processes (the fused AG+GEMM / GEMM+RS on their peer route in both
passes, the norms' gradients summed over the processes, AdamW on each
process's leaves); process 0 logs and returns the history.  A checkpoint is
written by process 0 with every process's slices gathered
(``CheckpointManager.save`` over processes) and restores at any P.  Only
the dense models train there (attention with a dense MLP: smollm-360m,
qwen2-72b, starcoder2-7b, gemma3-27b); ``--procs`` with ``--data`` (TP x
data across processes), beyond the visible cards or not dividing W raises,
and nothing falls back to one card:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --world 4 --procs 4 --steps 30
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch

from repro_torch import kernels as K
from repro_torch.backend.mesh import GLOO_CUDA_STAGING, CommCounter, DistWorld, World
from repro_torch.backend.target import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.launch.serve import DTYPES
from repro_torch.models import encdec, lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.runtime import StepWatchdog
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training.optimizer import tree_map
from repro_torch.training.steps import data_blocks, gather_blocks

__all__ = ["train", "train_replica", "train_tp", "model_module", "main", "run_replicas", "staging_for",
           "device_bytes"]

REPLICA_TIMEOUT_S = 3600.0  # run_replicas stops its processes after this long


def model_module(cfg):
    """The model module of a config (``repro/launch/specs.model_module``)."""
    return encdec if cfg.encoder_layers else lm


def staging_for(backend: str, device):
    """The DistWorld staging of a backend on a device: None (every
    collective direct) unless gloo moves CUDA tensors, then
    :data:`GLOO_CUDA_STAGING`."""
    if backend != "gloo" or torch.device(device).type != "cuda":
        return None
    return dict(GLOO_CUDA_STAGING)


def run_replicas(target: Callable, size: int, *, device=None, backend: str = "gloo", staging=None,
                 args: Sequence = ()) -> list:  # fmt: skip
    """``target(data, *args)`` in ``size`` spawned processes, ``data`` each
    one's :class:`DistWorld` (rank r of ``size``) over a file store in a
    temporary directory, on ``device`` (the card unless said; under NCCL,
    process r on CUDA device r); returns their
    results by rank (each saved with ``torch.save`` by its process: keep
    them on the CPU).  ``target`` must be importable by name.  Each process
    runs torch at this process's intra-op thread count over ``size``.  On a
    CUDA device the kernel library is built
    here first, so the processes load it rather than each building it.  A
    process that fails prints its traceback and exits at once; this then
    stops the others and raises."""
    import multiprocessing

    dev = resolve_device(device)
    if dev.type == "cuda":
        K.prebuild()
    threads = max(1, torch.get_num_threads() // size)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro-replicas-") as tmp:
        devs = [str(torch.device("cuda", r)) if backend == "nccl" and dev.type == "cuda" else str(dev)
                for r in range(size)]  # fmt: skip
        procs = [ctx.Process(target=_replica, args=(target, r, size, tmp, devs[r], backend, staging, threads, args),
                             name=f"replica-{r}") for r in range(size)]  # fmt: skip
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + REPLICA_TIMEOUT_S
        try:
            while any(proc.is_alive() for proc in procs):
                failed = [proc for proc in procs if proc.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    raise RuntimeError(f"run_replicas: {[(p.name, p.exitcode) for p in failed] or 'timed out'}")
                for proc in procs:
                    proc.join(timeout=0.2)
            codes = [proc.exitcode for proc in procs]
            if any(codes):
                raise RuntimeError(f"run_replicas: replica exit codes {codes}")
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.terminate()
                proc.join(timeout=30)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(size)]


def _replica(target, rank, size, tmp, device, backend, staging, threads, args):
    """One replica process of :func:`run_replicas`.  A failure prints its
    traceback and ends the process at once, without leaving the group: a
    peer may be waiting in a collective, and NCCL's teardown would wait on
    it (the parent then stops the others)."""
    import sys
    import traceback

    torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    data = DistWorld(size, rank, init_file=os.path.join(tmp, "store"), backend=backend, device=device,
                     staging=staging)  # fmt: skip
    try:
        out = target(data, *args)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    data.close()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


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
    data: int = 1,
    dist_backend: str = "gloo",
    time_data: bool = False,
    procs: int = 1,
) -> dict:
    """Train ``arch`` for ``steps`` steps (resuming from the latest checkpoint
    in ``ckpt_dir`` when ``resume``) with seeded weights (seed 0);
    ``layers`` cuts the depth; ``remat`` is the step's ``remat_policy``.  Returns {"history": one record per
    step run (loss, ce, grad_norm, lr, ms, launches), "params", "opt_state",
    "cfg"}.  A step's ``ms`` is CUDA-event time on the card, host time on
    the CPU; ``launches`` counts each kernel's launches in that step.
    ``data`` > 1 trains that many replicas in spawned processes (module
    docstring); then "params" and "opt_state" are rank 0's blocks, on the
    CPU, and "replicas" holds each process's peak device memory, the device
    memory its placed parameters and moments took ("placed_bytes": what its
    live tensors requested and ``memory_allocated``, which adds the caching
    allocator's rounding of each block, both from before the init to after
    the placement) and its launch counts;
    ``time_data`` fills each record's
    ``data_ms`` (the device drained around every data collective, which
    slows the step; None without it).  ``procs`` > 1 spreads the ``world``
    ranks over that many processes, one card each (module docstring); then
    "params" and "opt_state" are not returned, and "processes" holds each
    one's device, peak device memory and launch counts."""
    kw = dict(steps=steps, batch=batch, seq=seq, reduce=reduce, layers=layers, mode=mode, remat=remat,
              ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, lr=lr, dtype=dtype, world=world, log_every=log_every,
              resume=resume, time_data=time_data)  # fmt: skip
    if procs > 1:
        if data > 1:
            raise ValueError("--procs with --data: TP x data across processes is not ported (ROADMAP queue 1 "
                             "item 1 (d)); the data transport and the TP world would both own the process group")  # fmt: skip
        from repro_torch.launch.serve import run_tp

        outs = run_tp(train_tp, world, procs, device, args=(arch, kw))
        return {"history": outs[0]["history"], "cfg": outs[0]["cfg"],
                "processes": [{k: o[k] for k in ("device", "peak_bytes", "launches")} for o in outs]}  # fmt: skip
    if data == 1:
        return _train(arch, device=device, dist=None, **kw)
    if data < 1 or batch % data:
        raise ValueError(f"--data {data}: the global batch {batch} must divide over the replicas")
    dev = resolve_device(device)
    stage = staging_for(dist_backend, dev)
    print(f"data axis: {data} replica processes over torch.distributed {dist_backend}, staging "
          f"{stage or 'direct'}")  # fmt: skip
    outs = run_replicas(train_replica, data, device=dev, backend=dist_backend, staging=stage, args=(arch, kw))
    return {**outs[0], "replicas": [{k: o[k] for k in ("peak_bytes", "placed_bytes", "launches")} for o in outs]}


def train_replica(dist: DistWorld, arch: str, kw: dict, keep_state: bool = True) -> dict:
    """One replica of ``train(data=D)``, in a process of ``dist``: ``kw``
    holds every keyword of :func:`train` from ``steps`` to ``time_data``.
    Returns {"history" (rank 0's; None elsewhere), "cfg", "peak_bytes",
    "placed_bytes", "launches"} and, on rank 0 with ``keep_state``, its
    "params" and "opt_state" blocks on the CPU (rank 0 logs)."""
    if dist.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    out = _train(arch, device=dist.device, dist=dist, **kw)
    res = {"history": out["history"] if dist.rank == 0 else None, "cfg": out["cfg"],
           "peak_bytes": torch.cuda.max_memory_allocated() if dist.device.type == "cuda" else None,
           "placed_bytes": out["placed_bytes"], "launches": K.launch_counts()}  # fmt: skip
    if dist.rank == 0 and keep_state:
        res.update(params=tree_map(_host, out["params"]), opt_state=tree_map(_host, out["opt_state"]))
    return res


def train_tp(tp: World, arch: str, kw: dict) -> dict:
    """One process of ``train(procs=P)`` over the TP world ``tp``: ``kw``
    holds every keyword of :func:`train` from ``steps`` to ``time_data``.
    Returns {"history" (process 0's; None elsewhere), "cfg", "device",
    "peak_bytes", "launches"} (process 0 logs)."""
    if tp.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    out = _train(arch, device=tp.device, dist=None, tp=tp, **kw)
    return {"history": out["history"] if tp.procs.rank == 0 else None, "cfg": out["cfg"], "device": str(tp.device),
            "peak_bytes": torch.cuda.max_memory_allocated() if tp.device.type == "cuda" else None,
            "launches": K.launch_counts()}  # fmt: skip


def _host(t):
    return t.detach().cpu() if torch.is_tensor(t) else t


def _train(arch, *, steps, batch, seq, reduce, layers, mode, remat, ckpt_dir, ckpt_every, lr, dtype, world, device,
           log_every, resume, time_data, dist: Optional[DistWorld], tp: Optional[World] = None) -> dict:  # fmt: skip
    """:func:`train`'s loop in this process: one replica of ``dist`` (its
    DistWorld), one process of the TP world ``tp``, or the whole run."""
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
    w = World(world, device) if tp is None else tp
    dtype = dtype or ("bf16" if w.device.type == "cuda" else "f32")
    n_data, rank = (1, 0) if dist is None else (dist.size, dist.rank)
    lead = rank == 0 and (tp is None or tp.procs.rank == 0)
    if dist is None:
        pc = ParallelContext(world=w, mode=mode)
    else:
        pc = ParallelContext(world=w, mode=mode, mesh_axes=make_dev_mesh(world, n_data).axes, data=dist)
    before = device_bytes(w.device)
    params = mod.init(cfg, w, torch.Generator(device=w.device).manual_seed(0), DTYPES[dtype])
    opt_state = init_opt_state(mod.trainable(params, cfg)) if dist is None else None
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=max(5, steps // 20))
    # donated: each step updates the state it is given in place (one copy of the weights and moments)
    step_fn = make_train_step(
        mod, cfg, pc, opt_cfg, remat_policy=remat, grad_masks=mod.grad_masks(cfg, pc), donate=True
    )

    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, n_hosts=n_data, host_id=rank)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr and resume and mgr.latest_step() is not None:
        s0 = mgr.latest_step()
        full = init_opt_state(mod.trainable(params, cfg)) if dist is not None else opt_state
        restored, meta = mgr.restore(s0, {"params": params, "opt": full}, cfg=cfg, world=w)
        params, opt_state = restored["params"], restored["opt"]
        del restored, full
        pipe.restore(meta["extra"]["data"])
        start = s0
        if lead:
            print(f"resumed from step {s0}")
    placed = None
    if dist is not None:  # ZeRO-3: this replica's blocks of the parameters and moments, the whole trees dropped
        if opt_state is None:
            opt_state = init_opt_state(data_blocks(mod, cfg, pc, mod.trainable(params, cfg)))
        else:
            opt_state = {**{k: data_blocks(mod, cfg, pc, opt_state[k]) for k in ("mu", "nu")},
                         "step": opt_state["step"]}  # fmt: skip
        params = mod.with_tied(data_blocks(mod, cfg, pc, mod.trainable(params, cfg)), cfg)
        if before is not None:
            placed = {k: v - before[k] for k, v in device_bytes(w.device).items()}

    def save(step):
        p, opt = params, opt_state
        if dist is not None:  # the blocks gathered on every replica: rank 0 writes the logical arrays
            p = mod.with_tied(gather_blocks(mod, cfg, pc, mod.trainable(params, cfg)), cfg)
            opt = {**opt, **{k: gather_blocks(mod, cfg, pc, opt[k]) for k in ("mu", "nu")}}
        if lead or tp is not None:  # over the TP processes every one gathers its slices, process 0 writes
            mgr.save(step, p, opt, extra={"data": pipe.state(), "arch": arch}, cfg=cfg, world=w)

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
        counter = CommCounter(timed=time_data)
        with dist.counting(counter) if dist is not None else contextlib.nullcontext():
            params, opt_state, metrics = step_fn(params, opt_state, batch_np)
        if cuda:
            e1.record()
        loss = float(metrics["loss"])  # a host sync
        straggler = wd.stop()
        ms = e0.elapsed_time(e1) if cuda else (time.perf_counter() - t0) * 1e3
        after = K.launch_counts()
        rec = {"step": step, "loss": loss, "ce": float(metrics["ce"]), "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]), "ms": ms, "launches": {k: after[k] - before[k] for k in after}}  # fmt: skip
        if dist is not None:
            rec["data_bytes"] = {k: float(sum(v.values())) for k, v in counter.payload.items() if v}
            rec["data_ms"] = counter.seconds * 1e3 if time_data else None
        history.append(rec)
        if lead and (step % log_every == 0 or step == steps - 1):
            data_txt = f" data={rec['data_ms']:.1f}ms" if dist is not None and time_data else ""
            print(f"step {step}: loss={loss:.4f} lr={rec['lr']:.2e} gnorm={rec['grad_norm']:.3f} "
                  f"step={ms:.1f}ms{data_txt} med_step={wd.median() * 1e3:.0f}ms"
                  + (" [STRAGGLER]" if straggler else ""))  # fmt: skip
        if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
            save(step + 1)
    if mgr:
        save(steps)
        mgr.wait()
    return {"history": history, "params": params, "opt_state": opt_state, "cfg": cfg, "placed_bytes": placed}


def device_bytes(device) -> Optional[dict]:
    """The device memory this process's live tensors requested and what the
    caching allocator's blocks for them hold (each rounded up); None off the
    card."""
    if torch.device(device).type != "cuda":
        return None
    return {"requested": torch.cuda.memory_stats(device)["requested_bytes.all.current"],
            "allocated": torch.cuda.memory_allocated(device)}  # fmt: skip


def main(argv=None):
    ap = argparse.ArgumentParser(description="train an LM of the port (W ranks on one device, or over --procs cards)")
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
    ap.add_argument("--world", type=int, default=4, help="tensor-parallel ranks (on one device unless --procs)")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data", type=int, default=1, help="data-parallel replicas, one spawned process each")
    ap.add_argument("--dist-backend", default="gloo", choices=["gloo", "nccl"],
                    help="the replicas' torch.distributed backend (gloo: replicas sharing one card, or the CPU)")
    ap.add_argument("--time-data", action="store_true",
                    help="time the data transport (data_ms): drains the device around each collective")
    ap.add_argument("--procs", type=int, default=1, help="processes the W ranks spread over, one card each")
    args = ap.parse_args(argv)
    out = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq, reduce=args.reduce, layers=args.layers,
        mode=args.mode, remat=args.remat,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, lr=args.lr, dtype=args.dtype, world=args.world,
        device=args.device, log_every=args.log_every, resume=args.resume, data=args.data,
        dist_backend=args.dist_backend, time_data=args.time_data, procs=args.procs,
    )  # fmt: skip
    losses = [r["loss"] for r in out["history"]]
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return out


if __name__ == "__main__":
    main()
