"""Paper Fig. 11 on one card or across cards: one LM train step, overlapped against not.

The port's analog of ``benchmarks/fig11_e2e.py``: per model, one bf16
AdamW train step (``training.make_train_step`` over ``models/lm.forward``)
with W = 4 tensor-parallel ranks emulated on one card, in
``ParallelContext(mode="baseline")`` and in ``mode="overlap"`` on the same
weights and batch.  The two modes differ only in the collective GEMMs and
the MoE blocks, as in the JAX package: "overlap" runs the fused AG+GEMM /
GEMM+RS kernels in both passes and the AG+MoE double ring with its expert
GEMMs on the grouped kernel (forward and input gradients), "baseline" the
emulated all-gather then one tensor-core GEMM per rank, one GEMM then the
reduce-scatter, and the gathered MoE with tensor-core expert GEMMs (their
autograd Functions' backward the same non-overlapped forms); flash
attention and the tile-GEMM LM head run in both.

Per row: both modes' first-step loss on the initial weights (a forward
each, held by ``chip_smoke.py`` to the logits' bound), then ``WARMUP``
steps of each mode and ``PAIRS`` timed pairs, the two modes in turns (the
order alternating pair by pair) on one shared, donated state, each step
between two CUDA events; the median step ms of each mode, the speedup
(baseline / overlap), tokens/s, the launches of every step by kernel and
the peak device memory of the row.

The cells (``MODELS`` is the reference's list):

  * 1 x 4096 tokens a step: the sequence of the JAX package's
    ``train_4k`` shape (``src/repro/configs/base.py``, ``SHAPES``), its
    batch of 256 cut to 1, so gemma3-27b's 1024-token window skips real
    tiles;
  * published widths, depth cut to fit one 80 GB card (``DEPTH``; a layer
    and its optimizer state take 12 bytes a parameter: a bf16 weight and
    gradient, float32 moments): smollm-360m at its full 32 layers,
    qwen2-72b 2 of 80 (0.878 B parameters a layer plus 2.49 B of untied
    embedding and head), starcoder2-7b 8 of 32, gemma3-27b 6 of 62 (one
    5:1 period, the 262144-wide tied embedding), granite-moe-3b-a800m at
    its full 32 layers (0.101 B parameters a layer plus 0.15 B of untied
    embedding and head) and deepseek-moe-16b 9 of 28 (the 0.084 B dense
    first layer, 0.588 B per MoE layer, 0.42 B of untied embedding and
    head: 5.21 B, 62.5 GB, plus ~1 GB of saved activations a MoE layer at
    4096 tokens).

What these numbers are: the W ranks share one card.  An emulated
collective is a copy (or a sum over the ranks) inside that card's memory,
not NVLink traffic, so the overlap can hide at most that copy's time and
the paper's multi-GPU end-to-end speedups do not carry over.

``--procs P`` (P divides W = 4; P cards visible, else it raises) runs
every row with the W ranks spread over P processes, one card each
(``launch/serve.run_tp``, :func:`procs_rows`): "baseline" is then one
cuBLAS GEMM a rank with NCCL's all-gather / reduce-scatter between the
cards (the World's collectives over processes, and their adjoints in the
backward), and the MoE blocks' ``ag_moe_baseline`` (NCCL's all-gather of
the tokens, tensor-core expert GEMMs, NCCL's reduce-scatter); "overlap" the
fused kernels pushing tiles into the peer cards over NVLink in both passes
(``kernels/peer``) and the MoE double ring, its tiles crossing the cards by
NCCL send / recv waited on where they are read and its expert GEMMs on each
card's grouped kernel, in turns as the one-card rows run; every process
runs the same steps on its ranks' slices and times them on its own card
(the rows report process 0's medians, every process's peak memory).  Here a collective is real traffic between cards,
so the overlap can hide it, as in the paper's figure; the cards' count and
the step are the paper's shape, cut in depth (``DEPTH_PROCS``: each card's
share within 80 GB by the same 12-byte rule, the embedding, the head and
the norms counted whole on every card, and besides it the update's float32
temporaries of the largest leaf, three copies of the whole embedding (15 GB
at qwen2-72b's, 17 GB at gemma3-27b's), and the 4096-token activations and
logits: smollm-360m and starcoder2-7b at their full 32 layers (34 GB a
card), qwen2-72b 6 of 80 (2.49 B parameters of embedding and head, 29.9 GB
a card, then 0.219 B a layer a card: 45.7 GB), gemma3-27b 12 of 62 (two
5:1 periods, 31.8 GB)), granite-moe-3b-a800m at its full 32 layers (~10
GB a card), and deepseek-moe-16b at its full 28, the depth its measured peak
allows (``DEPTH_PROCS``' comment: the peak of the row at a few layers,
extrapolated per layer, the largest depth that leaves 8 GB of the card
free, the dense first layer kept).

On the card:

  PYTHONPATH=src python -m repro_torch.benchmarks.paper_e2e --json paper_e2e.json
  PYTHONPATH=src python -m repro_torch.benchmarks.paper_e2e --procs 4 --json paper_e2e_4gpu.json   # four cards
  PYTHONPATH=src python -m repro_torch.benchmarks.paper_e2e --procs 4 --models deepseek-moe-16b --layers 2 4 \
      --pairs 1                 # a row's peak memory at a few depths (how DEPTH_PROCS is set)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
from pathlib import Path
from typing import Optional

import torch

from repro_torch import kernels as K
from repro_torch.backend.mesh import World
from repro_torch.benchmarks.common import card_line, fp32_reductions
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.models import lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.training import AdamWConfig, init_opt_state, make_eval_step, make_train_step
from repro_torch.training.optimizer import tree_leaves

__all__ = ["MODELS", "DEPTH", "DEPTH_PROCS", "MODES", "CAVEAT", "CAVEAT_PROCS", "e2e_config", "expected_launches",
           "run_row", "fig11_row", "procs_rows", "process_rows", "describe", "main"]  # fmt: skip

MODELS = ["smollm-360m", "qwen2-72b", "starcoder2-7b", "gemma3-27b", "granite-moe-3b-a800m", "deepseek-moe-16b"]
# layers run of each model at its published width (None: all); see the module docstring
DEPTH = {"smollm-360m": None, "qwen2-72b": 2, "starcoder2-7b": 8, "gemma3-27b": 6, "granite-moe-3b-a800m": None,
         "deepseek-moe-16b": 9}  # fmt: skip
# layers run of each model with the W ranks one a card (module docstring).  deepseek-moe-16b: its row peaked at 8.89
# and 12.38 GiB a card at 2 and 4 layers (--layers 2 4 on four H100s), 1.745 GiB a MoE layer, so its full 28 layers
# take ~54.3 GiB and leave ~25 GiB of the 79.18 free (measured at 28: 54.32 GiB).
DEPTH_PROCS = {"smollm-360m": 32, "qwen2-72b": 6, "starcoder2-7b": 32, "gemma3-27b": 12, "granite-moe-3b-a800m": 32,
               "deepseek-moe-16b": 28}  # fmt: skip
SEQ, BATCH = 4096, 1  # train_4k's sequence; its batch of 256 cut to 1
WORLD = 4
WARMUP, PAIRS = 3, 5  # untimed steps of each mode, then timed (baseline, overlap) pairs
MODES = ("baseline", "overlap")
CAVEAT = (
    "W ranks emulated on one card: a collective is a copy or a sum inside one card's memory, not NVLink, "
    "so the overlap can hide at most that copy's time; the paper's multi-GPU end-to-end speedups do not carry over"
)
CAVEAT_PROCS = (
    "W ranks spread over P processes, one card each: baseline NCCL collectives and cuBLAS GEMMs, overlap the fused "
    "kernels pushing tiles over NVLink; depth cut to fit 80 GB a card (DEPTH_PROCS)"
)


def e2e_config(arch: str, layers: Optional[int] = None):
    """``arch``'s published config with its depth cut to ``layers``
    (default ``DEPTH[arch]``; None keeps every layer)."""
    cfg = get_config(arch)
    layers = layers if layers is not None else DEPTH.get(arch)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def expected_launches(cfg, mode: str, remat: str = "none", fuse_seams: bool = False) -> dict:
    """Kernel launches of one train step on the card: the LM head's tile
    GEMM forward, one flash launch an attention layer (its backward is
    torch ops from the saved statistics) and one SSD intra-chunk launch a
    Mamba layer (its backward torch ops too) in both modes; with overlap,
    each mixer's (attention or Mamba) and each dense MLP's (a dense
    layer's, or a MoE layer's shared experts) AG+GEMM and GEMM+RS forward
    and each one's transpose through the other kernel backward, and each
    MoE block's two grouped GEMMs at every one of the double ring's W steps
    (one channel), forward and input gradients.  ``remat`` other than
    "none" runs each layer's forward launches twice (the head's once).

    ``fuse_seams`` (overlap only): each segment's runs of consecutive
    seam-eligible layers (``lm.segments``, ``LayerDef.seam_eligible``) form
    one chain whose inner RS -> AG seams run on the eager executor, so a
    chain launches one AG+GEMM (its first qkv) and one GEMM+RS (its last
    down projection) forward, and each one's transpose backward; under remat
    only the scan units' chains run their forward twice, as ``lm.forward``
    checkpoints them."""
    on = mode == "overlap"
    if fuse_seams and not on:
        raise ValueError("fused seams are an overlap-mode path")
    plan = lm.layer_plan(cfg)
    k0, period, n_units, _ = lm.scan_units(cfg)
    units = range(k0, k0 + n_units * period)
    out = dict.fromkeys(("ag_gemm", "gemm_rs", "flash_attention", "grouped_matmul", "ssd_intra_chunk"), 0)
    out["matmul"] = 1
    seg_starts = {seg.start for seg in lm.segments(cfg)}
    for i, d in enumerate(plan):
        fwd = 2 if remat != "none" and (not fuse_seams or i in units) else 1  # the forward, and its recompute
        out["flash_attention"] += fwd * (d.kind != "mamba")
        out["ssd_intra_chunk"] += fwd * (d.kind == "mamba")
        if not on:
            continue
        if fuse_seams and d.seam_eligible():
            starts = i in seg_starts or not plan[i - 1].seam_eligible()  # a chain's first layer
            out["ag_gemm"] += (fwd + 1) * starts
            out["gemm_rs"] += (fwd + 1) * starts
            continue
        mlps = 1 + (d.ffn_kind == "mlp" or (d.ffn_kind == "moe" and bool(cfg.moe.num_shared)))  # mixer, dense MLP
        out["ag_gemm"] += (fwd + 1) * mlps
        out["gemm_rs"] += (fwd + 1) * mlps
        out["grouped_matmul"] += (2 * fwd + 2) * WORLD * (d.ffn_kind == "moe")
    return out


def _timed_step(step, params, opt, batch, cuda: bool):
    """One train step: (params, opt, metrics, ms between two CUDA events;
    None off the card, where no device time exists)."""
    if not cuda:
        return (*step(params, opt, batch), None)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    params, opt, metrics = step(params, opt, batch)
    e1.record()
    e1.synchronize()
    return params, opt, metrics, e0.elapsed_time(e1)


def run_row(cfg, world: World, *, dtype=torch.bfloat16, batch: int = BATCH, seq: int = SEQ, warmup: int = WARMUP,
            pairs: int = PAIRS) -> dict:  # fmt: skip
    """One Fig. 11 row of ``cfg`` on ``world`` (module docstring).  Raises
    ``lm.check_trainable``'s error for a model whose training is not
    ported, before anything is allocated."""
    pcs = {m: ParallelContext(world=world, mode=m) for m in MODES}
    for pc in pcs.values():
        lm.check_trainable(cfg, pc)
    cuda = world.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), dtype)
    opt = init_opt_state(lm.trainable(params, cfg))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch).host_batch()
    opt_cfg = AdamWConfig(total_steps=warmup + 2 * pairs, warmup_steps=warmup)
    steps = {m: make_train_step(lm, cfg, pc, opt_cfg, grad_masks=lm.grad_masks(cfg, pc), donate=True)
             for m, pc in pcs.items()}  # fmt: skip
    ms = {m: [] for m in MODES}
    launches = {m: [] for m in MODES}
    step_loss = {m: [] for m in MODES}
    with fp32_reductions():  # the baselines' bf16 GEMMs keep float32 sums
        first = {m: float(make_eval_step(lm, cfg, pc)(params, data)) for m, pc in pcs.items()}
        for i in range(warmup + pairs):
            for m in MODES if i % 2 == 0 else MODES[::-1]:
                before = K.launch_counts()
                params, opt, metrics, t = _timed_step(steps[m], params, opt, data, cuda)
                after = K.launch_counts()
                launches[m].append({k: after[k] - before[k] for k in after})
                step_loss[m].append(float(metrics["loss"]))
                if i >= warmup and t is not None:
                    ms[m].append(t)
    tree = lm.trainable(params, cfg)
    roles = tree_leaves(lm.proc_roles(tree, cfg))  # a held leaf is 1 / P of the model's
    n_params = sum(t.numel() * (world.nprocs if r == "held" else 1) for t, r in zip(tree_leaves(tree), roles))
    row = {
        "arch": cfg.name, "layers": cfg.n_layers, "published_layers": get_config(cfg.name).n_layers,
        "params": n_params, "tokens": batch * seq, "world": world.size, "procs": world.nprocs,
        "dtype": str(dtype).removeprefix("torch."),
        "first_loss": first, "step_loss": step_loss, "launches": launches, "step_ms": ms,
        "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
    }  # fmt: skip
    if cuda:
        med = {m: statistics.median(ms[m]) for m in MODES}
        row.update(median_ms=med, speedup=med["baseline"] / med["overlap"],
                   tokens_per_s={m: batch * seq / (med[m] / 1e3) for m in MODES})  # fmt: skip
    del params, opt
    if cuda:
        torch.cuda.empty_cache()
    return row


def fig11_row(arch: str, **kw) -> dict:
    """Fig. 11's row of ``arch`` on the card at W = ``WORLD``, depth ``DEPTH[arch]``."""
    return run_row(e2e_config(arch), World(WORLD, "cuda"), **kw)


def process_rows(tp: World, models, pairs: int = PAIRS, warmup: int = WARMUP, depths=None) -> list:
    """One process's rows of :func:`procs_rows` over the TP world ``tp``
    (every process runs the same rows): each model at ``depths`` (default
    ``DEPTH_PROCS``; a model may appear in ``models`` more than once, with
    a list of depths), its peer pools released after it (a barrier of the
    processes first), so one model's pools do not hold the next one's
    memory."""
    from repro_torch.kernels import peer

    rows = []
    for arch, layers in _row_depths(models, depths):
        rows.append(run_row(e2e_config(arch, layers), tp, warmup=warmup, pairs=pairs))
        rows[-1]["pool_bytes"] = peer.pool_bytes(tp.device)  # the row's receive pools on this card
        if tp.procs.rank == 0:
            print(f"[fig11] process 0: {describe(rows[-1])}", flush=True)
        peer.release(tp.procs.barrier)
        torch.cuda.empty_cache()
    return rows


def _row_depths(models, depths=None) -> list:
    """(arch, layers) of each row: ``depths[arch]`` (default ``DEPTH_PROCS``),
    an int or a list of ints (one row each)."""
    depths = DEPTH_PROCS if depths is None else {**DEPTH_PROCS, **depths}
    out = []
    for arch in models:
        d = depths[arch]
        out += [(arch, n) for n in (d if isinstance(d, (list, tuple)) else [d])]
    return out


def procs_rows(procs: int, models=MODELS, pairs: int = PAIRS, warmup: int = WARMUP, depths=None) -> list:
    """Fig. 11's rows with the ``WORLD`` ranks over ``procs`` processes, one
    card each (module docstring; ``depths`` as :func:`process_rows` takes
    them): process 0's row of each model with ``peak_bytes_by_card`` (every
    process's peak), ``median_ms_by_card``, ``pool_bytes_by_card`` (the
    receive pools at the row's end) and ``launches_by_card``."""
    from repro_torch.launch.serve import run_tp

    got = run_tp(process_rows, WORLD, procs, "cuda", args=(list(models), pairs, warmup, depths))
    rows = []
    for i, (arch, _) in enumerate(_row_depths(models, depths)):
        row = dict(got[0][i])
        row["peak_bytes_by_card"] = [g[i]["peak_bytes"] for g in got]
        row["median_ms_by_card"] = [g[i]["median_ms"] for g in got]
        row["pool_bytes_by_card"] = [g[i]["pool_bytes"] for g in got]
        row["launches_by_card"] = [g[i]["launches"] for g in got]
        row["step_loss_equal"] = all(g[i]["step_loss"] == row["step_loss"] for g in got)
        rows.append(row)
    return rows


def describe(row: dict) -> str:
    where = f"W = {row['world']}" + (f" over {row['procs']} cards" if row.get("procs", 1) > 1 else " on one card")
    head = (f"Fig. 11 {row['arch']} ({row['layers']} of {row['published_layers']} layers, "
            f"{row['params'] / 1e9:.3f} B parameters, {where}, {row['dtype']}, {row['tokens']} tokens "
            f"a step): first-step loss baseline {row['first_loss']['baseline']:.6f} overlap "
            f"{row['first_loss']['overlap']:.6f}")  # fmt: skip
    if row.get("median_ms") is None:
        return head
    med, tps = row["median_ms"], row["tokens_per_s"]
    return (f"{head}; step ms baseline {med['baseline']:.2f} overlap {med['overlap']:.2f} (medians of "
            f"{len(row['step_ms']['overlap'])} pairs), speedup {row['speedup']:.3f}x, tokens/s baseline "
            f"{tps['baseline']:.0f} overlap {tps['overlap']:.0f}, peak memory {row['peak_bytes'] / 2**30:.2f} GiB"
            + (f" (receive pools {row['pool_bytes'] / 2**20:.1f} MiB)" if "pool_bytes" in row else "")
            + (f"; peak by card {[round(b / 2**30, 2) for b in row['peak_bytes_by_card']]} GiB"
               if "peak_bytes_by_card" in row else ""))  # fmt: skip


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="paper Fig. 11: one train step, overlap vs baseline, on one card or "
                                 "across --procs cards")  # fmt: skip
    ap.add_argument("--models", nargs="+", default=MODELS, help=f"of {MODELS}")
    ap.add_argument("--pairs", type=int, default=PAIRS)
    ap.add_argument("--procs", type=int, default=1, help="processes the W = 4 ranks spread over, one card each")
    ap.add_argument("--layers", type=int, nargs="+", default=None,
                    help="with --procs: one row of each model at each of these depths (default DEPTH_PROCS)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("paper_e2e: no CUDA device; the figure is a measurement on the card")
    card = card_line()
    print(f"[fig11] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; {CAVEAT if args.procs == 1 else CAVEAT_PROCS}")
    rows = []
    if args.procs > 1:
        depths = None if args.layers is None else {arch: list(args.layers) for arch in args.models}
        rows = procs_rows(args.procs, args.models, args.pairs, depths=depths)
        for row in rows:
            print(f"[fig11] {describe(row)}")
    for arch in args.models if args.procs == 1 else ():
        rows.append(fig11_row(arch, pairs=args.pairs))
        print(f"[fig11] {describe(rows[-1])}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main()
