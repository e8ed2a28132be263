"""Paper Fig. 9 on one card or on P: TP-MoE overlap against no overlap.

The port's analog of ``benchmarks/fig9_moe.py`` at the published shapes of
``configs/paper.py::PAPER_MOE`` (S = 8192 tokens, H / I 2048 / 1536 and
4096 / 2048, E 8 and 32 experts, top-2 and top-5), not the JAX bench's
``SCALE`` cut, with W tensor-parallel ranks emulated on one card and
bfloat16 operands.  Each shape is the paper's "hardest case", AG +
GroupGEMM + TopkReduce + RS with dynamic routing:

  * the router: top-k softmax in float32 on seeded float32 weights, inside
    the timed call as in the JAX bench (both modes route the same tokens
    the same way);
  * "overlap" is ``ag_moe`` on the fused backend: the token tiles and their
    routing tables ride the ring while every rank's local experts run on
    the grouped GEMM kernel (``kernels/grouped_matmul.py``), two launches per
    ring step;
  * "non-overlap" is ``ag_moe_baseline``: the emulated all-gather of tokens
    and tables, the capacity dispatch, the expert GEMMs as one tensor-core
    ``torch.bmm`` per GEMM over every (rank, expert) (float32 sums), the
    combine, then the emulated reduce-scatter.

Per row: the median of 10 timed calls (``ITERS``) of each mode (CUDA
events) after warm-up, the speedup, the emulated collectives alone
("comm-only"), peak device memory, the grouped kernel's row tile bm and
launches per call, and the bound: the routed tokens' FLOPs
(S x k x 6 H I) at the card's bf16 peak, or the bytes of the tokens, the
expert weights and the output at the memory rate, whichever is larger.  The
capacity pad (each (rank, expert) group runs ``cap`` rows, routed or not)
and the dense one-hot dispatch and combine are work the bound does not
count; ``gemm_rows`` / ``routed_rows`` gives the pad.  The overlap's output
is held against the non-overlap output to 2e-2 of max |non-overlap| (both
round their outputs to bf16).

Where the ranks live (each row's ``ranks``, ``procs`` and ``cards``):

  * ``--procs 1`` (the default): the W ranks share one card, so a
    collective is a copy (or a sum over ranks) inside its memory, not
    NVLink traffic; the overlap can hide at most the comm-only time, and
    the paper's multi-GPU speedups do not carry over.
  * ``--procs P`` (P divides W; P cards visible, else it raises): one
    process a card, each holding W / P ranks (``launch/serve.run_tp``), the
    S tokens whole over the W ranks.  "non-overlap" is ``ag_moe_baseline``
    over NCCL: the all-gather of every origin's tokens and tables, the
    tensor-core ``torch.bmm`` experts of the held ranks, then a
    reduce-scatter of the partials home; comm-only is those two NCCL
    collectives alone, with the link rate they reach (``link_gbps``: the
    bytes a card receives over the comm-only time).  "overlap" is
    ``ag_moe``: its token tiles and tables, and the reduction riding them,
    cross the cards by NCCL send / recv that complete lazily, so each ring
    step's grouped GEMMs are issued before the wait for the next step's
    tile (``core/overlap._permute_start``); ``overlap_lazy_ms`` and
    ``overlap_waits_at_once_ms`` time it in turns with the same call whose
    every permute is waited on where it is issued (the serialized ring),
    and ``--profile`` adds that call's profile, with the time NCCL's
    kernels ran at once with the GEMMs (``common.nccl_concurrency``).
    Beside them: ``ring_comm_ms``,
    the double ring's permutes alone (every step's tile and reduction hop,
    no expert compute), ``comp_ms``, its W steps of expert compute alone on
    the held tile (the same capacity, no permute), and the paper's overlap
    ratio of the two against the overlap's time (``paper_attn.overlap_ratio``:
    the share of the ring's comm-only time hidden).  A row's times are its
    slowest process's (``paper_mlp.combine_rows``).

On the card (``--profile`` adds one call of each mode under torch.profiler,
``--cases`` picks shapes):

  PYTHONPATH=src python -m repro_torch.benchmarks.paper_moe --json paper_moe.json
  PYTHONPATH=src python -m repro_torch.benchmarks.paper_moe --world 4 --procs 4 --json paper_moe_4gpu.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch import kernels as K
from repro_torch.backend.mesh import Landing, World
from repro_torch.backend.target import resolve_device
from repro_torch.benchmarks.common import bound_ms, card_line, event_ms, fp32_reductions, profile_windows
from repro_torch.benchmarks.paper_attn import overlap_ratio
from repro_torch.benchmarks.paper_mlp import _held, _link, _where, combine_rows
from repro_torch.configs.paper import PAPER_MOE
from repro_torch.core import moe_overlap as moe
from repro_torch.core.channels import BlockChannel
from repro_torch.core.comp_tiles import largest_divisor
from repro_torch.core.compiler import compile_overlap
from repro_torch.core.moe_overlap import _capacity, moe_router
from repro_torch.core.overlap import plan_for, run_plan
from repro_torch.kernels.grouped_matmul import ROW_TILE

__all__ = ["moe_layer", "moe_operands", "moe_flops", "row_tile", "fig9_row", "process_rows", "procs_rows",
           "describe", "main", "TOL", "CAPACITY"]  # fmt: skip

TOL = 2e-2  # overlap vs non-overlap, relative to max |non-overlap| (bf16 outputs)
ITERS = 10  # timed calls per mode (median), after 3 warm-up calls
WORLDS = (8, 4)
CAPACITY = 1.25  # the capacity factor of ag_moe (the JAX package's default)
CAVEAT = (
    "W ranks emulated on one card: a collective is a copy or a sum inside one card's memory, not NVLink, "
    "so the overlap can hide at most the comm-only time; the paper's multi-GPU speedups do not carry over"
)
CAVEAT_PROCS = (
    "one process a card: non-overlap is NCCL's all-gather of the tokens, tensor-core expert GEMMs and NCCL's "
    "reduce-scatter; overlap the double ring over NCCL send / recv, waited on where a landed tile is read, its "
    "experts on the grouped kernel; a row's time is the slowest process's"
)


def moe_layer(mode: str, world: World, num_experts: int, top_k: int, channel: Optional[BlockChannel] = None) -> Callable:
    """Fig. 9's TP-MoE, ``fn(x [W, S/W, H], w_router [H, E] f32,
    w_gu [W, E/W, H, 2 I], w_down [W, E/W, I, H]) -> [W, S/W, H]``: the
    float32 top-k router, then ``ag_moe`` (``"overlap"``: the fused backend,
    whose grouped-GEMM wrapper runs its plain version on CPU tensors) or
    ``ag_moe_baseline`` (``"non-overlap"``)."""
    if mode not in ("overlap", "non-overlap"):
        raise ValueError(f"mode must be 'overlap' or 'non-overlap', got {mode!r}")
    ch = channel or BlockChannel(axis="model")
    kw = dict(backend="fused") if mode == "overlap" else dict(backend="eager", overlapped=False)
    op = compile_overlap("ag_moe", ch, world=world, capacity_factor=CAPACITY, **kw)

    def f(x, w_router, w_gu, w_down):
        ids, wts, _ = moe_router(x, w_router, num_experts=num_experts, top_k=top_k)
        return op(x, ids, wts, w_gu, w_down)

    return f


def moe_operands(world: World, s: int, h: int, i: int, e: int, dtype):
    """Seeded x [W, S/W, H], router [H, E] (float32), w_gu [W, E/W, H, 2 I]
    and w_down [W, E/W, I, H]; every weight scaled by 1 / sqrt(fan-in).
    Over processes each makes every rank's operands from the one seed and
    keeps its held ranks' (the router whole)."""
    w, dev = world.size, world.device
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = normal((w, s // w, h)).to(dtype)
    wr = normal((h, e), h**-0.5)
    w_gu = normal((w, e // w, h, 2 * i), h**-0.5).to(dtype)
    w_down = normal((w, e // w, i, h), i**-0.5).to(dtype)
    return _held(world, x), wr, _held(world, w_gu), _held(world, w_down)


def moe_flops(s: int, h: int, i: int, k: int) -> int:
    """The routed tokens' FLOPs: S x k rows through gate|up [H, 2 I] and down [I, H]."""
    return 6 * s * k * h * i


def row_tile(world_size: int, s: int, k: int, e: int) -> tuple:
    """(capacity, the grouped kernel's row tile bm) of ``ag_moe`` at one
    channel: every (rank, expert) group has ``cap`` rows."""
    cap = _capacity(s // world_size, k, e, CAPACITY)
    return cap, largest_divisor(cap, ROW_TILE)


def _hold(out, ref, what: str):
    """Fail unless ``out`` is finite and within TOL x max |ref| of ``ref``."""
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not (bool(torch.isfinite(out).all()) and err <= TOL * scale):
        raise RuntimeError(f"{what}: max|err| {err} > {TOL} x max|non-overlap| {scale}")
    return err, scale


def _comm_ms(world: World, x, ids, wts) -> float:
    """The baseline's collectives alone, as it runs them: on one card the
    emulated all-gather of the tokens and their tables and the sum over the
    ranks of the [W, W, S/W, H] partials; over processes
    ``moe_overlap.gather_origins`` of each (NCCL's all-gather) and
    ``return_home`` of the [held, W, S/W, H] partials (NCCL's
    reduce-scatter)."""
    part = torch.zeros((world.held, world.size) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)

    def comm():
        if world.nprocs == 1:
            for t in (x, ids, wts):
                world.all_gather(t, dim=0)
            world.psum(part)
            return
        for t in (x, ids, wts):
            moe.gather_origins(world, t)
        moe.return_home(world, part)

    return event_ms(comm, ITERS)[0]


def _ring_ms(world: World, x, ids, wts, w_gu, w_down, top_k: int) -> tuple:
    """The overlap's two halves apart, at one channel: (the double ring's
    permutes alone, its tiles and tables and the reduction's hops with a
    zero partial at each step; its W steps of expert compute on the held
    tile alone, the same capacity and grouped launches, no permute)."""
    ch = BlockChannel(axis="model")
    plan = plan_for("ag_moe", ch, world.size, x.shape[-2])
    zero = torch.zeros(x.shape, dtype=plan.accum_dtype, device=x.device)
    state = moe._token_chunks(x, ids, wts, 1)
    cap = _capacity(x.shape[-2], top_k, w_gu.shape[1] * world.size, CAPACITY)
    tile = moe._expert_tile(w_gu, w_down, cap, torch.nn.functional.silu, ch, True, plan.accum_dtype, world.rank0)

    def compute():
        acc = None
        for s in range(plan.steps):
            part = tile(None, state[0], None)
            acc = part if acc is None else acc + part
        return acc

    comm = event_ms(lambda: run_plan(plan, world, lambda ctx, t, _: zero, state=state), ITERS)[0]
    return comm, event_ms(compute, ITERS)[0]


@contextlib.contextmanager
def _waits_at_once(world: World):
    """Inside, every permute of ``world`` is waited on where it is issued
    (``World.permute``), so each ring step's compute queues behind the next
    step's transfer: the serialized ring the lazy landings replace."""
    lazy = world.permute_start
    world.permute_start = lambda xs, pairs: Landing(lazy(xs, pairs).wait())
    try:
        yield
    finally:
        del world.permute_start


@fp32_reductions()
def fig9_row(name: str, world_size: int, profile: bool = False, world: Optional[World] = None) -> dict:
    """One Fig. 9 row on the card: both modes timed, the overlap's output
    held; ``profile`` adds one call of each mode under torch.profiler
    (``world``: a world over processes, else ``world_size`` emulated
    ranks)."""
    world = world or World(world_size, resolve_device())
    dev = world.device
    s, h, i, e, k = PAPER_MOE[name]
    torch.cuda.reset_peak_memory_stats(dev)
    x, wr, w_gu, w_down = moe_operands(world, s, h, i, e, torch.bfloat16)
    fns = {m: moe_layer(m, world, e, k) for m in ("non-overlap", "overlap")}
    before = K.grouped_matmul.launches
    out = fns["overlap"](x, wr, w_gu, w_down)
    launches = K.grouped_matmul.launches - before
    err, scale = _hold(out, fns["non-overlap"](x, wr, w_gu, w_down), f"fig9 {name} W={world_size}")
    del out
    ms = {m: event_ms(lambda m=m: fns[m](x, wr, w_gu, w_down), ITERS)[0] for m in fns}
    if world.nprocs > 1:  # the lazy ring against the one waited on at once, timed in turns
        lazy_ms, eager_ms = _in_turns([lambda: fns["overlap"](x, wr, w_gu, w_down),
                                       lambda: _serialized(world, fns["overlap"], x, wr, w_gu, w_down)], ITERS)  # fmt: skip
    ids, wts, _ = moe_router(x, wr, num_experts=e, top_k=k)
    cap, bm = row_tile(world_size, s, k, e)
    p = world.nprocs  # a card's share of the work and of every rank's operands
    nbytes = 2 * (world_size * x.numel() // world.held + p * (w_gu.numel() + w_down.numel()) + s * h) + 4 * wr.numel()
    bound, by = bound_ms(moe_flops(s, h, i, k) / p, nbytes / p, torch.bfloat16)
    comm = _comm_ms(world, x, ids, wts)
    ring_comm, comp = _ring_ms(world, x, ids, wts, w_gu, w_down, k)
    row = {
        "figure": "fig9", "case": name, "source": "Table 4", "world": world_size, "shape": [s, h, i, e, k],
        **_where(world), "nonoverlap_ms": ms["non-overlap"], "overlap_ms": ms["overlap"],
        "speedup": ms["non-overlap"] / ms["overlap"], "comm_ms": comm, "ring_comm_ms": ring_comm, "comp_ms": comp,
        "overlap_ratio": overlap_ratio(comp, ring_comm, ms["overlap"]),
        "bound_ms": bound, "bound_by": by, "max_abs_err": err, "max_abs_ref": scale,
        "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20, "capacity": cap, "bm": bm,
        "grouped_launches": launches, "gemm_rows": world_size * e * cap, "routed_rows": s * k,
        **_link(world, 2 * s * h + 12 * s * k, 2 * s * h, comm),
    }  # fmt: skip
    if world.nprocs > 1:
        row.update(overlap_lazy_ms=lazy_ms, overlap_waits_at_once_ms=eager_ms)
    if profile:
        windows = {m: (lambda m=m: fns[m](x, wr, w_gu, w_down)) for m in fns}
        if world.nprocs > 1:
            windows["overlap, waits at once"] = lambda: _serialized(world, fns["overlap"], x, wr, w_gu, w_down)
        row["profile"] = profile_windows(f"fig9 {name} W={world_size}", windows)
    del x, wr, w_gu, w_down, ids, wts
    torch.cuda.empty_cache()
    return row


def _in_turns(fns: list, iters: int) -> list:
    """The median ms of each callable over ``iters`` rounds of one call of
    each in turn (CUDA events), after one warm-up call of each."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(iters):
        for t, fn in zip(times, fns):
            t.append(event_ms(fn, 1, warmup=0)[0])
    return [statistics.median(t) for t in times]


def _serialized(world: World, fn, *args):
    """``fn(*args)`` with every permute of ``world`` waited on at once."""
    with _waits_at_once(world):
        return fn(*args)


def describe(row: dict) -> str:
    s, h, i, e, k = row["shape"]
    link = "" if row.get("link_gbps") is None else f" ({row['link_gbps']:.1f} GB/s a card)"
    eager = row.get("overlap_waits_at_once_ms")
    eager = "" if eager is None else (f" (in turns: lazy {row['overlap_lazy_ms']:.3f} ms, every permute waited on at "
                                      f"once {eager:.3f} ms)")  # fmt: skip
    return (
        f"fig9 {row['case']} W={row['world']} P={row.get('procs', 1)}, {row.get('ranks', 'emulated')} [S {s}, H {h}, "
        f"I {i}, E {e}, top-{k}]: non-overlap "
        f"{row['nonoverlap_ms']:.3f} ms, overlap {row['overlap_ms']:.3f} ms{eager}, speedup {row['speedup']:.3f}x; "
        f"comm-only {row['comm_ms']:.3f} ms{link}; the ring's comm-only {row['ring_comm_ms']:.3f} ms, comp-only "
        f"{row['comp_ms']:.3f} ms, overlap ratio {row['overlap_ratio']:.3f}; bound {row['bound_ms']:.3f} ms "
        f"({row['bound_by']}); peak memory "
        f"{row['peak_mib']:.0f} MiB; capacity {row['capacity']}, bm {row['bm']}, grouped launches "
        f"{row['grouped_launches']}, GEMM rows {row['gemm_rows']} for {row['routed_rows']} routed; max|err| "
        f"{row['max_abs_err']:.3e} (bound {TOL:g} x max|non-overlap| {row['max_abs_ref']:.3e})"
    )


def process_rows(world: World, names, profile: bool = False) -> list:
    """One process's Fig. 9 rows (``names``) over a world of processes;
    ``paper_mlp.combine_rows`` joins them."""
    return [fig9_row(name, world.size, profile, world) for name in names]


def procs_rows(world_size: int, procs: int, names=None, profile: bool = False) -> list:
    """Fig. 9 (``names``, default every shape) with the W ranks over
    ``procs`` processes, one card each (``launch/serve.run_tp``): each row's
    times from its slowest process, the cards' names listed."""
    from repro_torch.launch.serve import run_tp

    names = list(PAPER_MOE) if names is None else list(names)
    return combine_rows(run_tp(process_rows, world_size, procs, resolve_device(), args=(names, profile)))


def main(argv=None) -> list:
    """Fig. 9 over the six shapes, for W = 8 then 4 on one card, or at
    ``--world`` over ``--procs`` cards."""
    ap = argparse.ArgumentParser(description="paper Fig. 9 on one card (W emulated ranks) or P cards")
    ap.add_argument("--json", default=None, help="also write the rows to this file")
    ap.add_argument("--profile", action="store_true", help="device time by kernel for one call of each mode")
    ap.add_argument("--world", type=int, default=None, help="W (default: 8 then 4 on one card; 4 with --procs)")
    ap.add_argument("--procs", type=int, default=1, help="processes, one card each (P divides W)")
    ap.add_argument("--cases", nargs="+", default=list(PAPER_MOE), choices=list(PAPER_MOE), help="Fig. 9 shapes")
    args = ap.parse_args(argv)
    dev = resolve_device()
    caveat = CAVEAT if args.procs == 1 else CAVEAT_PROCS
    print(f"[paper] {torch.cuda.get_device_name(dev)}; nvidia-smi: {card_line()}; {caveat}")
    rows = []
    if args.procs > 1:
        rows = procs_rows(args.world or 4, args.procs, args.cases, profile=args.profile)
        for r in rows:
            print(describe(r))
    for w in (WORLDS if args.world is None else (args.world,)) if args.procs == 1 else ():
        for name in args.cases:
            rows.append(fig9_row(name, w, args.profile))
            print(describe(rows[-1]))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card_line(), "caveat": caveat, "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main()
