"""Paper Fig. 8 and Tab. 2: TP-MLP overlap against no overlap, on one card or on P.

The port's analog of ``benchmarks/fig8_mlp.py`` and
``benchmarks/tab2_motivational.py`` at the full paper shapes
(``configs/paper.py``: S = 8192 tokens, the H and I of six published MLPs),
with W tensor-parallel ranks, bfloat16 operands and float32 accumulation:

  * Fig. 8, per shape, ``full_mlp``: AG+GEMM (gate | up) -> SiLU-mul ->
    GEMM+RS (down).  "overlap" is the pair of fused Hopper kernels
    (``compile_overlap(..., backend="fused")``); "non-overlap" is the same
    pair with ``overlapped=False``: the all-gather then one tensor-core GEMM
    per rank, one GEMM per rank into float32 partials then the
    reduce-scatter.
  * Tab. 2, LLaMA-7B (MLP-1): AG+GEMM [S, H] x [H, I] and GEMM+RS
    [S, I] x [I, H] under non-overlap and TileLink, and AG+GEMM
    "decompose": W host-dispatched (peer copy + GEMM) pairs, the
    counterpart of ``_decomposed_ag_gemm``.

Per row: the median of 10 timed calls (``ITERS``) of each mode (CUDA events)
after warm-up, the speedup, the bound (the work's FLOPs at the card's bf16
peak, or its bytes at the memory rate, whichever is larger, for one card's
share of the work) and the collective alone ("comm-only").  The fused
output is held against the non-overlap output to 2e-2 of max
|non-overlap| (both round their outputs to bf16).

Where the ranks live (each row's ``ranks``, ``procs`` and ``cards``):

  * ``--procs 1`` (the default): the W ranks share one card.  A collective
    is a copy (or a sum over the ranks) inside that card's memory, not
    NVLink traffic, so the overlap can hide at most the comm-only time, and
    the paper's 1.17x-20.76x over eight GPUs does not carry over.
  * ``--procs P`` (P divides W; P cards visible, else it raises): one
    process a card, each holding W / P ranks (``launch/serve.run_tp``).  The
    fused kernels push their tiles into the peer cards' receive regions
    over NVLink (``kernels/peer``); the non-overlap baseline is a
    tensor-core GEMM plus NCCL's all-gather or reduce-scatter, the paper's
    baseline, and comm-only is those NCCL collectives alone, with the link
    rate they reach (``link_gbps``: the bytes a card receives over the
    comm-only time).  A row's time is the slowest process's.

On the card:

  PYTHONPATH=src python -m repro_torch.benchmarks.paper_mlp --json paper_mlp.json
  PYTHONPATH=src python -m repro_torch.benchmarks.paper_mlp --world 4 --procs 4 --json paper_mlp_4gpu.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.backend.mesh import World
from repro_torch.backend.target import resolve_device
from repro_torch.benchmarks.common import bound_ms, card_line, event_ms, fp32_reductions
from repro_torch.configs.paper import PAPER_MLP
from repro_torch.core.channels import BlockChannel
from repro_torch.core.compiler import compile_overlap

__all__ = ["full_mlp", "decomposed_ag_gemm", "tab2_fns", "mlp_operands", "fig8_row", "tab2_rows", "procs_rows",
           "process_rows", "combine_rows", "describe", "main", "TOL"]  # fmt: skip

TOL = 2e-2  # fused vs non-overlap, relative to max |non-overlap| (bf16 outputs)
ITERS = 10  # timed calls per mode (median), after 3 warm-up calls
WORLDS = (8, 4)
CAVEAT = (
    "W ranks emulated on one card: a collective is a copy or a sum inside one card's memory, not NVLink, "
    "so the overlap can hide at most the comm-only time; the paper's multi-GPU speedups do not carry over"
)
CAVEAT_PROCS = (
    "one process a card: the fused kernels push tiles into the peer cards over NVLink; non-overlap is a "
    "tensor-core GEMM plus NCCL's all-gather / reduce-scatter; a row's time is the slowest process's"
)
# a multi-card row takes each from its slowest process (Fig. 9's rows also their ring's halves)
TIMES = ("nonoverlap_ms", "overlap_ms", "ms", "comm_ms", "ring_comm_ms", "comp_ms", "overlap_lazy_ms",
         "overlap_waits_at_once_ms")  # fmt: skip


def _pair(world: World, overlapped: bool, channel: Optional[BlockChannel]):
    ch = channel or BlockChannel(axis="model")
    kw = dict(world=world, backend="fused") if overlapped else dict(world=world, backend="eager", overlapped=False)
    return compile_overlap("ag_matmul", ch, **kw), compile_overlap("matmul_rs", ch, **kw)


def full_mlp(mode: str, world: World, channel: Optional[BlockChannel] = None) -> Callable:
    """Fig. 8's TP-MLP, ``fn(x [W, S/W, H], w1 [W, H, 2 I/W], w2 [W, I/W, H])
    -> [W, S/W, H]``; each rank's ``w1`` shard holds its gate columns, then
    its up columns.  ``mode`` is ``"overlap"`` (the fused kernels; their
    plain versions on CPU tensors) or ``"non-overlap"`` (the baselines)."""
    if mode not in ("overlap", "non-overlap"):
        raise ValueError(f"mode must be 'overlap' or 'non-overlap', got {mode!r}")
    ag, rs = _pair(world, mode == "overlap", channel)

    def f(x, w1, w2):
        h = ag(x, w1)
        f_loc = h.shape[-1] // 2
        return rs(F.silu(h[..., :f_loc]) * h[..., f_loc:], w2)

    return f


def decomposed_ag_gemm(world: World) -> Callable:
    """Operator decomposition (async-TP style): W host-dispatched pairs of
    one GEMM per rank on the rows it holds and one ring hop (a peer copy);
    ``fn(x [W, m, K], w [W, K, n]) -> [W, W m, n]``, rows in rank order."""
    size = world.size
    ring = [(r, (r + 1) % size) for r in range(size)]
    ranks = torch.arange(world.held, device=world.device)  # this process's ranks, rank0 + i
    # after s hops rank r holds rank r - s's rows
    held = [torch.remainder(ranks + world.rank0 - s, size) for s in range(size)]

    def run(x, w):
        m = x.shape[-2]
        out = torch.empty((world.held, size, m, w.shape[-1]), dtype=x.dtype, device=x.device)
        c = x
        for s in range(size):
            out[ranks, held[s]] = torch.matmul(c, w)
            if s < size - 1:
                c = world.permute(c, ring)
        return out.reshape(world.held, size * m, w.shape[-1])

    return run


def tab2_fns(world: World, channel: Optional[BlockChannel] = None) -> Dict[str, Callable]:
    """Tab. 2's five cases, each ``fn(x, w)`` on rank-stacked operands."""
    ag_base, rs_base = _pair(world, False, channel)
    ag_tl, rs_tl = _pair(world, True, channel)
    return {
        "AG+GEMM/non-overlap": ag_base,
        "AG+GEMM/decompose": decomposed_ag_gemm(world),
        "AG+GEMM/tilelink": ag_tl,
        "GEMM+RS/non-overlap": rs_base,
        "GEMM+RS/tilelink": rs_tl,
    }


def _normal(shape, gen, dtype, device, scale=1.0):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def mlp_operands(world: World, s: int, h: int, i: int, dtype):
    """Seeded x [W, S/W, H], w1 [W, H, 2 I/W], w2 [W, I/W, H]; the weights
    scaled by 1 / sqrt(fan-in) so activations stay of order one.  Over
    processes each makes every rank's operands from the one seed and keeps
    its held ranks'."""
    w, dev = world.size, world.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _normal((w, s // w, h), gen, dtype, dev)
    w1 = _normal((w, h, 2 * i // w), gen, dtype, dev, h**-0.5)
    w2 = _normal((w, i // w, h), gen, dtype, dev, i**-0.5)
    return tuple(_held(world, t) for t in (x, w1, w2))


def _held(world: World, t: torch.Tensor) -> torch.Tensor:
    """The held ranks' slice of a rank-stacked tensor of every rank."""
    if world.nprocs == 1:
        return t
    return t[world.rank0 : world.rank0 + world.held].clone()  # a slice would keep every rank's storage


def _where(world: World) -> dict:
    """Where a row's ranks ran: emulated on one card or one process a card,
    and the card's name (:func:`combine_rows` lists every process's)."""
    return {"ranks": "emulated" if world.nprocs == 1 else "separate cards", "procs": world.nprocs,
            "cards": [torch.cuda.get_device_name(world.device)]}  # fmt: skip


def _hold(out, ref, what: str):
    """Fail unless ``out`` is finite and within TOL x max |ref| of ``ref``."""
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not (bool(torch.isfinite(out).all()) and err <= TOL * scale):
        raise RuntimeError(f"{what}: max|err| {err} > {TOL} x max|non-overlap| {scale}")
    return err, scale


def _comm_ms(world: World, gather=None, scatter_shape=None) -> float:
    """The emulated collectives alone, as the baselines run them: the
    all-gather of ``gather`` [W, m, K] and the reduce-scatter of float32
    partials of ``scatter_shape`` [W, S, N]."""
    part = None
    if scatter_shape is not None:
        part = torch.zeros(scatter_shape, dtype=torch.float32, device=world.device)

    def comm():
        if gather is not None:
            world.all_gather(gather, dim=0)
        if part is not None:
            world.reduce_scatter(part, dim=0)

    return event_ms(comm, ITERS)[0]


def _link(world: World, gathered: int, scattered: int, comm_ms: float) -> dict:
    """The bytes a card receives in the comm-only collectives (an all-gather
    of ``gathered`` bytes in all, a reduce-scatter of a card's ``scattered``
    bytes of float32 partials, its held ranks summed first) and their rate;
    over one card there is no link (None)."""
    if world.nprocs == 1:
        return {"link_bytes": None, "link_gbps": None}
    share = (world.nprocs - 1) / world.nprocs  # of each collective's data, what comes from the other cards
    nbytes = share * gathered + share * scattered
    return {"link_bytes": nbytes, "link_gbps": nbytes / (comm_ms * 1e-3) / 1e9}


@fp32_reductions()
def fig8_row(name: str, world_size: int, world: Optional[World] = None) -> dict:
    """One Fig. 8 row on the card: both modes timed, the fused output held
    (``world``: a world over processes, else ``world_size`` emulated ranks)."""
    world = world or World(world_size, resolve_device())
    dev = world.device
    s, h, i, src = PAPER_MLP[name]
    torch.cuda.reset_peak_memory_stats(dev)
    x, w1, w2 = mlp_operands(world, s, h, i, torch.bfloat16)
    fns = {m: full_mlp(m, world) for m in ("non-overlap", "overlap")}
    err, scale = _hold(fns["overlap"](x, w1, w2), fns["non-overlap"](x, w1, w2), f"fig8 {name} W={world_size}")
    ms = {m: event_ms(lambda m=m: fns[m](x, w1, w2), ITERS)[0] for m in fns}
    p = world.nprocs
    nbytes = 2 * (world_size * x.numel() // world.held + w1.numel() * p + w2.numel() * p + s * h)
    bound, by = bound_ms(6 * s * h * i / p, nbytes / p, torch.bfloat16)
    comm = _comm_ms(world, x, (world.held, s, h))
    row = {
        "figure": "fig8", "case": name, "source": src, "world": world_size, "shape": [s, h, i], **_where(world),
        "nonoverlap_ms": ms["non-overlap"], "overlap_ms": ms["overlap"],
        "speedup": ms["non-overlap"] / ms["overlap"], "comm_ms": comm,
        "bound_ms": bound, "bound_by": by, "max_abs_err": err, "max_abs_ref": scale,
        "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20,
        **_link(world, 2 * s * h, 4 * s * h, comm),
    }  # fmt: skip
    del x, w1, w2
    torch.cuda.empty_cache()
    return row


@fp32_reductions()
def tab2_rows(world_size: int, world: Optional[World] = None) -> list:
    """Tab. 2 on the card at LLaMA-7B (MLP-1): one row per case, each case's
    output held against its non-overlap output (``world`` as in
    :func:`fig8_row`)."""
    world = world or World(world_size, resolve_device())
    dev = world.device
    s, h, i, src = PAPER_MLP["MLP-1"]
    w, p = world_size, world.nprocs
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    ops = {
        "AG+GEMM": (_normal((w, s // w, h), gen, bf16, dev), _normal((w, h, i // w), gen, bf16, dev, h**-0.5)),
        "GEMM+RS": (_normal((w, s, i // w), gen, bf16, dev), _normal((w, i // w, h), gen, bf16, dev, i**-0.5)),
    }
    ops = {k: tuple(_held(world, t) for t in v) for k, v in ops.items()}
    fns = tab2_fns(world)
    rows = []
    for case, fn in fns.items():
        op, mode = case.split("/")
        x, wt = ops[op]
        base = fns[f"{op}/non-overlap"]
        err, scale = (0.0, 0.0) if mode == "non-overlap" else _hold(fn(x, wt), base(x, wt), f"tab2 {case} W={w}")
        n_out = wt.shape[-1] * (w if op == "AG+GEMM" else 1)
        nbytes = 2 * p * (x.numel() + wt.numel() + s * n_out)  # every card's operands (x, wt hold this card's)
        bound, by = bound_ms(2 * s * h * i / p, nbytes / p, bf16)
        rows.append({
            "figure": "tab2", "case": case, "source": src, "world": w, "shape": [s, h, i], **_where(world),
            "ms": event_ms(lambda fn=fn, x=x, wt=wt: fn(x, wt), ITERS)[0], "bound_ms": bound, "bound_by": by,
            "max_abs_err": err, "max_abs_ref": scale,
        })  # fmt: skip
    for op, (x, wt) in ops.items():
        base_ms = next(r["ms"] for r in rows if r["case"] == f"{op}/non-overlap")
        ag = op == "AG+GEMM"
        comm = _comm_ms(world, x if ag else None, None if ag else (world.held, s, h))
        link = _link(world, 2 * s * h if ag else 0, 0 if ag else 4 * s * h, comm)
        for r in rows:
            if r["case"].startswith(op):
                r.update(speedup=base_ms / r["ms"], comm_ms=comm, **link)
    del ops
    torch.cuda.empty_cache()
    return rows


def describe(row: dict) -> str:
    s, h, i = row["shape"]
    where = f"P={row.get('procs', 1)}, {row.get('ranks', 'emulated')}"
    head = f"{row['figure']} {row['case']} ({row['source']}) W={row['world']} {where} [S {s}, H {h}, I {i}]"
    if row["figure"] == "fig8":
        times = (f"non-overlap {row['nonoverlap_ms']:.3f} ms, overlap {row['overlap_ms']:.3f} ms, "
                 f"peak memory {row['peak_mib']:.0f} MiB")  # fmt: skip
    else:
        times = f"{row['ms']:.3f} ms"
    held = (
        "the reference row"
        if row["case"].endswith("non-overlap")
        else f"max|err| {row['max_abs_err']:.3e} (bound {TOL:g} x max|non-overlap| {row['max_abs_ref']:.3e})"
    )
    link = "" if row.get("link_gbps") is None else f" ({row['link_gbps']:.1f} GB/s a card)"
    return (
        f"{head}: {times}, speedup {row['speedup']:.3f}x; comm-only {row['comm_ms']:.3f} ms{link}; "
        f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}); {held}"
    )


def process_rows(world: World, names) -> list:
    """One process's Fig. 8 (``names``) and Tab. 2 rows over a world of
    processes; :func:`combine_rows` joins them."""
    return [fig8_row(name, world.size, world) for name in names] + tab2_rows(world.size, world)


def procs_rows(world_size: int, procs: int, names=None) -> list:
    """Fig. 8 (``names``, default every shape) and Tab. 2 with the W ranks
    over ``procs`` processes, one card each (``launch/serve.run_tp``): each
    row's times from its slowest process, the cards' names listed."""
    from repro_torch.launch.serve import run_tp

    names = list(PAPER_MLP) if names is None else list(names)
    return combine_rows(run_tp(process_rows, world_size, procs, resolve_device(), args=(names,)))


def combine_rows(per: list) -> list:
    """Every process's rows (:func:`process_rows`, or Fig. 9's
    ``paper_moe.process_rows``) as one row per case: its times from the
    slowest process, its error the largest, the cards listed."""
    rows = []
    for group in zip(*per):
        row = dict(group[0])
        for k in TIMES:
            if k in row:
                row[k] = max(r[k] for r in group)
        row["cards"] = [r["cards"][0] for r in group]
        row["max_abs_err"] = max(r["max_abs_err"] for r in group)
        row["max_abs_ref"] = max(r["max_abs_ref"] for r in group)
        if "peak_mib" in row:
            row["peak_mib"] = max(r["peak_mib"] for r in group)
        rows.append(row)
    for r in rows:  # speedups, link rates and overlap ratios from the slowest processes' times
        if r["figure"] in ("fig8", "fig9"):
            r["speedup"] = r["nonoverlap_ms"] / r["overlap_ms"]
            if "overlap_ratio" in r:
                r["overlap_ratio"] = (r["comp_ms"] + r["ring_comm_ms"] - r["overlap_ms"]) / r["ring_comm_ms"]
        else:
            base = r["case"].split("/")[0] + "/non-overlap"
            r["speedup"] = next(x["ms"] for x in rows if x["figure"] == "tab2" and x["case"] == base) / r["ms"]
        if r.get("link_bytes") is not None:
            r["link_gbps"] = r["link_bytes"] / (r["comm_ms"] * 1e-3) / 1e9
    return rows


def main(argv=None) -> list:
    """Fig. 8 over the six shapes and Tab. 2, for W = 8 then 4 on one card,
    or at ``--world`` over ``--procs`` cards."""
    ap = argparse.ArgumentParser(description="paper Fig. 8 / Tab. 2 on one card (W emulated ranks) or P cards")
    ap.add_argument("--json", default=None, help="also write the rows to this file")
    ap.add_argument("--world", type=int, default=None, help="W (default: 8 then 4 on one card; 4 with --procs)")
    ap.add_argument("--procs", type=int, default=1, help="processes, one card each (P divides W)")
    args = ap.parse_args(argv)
    dev = resolve_device()
    caveat = CAVEAT if args.procs == 1 else CAVEAT_PROCS
    print(f"[paper] {torch.cuda.get_device_name(dev)}; nvidia-smi: {card_line()}; {caveat}")
    rows = []
    if args.procs > 1:
        rows = procs_rows(args.world or 4, args.procs)
        for r in rows:
            print(describe(r))
    for w in (WORLDS if args.world is None else (args.world,)) if args.procs == 1 else ():
        for r in [fig8_row(name, w) for name in PAPER_MLP] + tab2_rows(w):
            rows.append(r)
            print(describe(r))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card_line(), "caveat": caveat, "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main()
