"""Paper Fig. 8 and Tab. 2 on one card: TP-MLP overlap against no overlap.

The port's analog of ``benchmarks/fig8_mlp.py`` and
``benchmarks/tab2_motivational.py`` at the full paper shapes
(``configs/paper.py``: S = 8192 tokens, the H and I of six published MLPs),
with W tensor-parallel ranks emulated on one card, bfloat16 operands and
float32 accumulation:

  * Fig. 8, per shape, ``full_mlp``: AG+GEMM (gate | up) -> SiLU-mul ->
    GEMM+RS (down).  "overlap" is the pair of fused Hopper kernels
    (``compile_overlap(..., backend="fused")``); "non-overlap" is the same
    pair with ``overlapped=False``: the emulated all-gather then one
    tensor-core GEMM per rank, one GEMM per rank into float32 partials then
    the emulated reduce-scatter.
  * Tab. 2, LLaMA-7B (MLP-1): AG+GEMM [S, H] x [H, I] and GEMM+RS
    [S, I] x [I, H] under non-overlap and TileLink, and AG+GEMM
    "decompose": W host-dispatched (peer copy + GEMM) pairs, the
    counterpart of ``_decomposed_ag_gemm``.

Per row: the median of 10 timed calls (``ITERS``) of each mode (CUDA events)
after warm-up, the speedup, the bound (the work's FLOPs at the card's bf16
peak, since one card does every rank's work, or its bytes at the memory
rate, whichever is larger) and the emulated collective alone ("comm-only").
The fused output is held against the non-overlap output to 2e-2 of
max |non-overlap| (both round their outputs to bf16).

What these numbers are: the W ranks share one card.  An emulated
collective is a copy (or a sum over the ranks) inside that card's memory,
not NVLink traffic, and NCCL cannot put two ranks on one device.  So the
overlap can hide at most the comm-only time, and the paper's 1.17x-20.76x
over eight GPUs does not carry over.

On the card:

  PYTHONPATH=src python -m repro_torch.benchmarks.paper_mlp --json paper_mlp.json
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

__all__ = ["full_mlp", "decomposed_ag_gemm", "tab2_fns", "mlp_operands", "fig8_row", "tab2_rows", "describe", "main", "TOL"]

TOL = 2e-2  # fused vs non-overlap, relative to max |non-overlap| (bf16 outputs)
ITERS = 10  # timed calls per mode (median), after 3 warm-up calls
WORLDS = (8, 4)
CAVEAT = (
    "W ranks emulated on one card: a collective is a copy or a sum inside one card's memory, not NVLink, "
    "so the overlap can hide at most the comm-only time; the paper's multi-GPU speedups do not carry over"
)


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
    ranks = torch.arange(size, device=world.device)
    held = [torch.remainder(ranks - s, size) for s in range(size)]  # after s hops rank r holds rank r - s's rows

    def run(x, w):
        m = x.shape[-2]
        out = torch.empty((size, size, m, w.shape[-1]), dtype=x.dtype, device=x.device)
        c = x
        for s in range(size):
            out[ranks, held[s]] = torch.matmul(c, w)
            if s < size - 1:
                c = world.permute(c, ring)
        return out.reshape(size, size * m, w.shape[-1])

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
    scaled by 1 / sqrt(fan-in) so activations stay of order one."""
    w, dev = world.size, world.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _normal((w, s // w, h), gen, dtype, dev)
    w1 = _normal((w, h, 2 * i // w), gen, dtype, dev, h**-0.5)
    w2 = _normal((w, i // w, h), gen, dtype, dev, i**-0.5)
    return x, w1, w2


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


@fp32_reductions()
def fig8_row(name: str, world_size: int) -> dict:
    """One Fig. 8 row on the card: both modes timed, the fused output held."""
    dev = resolve_device()
    s, h, i, src = PAPER_MLP[name]
    world = World(world_size, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    x, w1, w2 = mlp_operands(world, s, h, i, torch.bfloat16)
    fns = {m: full_mlp(m, world) for m in ("non-overlap", "overlap")}
    err, scale = _hold(fns["overlap"](x, w1, w2), fns["non-overlap"](x, w1, w2), f"fig8 {name} W={world_size}")
    ms = {m: event_ms(lambda m=m: fns[m](x, w1, w2), ITERS)[0] for m in fns}
    nbytes = 2 * (x.numel() + w1.numel() + w2.numel() + s * h)
    bound, by = bound_ms(6 * s * h * i, nbytes, torch.bfloat16)
    row = {
        "figure": "fig8", "case": name, "source": src, "world": world_size, "shape": [s, h, i],
        "nonoverlap_ms": ms["non-overlap"], "overlap_ms": ms["overlap"],
        "speedup": ms["non-overlap"] / ms["overlap"], "comm_ms": _comm_ms(world, x, (world_size, s, h)),
        "bound_ms": bound, "bound_by": by, "max_abs_err": err, "max_abs_ref": scale,
        "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20,
    }  # fmt: skip
    del x, w1, w2
    torch.cuda.empty_cache()
    return row


@fp32_reductions()
def tab2_rows(world_size: int) -> list:
    """Tab. 2 on the card at LLaMA-7B (MLP-1): one row per case, each case's
    output held against its non-overlap output."""
    dev = resolve_device()
    s, h, i, src = PAPER_MLP["MLP-1"]
    world = World(world_size, dev)
    w = world_size
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    ops = {
        "AG+GEMM": (_normal((w, s // w, h), gen, bf16, dev), _normal((w, h, i // w), gen, bf16, dev, h**-0.5)),
        "GEMM+RS": (_normal((w, s, i // w), gen, bf16, dev), _normal((w, i // w, h), gen, bf16, dev, i**-0.5)),
    }
    fns = tab2_fns(world)
    rows = []
    for case, fn in fns.items():
        op, mode = case.split("/")
        x, wt = ops[op]
        base = fns[f"{op}/non-overlap"]
        err, scale = (0.0, 0.0) if mode == "non-overlap" else _hold(fn(x, wt), base(x, wt), f"tab2 {case} W={w}")
        n_out = wt.shape[-1] * (w if op == "AG+GEMM" else 1)
        nbytes = 2 * (x.numel() + wt.numel() + s * n_out)
        bound, by = bound_ms(2 * s * h * i, nbytes, bf16)
        rows.append({
            "figure": "tab2", "case": case, "source": src, "world": w, "shape": [s, h, i],
            "ms": event_ms(lambda fn=fn, x=x, wt=wt: fn(x, wt), ITERS)[0], "bound_ms": bound, "bound_by": by,
            "max_abs_err": err, "max_abs_ref": scale,
        })  # fmt: skip
    for op, (x, wt) in ops.items():
        base_ms = next(r["ms"] for r in rows if r["case"] == f"{op}/non-overlap")
        ag = op == "AG+GEMM"
        comm = _comm_ms(world, x if ag else None, None if ag else (w, s, h))
        for r in rows:
            if r["case"].startswith(op):
                r["speedup"], r["comm_ms"] = base_ms / r["ms"], comm
    del ops
    torch.cuda.empty_cache()
    return rows


def describe(row: dict) -> str:
    s, h, i = row["shape"]
    head = f"{row['figure']} {row['case']} ({row['source']}) W={row['world']} [S {s}, H {h}, I {i}]"
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
    return (
        f"{head}: {times}, speedup {row['speedup']:.3f}x; comm-only {row['comm_ms']:.3f} ms; "
        f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}); {held}"
    )


def main(argv=None) -> list:
    """Fig. 8 over the six shapes and Tab. 2, for W = 8 then 4, on the card."""
    ap = argparse.ArgumentParser(description="paper Fig. 8 / Tab. 2 on one card (W emulated ranks)")
    ap.add_argument("--json", default=None, help="also write the rows to this file")
    args = ap.parse_args(argv)
    dev = resolve_device()
    print(f"[paper] {torch.cuda.get_device_name(dev)}; nvidia-smi: {card_line()}; {CAVEAT}")
    rows = []
    for w in WORLDS:
        for r in [fig8_row(name, w) for name in PAPER_MLP] + tab2_rows(w):
            rows.append(r)
            print(describe(r))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card_line(), "caveat": CAVEAT, "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main()
