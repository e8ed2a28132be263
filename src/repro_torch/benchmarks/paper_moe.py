"""Paper Fig. 9 on one card: TP-MoE overlap against no overlap.

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

What these numbers are: the W ranks share one card, so a collective is a
copy (or a sum over ranks) inside its memory, not NVLink traffic; the
overlap can hide at most the comm-only time, and the paper's multi-GPU
speedups do not carry over.

On the card (``--profile`` adds one call of each mode under torch.profiler):

  PYTHONPATH=src python -m repro_torch.benchmarks.paper_moe --json paper_moe.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch import kernels as K
from repro_torch.backend.mesh import World
from repro_torch.backend.target import resolve_device
from repro_torch.benchmarks.common import bound_ms, card_line, event_ms, fp32_reductions, profile_windows
from repro_torch.configs.paper import PAPER_MOE
from repro_torch.core.channels import BlockChannel
from repro_torch.core.comp_tiles import largest_divisor
from repro_torch.core.compiler import compile_overlap
from repro_torch.core.moe_overlap import _capacity, moe_router
from repro_torch.kernels.grouped_matmul import ROW_TILE

__all__ = ["moe_layer", "moe_operands", "moe_flops", "row_tile", "fig9_row", "describe", "main", "TOL", "CAPACITY"]

TOL = 2e-2  # overlap vs non-overlap, relative to max |non-overlap| (bf16 outputs)
ITERS = 10  # timed calls per mode (median), after 3 warm-up calls
WORLDS = (8, 4)
CAPACITY = 1.25  # the capacity factor of ag_moe (the JAX package's default)
CAVEAT = (
    "W ranks emulated on one card: a collective is a copy or a sum inside one card's memory, not NVLink, "
    "so the overlap can hide at most the comm-only time; the paper's multi-GPU speedups do not carry over"
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
    and w_down [W, E/W, I, H]; every weight scaled by 1 / sqrt(fan-in)."""
    w, dev = world.size, world.device
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = normal((w, s // w, h)).to(dtype)
    wr = normal((h, e), h**-0.5)
    w_gu = normal((w, e // w, h, 2 * i), h**-0.5).to(dtype)
    w_down = normal((w, e // w, i, h), i**-0.5).to(dtype)
    return x, wr, w_gu, w_down


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
    """The emulated collectives alone, as the baseline runs them: the
    all-gather of the tokens and their tables, and the sum over the ranks of
    the [W, W, S/W, H] partials."""
    part = torch.zeros((world.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)

    def comm():
        for t in (x, ids, wts):
            world.all_gather(t, dim=0)
        world.psum(part)

    return event_ms(comm, ITERS)[0]


@fp32_reductions()
def fig9_row(name: str, world_size: int, profile: bool = False) -> dict:
    """One Fig. 9 row on the card: both modes timed, the overlap's output
    held; ``profile`` adds one call of each mode under torch.profiler."""
    dev = resolve_device()
    s, h, i, e, k = PAPER_MOE[name]
    world = World(world_size, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    x, wr, w_gu, w_down = moe_operands(world, s, h, i, e, torch.bfloat16)
    fns = {m: moe_layer(m, world, e, k) for m in ("non-overlap", "overlap")}
    before = K.grouped_matmul.launches
    out = fns["overlap"](x, wr, w_gu, w_down)
    launches = K.grouped_matmul.launches - before
    err, scale = _hold(out, fns["non-overlap"](x, wr, w_gu, w_down), f"fig9 {name} W={world_size}")
    del out
    ms = {m: event_ms(lambda m=m: fns[m](x, wr, w_gu, w_down), ITERS)[0] for m in fns}
    ids, wts, _ = moe_router(x, wr, num_experts=e, top_k=k)
    cap, bm = row_tile(world_size, s, k, e)
    nbytes = 2 * (x.numel() + w_gu.numel() + w_down.numel() + s * h) + 4 * wr.numel()
    bound, by = bound_ms(moe_flops(s, h, i, k), nbytes, torch.bfloat16)
    row = {
        "figure": "fig9", "case": name, "world": world_size, "shape": [s, h, i, e, k],
        "nonoverlap_ms": ms["non-overlap"], "overlap_ms": ms["overlap"],
        "speedup": ms["non-overlap"] / ms["overlap"], "comm_ms": _comm_ms(world, x, ids, wts),
        "bound_ms": bound, "bound_by": by, "max_abs_err": err, "max_abs_ref": scale,
        "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20, "capacity": cap, "bm": bm,
        "grouped_launches": launches, "gemm_rows": world_size * e * cap, "routed_rows": s * k,
    }  # fmt: skip
    if profile:
        windows = {m: (lambda m=m: fns[m](x, wr, w_gu, w_down)) for m in fns}
        row["profile"] = profile_windows(f"fig9 {name} W={world_size}", windows)
    del x, wr, w_gu, w_down, ids, wts
    torch.cuda.empty_cache()
    return row


def describe(row: dict) -> str:
    s, h, i, e, k = row["shape"]
    return (
        f"fig9 {row['case']} W={row['world']} [S {s}, H {h}, I {i}, E {e}, top-{k}]: non-overlap "
        f"{row['nonoverlap_ms']:.3f} ms, overlap {row['overlap_ms']:.3f} ms, speedup {row['speedup']:.3f}x; "
        f"comm-only {row['comm_ms']:.3f} ms; bound {row['bound_ms']:.3f} ms ({row['bound_by']}); peak memory "
        f"{row['peak_mib']:.0f} MiB; capacity {row['capacity']}, bm {row['bm']}, grouped launches "
        f"{row['grouped_launches']}, GEMM rows {row['gemm_rows']} for {row['routed_rows']} routed; max|err| "
        f"{row['max_abs_err']:.3e} (bound {TOL:g} x max|non-overlap| {row['max_abs_ref']:.3e})"
    )


def main(argv=None) -> list:
    """Fig. 9 over the six shapes, for W = 8 then 4, on the card."""
    ap = argparse.ArgumentParser(description="paper Fig. 9 on one card (W emulated ranks)")
    ap.add_argument("--json", default=None, help="also write the rows to this file")
    ap.add_argument("--profile", action="store_true", help="device time by kernel for one call of each mode")
    args = ap.parse_args(argv)
    dev = resolve_device()
    print(f"[paper] {torch.cuda.get_device_name(dev)}; nvidia-smi: {card_line()}; {CAVEAT}")
    rows = []
    for w in WORLDS:
        for name in PAPER_MOE:
            rows.append(fig9_row(name, w, args.profile))
            print(describe(rows[-1]))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card_line(), "caveat": CAVEAT, "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main()
