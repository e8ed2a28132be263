"""Paper Fig. 10 on one card: sequence-parallel self-attention, the AG-KV
ring against all-gather then attention.

The port's analog of ``benchmarks/fig10_attention.py`` at the published
shapes of ``configs/paper.py::PAPER_ATTN`` (Attn-1 / Attn-2: 32 / 64 heads of
128, S = 16k, 32k, 64k and 128k tokens, batch 1, causal), not the JAX
bench's ``SCALE`` cut, with W sequence-parallel ranks emulated on one card
and bfloat16 operands.  Every rank holds S / W queries and the same rows of
K and V, all heads:

  * "overlap" is ``compile_overlap("ag_attention", backend="fused")``: the
    K / V tiles ride the ring (one emulated permute per step) while flash
    attention (kernel #4, ``kernels/flash_attention.py``) consumes each held
    tile for every rank in one launch per step, its float32 state carried
    from step to step;
  * "non-overlap" is ``ag_attention_baseline``: the emulated all-gather of K
    and V (W copies), then the same kernel once over the gathered KV, so
    both modes share one attention kernel and the speedup isolates the
    overlap;
  * "comm-only" is that all-gather of K and V alone, "comp-only" the kernel
    on KV already resident, and the paper's overlap ratio is
    ``(comp + comm - overlap) / comm``;
  * "library" is ``scaled_dot_product_attention`` over the whole sequence
    (PyTorch's flash attention: the paper's FlashAttention baseline), timed
    as a yardstick and used nowhere in the port.

Per row: the median of 10 timed calls (``ITERS``) of each after warm-up
(CUDA events), the bound (the causal FLOPs ``2 S^2 H D`` at the card's bf16
peak, or the bytes of q, k, v and o at the memory rate, whichever is
larger), peak device memory of each mode, and the flash launches of one
overlap call.  The overlap's output is held against the non-overlap output
to 2e-2 of max |non-overlap| (both round their outputs to bf16).

What these numbers are: the W ranks share one card.  An emulated collective
is a copy inside that card's memory, not NVLink traffic, and the ring's
permutes run on the kernel's stream, so the ratio measures the emulation,
not the paper's copy-engine overlap over eight GPUs.

On the card (``--profile`` adds one call of each mode under torch.profiler):

  PYTHONPATH=src python -m repro_torch.benchmarks.paper_attn --json paper_attn.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch import kernels as K
from repro_torch.backend.mesh import World
from repro_torch.backend.target import resolve_device
from repro_torch.benchmarks.common import bound_ms, card_line, event_ms, profile_windows
from repro_torch.configs.paper import PAPER_ATTN
from repro_torch.core.channels import BlockChannel
from repro_torch.core.compiler import compile_overlap
from repro_torch.kernels.flash_attention import flash_attention_ranked

__all__ = [
    "attention", "attn_operands", "attn_flops", "overlap_ratio", "row_fields", "fig10_row", "describe", "main", "TOL",
]  # fmt: skip

TOL = 2e-2  # overlap vs non-overlap, relative to max |non-overlap| (bf16 outputs)
ITERS = 10  # timed calls per mode (median), after 3 warm-up calls
WORLDS = (8, 4)
CAVEAT = (
    "W ranks emulated on one card: a collective is a copy inside one card's memory, not NVLink, and the ring's "
    "permutes share the kernel's stream, so the overlap ratio measures the emulation; the paper's multi-GPU "
    "speedups do not carry over"
)


def attention(mode: str, world: World, channel: Optional[BlockChannel] = None) -> Callable:
    """Fig. 10's sequence-parallel attention, ``fn(q, k, v) -> o`` on
    [W, B, H, S/W, D] (causal): ``"overlap"`` (the ring on the fused backend,
    whose flash wrapper runs its plain version on CPU tensors) or
    ``"non-overlap"`` (the baseline)."""
    if mode not in ("overlap", "non-overlap"):
        raise ValueError(f"mode must be 'overlap' or 'non-overlap', got {mode!r}")
    ch = channel or BlockChannel(axis="model")
    kw = dict(backend="fused") if mode == "overlap" else dict(backend="eager", overlapped=False)
    op = compile_overlap("ag_attention", ch, world=world, **kw)
    return lambda q, k, v: op(q, k, v, causal=True)


def attn_operands(world: World, s: int, heads: int, hd: int, dtype, batch: int = 1):
    """Seeded q, k, v [W, B, H, S/W, D] (every rank's rows of the sequence)."""
    w, dev = world.size, world.device
    gen = torch.Generator(device=dev).manual_seed(0)
    return tuple(torch.randn((w, batch, heads, s // w, hd), generator=gen, device=dev).to(dtype) for _ in range(3))


def attn_flops(s: int, heads: int, hd: int, batch: int = 1) -> int:
    """Causal attention's FLOPs: half of 4 S^2 H D (QK^T and PV)."""
    return 2 * batch * s * s * heads * hd


def overlap_ratio(comp_ms: float, comm_ms: float, overlap_ms: float) -> float:
    """The paper's overlap ratio: the share of the comm-only time hidden."""
    return (comp_ms + comm_ms - overlap_ms) / comm_ms


def row_fields(case: str, s: int, heads: int, hd: int, world_size: int, ms: dict) -> dict:
    """A Fig. 10 row from its measured medians ``ms`` (keys "overlap",
    "non-overlap", "comm", "comp", "library"): the times, the speedup, the
    overlap ratio and the bound."""
    nbytes = 2 * 4 * s * heads * hd  # q, k, v read once, o written once (bf16, batch 1)
    bound, by = bound_ms(attn_flops(s, heads, hd), nbytes, torch.bfloat16)
    return {
        "figure": "fig10", "case": case, "world": world_size, "shape": [s, heads, hd],
        "overlap_ms": ms["overlap"], "nonoverlap_ms": ms["non-overlap"], "comm_ms": ms["comm"],
        "comp_ms": ms["comp"], "library_ms": ms["library"], "speedup": ms["non-overlap"] / ms["overlap"],
        "overlap_ratio": overlap_ratio(ms["comp"], ms["comm"], ms["overlap"]), "bound_ms": bound, "bound_by": by,
    }  # fmt: skip


def _hold(out, ref, what: str):
    """Fail unless ``out`` is finite and within TOL x max |ref| of ``ref``."""
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not (bool(torch.isfinite(out).all()) and err <= TOL * scale):
        raise RuntimeError(f"{what}: max|err| {err} > {TOL} x max|non-overlap| {scale}")
    return err, scale


def _gather(world: World, k, v):
    """The emulated all-gather of K and V as the baseline runs it: every rank
    receives every rank's rows (W copies)."""
    return world.all_gather(k, dim=2).contiguous(), world.all_gather(v, dim=2).contiguous()


def _whole(t):
    """[W, B, H, S/W, D] -> [B, H, S, D] (the whole sequence)."""
    w, b, h, s_loc, d = t.shape
    return t.permute(1, 2, 0, 3, 4).reshape(b, h, w * s_loc, d)


def _peak(dev, fn) -> float:
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) / 2**20


def fig10_row(name: str, s: int, world_size: int, profile: bool = False) -> dict:
    """One Fig. 10 row on the card: every mode timed, the overlap's output
    held; ``profile`` adds one call of each mode under torch.profiler."""
    dev = resolve_device()
    heads, hd, _seqs = PAPER_ATTN[name]
    world = World(world_size, dev)
    q, k, v = attn_operands(world, s, heads, hd, torch.bfloat16)
    fns = {m: attention(m, world) for m in ("non-overlap", "overlap")}
    before = K.flash_attention.launches
    out = fns["overlap"](q, k, v)
    launches = K.flash_attention.launches - before
    err, scale = _hold(out, fns["non-overlap"](q, k, v), f"fig10 {name} S={s} W={world_size}")
    del out
    ms, peaks = {}, {}
    for m, fn in fns.items():
        ms[m] = event_ms(lambda fn=fn: fn(q, k, v), ITERS)[0]
        peaks[m] = _peak(dev, lambda fn=fn: fn(q, k, v))
    s_loc = s // world_size
    q_off = tuple(r * s_loc for r in range(world_size))
    ms["comm"] = event_ms(lambda: _gather(world, k, v), ITERS)[0]
    kg, vg = _gather(world, k, v)
    ms["comp"] = event_ms(
        lambda: flash_attention_ranked(q, kg, vg, q_off=q_off, k_off=(0,) * world_size, causal=True), ITERS
    )[0]
    del kg, vg
    torch.cuda.empty_cache()
    qw, kw, vw = _whole(q), _whole(k), _whole(v)
    ms["library"] = event_ms(lambda: F.scaled_dot_product_attention(qw, kw, vw, is_causal=True), ITERS)[0]
    del qw, kw, vw
    row = row_fields(name, s, heads, hd, world_size, ms)
    row.update(
        overlap_peak_mib=peaks["overlap"], nonoverlap_peak_mib=peaks["non-overlap"], flash_launches=launches,
        max_abs_err=err, max_abs_ref=scale,
    )  # fmt: skip
    if profile:
        windows = {m: (lambda fn=fn: fn(q, k, v)) for m, fn in fns.items()}
        row["profile"] = profile_windows(f"fig10 {name} S={s} W={world_size}", windows)
    del q, k, v
    torch.cuda.empty_cache()
    return row


def describe(row: dict) -> str:
    s, h, d = row["shape"]
    return (
        f"fig10 {row['case']} W={row['world']} [S {s}, H {h}, D {d}, causal]: non-overlap "
        f"{row['nonoverlap_ms']:.3f} ms, overlap {row['overlap_ms']:.3f} ms, speedup {row['speedup']:.3f}x; "
        f"comm-only {row['comm_ms']:.3f} ms, comp-only {row['comp_ms']:.3f} ms, overlap ratio "
        f"{row['overlap_ratio']:.3f}; SDPA {row['library_ms']:.3f} ms; bound {row['bound_ms']:.3f} ms "
        f"({row['bound_by']}); peak memory {row['overlap_peak_mib']:.0f} / {row['nonoverlap_peak_mib']:.0f} MiB "
        f"(overlap / non-overlap); flash launches {row['flash_launches']}; max|err| {row['max_abs_err']:.3e} "
        f"(bound {TOL:g} x max|non-overlap| {row['max_abs_ref']:.3e})"
    )


def main(argv=None) -> list:
    """Fig. 10 over both shapes and four sequence lengths, for W = 8 then 4."""
    ap = argparse.ArgumentParser(description="paper Fig. 10 on one card (W emulated ranks)")
    ap.add_argument("--json", default=None, help="also write the rows to this file")
    ap.add_argument("--profile", action="store_true", help="device time by kernel for one call of each mode")
    ap.add_argument("--rows", default=None, help="only these 'Attn-1:16384,...' rows (default: all)")
    args = ap.parse_args(argv)
    dev = resolve_device()
    print(f"[paper] {torch.cuda.get_device_name(dev)}; nvidia-smi: {card_line()}; {CAVEAT}")
    only = None if args.rows is None else {tuple(r.split(":")) for r in args.rows.split(",")}
    rows = []
    for w in WORLDS:
        for name, (_h, _d, seqs) in PAPER_ATTN.items():
            for s in seqs:
                if only is not None and (name, str(s)) not in only:
                    continue
                rows.append(fig10_row(name, s, w, args.profile))
                print(describe(rows[-1]), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card_line(), "caveat": CAVEAT, "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main()
