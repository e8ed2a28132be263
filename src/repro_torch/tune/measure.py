"""Measured ranker — time candidates through the port's own ``compile_overlap``.

The port's counterpart of ``repro/tune/measure.py``.  Each candidate is
realized as a ``BlockChannel``, compiled with ``compile_overlap`` (the entry
point the model uses, no tuning-only path) for the :class:`World` and
backend being tuned, and timed on operands built from the signature once per
case, so candidate scores differ only by the design point.  On the card the
fused backend's candidates launch the hand-written kernels.

Timing (:func:`time_fn`):

  * ``warmup >= 1`` launches run first: the first launch of a new (C,
    order) builds its plan, its device tables and flags, and the first
    launch of all builds the kernel library, so neither is ever scored;
  * then each of ``repeats`` launches is timed on its own, with CUDA events
    around it on the card (``elapsed_time`` after one synchronise), or with
    the host clock on the CPU (synchronous there);
  * the result is ``(median_us, iqr_us)``, the iqr the sweep's noise band.

A signature is per rank.  A decode signature (negated lead, ``signature(...,
decode=True)``) is measured as one GEMM over the decode batch's rows, the
lead folded into the rows (``|lead| * m``, for a GEMM+RS rounded up to a
multiple of W): one token per slot, so a GEMM+RS can scatter the slots' rows
over the ranks.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch

from repro_torch.core.channels import BlockChannel
from repro_torch.tune.candidates import TUNABLE_KINDS

__all__ = ["build_case", "measure_channel", "time_fn", "CaseTimer"]


def time_fn(fn: Callable, *args, repeats: int = 3, warmup: int = 1) -> Tuple[float, float]:
    """``(median_us, iqr_us)`` per call of ``fn(*args)`` after ``warmup`` calls
    (module docstring): CUDA events when an argument lives on the card."""
    if warmup < 1:
        raise ValueError(f"time_fn needs warmup >= 1 (a cold call must never be scored), got {warmup}")
    if repeats < 1:
        raise ValueError(f"time_fn needs repeats >= 1, got {repeats}")
    dev = next((a.device for a in args if isinstance(a, torch.Tensor) and a.is_cuda), None)
    with torch.no_grad():
        for _ in range(warmup):
            fn(*args)
        if dev is not None:
            events = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2)) for _ in range(repeats)]
            torch.cuda.synchronize(dev)
            for start, end in events:
                start.record()
                fn(*args)
                end.record()
            torch.cuda.synchronize(dev)
            ts = sorted(start.elapsed_time(end) * 1e3 for start, end in events)
        else:
            ts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                fn(*args)
                ts.append((time.perf_counter() - t0) * 1e6)
            ts.sort()
    n = len(ts)
    return ts[n // 2], ts[min(n - 1, (3 * n) // 4)] - ts[n // 4]


def _rows(lead: int, m: int, multiple: int = 1) -> Tuple[int, ...]:
    """Per-rank leading shape of a GEMM operand: a decode lead folds into the
    rows, rounded up to a multiple of ``multiple``."""
    if lead < 0:
        return (-(-(-lead * m) // multiple) * multiple,)
    return ((lead,) if lead > 1 else ()) + (m,)


def build_case(kind: str, world, sig: Tuple[int, ...], *, backend: str = "eager", dtype=torch.float32, seed: int = 0):
    """``(build, args)``: ``build(channel)`` is the compiled op for ``world``
    on ``backend``; ``args`` its rank-stacked operands on the world's device
    in ``dtype``, drawn once from ``seed``."""
    from repro_torch.core.compiler import compile_overlap  # late: the compiler imports the tuner

    w_ = world.size
    gen = torch.Generator(device=world.device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=world.device) * scale).to(dtype)

    def compiled(**kw):
        return lambda ch: compile_overlap(kind, ch, world=world, backend=backend, **kw)

    if kind == "ag_matmul":
        lead, m_loc, k, n_loc = sig
        return compiled(), (randn(w_, *_rows(lead, m_loc), k), randn(w_, k, n_loc, scale=k**-0.5))
    if kind == "matmul_rs":
        lead, m_glob, k_loc, n = sig
        return compiled(), (randn(w_, *_rows(lead, m_glob, w_), k_loc), randn(w_, k_loc, n, scale=k_loc**-0.5))
    if kind == "ag_attention":
        b, h, hkv, s_loc, d = sig
        q = randn(w_, b, h, s_loc, d)
        kv = randn(w_, b, hkv, s_loc, d)
        return compiled(causal=True), (q, kv, randn(w_, b, hkv, s_loc, d))
    if kind == "ag_moe":
        from repro_torch.core.moe_overlap import moe_router

        m_loc, d_model, top_k, e_loc, d_exp = sig[:5]
        e = e_loc * w_
        x = randn(w_, m_loc, d_model, scale=0.5)
        ids, wts, _ = moe_router(x, randn(d_model, e), num_experts=e, top_k=max(1, top_k))
        w_gu = randn(w_, e_loc, d_model, 2 * d_exp, scale=0.1)
        w_down = randn(w_, e_loc, d_exp, d_model, scale=0.1)
        return compiled(capacity_factor=8.0), (x, ids, wts, w_gu, w_down)
    raise ValueError(f"kind {kind!r} is not measurable; one of {TUNABLE_KINDS}")


class CaseTimer:
    """One ``(kind, world, signature, backend, dtype)`` measurement context
    for a whole sweep: the operands are built once and shared by every
    candidate."""

    def __init__(self, kind: str, world, sig: Tuple[int, ...], *, backend: str = "eager", dtype=torch.float32):
        self.kind = kind
        self._build, self.args = build_case(kind, world, tuple(sig), backend=backend, dtype=dtype)

    def run(self, channel: BlockChannel):
        """One call of the candidate's compiled op on the shared operands."""
        with torch.no_grad():
            return self._build(channel)(*self.args)

    def time(self, channel: BlockChannel, *, repeats: int = 3, warmup: int = 1) -> Tuple[float, float]:
        """``(median_us, iqr_us)`` of one realized candidate."""
        return time_fn(self._build(channel), *self.args, repeats=repeats, warmup=warmup)


def measure_channel(
    kind: str, channel: BlockChannel, world, sig, *, backend="eager", dtype=torch.float32, repeats=3, warmup=1
) -> Tuple[float, float]:
    """``(median_us, iqr_us)`` of one realized candidate on ``world``."""
    return CaseTimer(kind, world, sig, backend=backend, dtype=dtype).time(channel, repeats=repeats, warmup=warmup)
