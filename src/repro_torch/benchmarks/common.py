"""Measurement helpers of the port's benchmarks and ``chip_smoke.py``:
CUDA-event timing, roofline bounds, device time by kernel (torch.profiler),
the card's name and power limit.

Bounds use the H100 SXM's published dense peaks (NVIDIA's data sheet).
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
from typing import Callable, List, Tuple

import torch

__all__ = ["event_ms", "bound_ms", "profile_windows", "nccl_concurrency", "card_line", "fp32_reductions", "PEAK_OPS",
           "MEM_BYTES_PER_S"]  # fmt: skip

# published dense peaks of one H100 SXM, by dtype, and its memory rate
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
MEM_BYTES_PER_S = 3.35e12


@contextlib.contextmanager
def fp32_reductions():
    """Inside, bf16 GEMMs keep float32 sums: PyTorch's reduced-precision
    (split-K in bf16) reductions are off, as the baselines' semantics need."""
    matmul = torch.backends.cuda.matmul
    flag = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = flag


def event_ms(fn: Callable[[], object], iters: int, warmup: int = 3) -> Tuple[float, List[float]]:
    """Median and all per-call times (ms) of ``fn`` over ``iters`` calls, each
    between two CUDA events, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times), times


def bound_ms(flops: float, nbytes: float, dtype: torch.dtype) -> Tuple[float, str]:
    """The least time the card could take: the larger of the operations over
    the peak rate for their type and the bytes over the memory rate."""
    t_ops, t_mem = flops / PEAK_OPS[dtype], nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def _spans(intervals) -> list:
    """The union of ``(start, end)`` intervals, merged, in order."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _shared_us(xs: list, ys: list) -> float:
    """The time two unions of intervals (:func:`_spans`) cover at once."""
    i = j = 0
    t = 0.0
    while i < len(xs) and j < len(ys):
        t += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return t


def nccl_concurrency(kernels) -> dict:
    """From the device kernels' ``(name, start_us, end_us)``: the time NCCL's
    kernels cover, the time the GEMM kernels (names holding "gemm" or
    "grouped") cover, and the time both run at once on the device."""
    named = [(n.lower(), a, b) for n, a, b in kernels]
    nccl = _spans([(a, b) for n, a, b in named if "nccl" in n])
    gemm = _spans([(a, b) for n, a, b in named if "nccl" not in n and ("gemm" in n or "grouped" in n)])
    return {"nccl_us": sum(b - a for a, b in nccl), "gemm_us": sum(b - a for a, b in gemm),
            "nccl_with_gemm_us": _shared_us(nccl, gemm)}  # fmt: skip


def profile_windows(label: str, windows: dict) -> dict:
    """Profile each window (a callable) once under torch.profiler: wall time,
    device kernel time, the device's idle share, the top kernels by device
    time, and where NCCL's kernels ran, the time they ran at once with the
    GEMM kernels (:func:`nccl_concurrency`), printed and returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in windows.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only (CPU ops also carry their children's device time)
        rows = [
            (e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0
        ]
        busy = sum(r[1] for r in rows)
        rows.sort(key=lambda r: -r[1])
        print(f"[profile] {label} {name}: wall {wall_us / 1e3:.2f} ms, device kernels {busy / 1e3:.2f} ms "
              f"(idle share {max(0.0, 1 - busy / wall_us):.3f}; {sum(r[2] for r in rows)} kernels)")  # fmt: skip
        for key, t, n in rows[:8]:
            print(f"[profile]   {t / 1e3:9.3f} ms  x{n:<5d} {key[:90]}")
        out[name] = {"wall_us": wall_us, "kernel_us": busy, "kernels": sum(r[2] for r in rows), "top": rows[:8]}
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        both = nccl_concurrency([(e.name, e.time_range.start, e.time_range.end) for e in device])
        if both["nccl_us"]:
            print(f"[profile]   NCCL kernels {both['nccl_us'] / 1e3:.3f} ms, GEMM kernels "
                  f"{both['gemm_us'] / 1e3:.3f} ms, both at once {both['nccl_with_gemm_us'] / 1e3:.3f} ms")
            out[name].update(both)
    return out


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )  # fmt: skip
    return res.stdout.strip().splitlines()[0]
