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

__all__ = ["event_ms", "bound_ms", "profile_windows", "card_line", "fp32_reductions", "PEAK_OPS", "MEM_BYTES_PER_S"]

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


def profile_windows(label: str, windows: dict) -> dict:
    """Profile each window (a callable) once under torch.profiler: wall time,
    device kernel time, the device's idle share, and the top kernels by
    device time, printed and returned."""
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
    return out


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )  # fmt: skip
    return res.stdout.strip().splitlines()[0]
