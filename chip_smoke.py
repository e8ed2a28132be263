#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port in phases; each prints its own lines and any failure exits
non-zero (no phase catches its own failure):

  1. device   the card's name, count, torch / CUDA versions and power limit;
              TF32 off, so the float32 plain versions are true float32.
  2. build    builds the kernels from ``src/repro_torch/kernels/csrc``.
  3. kernels  every kernel against its plain PyTorch version at the shapes
              the serve path gives it (smollm-360m, W = 4 emulated ranks,
              4 requests x 256 tokens), in float32 and bfloat16, plus the
              fused kernels over every tile order x C in {1, 2}; kernel,
              plain-version and library-call times with CUDA events.
  4. serve    smollm-360m at its published size with seeded weights: the
              float32 prefill through the fused kernels against the eager
              executor with plain attention, then the main path in bfloat16
              (prefill + greedy decode), with the kernels' launch counts.
  5. summary  the launch counts, the per-kernel JSON line, the card's power
              limit, and the last line ``{"ok": true, "device": {...}}``.

Usage: ``python3 chip_smoke.py`` (one CUDA device).  Needs the repository
(``src/``) beside this script and ``nvcc`` (PATH or /usr/local/cuda/bin).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "smollm-360m"
WORLD, BATCH, PROMPT, NEW_TOKENS = 4, 4, 256, 16
ITERS = 20  # timed launches per kernel case (after warm-up)
# published dense peaks of the H100 SXM and its memory rate (bound_ms)
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
MEM_BYTES_PER_S = 3.35e12
# kernel vs plain: float32 agrees to summation order; bfloat16 outputs round
# to 8 mantissa bits (2^-8 = 3.9e-3 relative) in both versions, plus the
# plain version's bf16 pre-scale of q in attention
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# prefill logits, fused vs eager (float32): as tests/test_serving.py
LOGIT_ATOL = LOGIT_RTOL = 2e-3
REPLACES = {
    "matmul": "src/repro/kernels/matmul.py:35",
    "ag_gemm": "src/repro/kernels/ag_gemm.py:145",
    "gemm_rs": "src/repro/kernels/gemm_rs.py:183",
    "flash_attention": "src/repro/kernels/flash_attention.py:101",
}
SOURCES = {
    "matmul": "src/repro_torch/kernels/csrc/matmul.cu",
    "ag_gemm": "src/repro_torch/kernels/csrc/ag_gemm.cu",
    "gemm_rs": "src/repro_torch/kernels/csrc/gemm_rs.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )  # fmt: skip
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(flops: float, nbytes: float, dtype_name: str):
    t_ops = flops / PEAK_OPS[dtype_name]
    t_mem = nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; count {torch.cuda.device_count()}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    smi = nvidia_smi()
    print(f"[device] nvidia-smi: {smi}")
    from repro_torch.backend import hw

    info = hw.require_hopper(torch.device("cuda", 0))
    print(f"[device] {info.sm_count} SMs, {info.smem_per_block_optin} B shared memory per block (opt-in)")
    return name, smi


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    dt = time.perf_counter() - t0
    print(f"[build] kernels built and loaded in {dt:.1f} s")
    for line in build.ptxas_report().splitlines():
        if "registers" in line or "spill" in line.lower():
            print(f"[build] {line.strip()}")
    return dt


def _case(name, dtype, kernel, plain, library, flops, nbytes, iters, check_only=False):
    """Run one kernel case: max error vs the plain version, then times."""
    import torch

    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    dn = str(dtype).removeprefix("torch.")
    ok = bool(torch.isfinite(out).all().item()) and err <= TOL[dn] * max(scale, 1e-30)
    rec = {"case": name, "dtype": dn, "max_abs_err": err, "max_abs_ref": scale, "tol_rel": TOL[dn], "ok": ok}
    if not check_only:
        rec["ms"] = cuda_ms(kernel, iters)
        rec["plain_ms"] = cuda_ms(plain, max(2, iters // 4))
        rec["library_ms"] = cuda_ms(library, iters) if library is not None else None
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, dn)
    times = "" if check_only else (
        f" ms {rec['ms']:.4f} plain {rec['plain_ms']:.4f} library "
        f"{rec['library_ms'] if rec['library_ms'] is None else round(rec['library_ms'], 4)} "
        f"bound {rec['bound_ms']:.4f} ({rec['bound_by']})"
    )  # fmt: skip
    print(f"[kernels] {name} {dn}: max|err| {err:.3e} (max|ref| {scale:.3e}, bound {TOL[dn]:g} x max|ref|){times}")
    if not ok:
        raise SystemExit(f"chip_smoke: kernel {name} ({dn}) disagrees with its plain version: {err} > {TOL[dn]} x {scale}")
    return rec


def phase_kernels(iters: int):
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.core.channels import BlockChannel, CommSpec

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    W, B, S = WORLD, BATCH, PROMPT
    s_loc = S // W
    d, hd, n_qkv, n_gu, n_o, f_loc = 960, 64, 512, 1280, 256, 640
    recs = {}

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        it = iters if dtype == torch.bfloat16 else 2
        check_only = dtype != torch.bfloat16  # times are taken in the serving dtype
        isz = torch.tensor([], dtype=dtype).element_size()
        # --- ag_gemm: qkv and gate/up projections
        for tag, n in (("qkv", n_qkv), ("gate_up", n_gu)):
            x, w = rnd(W, B, s_loc, d, dtype=dtype), rnd(W, d, n, dtype=dtype) * d**-0.5
            xg = x.permute(1, 0, 2, 3).reshape(B, S, d)
            recs[("ag_gemm", tag, dtype)] = _case(
                f"ag_gemm[{tag}] x{list(x.shape)} w{list(w.shape)}", dtype,
                lambda: K.ag_gemm(x, w), lambda: K.ag_gemm_plain(x, w),
                lambda: torch.matmul(xg[None], w[:, None]),
                2 * W * B * S * d * n, isz * (x.numel() + w.numel() + W * B * S * n), it, check_only,
            )  # fmt: skip
        # --- gemm_rs: attention out-projection and MLP down projection
        for tag, k in (("o_proj", n_o), ("down", f_loc)):
            x, w = rnd(W, B, S, k, dtype=dtype), rnd(W, k, d, dtype=dtype) * (W * k) ** -0.5
            recs[("gemm_rs", tag, dtype)] = _case(
                f"gemm_rs[{tag}] x{list(x.shape)} w{list(w.shape)}", dtype,
                lambda: K.gemm_rs(x, w), lambda: K.gemm_rs_plain(x, w),
                lambda: torch.matmul(x, w[:, None]).sum(0),
                2 * W * B * S * k * d, isz * (x.numel() + w.numel() + W * B * s_loc * d), it, check_only,
            )  # fmt: skip
        # --- flash attention: [W*B*h_loc, S, hd] vs [W*B*kv_loc, S, hd], causal
        q = rnd(W * B * 4, S, hd, dtype=dtype)
        kk, vv = rnd(W * B * 2, S, hd, dtype=dtype), rnd(W * B * 2, S, hd, dtype=dtype)
        ke, ve = kk.repeat_interleave(2, 0)[None], vv.repeat_interleave(2, 0)[None]
        pairs = S * (S + 1) // 2
        recs[("flash_attention", "prefill", dtype)] = _case(
            f"flash_attention q{list(q.shape)} kv{list(kk.shape)} causal", dtype,
            lambda: K.flash_attention(q, kk, vv, causal=True),
            lambda: K.flash_attention_plain(q, kk, vv, causal=True),
            lambda: F.scaled_dot_product_attention(q[None], ke, ve, is_causal=True),
            4 * q.shape[0] * pairs * hd, isz * (2 * q.numel() + kk.numel() + vv.numel()), it, check_only,
        )  # fmt: skip
        # --- matmul: the LM head of the prefill
        vocab = 49152
        x, w = rnd(B * S, d, dtype=dtype), rnd(d, vocab, dtype=dtype) * 0.02
        recs[("matmul", "lm_head", dtype)] = _case(
            f"matmul[lm_head] x{list(x.shape)} w{list(w.shape)}", dtype,
            lambda: K.matmul(x, w), lambda: K.matmul_plain(x, w), lambda: torch.matmul(x, w),
            2 * B * S * d * vocab, isz * (x.numel() + w.numel() + B * S * vocab), it, check_only,
        )  # fmt: skip

    # --- every order x C in {1, 2} through both fused kernels (float32)
    for order in ("ring", "bidir_ring", "all2all"):
        for nch in (1, 2):
            ch = BlockChannel(axis="model", num_channels=nch, comm=CommSpec(order=order))
            x, w = rnd(W, B, s_loc, d, dtype=torch.float32), rnd(W, d, n_qkv, dtype=torch.float32) * d**-0.5
            _case(f"ag_gemm {order} C{nch}", torch.float32, lambda: K.ag_gemm(x, w, channel=ch),
                  lambda: K.ag_gemm_plain(x, w, channel=ch), None, 0, 0, 0, True)  # fmt: skip
            x, w = rnd(W, B, S, n_o, dtype=torch.float32), rnd(W, n_o, d, dtype=torch.float32) * (W * n_o) ** -0.5
            _case(f"gemm_rs {order} C{nch}", torch.float32, lambda: K.gemm_rs(x, w, channel=ch),
                  lambda: K.gemm_rs_plain(x, w, channel=ch), None, 0, 0, 0, True)  # fmt: skip
    return recs


def phase_serve(profile: bool = False):
    import torch

    from repro_torch import kernels as K
    from repro_torch.backend.mesh import World
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext

    cfg = get_config(ARCH)
    world = World(WORLD, "cuda")
    pc = ParallelContext(world=world)
    pc_eager = ParallelContext(world=world, backend="eager")
    assert pc.backend == "fused", pc.backend
    prompts = torch.from_numpy(serve.make_prompts(cfg.vocab_size, BATCH, PROMPT, seed=0)).to(world.device)
    max_len = PROMPT + NEW_TOKENS

    # float32: the fused prefill against the eager executor + plain attention
    params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.float32)
    lg_f, _ = lm.prefill(params, cfg, pc, prompts, max_len=max_len)
    lg_e, _ = lm.prefill(params, cfg, pc_eager, prompts, max_len=max_len)
    a, b = lg_f[:, -1].float(), lg_e[:, -1].float()
    diff = (a - b).abs()
    worst = (diff - LOGIT_RTOL * b.abs()).max().item()
    print(
        f"[serve] f32 prefill last-position logits, fused vs eager: max|diff| {diff.max().item():.3e} "
        f"(bound |diff| <= {LOGIT_ATOL:g} + {LOGIT_RTOL:g} x |eager|; max|eager| {b.abs().max().item():.3e})"
    )
    if not (torch.isfinite(a).all() and worst <= LOGIT_ATOL):
        raise SystemExit("chip_smoke: fused prefill logits disagree with the eager path")
    del params, lg_f, lg_e, a, b, diff
    torch.cuda.empty_cache()

    # bfloat16: the main path (prefill + greedy decode) through the kernels
    params = lm.init(cfg, world, torch.Generator(device=world.device).manual_seed(0), torch.bfloat16)
    warm, _ = serve.greedy(params, cfg, pc, prompts, NEW_TOKENS, max_len)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    tokens, t = serve.greedy(params, cfg, pc, prompts, NEW_TOKENS, max_len)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = t["prefill_s"] * 1e3
    tps = BATCH * t["decode_steps"] / t["decode_s"]
    print(
        f"[serve] bf16 {ARCH} W={WORLD}: {BATCH} requests x {PROMPT} prompt tokens + {NEW_TOKENS} greedy tokens; "
        f"prefill {prefill_ms:.2f} ms, decode {tps:.1f} tokens/s ({t['decode_steps']} steps), "
        f"peak memory {peak / 2**20:.0f} MiB"
    )
    print(f"[serve] launch counts of the main path: {counts}")
    expect = {"ag_gemm": 2 * cfg.n_layers, "gemm_rs": 2 * cfg.n_layers, "flash_attention": cfg.n_layers,
              "matmul": NEW_TOKENS}  # fmt: skip
    if counts != expect:
        raise SystemExit(f"chip_smoke: launch counts {counts} != expected {expect}")
    if tuple(tokens.shape) != (BATCH, NEW_TOKENS) or not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise SystemExit(f"chip_smoke: bad generated tokens {tokens.shape}")
    if not torch.equal(tokens, warm):
        raise SystemExit("chip_smoke: two greedy runs on the same weights gave different tokens")
    print(f"[serve] tokens[0]: {tokens[0].tolist()}")
    result = {"prefill_ms": prefill_ms, "decode_tokens_per_s": tps, "peak_bytes": peak, "counts": counts}
    if profile:
        result["profile"] = _profile(params, cfg, pc, prompts, max_len)
    return result


def _profile(params, cfg, pc, prompts, max_len):
    """Device time by kernel name for one prefill and one decode step
    (torch.profiler), with the device-busy share of each window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm

    out = {}
    _, caches = lm.prefill(params, cfg, pc, prompts, max_len=max_len)
    tok = prompts[:, -1:]
    windows = {
        "prefill": lambda: lm.prefill(params, cfg, pc, prompts, max_len=max_len),
        "decode_step": lambda: lm.decode_step(params, caches, cfg, pc, tok, PROMPT),
    }
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
        print(f"[profile] {name}: wall {wall_us / 1e3:.2f} ms, device kernels {busy / 1e3:.2f} ms "
              f"(idle share {max(0.0, 1 - busy / wall_us):.3f})")  # fmt: skip
        for key, t, n in rows[:8]:
            print(f"[profile]   {t / 1e3:9.3f} ms  x{n:<5d} {key[:90]}")
        out[name] = {"wall_us": wall_us, "kernel_us": busy, "top": rows[:8]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chip smoke test of the PyTorch/CUDA port")
    ap.add_argument("--json", default=None, help="also write every measured record to this file")
    ap.add_argument("--profile", action="store_true", help="device time by kernel for one prefill / decode step")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    kind, smi = phase_device()
    out = {"device": kind, "nvidia_smi": smi, "build_s": phase_build()}
    recs = phase_kernels(ITERS)
    out["serve"] = phase_serve(args.profile)
    counts = out["serve"]["counts"]
    print("kernels: " + json.dumps(counts))
    line = []
    for name, tag in (("matmul", "lm_head"), ("ag_gemm", "gate_up"), ("gemm_rs", "down"),
                      ("flash_attention", "prefill")):  # fmt: skip
        r = recs[(name, tag, torch.bfloat16)]
        line.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": counts.get(name, 0), "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["case"], "dtype": r["dtype"],
        })  # fmt: skip
    if args.json:
        out["cases"] = [r for r in recs.values()]
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1, default=str))
    print(f"{smi}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
