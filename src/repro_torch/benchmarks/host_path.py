"""Per-call cost of the fused kernels' wrappers on one card, and the prefill they serve.

    python -m repro_torch.benchmarks.host_path [--iters N] [--rounds R] [--prefills N] [--json PATH]

At ``P = 1`` every rank is emulated on one card and each AG+GEMM / GEMM+RS
call makes its receive regions, builds its launch's table and launches one
cooperative grid: host work that the smollm-360m shapes (a few tens of
microseconds of device time a call) cannot hide.  For each case this
prints the mean time of back-to-back calls (CUDA events: the host's cost
where it exceeds the kernel's), the median of ``--rounds`` rounds of
``--iters`` calls, beside the kernels' device time
(torch.profiler), then smollm-360m's bf16 prefill (W = 4, 4 x 256 tokens,
32 layers, seeded weights) through ``launch/serve.greedy``, the median of
``--prefills`` runs.  It uses only the wrappers' and the models' public
calls, so one copy of it times two checkouts (``PYTHONPATH=<checkout>/src``)
on one machine, in turns.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

WORLD, BATCH, PROMPT, D, N_QKV, N_GU, N_O = 4, 4, 256, 960, 512, 1280, 256


def _cases(dev) -> dict:
    """(kind, x, w) of smollm-360m's fused calls at W = 4, B x S = 4 x 256
    (bf16), and the quant path's int8-packed float32 GEMM+RS (down)."""
    from repro_torch.core.quant import QuantSpec, pack_weight

    g = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g) * scale).to(dtype).to(dev)

    m_loc = PROMPT // WORLD
    out = {
        "qkv": ("ag_gemm", rnd(WORLD, BATCH, m_loc, D), rnd(WORLD, D, N_QKV, scale=D**-0.5)),
        "gate_up": ("ag_gemm", rnd(WORLD, BATCH, m_loc, D), rnd(WORLD, D, N_GU, scale=D**-0.5)),
        "o_proj": ("gemm_rs", rnd(WORLD, BATCH, PROMPT, N_O), rnd(WORLD, N_O, D, scale=N_O**-0.5)),
        "down": ("gemm_rs", rnd(WORLD, BATCH, PROMPT, N_GU // 2), rnd(WORLD, N_GU // 2, D, scale=(N_GU // 2) ** -0.5)),
    }
    wf = rnd(WORLD, N_GU // 2, D, scale=(N_GU // 2) ** -0.5, dtype=torch.float32)
    out["down packed int8 f32"] = ("gemm_rs", rnd(WORLD, BATCH, PROMPT, N_GU // 2, dtype=torch.float32),
                                   pack_weight(wf, QuantSpec(weight_dtype="int8")))  # fmt: skip
    return out


def wall_ms(fn, iters: int, rounds: int) -> list:
    """Mean time of ``iters`` back-to-back calls (CUDA events), each of ``rounds`` rounds, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / iters)
    return out


def device_ms(fn, iters: int):
    """The kernels' device time a call (torch.profiler), or None when it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return total / iters / 1e3 if total > 0 else None


def prefill_ms(runs: int, dev) -> list:
    """smollm-360m's bf16 prefill (ms, host clock as ``serve.greedy`` takes it), ``runs`` times after a warm-up."""
    from repro_torch.backend.mesh import World
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.context import ParallelContext

    cfg = get_config("smollm-360m")
    pc = ParallelContext(world=World(WORLD, dev))
    params = lm.init(cfg, pc.world, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
    prompts = torch.as_tensor(serve.make_prompts(cfg.vocab_size, BATCH, PROMPT, 0), device=dev)
    serve.greedy(params, cfg, pc, prompts, 2, PROMPT + 2)
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        out.append(serve.greedy(params, cfg, pc, prompts, 2, PROMPT + 2)[1]["prefill_s"] * 1e3)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--prefills", type=int, default=7)
    ap.add_argument("--tag", default="")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_path: no CUDA device")
    from repro_torch import kernels as K

    dev = torch.device("cuda", 0)
    rec = {"tag": args.tag, "card": torch.cuda.get_device_name(0), "cases": {}}
    for name, (kind, x, w) in _cases(dev).items():
        fn = getattr(K, kind)
        call = lambda: fn(x, w)  # noqa: E731
        walls = wall_ms(call, args.iters, args.rounds)
        rec["cases"][name] = {"wall_ms": statistics.median(walls), "wall_rounds": walls, "device_ms": device_ms(call, 20)}
        print(f"[host_path {args.tag}] {kind} {name}: {rec['cases'][name]['wall_ms']:.4f} ms a call back to back "
              f"(median of {[round(v, 4) for v in walls]}), device {rec['cases'][name]['device_ms']}",
              flush=True)  # fmt: skip
    runs = prefill_ms(args.prefills, dev)
    rec["prefill_ms"] = {"runs": runs, "median": statistics.median(runs)}
    print(f"[host_path {args.tag}] smollm-360m bf16 prefill {BATCH} x {PROMPT}: median {rec['prefill_ms']['median']:.2f} "
          f"ms of {[round(r, 2) for r in runs]}", flush=True)  # fmt: skip
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        with open(args.json, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
