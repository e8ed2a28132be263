"""Quickstart: TileLink's tile-centric overlap on the port, in one file.

Runs the paper's motivating TP-MLP projection, all_gather(x) @ w over W
ranks, three ways on the same operands: the overlapped tile program (the
AllGather decomposed into ring permutes, each step's GEMM on the tile that
has landed; the eager executor), the non-overlapped baseline (one gather,
then the GEMM), and the fused AG+GEMM kernel (``backend="fused"``: the
ring inside one launch on the card, its plain version on the CPU).  It
checks that they agree and prints each path's transport from the
``World``'s ``CommCounter`` (where the JAX package's quickstart prints the
collectives of the compiled HLO): the ring's permutes against the
baseline's one gather, and none for the kernel, whose tiles travel inside
the launch.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.backend.mesh import World
from repro_torch.core import BlockChannel, CommSpec, compile_overlap

ATOL = 1e-3  # float32 paths that differ by summation order only (the JAX package's bound)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="overlapped vs non-overlapped AG+GEMM on W emulated ranks")
    ap.add_argument("--device", default=None, help="default: cuda (raises when absent); 'cpu' runs the plain versions")
    ap.add_argument("--tokens", type=int, default=1024, help="S, rows of x")
    ap.add_argument("--hidden", type=int, default=512, help="H, columns of x")
    ap.add_argument("--ffn", type=int, default=1408, help="FF, columns of w")
    ap.add_argument("--world", type=int, default=8, help="W, ranks emulated on the device")
    ap.add_argument("--channels", type=int, default=2, help="C, channels per rank")
    args = ap.parse_args(argv)

    world = World(args.world, args.device)
    channel = BlockChannel(axis="model", num_channels=args.channels, comm=CommSpec(order="ring"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((args.tokens, args.hidden), dtype=np.float32)).to(world.device)
    w = torch.from_numpy(rng.standard_normal((args.hidden, args.ffn), dtype=np.float32)).to(world.device)
    xs = world.shard(x, dim=0)  # [W, S/W, H]: rows sharded
    ws = world.shard(w, dim=1)  # [W, H, FF/W]: columns sharded

    paths = {
        "tilelink": compile_overlap("ag_matmul", channel, world=world, overlapped=True),
        "non-overlap": compile_overlap("ag_matmul", channel, world=world, overlapped=False),
        "fused kernel": compile_overlap("ag_matmul", channel, world=world, backend="fused"),
    }
    outs, counts = {}, {}
    for name, fn in paths.items():
        with world.counting() as counter:
            outs[name] = fn(xs, ws)
        counts[name] = {k: dict(v) for k, v in counter.payload.items() if v}
    errs = {name: (y - outs["non-overlap"]).abs().max().item() for name, y in outs.items()}
    for name, err in errs.items():
        if err > ATOL:
            raise SystemExit(f"quickstart: {name} differs from the non-overlap baseline by {err} > {ATOL}")
    print(f"TileLink overlap == non-overlap baseline == fused kernel on {world}: OK "
          f"(S {args.tokens}, H {args.hidden}, FF {args.ffn}, C {args.channels})")  # fmt: skip
    for name in paths:
        print(f"{name:12s} transport (bytes per rank by collective and group): {counts[name] or 'none'}")
    print("note: the overlapped program decomposes the AllGather into ring permutes, each step's GEMM "
          "consuming the tile that landed; the fused kernel moves its tiles inside the launch")  # fmt: skip
    return {"outputs": outs, "counts": counts, "max_abs_err": errs}


if __name__ == "__main__":
    main()
