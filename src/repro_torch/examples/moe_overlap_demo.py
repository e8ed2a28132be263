"""Dynamic-mapping demo: the paper's AG + MoE double ring (Fig. 5) on the port.

Routes tokens with a top-k router (the routing tables travel with the
token tiles around the ring), runs the overlapped AG -> grouped GEMM ->
top-k reduce -> RS chain (``core/moe_overlap.ag_moe``, its expert GEMMs on
the grouped kernel: the hand-written kernel on the card, its plain version
on the CPU), and checks it against a dense per-expert oracle.

Run:  PYTHONPATH=src python -m repro_torch.examples.moe_overlap_demo [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import kernels as K
from repro_torch.backend.mesh import World
from repro_torch.core.moe_overlap import ag_moe, moe_router

ATOL = 1e-4  # float32, summation order only (the JAX package's bound)
CAPACITY = 8.0  # no token is dropped, so the dense oracle applies


def dense_oracle(x, w_router, w_gu, w_down, top_k: int) -> torch.Tensor:
    """Every token through its top-k experts, weighted, summed: no capacity."""
    e, f = w_gu.shape[0], w_down.shape[1]
    probs = torch.softmax(x @ w_router, -1)
    top_w, top_i = torch.topk(probs, top_k, -1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for ei in range(e):
        h = x @ w_gu[ei]
        y = (F.silu(h[:, :f]) * h[:, f:]) @ w_down[ei]
        out += ((top_i == ei) * top_w).sum(-1)[:, None] * y
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="AG + MoE double ring against a dense per-expert oracle")
    ap.add_argument("--device", default=None, help="default: cuda (raises when absent); 'cpu' runs the plain versions")
    ap.add_argument("--experts", type=int, default=16)
    ap.add_argument("--top-k", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--d-expert", type=int, default=128)
    ap.add_argument("--world", type=int, default=8, help="ranks emulated on the device")
    args = ap.parse_args(argv)

    world = World(args.world, args.device)
    e, k, d, f, tok = args.experts, args.top_k, args.d_model, args.d_expert, args.tokens
    rng = np.random.default_rng(0)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(world.device)

    x, w_router = rand(tok, d, scale=0.5), rand(d, e)
    w_gu, w_down = rand(e, d, 2 * f, scale=0.1), rand(e, f, d, scale=0.1)
    xs = world.shard(x, dim=0)  # [W, tok/W, d]: each rank's token chunk
    ids, wts, _ = moe_router(xs, w_router, num_experts=e, top_k=k)
    e_loc = e // world.size  # rank r hosts experts r*e_loc .. (r+1)*e_loc - 1
    before = K.grouped_matmul.launches
    ys = ag_moe(xs, ids, wts, w_gu.reshape(world.size, e_loc, d, 2 * f), w_down.reshape(world.size, e_loc, f, d),
                world=world, capacity_factor=CAPACITY, grouped=True)  # fmt: skip
    launches = K.grouped_matmul.launches - before
    err = (world.unshard(ys, dim=0) - dense_oracle(x, w_router, w_gu, w_down, k)).abs().max().item()
    if err > ATOL:
        raise SystemExit(f"moe_overlap_demo: the double ring differs from the dense oracle by {err} > {ATOL}")
    print(f"AG+MoE double ring over {world.size} ranks == dense oracle (E={e}, top-{k}, {tok} tokens) on "
          f"{world.device}: OK (max|diff| {err:.2e}; grouped-GEMM kernel launches {launches})")  # fmt: skip
    return {"max_abs_err": err, "grouped_launches": launches}


if __name__ == "__main__":
    main()
