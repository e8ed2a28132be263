"""MoE block — the TP AG+MoE double ring; the port of ``repro/nn/moe.py``.

Prefill (``apply_seq``): rms_norm, the float32 top-k router (the dynamic
mapping), then ``pc.ag_moe``: token tiles and their routing tables flow
around the ranks while each rank's local experts compute, and the combined
outputs ride the same permutes back (``core/moe_overlap.py``).  With
``ParallelContext(ep_axis=...)`` (or ``apply_seq(ep=True)``) the routed
path is expert-parallel instead (``pc.a2a_moe``): each step a peer's own
token tile and tables land by a direct exchange, the local experts run on
it, and the partial returns home along the reversed edge.  On the "fused"
backend the expert GEMMs of either path run on the grouped kernel.

Decode (``apply_decode``): tokens are replicated over the ranks and a
``psum`` combines the ranks (over a world of processes the held ranks'
partials, gathered and summed in rank order: bitwise one process's).  Two
forms, as in the JAX package:

  * per-(token, k) gathers of each rank's local expert weights (the
    default), which read an expert's matrices once per (token, k) that
    picks it;
  * ``pc.moe_decode_stream``: every local expert's weights streamed once
    over all tokens, then a masked combine (one-hot of the valid local ids
    times the router weights).  Fixed shapes, no host sync, so the
    engine's captured step can replay it.

Shared experts (DeepSeek-style, ``moe.num_shared``) are one dense MLP of
width ``num_shared * d_expert`` (``p["shared"]``, ``nn/ffn``), applied
after the routed residual through its own ``ln`` with the residual inside,
as the JAX package computes it.

The expert count is padded up to a multiple of the TP degree; padding
experts get -inf router logits and are never selected.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.moe_overlap import moe_router
from repro_torch.nn import ffn
from repro_torch.nn.layers import ACTS, cdiv, he_init, rms_norm
from repro_torch.parallel.sharding import Spec

__all__ = ["padded_experts", "init", "specs", "apply_seq", "apply_decode"]


def padded_experts(cfg, tp: int) -> int:
    return cdiv(cfg.moe.num_experts, tp) * tp


def init(cfg, tp: int, generator: torch.Generator, dtype: torch.dtype, device) -> dict:
    """Global (unsharded) parameters in the JAX package's layout; the router
    stays float32 whatever ``dtype`` is; ``shared`` is a dense MLP's
    parameters when the config has shared experts."""
    m = cfg.moe
    d, e_pad, f = cfg.d_model, padded_experts(cfg, tp), m.d_expert
    p = {
        "ln": torch.zeros((d,), dtype=dtype, device=device),
        "router": he_init((d, e_pad), generator, torch.float32, device, fan_in=d),
        "w_gu": he_init((e_pad, d, 2 * f), generator, dtype, device, fan_in=d),
        "w_down": he_init((e_pad, f, d), generator, dtype, device, fan_in=f),
    }
    if m.num_shared:
        p["shared"] = ffn.init(cfg, generator, dtype, device, d_ff=m.num_shared * f)
    return p


def specs(cfg, tp: int, dp) -> dict:
    """``repro/nn/moe.specs`` on the rank-stacked layout: experts over the
    ranks (``w_gu`` [W, E_loc, D, 2f] with D over the data axes ``dp``,
    ``w_down`` [W, E_loc, f, D] likewise), the router and ``ln`` replicated,
    the shared MLP as a dense FFN."""
    s = {"ln": Spec(None), "router": Spec(None, None), "w_gu": Spec("model", None, dp, None),
         "w_down": Spec("model", None, None, dp)}  # fmt: skip
    if cfg.moe.num_shared:
        s["shared"] = ffn.specs(cfg, tp, dp)
    return s


def apply_seq(params: dict, x: torch.Tensor, pc, cfg, *, quant=None, ep=None, next_proj=None, tune=False):
    """x: [W, B, s_loc, D] (sequence-sharded) -> ([W, B, s_loc, D] (+ residual), aux).

    Capacity and routing are per (rank, batch row); the aux loss is the mean
    over batch rows and ranks.  ``ep`` picks the expert-parallel a2a path
    (default: whether ``pc.ep_axis`` is set; ``ep=True`` without it
    raises).  ``next_proj`` must be None: the MoE combine ends at the
    residual stream, so there is no RS -> AG seam to fuse.  Shared experts
    stay the dense TP MLP on either path.  ``quant`` pins a QuantSpec wire
    encoding on the block's collectives (``ParallelContext.quant``).
    ``tune=True`` has the routed exchange and the shared-expert MLP (which
    sees the same ``pc``) resolve tuned channels per shape."""
    if quant is not None and pc.quant != quant:
        pc = dataclasses.replace(pc, quant=quant)
    if tune and not pc.tune:
        pc = dataclasses.replace(pc, tune=True)
    if next_proj is not None:
        raise ValueError(
            "moe.apply_seq does not support next_proj: the MoE combine ends at the residual stream, "
            "so there is no RS->AG seam to fuse into a consumer"
        )
    if ep is None:
        ep = pc.ep_axis is not None
    if ep and pc.ep_axis is None:
        raise ValueError("moe.apply_seq(ep=True) requires ParallelContext(ep_axis=...); expert parallelism is opt-in")
    m = cfg.moe
    e_pad = params["w_gu"].shape[1] * pc.tp
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    ids, wts, aux = moe_router(h, params["router"], num_experts=e_pad, top_k=m.top_k, valid_experts=m.num_experts)
    moe_op = pc.a2a_moe if ep else pc.ag_moe
    out = moe_op(h, ids, wts, params["w_gu"], params["w_down"], capacity_factor=m.capacity_factor, act=ACTS[cfg.act])
    y = x + out.to(x.dtype)
    if "shared" in params:
        y = ffn.apply_seq(params["shared"], y, pc, cfg)  # residual inside
    return y, pc.pmean(aux.mean(-1))


def apply_decode(params: dict, x: torch.Tensor, pc, cfg) -> torch.Tensor:
    """x: [B, C, D] replicated over the ranks -> [B, C, D] (+ residual): each
    held rank's local experts (gathered per (token, k), or streamed once with
    ``pc.moe_decode_stream``), a ``psum`` combine, then the shared MLP.
    Held rank i is global rank ``pc.rank0 + i``, hosting experts from
    ``(pc.rank0 + i) * E_loc``."""
    m = cfg.moe
    w_gu, w_down = params["w_gu"], params["w_down"]  # [held, E_loc, D, 2f], [held, E_loc, f, D]
    world, e_loc, f = pc.tp, w_gu.shape[1], w_down.shape[2]
    b, s, d = x.shape
    act = ACTS[cfg.act]
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    tokens = h.reshape(b * s, d)
    ids, wts, _ = moe_router(tokens, params["router"], num_experts=e_loc * world, top_k=m.top_k,
                             valid_experts=m.num_experts)  # fmt: skip
    rank = torch.arange(pc.held, device=x.device)[:, None, None]  # the held ranks' index into w_gu / w_down
    local = ids[None] - (pc.rank0 + rank) * e_loc  # [held, m, k]
    valid = (local >= 0) & (local < e_loc)
    local_g = torch.where(valid, local, torch.zeros_like(local))
    if pc.moe_decode_stream:
        onehot = F.one_hot(local_g, e_loc).float() * valid[..., None]  # [W, m, k, E_loc]
        comb = torch.einsum("wmke,mk->wme", onehot, wts).to(x.dtype)
        hdn = torch.matmul(tokens, w_gu)  # [W, E_loc, m, 2f]: each local expert read once
        a = (act(hdn[..., :f]) * hdn[..., f:]).to(x.dtype)
        ye = torch.matmul(a, w_down)  # [W, E_loc, m, D]
        out = pc.psum(torch.einsum("wemd,wme->wmd", ye, comb))
    else:
        hdn = torch.einsum("md,wmkdf->wmkf", tokens, w_gu[rank, local_g])  # [W, m, k, 2f]
        a = (act(hdn[..., :f]) * hdn[..., f:]).to(x.dtype)
        ye = torch.einsum("wmkf,wmkfd->wmkd", a, w_down[rank, local_g])
        comb = (wts[None] * valid.float()).to(x.dtype)
        out = pc.psum(torch.einsum("wmkd,wmk->wmd", ye, comb))
    y = x + out.reshape(b, s, d)
    if "shared" in params:
        y = ffn.apply_decode(params["shared"], y, pc, cfg)
    return y
