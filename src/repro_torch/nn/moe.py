"""MoE block — the TP AG+MoE double ring; the port of ``repro/nn/moe.py``.

Prefill (``apply_seq``): rms_norm, the float32 top-k router (the dynamic
mapping), then ``pc.ag_moe``: token tiles and their routing tables flow
around the ranks while each rank's local experts compute, and the combined
outputs ride the same permutes back (``core/moe_overlap.py``).  On the
"fused" backend the expert GEMMs run on the grouped kernel.

Decode (``apply_decode``): tokens are replicated over the ranks; each rank
gathers its local experts' weights per (token, k), and a ``psum`` combines
the ranks — the JAX package's default decode path.

The expert count is padded up to a multiple of the TP degree; padding
experts get -inf router logits and are never selected.  Shared experts and
the expert-parallel (a2a) path are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.core.moe_overlap import moe_router
from repro_torch.nn.layers import ACTS, cdiv, he_init, rms_norm

__all__ = ["padded_experts", "init", "apply_seq", "apply_decode"]


def padded_experts(cfg, tp: int) -> int:
    return cdiv(cfg.moe.num_experts, tp) * tp


def _check(cfg):
    if cfg.moe.num_shared:
        raise NotImplementedError("repro_torch: shared experts (moe.num_shared > 0) are not ported yet")


def init(cfg, tp: int, generator: torch.Generator, dtype: torch.dtype, device) -> dict:
    """Global (unsharded) parameters in the JAX package's layout; the router
    stays float32 whatever ``dtype`` is."""
    _check(cfg)
    d, e_pad, f = cfg.d_model, padded_experts(cfg, tp), cfg.moe.d_expert
    return {
        "ln": torch.zeros((d,), dtype=dtype, device=device),
        "router": he_init((d, e_pad), generator, torch.float32, device, fan_in=d),
        "w_gu": he_init((e_pad, d, 2 * f), generator, dtype, device, fan_in=d),
        "w_down": he_init((e_pad, f, d), generator, dtype, device, fan_in=f),
    }


def apply_seq(params: dict, x: torch.Tensor, pc, cfg):
    """x: [W, B, s_loc, D] (sequence-sharded) -> ([W, B, s_loc, D] (+ residual), aux).

    Capacity and routing are per (rank, batch row); the aux loss is the mean
    over batch rows and ranks."""
    _check(cfg)
    m = cfg.moe
    e_pad = params["w_gu"].shape[1] * pc.tp
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    ids, wts, aux = moe_router(h, params["router"], num_experts=e_pad, top_k=m.top_k, valid_experts=m.num_experts)
    out = pc.ag_moe(
        h, ids, wts, params["w_gu"], params["w_down"], capacity_factor=m.capacity_factor, act=ACTS[cfg.act]
    )
    return x + out.to(x.dtype), pc.pmean(aux.mean(-1))


def apply_decode(params: dict, x: torch.Tensor, pc, cfg) -> torch.Tensor:
    """x: [B, C, D] replicated over the ranks. Per-(token, k) gathers of each
    rank's local expert weights, then a ``psum`` combine."""
    _check(cfg)
    m = cfg.moe
    w_gu, w_down = params["w_gu"], params["w_down"]  # [W, E_loc, D, 2f], [W, E_loc, f, D]
    world, e_loc, f = pc.tp, w_gu.shape[1], w_down.shape[2]
    b, s, d = x.shape
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    tokens = h.reshape(b * s, d)
    ids, wts, _ = moe_router(tokens, params["router"], num_experts=e_loc * world, top_k=m.top_k,
                             valid_experts=m.num_experts)  # fmt: skip
    rank = torch.arange(world, device=x.device)[:, None, None]
    local = ids[None] - rank * e_loc  # [W, m, k]
    valid = (local >= 0) & (local < e_loc)
    local_g = torch.where(valid, local, torch.zeros_like(local))
    hdn = torch.einsum("md,wmkdf->wmkf", tokens, w_gu[rank, local_g])  # [W, m, k, 2f]
    a = (ACTS[cfg.act](hdn[..., :f]) * hdn[..., f:]).to(x.dtype)
    ye = torch.einsum("wmkf,wmkfd->wmkd", a, w_down[rank, local_g])
    comb = (wts[None] * valid.float()).to(x.dtype)
    out = pc.psum(torch.einsum("wmkd,wmk->wmd", ye, comb))
    return x + out.reshape(b, s, d)
