"""Dense (gated) MLP block — the port of ``repro/nn/ffn.py``.

Prefill (``apply_seq``): AG+GEMM (gate/up fused, column-parallel) ->
activation -> GEMM+RS (down, row-parallel): the tensor-parallel MLP of the
paper's Fig. 1, on the fused kernels when ``pc.backend == "fused"``.
Decode (``apply_decode``): activations replicated over the ranks, local
per-rank matmuls and a ``psum`` epilogue.

Per rank, ``w_gu`` is [D, 2*f_loc] with the gate|up halves side by side in
each shard — the JAX package's layout, so its weights load as they are.

Seam fusion (``pc.fuse_seams``, driven by ``models/lm``): ``seam_proj``
gives the (glue, weight) pair an upstream RS fuses into this block's gate/up
AG; ``apply_seq(gu=)`` takes that fused projection, and
``apply_seq(next_proj=)`` fuses this block's down-projection RS into the
next consumer's AG.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn.layers import ACTS, he_init, rms_norm
from repro_torch.parallel.sharding import Spec

__all__ = ["init", "specs", "apply_seq", "apply_decode", "seam_proj"]


def init(cfg, generator: torch.Generator, dtype: torch.dtype, device, d_ff=None) -> dict:
    """Global (unsharded) parameters in the JAX package's layout; ``d_ff``
    overrides ``cfg.d_ff`` (a dense first layer, a shared-expert MLP)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "ln": torch.zeros((d,), dtype=dtype, device=device),
        "w_gu": he_init((d, 2 * f), generator, dtype, device, fan_in=d),
        "w_down": he_init((f, d), generator, dtype, device, fan_in=f),
    }


def specs(cfg, tp: int, dp) -> dict:
    """``repro/nn/ffn.specs`` on the rank-stacked layout: ``w_gu`` [W, D,
    2 f_loc] by columns (``P(dp, "model")``), ``w_down`` [W, f_loc, D] by rows
    (``P("model", dp)``); D over the data axes ``dp``."""
    return {"ln": Spec(None), "w_gu": Spec("model", dp, None), "w_down": Spec("model", None, dp)}


def _gate(cfg, gu: torch.Tensor) -> torch.Tensor:
    f_loc = gu.shape[-1] // 2
    return ACTS[cfg.act](gu[..., :f_loc]) * gu[..., f_loc:]


def seam_proj(params: dict, cfg):
    """(glue, w) for fusing an upstream RS into this block's gate/up AG:
    ``glue`` is the pre-MLP rms_norm, ``w`` the gate/up weight."""
    return (lambda y: rms_norm(y, params["ln"], cfg.norm_eps)), params["w_gu"]


def apply_seq(params: dict, x: torch.Tensor, pc, cfg, *, quant=None, gu=None, next_proj=None, ep=None, tune=False):
    """x: [W, B, s_loc, D] (sequence-sharded) -> [W, B, s_loc, D] (+ residual).

    ``gu``: this block's gate/up projection, already produced by the
    upstream op's fused RS -> AG pass (skips the norm and the AG here).
    ``next_proj=(glue, w)``: fuse the down-projection RS with the next
    consumer's AG; the return value is then ``(y, next_out)``.  ``ep`` must
    be falsy: a dense MLP has no expert-parallel form.
    ``quant`` pins a :class:`~repro_torch.core.quant.QuantSpec` wire encoding
    on this block's collectives (``ParallelContext.quant``); the weights may
    be :class:`~repro_torch.core.quant.PackedWeight` (``pack_weight``).
    ``tune=True`` has this block's collectives resolve tuned channels per
    shape (``ParallelContext.tune``).
    """
    if ep:
        raise ValueError(
            "ffn.apply_seq has no expert-parallel form; ep= selects the dispatch/combine a2a in moe.apply_seq only"
        )
    if quant is not None and pc.quant != quant:
        pc = dataclasses.replace(pc, quant=quant)
    if tune and not pc.tune:
        pc = dataclasses.replace(pc, tune=True)
    if gu is None:
        h = rms_norm(x, params["ln"], cfg.norm_eps)
        gu = pc.ag_matmul(h, params["w_gu"])  # AG + GEMM  [W, B, S, 2*f_loc]
    a = _gate(cfg, gu).to(x.dtype)
    if next_proj is None:
        return x + pc.matmul_rs(a, params["w_down"])  # GEMM + RS
    glue, w_next = next_proj
    return pc.matmul_rs_ag(a, params["w_down"], w_next, residual=x, glue=glue)


def apply_decode(params: dict, x: torch.Tensor, pc, cfg) -> torch.Tensor:
    """x: [B, C, D] replicated over the ranks. Local matmuls + psum epilogue."""
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    gu = torch.einsum("bsd,wdf->wbsf", h, params["w_gu"])
    a = _gate(cfg, gu).to(x.dtype)
    return x + pc.psum(torch.einsum("wbsf,wfd->wbsd", a, params["w_down"]))
