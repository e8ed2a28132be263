"""Dense (gated) MLP block — the port of ``repro/nn/ffn.py``.

Prefill (``apply_seq``): AG+GEMM (gate/up fused, column-parallel) ->
activation -> GEMM+RS (down, row-parallel): the tensor-parallel MLP of the
paper's Fig. 1, on the fused kernels when ``pc.backend == "fused"``.
Decode (``apply_decode``): activations replicated over the ranks, local
per-rank matmuls and a ``psum`` epilogue.

Per rank, ``w_gu`` is [D, 2*f_loc] with the gate|up halves side by side in
each shard — the JAX package's layout, so its weights load as they are.
"""

from __future__ import annotations

import torch

from repro_torch.nn.layers import ACTS, he_init, rms_norm

__all__ = ["init", "apply_seq", "apply_decode"]


def init(cfg, generator: torch.Generator, dtype: torch.dtype, device) -> dict:
    """Global (unsharded) parameters in the JAX package's layout."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln": torch.zeros((d,), dtype=dtype, device=device),
        "w_gu": he_init((d, 2 * f), generator, dtype, device, fan_in=d),
        "w_down": he_init((f, d), generator, dtype, device, fan_in=f),
    }


def _gate(cfg, gu: torch.Tensor) -> torch.Tensor:
    f_loc = gu.shape[-1] // 2
    return ACTS[cfg.act](gu[..., :f_loc]) * gu[..., f_loc:]


def apply_seq(params: dict, x: torch.Tensor, pc, cfg) -> torch.Tensor:
    """x: [W, B, s_loc, D] (sequence-sharded) -> [W, B, s_loc, D] (+ residual)."""
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    gu = pc.ag_matmul(h, params["w_gu"])  # AG + GEMM  [W, B, S, 2*f_loc]
    a = _gate(cfg, gu).to(x.dtype)
    return x + pc.matmul_rs(a, params["w_down"])  # GEMM + RS


def apply_decode(params: dict, x: torch.Tensor, pc, cfg) -> torch.Tensor:
    """x: [B, C, D] replicated over the ranks. Local matmuls + psum epilogue."""
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    gu = torch.einsum("bsd,wdf->wbsf", h, params["w_gu"])
    a = _gate(cfg, gu).to(x.dtype)
    return x + pc.psum(torch.einsum("wbsf,wfd->wbsd", a, params["w_down"]))
